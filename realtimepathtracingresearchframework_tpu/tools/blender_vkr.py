"""Blender exporter for .vks scenes.

Equivalent of the reference's blender_vkr addon
(ext/libvkr/scripts/blender_vkr/): exports Blender meshes, instances,
materials (base color / emission), and optionally textures to the
framework's quantized .vks/.vkt formats.

The conversion core (:func:`export_scene_data`) is pure Python/numpy and
unit-testable without Blender; the thin ``bpy`` layer at the bottom
registers the export operator when run inside Blender.

Install: Edit > Preferences > Add-ons > Install... and select this file
(with the realtimepathtracingresearchframework_tpu package importable).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from realtimepathtracingresearchframework_tpu.models import procedural, vkr


def export_scene_data(
    meshes: Sequence[dict],
    instances: Sequence[dict],
    materials: Sequence[dict],
    out_path: str,
) -> None:
    """Write a .vks from plain data:

    - meshes: [{"name", "triangles" (T,3,3) f32, "normals" (T,3,3)|None,
                "uvs" (T,3,2)|None, "material_ids" (T,)}]
    - instances: [{"name", "mesh_id", "transform" (3,4)}]
    - materials: [{"name", "base_color" (3,)|None, "emission" float,
                   "emission_color" (3,)|None, "transmission" float,
                   "ior" float}]
    """
    vmats = []
    for m in materials:
        vm = vkr.VkrMaterial(name=m["name"])
        if m.get("base_color") is not None:
            vm.base_color = np.asarray(m["base_color"], np.float32)
        if m.get("emission"):
            vm.emission_intensity = float(m["emission"])
            vm.emitter_base_color = np.asarray(
                m.get("emission_color", (1.0, 1.0, 1.0)), np.float32
            )
        if m.get("transmission"):
            vm.specular_transmission = float(m["transmission"])
            vm.ior_eta = float(m.get("ior", 1.5))
        vmats.append(vm)
    if not vmats:
        vmats = [vkr.VkrMaterial(name="Default")]

    vmeshes = []
    for m in meshes:
        vmeshes.append(
            procedural.make_mesh(
                m["name"],
                np.asarray(m["triangles"], np.float32),
                tri_normals=m.get("normals"),
                tri_uvs=m.get("uvs"),
                material_ids=np.asarray(
                    m.get("material_ids", np.zeros(len(m["triangles"]))), np.uint8
                ),
                num_materials=len(vmats),
            )
        )

    from realtimepathtracingresearchframework_tpu.models.quantization import (
        quantize_transforms,
    )

    transforms = np.array(
        [np.asarray(i["transform"], np.float32) for i in instances]
    )
    scene = vkr.VkrScene(
        materials=vmats,
        meshes=vmeshes,
        instances=[
            vkr.VkrInstance(name=i["name"], mesh_id=i["mesh_id"], transform_index=k)
            for k, i in enumerate(instances)
        ],
        lod_groups=[vkr.VkrLodGroup()],
        num_static_transforms=len(instances),
        transforms_q=quantize_transforms(transforms),
    )
    vkr.write_scene(out_path, scene)


# ---------------------------------------------------------------------------
# Blender integration (active only inside Blender)
# ---------------------------------------------------------------------------

bl_info = {
    "name": "Export .vks (rptr JAX path tracing framework)",
    "blender": (3, 0, 0),
    "category": "Import-Export",
}

# ---------------------------------------------------------------------------
# Camera-path export (operator_file_export_camera_path.py)
# ---------------------------------------------------------------------------


def blender_matrix_to_camera(m: np.ndarray):
    """Blender world matrix (4,4) -> framework (position, direction, up),
    rotated into the Vulkan coordinate frame Rx(-pi/2)*Rz(pi) exactly like
    write_camera_matrix (operator_file_export_camera_path.py:7-21)."""
    m = np.asarray(m, np.float64)
    p = m[:3, 3]
    rot = m[:3, :3]
    u = rot @ np.array([0.0, 1.0, 0.0])
    d = rot @ np.array([0.0, 0.0, -1.0])

    def swiz(v):
        return np.array([-v[0], v[2], v[1]], np.float64)

    return swiz(p), swiz(d), swiz(u)


def export_camera_path_ini(
    frames,
    out_path: str,
    seconds_per_frame: Optional[float] = None,
) -> None:
    """Write a keyframed camera-path ini (one [;] keyframe per frame) in
    the exact shape the reference exporter emits — readable by both this
    framework's imstate loader and the reference's
    (operator_file_export_camera_path.py:23-40). ``frames`` holds
    (position, direction, up) triples already in framework coordinates
    (use blender_matrix_to_camera); ``seconds_per_frame`` set = REAL_TIME
    intent (+dt relative timecodes), None = one logical frame per line."""
    dt = f"+{seconds_per_frame}" if seconds_per_frame is not None else ""
    with open(out_path, "w", encoding="utf-8") as f:
        for pos, dirn, up in frames:
            f.write("[Application][Scene]\n")
            f.write("[.][Camera]\n")
            f.write(f"position= {pos[0]} {pos[1]} {pos[2]}\n")
            f.write(f"direction= {dirn[0]} {dirn[1]} {dirn[2]}\n")
            f.write(f"up= {up[0]} {up[1]} {up[2]}\n")
            f.write("..\n")
            f.write(f"[;][{dt}]\n")


# ---------------------------------------------------------------------------
# PBR texture export (operator_file_export_pbr_textures.py)
# ---------------------------------------------------------------------------


def make_filename(s: str) -> str:
    """Sanitize like the reference (operator_file_export_pbr_textures.py:
    441-442)."""
    import re

    return re.sub(r"[^a-zA-Z0-9_. -]", "_-_", s)


def export_pbr_textures(
    material_images: Dict[str, Dict[str, np.ndarray]],
    output_dir: str,
) -> List[str]:
    """Write baked material layers as .vkt textures with the reference
    naming convention ``<Material>_<Layer>.vkt`` (BaseColor sRGB; Normal/
    Specular/SpecularTransmission linear — bake_material_texture,
    operator_file_export_pbr_textures.py:531-541). The Blender-side node
    baking lives in the bpy operator layer; this function is the pure
    writer so it is testable headlessly.

    ``material_images``: {material: {layer: (H, W, 3|4) float or uint8}}.
    Returns written paths."""
    import os

    from realtimepathtracingresearchframework_tpu.models.texture import (
        write_vkt,
    )

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for mat, layers in material_images.items():
        for layer, img in layers.items():
            path = os.path.join(
                output_dir, make_filename(f"{mat}_{layer}") + ".vkt"
            )
            write_vkt(path, np.asarray(img), srgb=layer == "BaseColor")
            written.append(path)
    return written


try:  # pragma: no cover - requires Blender
    import bpy
    from bpy_extras.io_utils import ExportHelper

    class ExportVKS(bpy.types.Operator, ExportHelper):
        bl_idname = "export_scene.vks"
        bl_label = "Export .vks"
        filename_ext = ".vks"

        def execute(self, context):
            meshes, instances, materials = [], [], []
            mat_index: Dict[str, int] = {}

            def material_id(mat) -> int:
                name = mat.name if mat else "Default"
                if name not in mat_index:
                    mat_index[name] = len(materials)
                    entry = {"name": name, "emission": 0.0}
                    if mat and mat.use_nodes:
                        bsdf = mat.node_tree.nodes.get("Principled BSDF")
                        if bsdf:
                            entry["base_color"] = tuple(
                                bsdf.inputs["Base Color"].default_value[:3]
                            )
                            entry["emission"] = float(
                                bsdf.inputs.get(
                                    "Emission Strength",
                                    type("x", (), {"default_value": 0.0}),
                                ).default_value
                            )
                            entry["transmission"] = float(
                                bsdf.inputs.get(
                                    "Transmission",
                                    type("x", (), {"default_value": 0.0}),
                                ).default_value
                            )
                    materials.append(entry)
                return mat_index[name]

            mesh_ids: Dict[str, int] = {}
            for obj in context.scene.objects:
                if obj.type != "MESH":
                    continue
                data = obj.data
                if data.name not in mesh_ids:
                    data.calc_loop_triangles()
                    tris, mids = [], []
                    for lt in data.loop_triangles:
                        tris.append([list(data.vertices[v].co) for v in lt.vertices])
                        slot = (
                            obj.material_slots[lt.material_index].material
                            if obj.material_slots
                            else None
                        )
                        mids.append(material_id(slot))
                    mesh_ids[data.name] = len(meshes)
                    meshes.append(
                        {
                            "name": data.name,
                            "triangles": np.array(tris, np.float32),
                            "material_ids": np.array(mids, np.uint8),
                        }
                    )
                mw = obj.matrix_world
                transform = np.array(
                    [[mw[r][c] for c in range(4)] for r in range(3)], np.float32
                )
                instances.append(
                    {
                        "name": obj.name,
                        "mesh_id": mesh_ids[data.name],
                        "transform": transform,
                    }
                )

            export_scene_data(meshes, instances, materials, self.filepath)
            return {"FINISHED"}

    def menu_func(self, context):
        self.layout.operator(ExportVKS.bl_idname)

    def register():
        bpy.utils.register_class(ExportVKS)
        bpy.types.TOPBAR_MT_file_export.append(menu_func)

    def unregister():
        bpy.utils.unregister_class(ExportVKS)
        bpy.types.TOPBAR_MT_file_export.remove(menu_func)

except ImportError:  # not running inside Blender
    pass
