"""`.vks` scene file reader/writer (libvkr equivalent).

Re-implements the on-disk format parsed by ``ext/libvkr/src/vkr.c``:
- scene header v1-v4 (``vkr_load_scene``, vkr.c:770-1146); we read v2-v4 and
  write v4,
- per-mesh quantized vertex / normal+uv / material-id / optional index
  buffers laid out sequentially after the material names
  (vkr.c:1108-1143),
- material names in-file; material parameters + textures in the sibling
  ``<scene>_textures/`` directory (``vkr_load_material``, vkr.c:505-627);
  filenames are ``<Name>_<Param>.<ext>`` (strcat5 with "_", vkr.c:459/478/494):
  ``<Name>_EmissionIntensity.txt`` (1 or 4 floats, one per line),
  ``<Name>_SpecularTransmission.txt`` (4 floats: transmission, eta, k,
  translucency), ``<Name>_{BaseColor,Normal,Specular}.vkt`` textures,
- animation: a table of 24-byte quantized transforms at ``animationOffset``
  — ``numStaticTransforms`` once + ``numAnimatedTransforms`` x ``numFrames``
  (vkr.c:199-209, scene.cpp:713-729),
- LoD groups: per group mesh ids + detail reduction (vkr.c:1069-1096).

Buffers are memory-mapped on read and stay quantized until scene build,
mirroring the reference's mmap-to-GPU path (librender/scene.cpp:622-644).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from realtimepathtracingresearchframework_tpu.models import texture as texture_mod
from realtimepathtracingresearchframework_tpu.models.quantization import (
    TRANSFORM_SIZE,
    dequantize_transforms,
    quantize_transforms,
)
from realtimepathtracingresearchframework_tpu.utils.error_io import throw_error

VKS_MAGIC = 0xABCABC
VKS_MIN_VERSION = 2
VKS_MAX_VERSION = 4

MESH_FLAG_INDICES = 0x1
MESH_FLAG_BLEND_ATTRIBUTES = 0x2

TEXTURE_DIR_POSTFIX = "_textures"


@dataclass
class VkrMaterial:
    name: str
    extended_name: str = ""
    # Constant diffuse color for untextured materials. The on-disk format
    # only carries color via BaseColor textures (default white + warning,
    # scene.cpp:886-896); we persist this as a "<Name>BaseColor.txt" param
    # (same mechanism the format already uses for legacy emitter color).
    base_color: Optional[np.ndarray] = None
    emitter_base_color: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    emission_intensity: float = 0.0
    specular_transmission: float = 0.0
    ior_eta: float = 1.5
    ior_k: float = 0.0
    translucency: float = 0.0
    tex_base_color: Optional[texture_mod.Texture] = None
    tex_normal: Optional[texture_mod.Texture] = None
    tex_specular: Optional[texture_mod.Texture] = None
    # extended materials only (vkr.h:170-175): feature textures + neural
    # tensors, loaded from <Name>Feature%u.vkt / <Name>Tensor%u.vktensor
    features: list = field(default_factory=list)
    tensors: list = field(default_factory=list)


# --- .vktensor files (vkr_open_tensor, vkr.c:627-738) ---------------------

TENSOR_MAGIC = 0xFE1FE1
TENSOR_VERSION = 1
TENSOR_MAX_DIMENSIONALITY = 4  # VkrTensorMaxDimensionality

TENSOR_FORMAT_HALF_FLOAT = 1
TENSOR_FORMAT_FLOAT = 2
TENSOR_FORMAT_INT8 = 8

TENSOR_FLAGS_INPUT_OUTPUT_SPEC = 0x1
TENSOR_FLAGS_OUTPUT_TRANSPOSED = 0x2
TENSOR_FLAGS_IMPLICIT_BIASES = 0x4
TENSOR_FLAGS_CUSTOM_DATA_LAYOUT = 0x8

_TENSOR_DTYPES = {
    TENSOR_FORMAT_HALF_FLOAT: np.float16,
    TENSOR_FORMAT_FLOAT: np.float32,
    TENSOR_FORMAT_INT8: np.int8,
}


@dataclass
class VkrTensor:
    """Neural-material tensor (VkrTensor, vkr.h:131-147)."""

    dimensions: tuple = ()
    format: int = TENSOR_FORMAT_FLOAT
    flags: int = 0
    num_inputs: int = 0
    num_input_layer_blocks: int = 0
    num_outputs: int = 0
    num_output_layer_blocks: int = 0
    storage_descriptor: int = 0
    components_descriptor: int = 0
    ratio_descriptor: float = 0.0
    values: Optional[np.ndarray] = None  # typed view when standard layout
    data: bytes = b""  # raw payload (authoritative for custom layouts)

    @property
    def num_values(self) -> int:
        n = 1
        for d in self.dimensions:
            n *= int(d)
        return n


def read_tensor(path: str) -> VkrTensor:
    """Parse a .vktensor file (header layout per vkr.c:663-676: dims,
    i32 format/flags, io spec, custom size, descriptors, 7 reserved u64)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != TENSOR_MAGIC:
            raise ValueError(f"{path} is not a .vktensor file")
        if version != TENSOR_VERSION:
            raise ValueError(f"unsupported tensor version {version}")
        (dimensionality,) = struct.unpack("<Q", f.read(8))
        if dimensionality > TENSOR_MAX_DIMENSIONALITY:
            raise ValueError(f"tensor dimensionality {dimensionality} > 4")
        dims = struct.unpack(f"<{dimensionality}Q", f.read(8 * dimensionality))
        fmt, flags = struct.unpack("<ii", f.read(8))
        (n_in, n_in_blocks, n_out, n_out_blocks, custom_size,
         storage, components) = struct.unpack("<7Q", f.read(56))
        (ratio,) = struct.unpack("<d", f.read(8))
        f.read(8 * 7)  # reserved
        if flags & TENSOR_FLAGS_INPUT_OUTPUT_SPEC:
            if n_in < n_in_blocks or n_out < n_out_blocks:
                raise ValueError("tensor input/output spec corrupted")
        elif n_in or n_in_blocks or n_out or n_out_blocks:
            raise ValueError("io spec without INPUT_OUTPUT_SPEC flag")
        t = VkrTensor(
            dimensions=tuple(int(d) for d in dims),
            format=fmt,
            flags=flags,
            num_inputs=n_in,
            num_input_layer_blocks=n_in_blocks,
            num_outputs=n_out,
            num_output_layer_blocks=n_out_blocks,
            storage_descriptor=storage,
            components_descriptor=components,
            ratio_descriptor=ratio,
        )
        if flags & TENSOR_FLAGS_CUSTOM_DATA_LAYOUT:
            size = custom_size
        else:
            dt = _TENSOR_DTYPES.get(fmt)
            if dt is None:
                raise ValueError(f"invalid tensor format {fmt}")
            size = np.dtype(dt).itemsize * t.num_values
        if size == 0:
            raise ValueError("invalid tensor format")
        t.data = f.read(size)
        if len(t.data) != size:
            raise ValueError("failed to read tensor array")
        if not (flags & TENSOR_FLAGS_CUSTOM_DATA_LAYOUT):
            t.values = np.frombuffer(t.data, _TENSOR_DTYPES[fmt]).reshape(
                t.dimensions
            )
        return t


def write_tensor(path: str, t: VkrTensor) -> None:
    """Byte-compatible .vktensor writer (for tooling + roundtrip tests)."""
    data = t.data
    if not data and t.values is not None:
        data = np.ascontiguousarray(
            t.values, _TENSOR_DTYPES[t.format]
        ).tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", TENSOR_MAGIC, TENSOR_VERSION))
        f.write(struct.pack("<Q", len(t.dimensions)))
        f.write(struct.pack(f"<{len(t.dimensions)}Q", *t.dimensions))
        f.write(struct.pack("<ii", t.format, t.flags))
        custom = (
            len(data) if (t.flags & TENSOR_FLAGS_CUSTOM_DATA_LAYOUT) else 0
        )
        f.write(
            struct.pack(
                "<7Q",
                t.num_inputs,
                t.num_input_layer_blocks,
                t.num_outputs,
                t.num_output_layer_blocks,
                custom,
                t.storage_descriptor,
                t.components_descriptor,
            )
        )
        f.write(struct.pack("<d", t.ratio_descriptor))
        f.write(b"\0" * (8 * 7))
        f.write(data)


@dataclass
class VkrMesh:
    name: str = ""
    vertex_scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    vertex_offset: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    flags: int = 0
    num_triangles: int = 0
    material_id_buffer_base: int = 0
    num_materials_in_range: int = 0
    lod_group: int = 0
    segment_num_triangles: List[int] = field(default_factory=list)
    segment_material_base_offsets: List[int] = field(default_factory=list)
    # quantized buffers (memory-mapped views on read)
    vertices_q: Optional[np.ndarray] = None  # (3*T,) u64
    normal_uv_q: Optional[np.ndarray] = None  # (3*T,) u64
    material_ids: Optional[np.ndarray] = None  # (T,) u8 or u16
    indices: Optional[np.ndarray] = None  # (3*T,) u32 or None

    @property
    def num_segments(self) -> int:
        return len(self.segment_num_triangles)

    @property
    def aabb(self):
        lo = self.vertex_offset
        hi = self.vertex_offset + self.vertex_scale * float(0x1FFFFF)
        return np.minimum(lo, hi), np.maximum(lo, hi)


@dataclass
class VkrInstance:
    name: str = ""
    mesh_id: int = 0
    transform_index: int = 0
    flags: int = 0


@dataclass
class VkrLodGroup:
    mesh_ids: List[int] = field(default_factory=list)
    detail_reduction: List[float] = field(default_factory=list)

    @property
    def num_levels_of_detail(self) -> int:
        return len(self.mesh_ids)


@dataclass
class VkrScene:
    version: int = VKS_MAX_VERSION
    materials: List[VkrMaterial] = field(default_factory=list)
    meshes: List[VkrMesh] = field(default_factory=list)
    instances: List[VkrInstance] = field(default_factory=list)
    lod_groups: List[VkrLodGroup] = field(default_factory=list)
    animation_start: float = 0.0
    animation_step: float = 0.0
    num_frames: int = 1
    num_static_transforms: int = 0
    num_animated_transforms: int = 0
    transforms_q: Optional[np.ndarray] = None  # (N, 24) u8
    texture_dir: str = ""

    @property
    def num_triangles(self) -> int:
        return sum(m.num_triangles for m in self.meshes)

    def transform_offset(self, transform_index: int, frame: int) -> int:
        """vkr_get_transform_offset (vkr.c:199-209)."""
        if transform_index < self.num_static_transforms:
            return transform_index
        return (
            self.num_static_transforms
            + (transform_index - self.num_static_transforms)
            + frame * self.num_animated_transforms
        )

    def instance_transform(self, inst: VkrInstance, frame: int = 0) -> np.ndarray:
        """(3,4) row-major world transform for an instance at a frame."""
        off = self.transform_offset(inst.transform_index, frame)
        return dequantize_transforms(self.transforms_q[off : off + 1])[0]


def _texture_dir(scene_path: str) -> str:
    base, _ = os.path.splitext(scene_path)
    return base + TEXTURE_DIR_POSTFIX + os.sep


def _read_string(mm: np.memmap, pos: int):
    (length,) = struct.unpack_from("<Q", mm, pos)
    raw = bytes(mm[pos + 8 : pos + 8 + length + 1])
    return raw[:length].decode("utf-8", "replace"), pos + 8 + length + 1


def _load_material_params(texture_dir: str, mat: VkrMaterial) -> None:
    """Loads <Name>_EmissionIntensity.txt / <Name>_SpecularTransmission.txt /
    standard textures, per vkr_load_material (vkr.c:505-627). Filenames are
    ``<Name>_<Param>.<ext>`` (strcat5 with "_", vkr.c:459/478/494)."""

    def read_floats(suffix):
        path = os.path.join(texture_dir, mat.name + "_" + suffix + ".txt")
        try:
            with open(path) as f:
                return [float(x) for x in f.read().split()]
        except FileNotFoundError:
            return None

    ext_path = os.path.join(texture_dir, mat.name + "_Ex.txt")
    if os.path.exists(ext_path):
        with open(ext_path) as f:
            mat.extended_name = f.read().strip()
    else:
        mat.extended_name = mat.name

    em = read_floats("EmissionIntensity")
    if em is not None:
        if len(em) >= 4:
            mat.emission_intensity = em[0]
            mat.emitter_base_color = np.array(em[1:4], np.float32)
        elif len(em) == 1:
            mat.emission_intensity = em[0]
            bc = read_floats("BaseColor")
            if bc is not None and len(bc) >= 3:
                mat.emitter_base_color = np.array(bc[:3], np.float32)

    tr = read_floats("SpecularTransmission")
    if tr is not None and len(tr) >= 4:
        mat.specular_transmission, mat.ior_eta, mat.ior_k, mat.translucency = tr[:4]

    bc = read_floats("BaseColor")
    if bc is not None and len(bc) >= 3:
        mat.base_color = np.array(bc[:3], np.float32)

    def load_tex(suffix):
        path = os.path.join(texture_dir, mat.name + "_" + suffix + ".vkt")
        if os.path.exists(path):
            return texture_mod.read_vkt(path)
        return None

    mat.tex_base_color = load_tex("BaseColor")
    mat.tex_normal = load_tex("Normal")
    mat.tex_specular = load_tex("Specular")

    # extended materials: feature textures + neural tensors
    # (vkr_load_material, vkr.c:536-620; stop at the first missing index).
    # Extended = renamed via _Ex.txt, or name contains "_SHADER"/"_EX"
    # (vkr.c:538-539).
    is_extended = (
        (mat.extended_name and mat.extended_name != mat.name)
        or "_SHADER" in mat.name
        or "_EX" in mat.name
    )
    if is_extended:
        for i in range(4):  # VkrMaterialMaxFeatureTextures
            tex = load_tex(f"Feature{i}")
            if tex is None:
                break
            mat.features.append(tex)
        for i in range(3):  # VkrMaterialMaxTensors
            tp = os.path.join(
                texture_dir, mat.name + f"_Tensor{i}" + ".vktensor"
            )
            if not os.path.exists(tp):
                break
            mat.tensors.append(read_tensor(tp))


def open_scene(path: str, load_textures: bool = True) -> VkrScene:
    """Read a .vks scene (v2-v4). Buffers are zero-copy memmap views."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    magic, version = struct.unpack_from("<ii", mm, 0)
    if magic != VKS_MAGIC:
        throw_error("%s is not a .vks file", path)
    if not (VKS_MIN_VERSION <= version <= VKS_MAX_VERSION):
        throw_error("Unsupported .vks version %d in %s", version, path)

    scene = VkrScene(version=version, texture_dir=_texture_dir(path))
    pos = 8

    header_size = data_offset = 0
    if version >= 3:
        _flags, header_size, data_offset = struct.unpack_from("<QQQ", mm, pos)
        pos += 24

    num_meshes, num_instances = struct.unpack_from("<QQ", mm, pos)
    pos += 16
    num_materials, num_triangles_total = struct.unpack_from("<QQ", mm, pos)
    pos += 16

    num_instance_groups = num_instances
    if version >= 3:
        (num_instance_groups,) = struct.unpack_from("<Q", mm, pos)
        pos += 8

    num_lod_groups = 1
    lod_groups_offset = 0
    if version >= 4:
        num_lod_groups, lod_groups_offset = struct.unpack_from("<Qq", mm, pos)
        pos += 16
        _nbit, _bito = struct.unpack_from("<Qq", mm, pos)
        pos += 16
        scene.animation_start, scene.animation_step = struct.unpack_from(
            "<ff", mm, pos
        )
        pos += 8
        (
            scene.num_frames,
            scene.num_static_transforms,
            scene.num_animated_transforms,
            animation_offset,
        ) = struct.unpack_from("<QQQq", mm, pos)
        pos += 32
    else:
        scene.num_frames = 1
        scene.num_static_transforms = num_instances
        scene.num_animated_transforms = 0
        animation_offset = 0

    if version >= 3 and pos != header_size:
        throw_error("Mismatching header size in %s (%d != %d)", path, pos, header_size)

    # -- meshes
    for _ in range(num_meshes):
        mesh = VkrMesh()
        if version != 2:
            # v2 stores scale/offset AFTER the name + id fields; reading
            # them here too would misalign the whole v2 record by 24
            # bytes (vkr.c:886-890 guards this read identically)
            mesh.vertex_scale = np.frombuffer(mm, "<f4", 3, pos).copy()
            mesh.vertex_offset = np.frombuffer(mm, "<f4", 3, pos + 12).copy()
            pos += 24
        header_end = vertex_buffer_offset = 0
        num_segments = 1
        mesh.num_triangles = num_triangles_total
        mesh.num_materials_in_range = num_materials
        if version >= 3:
            flags, header_end, vertex_buffer_offset = struct.unpack_from(
                "<QQQ", mm, pos
            )
            mesh.flags = flags & 0xFFFFFFFF
            pos += 24
            num_segments, mesh.num_triangles = struct.unpack_from("<QQ", mm, pos)
            pos += 16
            mesh.material_id_buffer_base, mesh.num_materials_in_range = (
                struct.unpack_from("<iI", mm, pos)
            )
            pos += 8
            reserved = 8 - 3
            if version >= 4:
                (mesh.lod_group,) = struct.unpack_from("<q", mm, pos)
                pos += 8
                reserved -= 1
            pos += 8 * reserved
            mesh.segment_num_triangles = list(
                np.frombuffer(mm, "<u8", num_segments, pos)
            )
            pos += 8 * num_segments
            mesh.segment_material_base_offsets = list(
                np.frombuffer(mm, "<i4", num_segments, pos)
            )
            pos += 4 * num_segments
        else:
            mesh.segment_num_triangles = [mesh.num_triangles]
            mesh.segment_material_base_offsets = [0]
        mesh.name, pos = _read_string(mm, pos)
        if version == 2:
            mesh.material_id_buffer_base, nmir, mesh.num_triangles = (
                struct.unpack_from("<iQQ", mm, pos)
            )
            mesh.num_materials_in_range = int(nmir)
            pos += 20
            mesh.segment_num_triangles = [mesh.num_triangles]
            mesh.segment_material_base_offsets = [mesh.material_id_buffer_base]
            mesh.vertex_scale = np.frombuffer(mm, "<f4", 3, pos).copy()
            mesh.vertex_offset = np.frombuffer(mm, "<f4", 3, pos + 12).copy()
            pos += 24
        if version >= 3 and header_end != pos:
            throw_error("Mismatching mesh header offset in %s", path)
        mesh._vertex_buffer_offset = vertex_buffer_offset  # checked later
        scene.meshes.append(mesh)

    # -- instance groups
    next_transform_index = 0
    legacy_transforms = []
    for _ in range(num_instance_groups):
        inst = VkrInstance()
        if version != 2:
            inst.flags, inst.mesh_id = struct.unpack_from("<Ii", mm, pos)
            pos += 8
        header_end = group_data_offset = 0
        num_in_group = 1
        if version >= 3:
            header_end, group_data_offset, num_in_group = struct.unpack_from(
                "<QQQ", mm, pos
            )
            pos += 24
        inst.name, pos = _read_string(mm, pos)
        if version == 2:
            (inst.mesh_id,) = struct.unpack_from("<i", mm, pos)
            pos += 4
        if version >= 3 and group_data_offset != pos:
            throw_error("Mismatching instance group data offset in %s", path)
        for j in range(num_in_group):
            cur = (
                inst
                if j == 0
                else VkrInstance(inst.name, inst.mesh_id, 0, inst.flags)
            )
            if version >= 4:
                (cur.transform_index,) = struct.unpack_from("<I", mm, pos)
                pos += 4
            else:
                t = np.frombuffer(mm, "<f4", 12, pos).reshape(4, 3)
                pos += 48
                # v<4 stores column-major (4 cols x 3 rows); convert to (3,4)
                legacy_transforms.append(
                    np.concatenate([t[:3].T, t[3][:, None]], axis=1)
                )
                cur.transform_index = next_transform_index
                next_transform_index += 1
            scene.instances.append(cur)
        if version >= 3 and header_end != pos:
            throw_error("Mismatching instance group header offset in %s", path)

    # -- LoD groups
    if version >= 4:
        if lod_groups_offset != pos:
            throw_error("Invalid LoD group offset in %s", path)
        for _ in range(num_lod_groups):
            (n_lod,) = struct.unpack_from("<Q", mm, pos)
            pos += 8
            g = VkrLodGroup()
            if n_lod > 0:
                g.mesh_ids = list(np.frombuffer(mm, "<q", n_lod, pos))
                pos += 8 * n_lod
                g.detail_reduction = list(np.frombuffer(mm, "<f4", n_lod, pos))
                pos += 4 * n_lod
            scene.lod_groups.append(g)
    else:
        scene.lod_groups.append(VkrLodGroup())

    if version >= 3 and data_offset != pos:
        throw_error("Mismatching body data offset in %s", path)

    # -- material names (+ params/textures from texture dir)
    for _ in range(num_materials):
        name, pos = _read_string(mm, pos)
        mat = VkrMaterial(name=name)
        if load_textures:
            _load_material_params(scene.texture_dir, mat)
        scene.materials.append(mat)

    # -- mesh data buffers
    for mesh in scene.meshes:
        t = int(mesh.num_triangles)
        if version >= 3 and mesh._vertex_buffer_offset != pos:
            throw_error("Mismatching mesh data offset in %s", path)
        mesh.vertices_q = np.frombuffer(mm, "<u8", 3 * t, pos)
        pos += 8 * 3 * t
        mesh.normal_uv_q = np.frombuffer(mm, "<u8", 3 * t, pos)
        pos += 8 * 3 * t
        mat_id_size = (
            1
            if (mesh.num_materials_in_range <= 0x100 or mesh.num_segments > 1)
            else 2
        )
        mesh.material_ids = np.frombuffer(
            mm, "<u1" if mat_id_size == 1 else "<u2", t, pos
        )
        pos += mat_id_size * t
        if mesh.flags & MESH_FLAG_INDICES:
            mesh.indices = np.frombuffer(mm, "<u4", 3 * t, pos)
            pos += 4 * 3 * t

    # -- animation transform table
    n_transforms = (
        scene.num_static_transforms
        + scene.num_frames * scene.num_animated_transforms
    )
    if version >= 4 and animation_offset > 0:
        scene.transforms_q = np.frombuffer(
            mm, np.uint8, n_transforms * TRANSFORM_SIZE, animation_offset
        ).reshape(n_transforms, TRANSFORM_SIZE)
    elif legacy_transforms:
        scene.transforms_q = quantize_transforms(np.array(legacy_transforms))
    else:
        ident = np.zeros((max(n_transforms, 1), 3, 4), np.float32)
        ident[:, :, :3] = np.eye(3)
        scene.transforms_q = quantize_transforms(ident)

    return scene


# ---------------------------------------------------------------------------
# Writer (v4)
# ---------------------------------------------------------------------------


def _pack_string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<Q", len(raw)) + raw + b"\0"


def write_scene(path: str, scene: VkrScene) -> None:
    """Serialize a VkrScene as a version-4 .vks file (byte-compatible with
    vkr_load_scene). Material params/textures are written to the sibling
    texture dir if present on the material objects."""
    meshes = scene.meshes
    instances = scene.instances
    lod_groups = scene.lod_groups or [VkrLodGroup()]

    n_transforms = (
        scene.num_static_transforms
        + scene.num_frames * scene.num_animated_transforms
    )
    transforms_q = scene.transforms_q
    if transforms_q is None:
        ident = np.zeros((max(n_transforms, 1), 3, 4), np.float32)
        ident[:, :, :3] = np.eye(3)
        transforms_q = quantize_transforms(ident)

    # Group consecutive instances sharing (name, mesh_id, flags) the way the
    # format expects; here: one group per instance run with identical fields.
    groups = []
    for inst in instances:
        if groups and groups[-1][0].name == inst.name and groups[-1][0].mesh_id == inst.mesh_id:
            groups[-1].append(inst)
        else:
            groups.append([inst])

    header_size = 4 + 4 + 24 + 16 + 16 + 8 + 16 + 16 + 8 + 32

    # -- mesh headers (two passes: sizes then offsets)
    def mesh_header_size(mesh):
        return (
            24  # scale+offset
            + 24  # flags, headerEnd, vertexBufferOffset
            + 16  # numSegments, numTriangles
            + 8  # matIdBase, numMaterialsInRange
            + 8  # lodGroup
            + 8 * 4  # reserved
            + 8 * mesh.num_segments
            + 4 * mesh.num_segments
            + 8
            + len(mesh.name.encode("utf-8"))
            + 1
        )

    def group_header_size(group):
        return 8 + 24 + 8 + len(group[0].name.encode("utf-8")) + 1 + 4 * len(group)

    pos = header_size
    mesh_header_ends = []
    for mesh in meshes:
        pos += mesh_header_size(mesh)
        mesh_header_ends.append(pos)
    group_spans = []
    for g in groups:
        data_off = pos + group_header_size(g) - 4 * len(g)
        pos += group_header_size(g)
        group_spans.append((data_off, pos))
    lod_groups_offset = pos
    for g in lod_groups:
        pos += 8 + (12 * g.num_levels_of_detail if g.num_levels_of_detail else 0)
    data_offset = pos
    for mat in scene.materials:
        pos += 8 + len(mat.name.encode("utf-8")) + 1
    mesh_buffer_offsets = []
    for mesh in meshes:
        mesh_buffer_offsets.append(pos)
        t = int(mesh.num_triangles)
        mat_id_size = (
            1
            if (mesh.num_materials_in_range <= 0x100 or mesh.num_segments > 1)
            else 2
        )
        pos += 8 * 3 * t + 8 * 3 * t + mat_id_size * t
        if mesh.flags & MESH_FLAG_INDICES:
            pos += 4 * 3 * t
    animation_offset = pos

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", VKS_MAGIC, 4))
        f.write(struct.pack("<QQQ", 0, header_size, data_offset))
        f.write(struct.pack("<QQ", len(meshes), len(instances)))
        f.write(
            struct.pack(
                "<QQ", len(scene.materials), sum(m.num_triangles for m in meshes)
            )
        )
        f.write(struct.pack("<Q", len(groups)))
        f.write(struct.pack("<Qq", len(lod_groups), lod_groups_offset))
        f.write(struct.pack("<Qq", 0, 0))  # bone index tuples
        f.write(struct.pack("<ff", scene.animation_start, scene.animation_step))
        f.write(
            struct.pack(
                "<QQQq",
                scene.num_frames,
                scene.num_static_transforms,
                scene.num_animated_transforms,
                animation_offset,
            )
        )
        assert f.tell() == header_size

        for mesh, hend, boff in zip(meshes, mesh_header_ends, mesh_buffer_offsets):
            f.write(np.asarray(mesh.vertex_scale, "<f4").tobytes())
            f.write(np.asarray(mesh.vertex_offset, "<f4").tobytes())
            f.write(struct.pack("<QQQ", mesh.flags, hend, boff))
            f.write(struct.pack("<QQ", mesh.num_segments, mesh.num_triangles))
            f.write(
                struct.pack(
                    "<iI", mesh.material_id_buffer_base, mesh.num_materials_in_range
                )
            )
            f.write(struct.pack("<q", mesh.lod_group))
            f.write(b"\0" * 32)
            f.write(np.asarray(mesh.segment_num_triangles, "<u8").tobytes())
            f.write(
                np.asarray(mesh.segment_material_base_offsets, "<i4").tobytes()
            )
            f.write(_pack_string(mesh.name))
            assert f.tell() == hend, (f.tell(), hend)

        for g, (doff, hend) in zip(groups, group_spans):
            f.write(struct.pack("<Ii", g[0].flags, g[0].mesh_id))
            f.write(struct.pack("<QQQ", hend, doff, len(g)))
            f.write(_pack_string(g[0].name))
            assert f.tell() == doff
            for inst in g:
                f.write(struct.pack("<I", inst.transform_index))
            assert f.tell() == hend

        assert f.tell() == lod_groups_offset
        for g in lod_groups:
            f.write(struct.pack("<Q", g.num_levels_of_detail))
            if g.num_levels_of_detail:
                f.write(np.asarray(g.mesh_ids, "<q").tobytes())
                f.write(np.asarray(g.detail_reduction, "<f4").tobytes())

        assert f.tell() == data_offset
        for mat in scene.materials:
            f.write(_pack_string(mat.name))

        for mesh, boff in zip(meshes, mesh_buffer_offsets):
            assert f.tell() == boff
            f.write(np.asarray(mesh.vertices_q, "<u8").tobytes())
            f.write(np.asarray(mesh.normal_uv_q, "<u8").tobytes())
            mat_id_size = (
                1
                if (mesh.num_materials_in_range <= 0x100 or mesh.num_segments > 1)
                else 2
            )
            f.write(
                np.asarray(
                    mesh.material_ids, "<u1" if mat_id_size == 1 else "<u2"
                ).tobytes()
            )
            if mesh.flags & MESH_FLAG_INDICES:
                f.write(np.asarray(mesh.indices, "<u4").tobytes())

        assert f.tell() == animation_offset
        f.write(np.asarray(transforms_q, np.uint8).tobytes())

    # material params/textures
    tex_dir = _texture_dir(path)
    for mat in scene.materials:
        needs_dir = (
            mat.emission_intensity != 0.0
            or mat.specular_transmission != 0.0
            or mat.translucency != 0.0
            or mat.tex_base_color is not None
            or mat.base_color is not None
        )
        if not needs_dir:
            continue
        os.makedirs(tex_dir, exist_ok=True)

        # Param files are <Name>_<Param>.txt with exactly one float per line
        # (vkr_parse_material_param_file rejects any other delimiter,
        # vkr.c:395-452; filenames via strcat5 with "_", vkr.c:459).
        def write_param(param_name, values):
            p = os.path.join(tex_dir, mat.name + "_" + param_name + ".txt")
            with open(p, "w") as f:
                f.write("\n".join(repr(float(v)) for v in values) + "\n")

        if mat.emission_intensity != 0.0:
            c = mat.emitter_base_color
            write_param(
                "EmissionIntensity", [mat.emission_intensity, c[0], c[1], c[2]]
            )
        if mat.base_color is not None:
            write_param("BaseColor", list(mat.base_color[:3]))
        if mat.specular_transmission != 0.0 or mat.translucency != 0.0 or mat.ior_eta != 1.5:
            write_param(
                "SpecularTransmission",
                [mat.specular_transmission, mat.ior_eta, mat.ior_k, mat.translucency],
            )


# ---------------------------------------------------------------------------
# vkrinfo-style CLI (ext/libvkr/scripts/vkrinfo.py equivalent)
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m ...models.vkr <scene.vks>")
        return 2
    s = open_scene(argv[0], load_textures=False)
    print(f"version:    {s.version}")
    print(f"meshes:     {len(s.meshes)}")
    print(f"instances:  {len(s.instances)}")
    print(f"materials:  {len(s.materials)}")
    print(f"triangles:  {s.num_triangles}")
    print(f"lod groups: {len(s.lod_groups)}")
    print(
        f"animation:  {s.num_frames} frames, {s.num_static_transforms} static + "
        f"{s.num_animated_transforms} animated transforms"
    )
    for i, m in enumerate(s.meshes):
        lo, hi = m.aabb
        print(
            f"  mesh[{i}] '{m.name}': {m.num_triangles} tris, "
            f"{m.num_segments} segments, lod {m.lod_group}, "
            f"aabb [{lo[0]:.3g} {lo[1]:.3g} {lo[2]:.3g}]..[{hi[0]:.3g} {hi[1]:.3g} {hi[2]:.3g}]"
        )
    for i, m in enumerate(s.materials):
        extra = ""
        if m.tensors:
            dims = ",".join(str(t.dimensions) for t in m.tensors)
            extra += f" tensors[{len(m.tensors)}]: {dims}"
        if m.features:
            extra += f" features[{len(m.features)}]"
        print(f"  material[{i}] '{m.name}'{extra}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


def optimize_mesh(mesh: "VkrMesh") -> "VkrMesh":
    """Spatial-locality triangle reorder — the vkr_optimize_mesh analogue
    (vkr.h:433-437, meshoptimizer). The reference optimizes for GPU vertex
    caches; with implicit-index triangle soup here the equivalent lever
    is BVH leaf coherence, so triangles are Morton-ordered by centroid
    (segment boundaries and material ids move with their triangles)."""
    from realtimepathtracingresearchframework_tpu.models.quantization import (
        dequantize_vertices,
    )
    from realtimepathtracingresearchframework_tpu.ops.bvh import morton3d

    p = dequantize_vertices(
        mesh.vertices_q, mesh.vertex_scale, mesh.vertex_offset
    ).reshape(-1, 3, 3)
    c = p.mean(axis=1)
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / ext) * 1024.0, 0, 1023).astype(np.uint32)
    order = np.argsort(
        morton3d(q[:, 0], q[:, 1], q[:, 2]), kind="stable"
    ).astype(np.int64)
    vq = mesh.vertices_q.reshape(-1, 3)[order].reshape(-1)
    nq = mesh.normal_uv_q.reshape(-1, 3)[order].reshape(-1)

    # material assignment must survive the segment collapse: resolve
    # per-triangle ABSOLUTE ids under the scene.cpp:665-676 rule (id
    # buffer only for single-segment meshes with num_materials_in_range
    # > 1; segment base offsets otherwise), reorder, then re-emit in the
    # canonical single-segment encoding of the same assignment
    if mesh.num_segments == 1 and mesh.num_materials_in_range > 1:
        resolved = np.asarray(mesh.material_ids, np.int64) + int(
            mesh.material_id_buffer_base
        )
    else:
        resolved = np.repeat(
            np.asarray(mesh.segment_material_base_offsets, np.int64),
            np.asarray(mesh.segment_num_triangles, np.int64),
        )
    resolved = resolved[order]
    base = int(resolved.min()) if len(resolved) else 0
    local = resolved - base
    nmir = int(local.max()) + 1 if len(local) else 1
    import dataclasses

    if nmir > 1:
        # id-buffer path (1 segment + nmir > 1 keeps it honored)
        return dataclasses.replace(
            mesh,
            vertices_q=vq,
            normal_uv_q=nq,
            material_ids=local.astype(
                np.uint16 if nmir > 0x100 else np.uint8
            ),
            material_id_buffer_base=base,
            num_materials_in_range=nmir,
            segment_num_triangles=[mesh.num_triangles],
            segment_material_base_offsets=[base],
            indices=None,
        )
    # uniform material: the offset path carries it (id buffer ignored)
    return dataclasses.replace(
        mesh,
        vertices_q=vq,
        normal_uv_q=nq,
        material_ids=np.zeros(len(order), np.uint8),
        material_id_buffer_base=base,
        num_materials_in_range=1,
        segment_num_triangles=[mesh.num_triangles],
        segment_material_base_offsets=[base],
        indices=None,
    )
