"""Animation, BVH refit, and LoD selection tests."""

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural, vkr
from realtimepathtracingresearchframework_tpu.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu.models.quantization import (
    quantize_transforms,
)
from realtimepathtracingresearchframework_tpu.models.scene import Scene


def _animated_scene(frames=3):
    """Single triangle translated +x by 1 unit per frame."""
    vs = procedural.single_triangle()
    mats = []
    for f in range(frames):
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.eye(3)
        m[0, 3] = float(f)
        mats.append(m)
    vs.num_static_transforms = 0
    vs.num_animated_transforms = 1
    vs.num_frames = frames
    vs.transforms_q = quantize_transforms(np.array(mats))
    vs.instances[0].transform_index = 0
    return Scene.from_vkr_scene(vs)


def test_animated_transform_table():
    scene = _animated_scene()
    anim = scene.animation_data[0]
    t0 = anim.transform(0, frame=0)
    t2 = anim.transform(0, frame=2)
    assert t0[0, 3] == pytest.approx(0.0, abs=1e-4)
    assert t2[0, 3] == pytest.approx(2.0, abs=1e-4)


def test_set_animation_frame_moves_geometry():
    scene = _animated_scene()
    r = Renderer()
    r.initialize(8, 8)
    r.set_scene(scene)
    t, tri, u, v = r.render_ray_queries(
        np.array([[0.0, 0.0, 5.0]], np.float32), np.array([[0.0, 0.0, -1.0]], np.float32)
    )
    assert tri[0] == 0  # hit at frame 0

    r.set_animation_frame(2)
    t, tri, u, v = r.render_ray_queries(
        np.array([[0.0, 0.0, 5.0]], np.float32), np.array([[0.0, 0.0, -1.0]], np.float32)
    )
    assert tri[0] == -1  # moved away
    t, tri, u, v = r.render_ray_queries(
        np.array([[2.0, 0.0, 5.0]], np.float32), np.array([[0.0, 0.0, -1.0]], np.float32)
    )
    assert tri[0] == 0  # found at x=+2


def test_refit_vs_rebuild_budget():
    scene = _animated_scene()
    r = Renderer()
    r.initialize(8, 8)
    r.options = r.options.replace(rebuild_triangle_budget=0)  # force refit path
    r.set_scene(scene)
    r.set_animation_frame(1)
    t, tri, _, _ = r.render_ray_queries(
        np.array([[1.0, 0.0, 5.0]], np.float32), np.array([[0.0, 0.0, -1.0]], np.float32)
    )
    assert tri[0] == 0


def test_lod_selection():
    # two-mesh lod group: fine (base) and coarse
    vs = procedural.single_triangle()
    coarse = procedural.make_mesh(
        "tri_lod1",
        np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32) * 1.0,
    )
    coarse.lod_group = 1
    vs.meshes[0].lod_group = 1
    vs.meshes.append(coarse)
    vs.lod_groups.append(
        vkr.VkrLodGroup(mesh_ids=[0, 1], detail_reduction=[0.0, 0.5])
    )
    scene = Scene.from_vkr_scene(vs)
    assert len(scene.instances) == 1  # only base level instanced

    xform = np.zeros((3, 4), np.float32)
    xform[:, :3] = np.eye(3)
    # close: base mesh; far: coarse
    near = scene.select_lod(0, xform, camera_pos=[0, 0, 2.0], lod_threshold=0.02)
    far = scene.select_lod(0, xform, camera_pos=[0, 0, 1e5], lod_threshold=0.02)
    assert near == 0
    assert far == 1

    flat_near = scene.flatten_world(camera_pos=[0, 0, 2.0])
    flat_far = scene.flatten_world(camera_pos=[0, 0, 1e5])
    assert flat_near.num_tris == 1 and flat_far.num_tris == 1


def test_lod_selection_drives_renderer():
    """Camera-aware LoD through the RENDERER: the
    render path re-flattens when the camera's LoD selection changes
    (util/lod.cpp; per-LoD offset render_vulkan.cpp:1244-1248), and
    leaves the geometry alone while the selection is stable."""
    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderParams,
    )
    from realtimepathtracingresearchframework_tpu.backend.renderer import (
        FrameConfig,
        Renderer,
    )
    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera,
    )

    fine_tris = np.array(
        [
            [[-1, -1, 0], [0, -1, 0], [-0.5, 0, 0]],
            [[0, -1, 0], [1, -1, 0], [0.5, 0, 0]],
            [[-0.5, 0, 0], [0.5, 0, 0], [0, 1, 0]],
            [[-0.5, 0, 0], [0, -1, 0], [0.5, 0, 0]],
        ],
        np.float32,
    )
    vs = procedural.identity_scene(
        [procedural.make_mesh("fine", fine_tris)],
        [vkr.VkrMaterial(name="m", base_color=np.ones(3, np.float32))],
    )
    coarse = procedural.make_mesh(
        "fine_lod1",
        np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32),
    )
    coarse.lod_group = 1
    vs.meshes[0].lod_group = 1
    vs.meshes.append(coarse)
    vs.lod_groups.append(
        vkr.VkrLodGroup(mesh_ids=[0, 1], detail_reduction=[0.0, 0.5])
    )
    scene = Scene.from_vkr_scene(vs)
    assert scene.has_lod_groups()

    r = Renderer()
    r.initialize(8, 8)
    r.set_scene(scene)

    near_cam = OrientedCamera.look_at([0, 0, 3.0], [0, 0, 0], fovy=50)
    far_cam = OrientedCamera.look_at([0, 0, 4e4], [0, 0, 0], fovy=50)
    params = RenderParams(max_path_depth=1)

    r.render(FrameConfig(camera=near_cam, params=params))
    assert r._flat.num_tris == 4, "near camera should select the base LoD"
    flat_near = r._flat
    r.render(FrameConfig(camera=near_cam, params=params))
    assert r._flat is flat_near, "stable selection must not re-flatten"

    r.render(FrameConfig(camera=far_cam, params=params))
    assert r._flat.num_tris == 1, "far camera should select the coarse LoD"
    r.render(FrameConfig(camera=near_cam, params=params))
    assert r._flat.num_tris == 4


def test_tlas_animation_reuses_pass_program():
    """Two-level animation: set_animation_frame rebuilds only the TLAS
    side, the compiled pass program stays valid (the per-frame TLAS
    arrays are call operands, no retrace) and both ray queries and
    rendered frames follow the moved instance."""
    scene = _animated_scene()
    r = Renderer()
    r.options = r.options.replace(use_tlas=True)
    r.initialize(8, 8)
    r.set_scene(scene)
    cam = OrientedCamera.look_at([0.0, 0.0, 5.0], [0.0, 0.0, 0.0], fovy=40)
    cfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=1))
    blas_before = r.device_scene.tlas.blas_nodes
    r.render(cfg)
    alpha0 = r.readback_accumulation()[..., 3].mean()
    fns_before = dict(r._pass_fns)
    assert len(fns_before) == 1

    r.set_animation_frame(2)
    # static BLAS side untouched (same device buffer object)
    assert r.device_scene.tlas.blas_nodes is blas_before
    t, tri, u, v = r.render_ray_queries(
        np.array([[0.0, 0.0, 5.0]], np.float32),
        np.array([[0.0, 0.0, -1.0]], np.float32),
    )
    assert tri[0] == -1
    t, tri, u, v = r.render_ray_queries(
        np.array([[2.0, 0.0, 5.0]], np.float32),
        np.array([[0.0, 0.0, -1.0]], np.float32),
    )
    assert tri[0] == 0
    r.render(cfg)
    assert r._pass_fns == fns_before  # same jit instance, no rebuild
    # the triangle moved 2 units right: it covers fewer pixels of the
    # centred view (or none), so the coverage changes with the pose
    alpha2 = r.readback_accumulation()[..., 3].mean()
    assert alpha2 != alpha0


@pytest.mark.slow
def test_lod_with_animation_refit():
    """set_animation_frame on an LoD scene re-flattens with the SAME LoD
    selection the topology was built over and keeps the render loop's
    frame bookkeeping in sync — a base-LoD flatten refit against a
    coarse-LoD topology would pair new vertex arrays with mismatched
    leaf/row indices."""
    fine_tris = np.array(
        [
            [[-1, -1, 0], [0, -1, 0], [-0.5, 0, 0]],
            [[0, -1, 0], [1, -1, 0], [0.5, 0, 0]],
            [[-0.5, 0, 0], [0.5, 0, 0], [0, 1, 0]],
            [[-0.5, 0, 0], [0, -1, 0], [0.5, 0, 0]],
        ],
        np.float32,
    )
    fine = procedural.make_mesh("fine", fine_tris)
    fine.lod_group = 1
    coarse = procedural.make_mesh(
        "fine_lod1",
        np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32),
    )
    coarse.lod_group = 1
    anim = procedural.make_mesh(
        "anim", np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)
    )
    ident = np.zeros((3, 4), np.float32)
    ident[:, :3] = np.eye(3)
    frames = []
    for f in range(3):
        m = ident.copy()
        m[0, 3] = 4.0 + f  # animated tri rides x = 4 + frame
        frames.append(m)
    vs = vkr.VkrScene(
        materials=[
            vkr.VkrMaterial(name="m", base_color=np.ones(3, np.float32))
        ],
        meshes=[fine, coarse, anim],
        instances=[
            vkr.VkrInstance(name="fine", mesh_id=0, transform_index=0),
            vkr.VkrInstance(name="anim", mesh_id=2, transform_index=1),
        ],
        lod_groups=[
            vkr.VkrLodGroup(),
            vkr.VkrLodGroup(mesh_ids=[0, 1], detail_reduction=[0.0, 0.5]),
        ],
        num_static_transforms=1,
        num_animated_transforms=1,
        num_frames=3,
        transforms_q=quantize_transforms(np.stack([ident] + frames)),
    )
    scene = Scene.from_vkr_scene(vs)
    assert scene.has_lod_groups()

    r = Renderer()
    r.initialize(8, 8)
    r.options = r.options.replace(rebuild_triangle_budget=0)  # force refit
    r.set_scene(scene)
    # far camera -> the render loop re-flattens with the COARSE level
    cfg = FrameConfig(
        camera=OrientedCamera.look_at([0, 0, 60.0], [0, 0, 0], fovy=40),
        params=RenderParams(batch_spp=1, max_path_depth=2),
    )
    r.render(cfg)
    assert r._flat.num_tris == 2  # coarse (1) + animated (1)

    r.set_animation_frame(2)
    # the coarse selection must survive the refit (base LoD would be 5)
    assert r._flat.num_tris == 2
    assert r._scene_frame == 2
    # animated tri now at x=6, no longer at x=4
    t, tri, _, _ = r.render_ray_queries(
        np.array([[6.0, -0.5, 5.0]], np.float32),
        np.array([[0.0, 0.0, -1.0]], np.float32),
    )
    assert tri[0] >= 0
    t, tri, _, _ = r.render_ray_queries(
        np.array([[4.0, -0.5, 5.0]], np.float32),
        np.array([[0.0, 0.0, -1.0]], np.float32),
    )
    assert tri[0] == -1
