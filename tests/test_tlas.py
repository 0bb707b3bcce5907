"""Two-level BLAS/TLAS traversal vs the flattened world BVH."""

import numpy as np
import pytest
import jax.numpy as jnp

from realtimepathtracingresearchframework_tpu.models import procedural
from realtimepathtracingresearchframework_tpu.models.scene import Scene
from realtimepathtracingresearchframework_tpu.ops import tlas as tlas_mod
from realtimepathtracingresearchframework_tpu.ops.bvh import build_threaded_bvh
from realtimepathtracingresearchframework_tpu.ops.traverse import (
    closest_hit_threaded,
    occluded_threaded,
    threaded_to_device,
)


def _two_level_from_scene(scene, frame=0):
    mts = []
    for m in scene.meshes:
        p = m.geometries[0].decode_positions()
        mts.append((p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]))
    blas = tlas_mod.build_blas_set(mts)
    mesh_ids = [
        scene.parameterized_meshes[i.parameterized_mesh_id].mesh_id
        for i in scene.instances
    ]
    mat_off = [
        scene.parameterized_meshes[i.parameterized_mesh_id].material_offset
        for i in scene.instances
    ]
    xfs = np.stack(
        [
            scene.animation_data[i.animation_data_index].transform(
                i.transform_index, frame
            )
            for i in scene.instances
        ]
    )
    aabbs = tlas_mod.instance_world_aabbs(blas, mesh_ids, xfs)
    nodes, row_inst = tlas_mod.build_tlas_nodes(aabbs)
    tables = tlas_mod.build_instance_tables(blas, mesh_ids, mat_off, xfs)
    return tlas_mod.TwoLevelBuffers(
        tlas_nodes=jnp.asarray(nodes),
        tlas_row_inst=jnp.asarray(row_inst),
        blas_nodes=jnp.asarray(blas.nodes),
        blas_tri_rows=jnp.asarray(blas.tri_rows),
        blas_row_tri=jnp.asarray(blas.row_tri),
        **tables,
    )


def _rot_y(deg):
    a = np.deg2rad(deg)
    return np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    )


def _instanced_scene():
    """Three transformed copies of one box mesh (rotation + scale +
    translation, one with negative scale = reflection)."""
    quads = np.concatenate(
        [
            procedural._quad([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]),
            procedural._quad([-1, 0, 1], [1, 0, 1], [1, 2, 1], [-1, 2, 1]),
        ]
    )
    mesh = procedural.make_mesh("panel", quads)
    xf = np.zeros((3, 3, 4), np.float32)
    xf[0, :, :3] = np.eye(3)
    xf[1, :, :3] = _rot_y(40) * 0.7
    xf[1, :, 3] = [2.5, 0.2, -0.5]
    xf[2, :, :3] = _rot_y(-25) * -0.9  # negative uniform scale (reflection)
    xf[2, :, 3] = [-2.5, 0.1, 0.4]
    vs = procedural.identity_scene([mesh, mesh, mesh], [procedural.cornell_box().materials[0]])
    vs.transforms_q = None
    from realtimepathtracingresearchframework_tpu.models.quantization import (
        quantize_transforms,
    )

    vs.transforms_q = quantize_transforms(xf)
    scene = Scene.from_vkr_scene(vs)
    return scene


def _rays(rng, n, origin):
    ro = jnp.asarray(np.tile(origin, (n, 1)), jnp.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, jnp.asarray(rd)


def _check_matches_flat(scene, origin, rng):
    flat = scene.flatten_world(frame=0)
    tb = threaded_to_device(build_threaded_bvh(flat.v0, flat.e1, flat.e2))
    tl = _two_level_from_scene(scene)
    ro, rd = _rays(rng, 2048, origin)
    h1 = closest_hit_threaded(tb, ro, rd)
    h2 = tlas_mod.closest_hit_two_level(tl, ro, rd)
    m1 = np.asarray(h1.tri) >= 0
    m2 = np.asarray(h2.tri) >= 0
    np.testing.assert_array_equal(m1, m2)
    # world t agrees (quantized transforms are decoded identically by both
    # paths; traversal order may differ so allow float slack)
    np.testing.assert_allclose(
        np.where(m1, np.asarray(h1.t), 0.0),
        np.where(m2, np.asarray(h2.t), 0.0),
        atol=2e-4,
        rtol=1e-4,
    )
    occ1 = np.asarray(occluded_threaded(tb, ro, rd, t_max=jnp.full((2048,), 1.5)))
    occ2 = np.asarray(
        tlas_mod.occluded_two_level(tl, ro, rd, t_max=jnp.full((2048,), 1.5))
    )
    np.testing.assert_array_equal(occ1, occ2)


def test_two_level_matches_flat_cornell(rng):
    scene = Scene.from_vkr_scene(procedural.cornell_box())
    _check_matches_flat(scene, [0.0, 1.0, 3.0], rng)


def test_two_level_matches_flat_instanced(rng):
    scene = _instanced_scene()
    _check_matches_flat(scene, [0.0, 1.0, 4.0], rng)


@pytest.mark.slow
def test_renderer_two_level_matches_flattened():
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

    scene = Scene.from_vkr_scene(procedural.cornell_box())
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    cfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=3))

    r_flat = Renderer()
    r_flat.initialize(24, 24)
    r_flat.set_scene(scene)
    r_flat.render(cfg)

    r_tlas = Renderer()
    r_tlas.options = r_tlas.options.replace(use_tlas=True)
    r_tlas.initialize(24, 24)
    r_tlas.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    assert r_tlas._use_two_level
    r_tlas.render(cfg)

    # identical RNG + hit semantics; ulp-level normal-transform noise
    # shifts a few BSDF directions at depth>=2, so allow small slack
    np.testing.assert_allclose(
        np.asarray(r_tlas.accum), np.asarray(r_flat.accum), atol=2e-3, rtol=1e-3
    )


@pytest.mark.slow
def test_renderer_two_level_animation_tlas_only():
    """Animated transforms: the TLAS fast path re-poses instances without a
    host reflatten, matching the flattened renderer at each frame."""
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
    from realtimepathtracingresearchframework_tpu.models.quantization import (
        quantize_transforms,
    )
    from realtimepathtracingresearchframework_tpu.models.scene import (
        AnimationData,
    )

    def animated_scene():
        scene = _instanced_scene()
        # two frames: frame 1 moves instance 1 (others static)
        ad = scene.animation_data[0]
        xf0 = scene.instance_transforms(0)
        xf1 = xf0.copy()
        xf1[1, :, 3] += [0.0, 0.5, 0.3]
        # table layout: statics first, then per-frame animated blocks
        statics = np.stack([xf0[0], xf0[2]])
        anim = np.stack([xf0[1], xf1[1]])[:, None]  # (frames, 1, 3, 4)
        table = np.concatenate([statics, anim.reshape(-1, 3, 4)])
        scene.animation_data = [
            AnimationData(
                num_static=2,
                num_animated=1,
                num_frames=2,
                transforms_q=quantize_transforms(table),
            )
        ]
        scene.instances[0].transform_index = 0
        scene.instances[2].transform_index = 1
        scene.instances[1].transform_index = 2  # first animated slot
        for i in scene.instances:
            i.animation_data_index = 0
        return scene

    cam = OrientedCamera.look_at([0, 1.0, 5.0], [0, 0.8, 0.0], fovy=55)
    cfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=2))

    imgs = {}
    for use_tlas in (False, True):
        r = Renderer()
        r.options = r.options.replace(use_tlas=use_tlas)
        r.initialize(24, 24)
        r.set_scene(animated_scene())
        for frame in (0, 1):
            r.set_animation_frame(frame)
            r.render(cfg)
            imgs[(use_tlas, frame)] = np.asarray(r.accum)

    assert not np.allclose(imgs[(True, 0)], imgs[(True, 1)])  # motion visible
    for frame in (0, 1):
        np.testing.assert_allclose(
            imgs[(True, frame)], imgs[(False, frame)], atol=2e-3, rtol=1e-3
        )


def test_two_level_tri_ids_are_global_shading_rows(rng):
    scene = _instanced_scene()
    tl = _two_level_from_scene(scene)
    ro, rd = _rays(rng, 1024, [0.0, 1.0, 4.0])
    h = tlas_mod.closest_hit_two_level(tl, ro, rd)
    tri = np.asarray(h.tri)
    inst = np.asarray(h.inst)
    hit = tri >= 0
    # three 4-tri meshes -> global shading rows 0..11, grouped by instance
    assert tri[hit].max() < 12
    np.testing.assert_array_equal(tri[hit] // 4, inst[hit])
    assert len(np.unique(inst[hit])) >= 2  # rays reach several instances


def test_two_level_aovs_match_flattened():
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

    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    cfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=2))
    out = {}
    for use_tlas in (False, True):
        r = Renderer()
        r.options = r.options.replace(use_tlas=use_tlas)
        r.initialize(16, 16)
        r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
        out[use_tlas] = r.render_aovs(cfg)
    for f in ("albedo_roughness", "normal_depth", "motion_jitter"):
        a = np.asarray(getattr(out[False], f))
        b = np.asarray(getattr(out[True], f))
        a = np.where(np.isfinite(a), a, 1e30)
        b = np.where(np.isfinite(b), b, 1e30)
        np.testing.assert_allclose(a, b, atol=1e-5)
