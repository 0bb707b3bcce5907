"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend.params import RenderParams
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural
from realtimepathtracingresearchframework_tpu.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu.models.scene import Scene
from realtimepathtracingresearchframework_tpu.ops.integrator import (
    FrameParams,
    ViewBuffers,
    render_tile,
)
from realtimepathtracingresearchframework_tpu.parallel.mesh import make_mesh
from realtimepathtracingresearchframework_tpu.parallel.render_sharded import (
    build_sharded_render,
)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device():
    scene = Scene.from_vkr_scene(procedural.cornell_box())
    r = Renderer()
    r.initialize(32, 32)
    r.set_scene(scene)
    params = RenderParams(batch_spp=2, max_path_depth=3)
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    cfg = r._integrator_config(params)

    pos, du, dv, tl = cam.view_basis(32, 32)
    view = ViewBuffers(
        cam_pos=jnp.asarray(pos),
        cam_du=jnp.asarray(du),
        cam_dv=jnp.asarray(dv),
        cam_dir_top_left=jnp.asarray(tl),
    )
    fp = FrameParams(
        rr_path_depth=jnp.int32(2),
        glossy_only_mode=jnp.int32(0),
        sample_offset=jnp.uint32(0),
        shot_offset=jnp.uint32(0),
    )

    single, rays_single = render_tile(
        r.device_scene, cfg, fp, view, 32, 32, 2
    )

    mesh = make_mesh()
    f = build_sharded_render(mesh, cfg, 32, 32)
    sharded, rays_sharded = f(r.device_scene, fp, view, jnp.int32(2))

    np.testing.assert_allclose(
        np.asarray(single), np.asarray(sharded), atol=2e-6, rtol=1e-5
    )
    assert int(rays_single) == int(rays_sharded)


def test_sharded_height_check():
    scene = Scene.from_vkr_scene(procedural.single_triangle())
    r = Renderer()
    r.initialize(16, 12)
    r.set_scene(scene)
    cfg = r._integrator_config(RenderParams(max_path_depth=2))
    mesh = make_mesh()
    with pytest.raises(ValueError):
        build_sharded_render(mesh, cfg, 16, 12)  # 12 % 8 != 0


def test_2d_mesh_matches_single_device():
    """2-D (tile_y, tile_x) sharding must be bit-identical to the
    single-device render (a pure work partition)."""
    import jax.numpy as jnp
    import numpy as np

    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderParams,
    )
    from realtimepathtracingresearchframework_tpu.backend.renderer import (
        Renderer,
    )
    from realtimepathtracingresearchframework_tpu.models import procedural
    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera,
    )
    from realtimepathtracingresearchframework_tpu.models.scene import Scene
    from realtimepathtracingresearchframework_tpu.ops import integrator as I
    from realtimepathtracingresearchframework_tpu.parallel.mesh import (
        make_mesh_2d,
    )
    from realtimepathtracingresearchframework_tpu.parallel.render_sharded import (
        build_sharded_render_2d,
    )

    W, H = 64, 32
    scene = Scene.from_vkr_scene(procedural.cornell_box())
    r = Renderer()
    r.initialize(W, H)
    r.set_scene(scene)
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    pos, du, dv, tl = cam.view_basis(W, H)
    view = I.ViewBuffers(
        jnp.asarray(pos), jnp.asarray(du), jnp.asarray(dv), jnp.asarray(tl)
    )
    fp = I.FrameParams(
        rr_path_depth=jnp.int32(2),
        glossy_only_mode=jnp.int32(0),
        sample_offset=jnp.uint32(0),
        shot_offset=jnp.uint32(0),
    )
    cfg = r._integrator_config(RenderParams(max_path_depth=3))

    single, rays1 = I.render_tile(r.device_scene, cfg, fp, view, W, H, 1)

    mesh = make_mesh_2d(2, 4)
    f = build_sharded_render_2d(mesh, cfg, W, H)
    sharded, rays2 = f(r.device_scene, fp, view, 1)

    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))
    assert int(rays1) == int(rays2)


@pytest.mark.slow
def test_multi_device_renderer_bit_identical():
    """Renderer(devices=[...]) round-robins swizzle chunks over
    per-device pass programs with the scene replicated (SURVEY 5.8) and
    must produce BIT-IDENTICAL frames to the single-device fast path —
    the multi-device product path (``--devices N``)."""
    import jax

    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderParams,
    )
    from realtimepathtracingresearchframework_tpu.backend.renderer import (
        FrameConfig,
        Renderer,
    )
    from realtimepathtracingresearchframework_tpu.models import procedural
    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera,
    )
    from realtimepathtracingresearchframework_tpu.models.scene import Scene

    devs = jax.devices()
    assert len(devs) >= 4, "conftest forces an 8-device CPU mesh"

    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    cfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=3))

    def run(devices):
        r = Renderer(devices=devices)
        r.initialize(64, 64)
        r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
        for _ in range(2):
            r.render(cfg)
        return np.asarray(r.accum), np.asarray(r.framebuffer), r

    ref, fb_ref, _ = run(None)
    for n in (2, 4):
        acc, fb, r = run(devs[:n])
        assert r._multi
        np.testing.assert_array_equal(acc, ref)
        np.testing.assert_array_equal(fb, fb_ref)
    # checkpoint/readback still works across devices
    import tempfile, os as _os

    _, _, r4 = run(devs[:4])
    with tempfile.TemporaryDirectory() as td:
        path = _os.path.join(td, "ck.npz")
        r4.save_state(path)
        r5 = Renderer()
        r5.initialize(64, 64)
        r5.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
        r5.load_state(path)
        assert r5.frame_id == 2
