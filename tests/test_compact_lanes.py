"""Carry-level lane compaction (IntegratorConfig.compact_lanes) is
semantically invisible: sorting the whole path-state carry live-first
and running each bounce on a live-covering lane prefix reproduces the
full-width loop (every live lane is inside every prefix it is dispatched
with, and all dead-lane state writes are masked — see
integrator.trace_paths).

Tolerance note: radiance equality is asserted to ~1e-5 relative, not
bitwise — XLA re-rounds elementwise chains differently across program
shapes, and the plain renderer already exhibits the same ~6e-6 variance
between the unrolled and dynamic bounce loops with compaction off
entirely (measured on CPU). Path STRUCTURE is asserted exactly:
per-lane traced-ray counts and alpha must match bitwise, proving
identical traversal results, NEE visibility, and RR decisions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    VARIANT_MEGAKERNEL,
    VARIANT_WAVEFRONT,
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural
from realtimepathtracingresearchframework_tpu.models.camera import (
    OrientedCamera,
)
from realtimepathtracingresearchframework_tpu.models.scene import Scene


@pytest.fixture(scope="module")
def village_ds():
    scfg = SceneConfig(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)
    r = Renderer()
    r.initialize(64, 64)
    r.set_scene(
        Scene.from_vkr_scene(procedural.cornell_box()), scene_config=scfg
    )
    return r


@pytest.mark.parametrize("wavefront", [False, True])
def test_trace_paths_compact_lanes(village_ds, wavefront):
    # resolve integrator/vec3 at call time: an earlier hot_reload test
    # may have reloaded these modules, and a stale collection-time Vec3
    # class breaks pytree-structure equality inside lax.cond
    from realtimepathtracingresearchframework_tpu.ops import (
        integrator as intg,
    )
    from realtimepathtracingresearchframework_tpu.ops import pointsets
    from realtimepathtracingresearchframework_tpu.ops.integrator import (
        FrameParams,
    )
    from realtimepathtracingresearchframework_tpu.ops.vec3 import Vec3

    r = village_ds
    ds = r.device_scene
    base = r._integrator_config(
        RenderParams(batch_spp=1, max_path_depth=5)
    )._replace(
        unroll=False, compact=False, compact_lanes=False,
        wavefront=wavefront,
    )
    comp = base._replace(compact_lanes=True)

    n = 6144
    rng = np.random.default_rng(3)
    p = np.full((n, 3), (0.0, 1.0, 0.5), np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = Vec3(*(jnp.asarray(p[:, k]) for k in range(3)))
    rd = Vec3(*(jnp.asarray(d[:, k]) for k in range(3)))
    st = pointsets.RngState(
        s0=jnp.asarray(rng.integers(0, 1 << 31, n).astype(np.uint32)),
        s1=jnp.asarray(rng.integers(0, 1 << 31, n).astype(np.uint32)),
    )
    fp = FrameParams(
        rr_path_depth=jnp.int32(2), glossy_only_mode=jnp.int32(0),
        sample_offset=jnp.uint32(0), shot_offset=jnp.uint32(0),
    )

    def run(cfg):
        f = jax.jit(
            lambda ro, rd, st: intg.trace_paths(ds, cfg, fp, ro, rd, st)
        )
        illum, alpha, rays = f(ro, rd, st)
        return (
            np.stack([np.asarray(c) for c in illum]),
            np.asarray(alpha),
            np.asarray(rays),
        )

    i0, a0, r0 = run(base)
    i1, a1, r1 = run(comp)
    # path structure: bitwise — same hits, same NEE visibility, same RR
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(a0, a1)
    # radiance: XLA program-shape rounding only
    np.testing.assert_allclose(i1, i0, rtol=3e-5, atol=1e-7)


def _render(variant, compact_lanes):
    os.environ["RPTR_COMPACT_LANES"] = "1" if compact_lanes else "0"
    try:
        scfg = SceneConfig(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)
        r = Renderer()
        r.initialize(96, 64)
        r.set_scene(
            Scene.from_vkr_scene(procedural.cornell_box()),
            scene_config=scfg,
        )
        r.set_variant(variant)
        cfg = FrameConfig(
            camera=OrientedCamera.look_at(
                [0, 1.2, 3.0], [0, 0.8, 0.0], fovy=55
            ),
            params=RenderParams(batch_spp=1, max_path_depth=5,
                                rr_path_depth=2),
            scene_config=scfg,
        )
        for _ in range(2):
            r.render(cfg)
        return np.asarray(r.readback_framebuffer())
    finally:
        os.environ.pop("RPTR_COMPACT_LANES", None)


@pytest.mark.parametrize(
    "variant", [VARIANT_MEGAKERNEL, VARIANT_WAVEFRONT]
)
def test_renderer_compact_lanes(variant):
    base = _render(variant, compact_lanes=False)
    comp = _render(variant, compact_lanes=True)
    assert base.shape == comp.shape
    np.testing.assert_allclose(comp, base, rtol=3e-5, atol=1e-7)
