"""Mode-completion features: DISCARD_HISTORY reprojection, thin-lens DoF,
data-capture POI/viewpoint generation."""

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend.params import (
    REPROJECTION_MODE_DISCARD_HISTORY,
    RenderBackendOptions,
    RenderParams,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural
from realtimepathtracingresearchframework_tpu.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu.models.scene import Scene


def _cornell():
    return Scene.from_vkr_scene(procedural.cornell_box())


def _renderer(w=32, h=32):
    r = Renderer()
    r.initialize(w, h)
    r.set_scene(_cornell())
    return r


def _config(**params):
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    return FrameConfig(
        camera=cam, params=RenderParams(max_path_depth=3, **params)
    )


# ---------------------------------------------------------------------------
# REPROJECTION_MODE_DISCARD_HISTORY
# ---------------------------------------------------------------------------


def test_discard_history_keeps_only_latest_frame():
    """Under DISCARD_HISTORY each frame stands alone
    (postprocess/reprojection.h:11-18): after two frames the accumulation
    equals a lone render of the second frame's sample index, not the
    two-frame average."""
    cfg = _config(reprojection_mode=REPROJECTION_MODE_DISCARD_HISTORY)
    r = _renderer()
    r.render(cfg)
    first = r.readback_accumulation()
    r.render(cfg)
    acc = r.readback_accumulation()

    # reference: progressive two-frame average from a fresh renderer;
    # frame 2 alone = 2*avg - frame 1 (discard frame 1 == progressive
    # frame 1 — same sample index 0)
    r2 = _renderer()
    r2.render(_config())
    r2.render(_config())
    avg2 = r2.readback_accumulation()
    lone_second = 2.0 * avg2 - first
    np.testing.assert_allclose(acc, lone_second, rtol=1e-4, atol=1e-5)
    # and it is NOT the progressive two-frame average
    assert np.abs(acc - avg2).max() > 1e-4


def test_progressive_mode_still_averages():
    cfg = _config()
    r = _renderer()
    r.render(cfg)
    first = r.readback_accumulation()
    r.render(cfg)
    acc = r.readback_accumulation()
    assert np.abs(acc - first).max() > 1e-4  # history retained, blended


# ---------------------------------------------------------------------------
# thin-lens depth of field
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_raytraced_dof_changes_image():
    """enable_raytraced_dof + aperture_radius > 0 must alter out-of-focus
    pixels (perspective.rgen:100-109); it was previously a no-op."""
    r = _renderer()
    sharp = _config()
    r.render(sharp)
    img_sharp = r.readback_accumulation()

    r.reset_accumulation()
    dof = _config(aperture_radius=0.2, focus_distance=1.0)
    r.render(dof)
    img_dof = r.readback_accumulation()
    assert np.abs(img_dof - img_sharp).max() > 1e-3


def test_dof_disabled_by_option():
    """With the RBO enable_raytraced_dof option off, aperture is ignored
    (option gating, render_params.glsl.h:97)."""
    r = _renderer()
    opts = RenderBackendOptions(enable_raytraced_dof=False)
    r.configure_for(opts)
    r.render(_config())
    base = r.readback_accumulation()
    r.reset_accumulation()
    r.render(_config(aperture_radius=0.2, focus_distance=1.0))
    with_ap = r.readback_accumulation()
    np.testing.assert_allclose(base, with_ap, rtol=1e-6, atol=0)


def test_dof_zero_aperture_matches_pinhole():
    r = _renderer()
    r.render(_config())
    pin = r.readback_accumulation()
    r.reset_accumulation()
    r.render(_config(aperture_radius=0.0, focus_distance=2.0))
    zero_ap = r.readback_accumulation()
    np.testing.assert_allclose(pin, zero_ap, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# data-capture POI sampling + viewpoint generation
# ---------------------------------------------------------------------------


def test_collect_and_prune_pois():
    from realtimepathtracingresearchframework_tpu.app import datacapture as dc

    r = _renderer()
    rng = np.random.default_rng(7)
    pois = dc.collect_visible_points(r, np.array([0.0, 1.0, 0.0]), 256, rng)
    assert len(pois) > 64  # the cornell interior surrounds the source
    pts = np.stack([p.position for p in pois])
    assert np.all(np.abs(pts[:, 0]) < 1.01 + 1e-3)
    assert np.all((pts[:, 1] > -1e-3) & (pts[:, 1] < 2.01))

    pruned = dc.prune_pois(r, pois, rng, min_separation=0.2)
    assert 0 < len(pruned) < len(pois)
    kept = np.stack([p.position for p in pruned])
    # grid-hash prune: no two kept points share a 0.2-cell
    cells = {tuple(c) for c in np.floor(kept / 0.2).astype(np.int64)}
    assert len(cells) == len(pruned)


def test_sample_viewpoint_is_unoccluded():
    from realtimepathtracingresearchframework_tpu.app import datacapture as dc

    r = _renderer()
    rng = np.random.default_rng(3)
    pois = dc.prune_pois(
        r, dc.collect_visible_points(r, np.array([0.0, 1.0, 0.0]), 256, rng),
        rng, min_separation=0.1,
    )
    v = dc.sample_viewpoint(r, pois, rng, min_dist=0.05, max_dist=5.0)
    assert np.isfinite(v.pos).all() and np.isfinite(v.dir).all()
    np.testing.assert_allclose(np.linalg.norm(v.dir), 1.0, rtol=1e-5)
    # the eye must see *some* geometry along its view direction
    t, tri, _u, _v = r.render_ray_queries(v.pos[None], v.dir[None])
    assert tri[0] >= 0


def test_generate_capture_views():
    from realtimepathtracingresearchframework_tpu.app import datacapture as dc

    r = _renderer()
    views = dc.generate_capture_views(
        r, [np.array([0.0, 1.0, 0.0])], num_pois_per_perspective=128,
        num_views=4, seed=1, min_dist=0.05, max_dist=5.0,
    )
    assert len(views) == 4
    for v in views:
        assert np.isfinite(v.pos).all()


# ---------------------------------------------------------------------------
# Full-integrator ray queries (render_vulkan.cpp:1867-1877)
# ---------------------------------------------------------------------------


def test_full_integrator_ray_queries():
    """render_ray_queries with an integrator variant dispatches the FULL
    path tracer over the query buffer with spp_per_query, returning
    per-query RGBA radiance (accumulate_query, accumulate.glsl:31-42)."""
    from realtimepathtracingresearchframework_tpu.backend.renderer import (
        VARIANT_MEGAKERNEL,
    )

    r = _renderer(8, 8)
    origins = np.array(
        [[0, 1.0, 3.2], [0, 1.0, 3.2], [0, 1.0, 3.2]], np.float32
    )
    dirs = np.array(
        [[0, 0, -1.0], [0.2, -0.1, -1.0], [0, 1.0, 0.0]], np.float32
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    res = r.render_ray_queries(
        origins, dirs, variant=VARIANT_MEGAKERNEL, spp_per_query=4,
        params=RenderParams(max_path_depth=3),
    )
    assert res.shape == (3, 4)
    assert np.isfinite(res).all()
    assert (res[:2, 3] == 1.0).all()  # forward rays hit the box
    assert res[:, :3].max() > 0.01  # lit interior returns radiance
    # more samples -> same shape, still finite (progressive average)
    res2 = r.render_ray_queries(
        origins, dirs, variant=VARIANT_MEGAKERNEL, spp_per_query=9,
        params=RenderParams(max_path_depth=3),
    )
    assert np.isfinite(res2).all()
    # the RQ_CLOSEST form keeps its tuple contract
    t, tri, u, v = r.render_ray_queries(origins, dirs)
    assert (np.asarray(tri)[:2] >= 0).all()


@pytest.mark.slow
def test_capture_poi_radiance():
    """Data capture uses the full-integrator query path for radiance
    targets (the denoiser-training capture)."""
    from realtimepathtracingresearchframework_tpu.app.datacapture import (
        capture_poi_radiance,
        collect_visible_points,
    )

    r = _renderer(8, 8)
    pois = collect_visible_points(
        r, np.array([0, 1.0, 0.0], np.float32), 32
    )
    assert pois
    rad = capture_poi_radiance(r, pois[:8], spp_per_query=2)
    assert rad.shape == (min(8, len(pois)), 4)
    assert np.isfinite(rad).all()
    assert rad[:, :3].max() > 0.0


def test_integrator_ray_query_t_max_bounds_primary():
    """A finite RenderRayQuery.t_max bounds the PRIMARY segment of
    integrator-variant queries (render_params.glsl.h:169): a surface
    beyond t_max is a miss, not shaded radiance."""
    from realtimepathtracingresearchframework_tpu.backend.renderer import (
        VARIANT_MEGAKERNEL,
    )

    r = _renderer(8, 8)
    o = np.array([[0, 1.0, 3.2]], np.float32)
    d = np.array([[0, 0, -1.0]], np.float32)
    unbounded = r.render_ray_queries(
        o, d, variant=VARIANT_MEGAKERNEL, spp_per_query=2,
        params=RenderParams(max_path_depth=2),
    )
    bounded = r.render_ray_queries(
        o, d, t_max=0.5, variant=VARIANT_MEGAKERNEL, spp_per_query=2,
        params=RenderParams(max_path_depth=2),
    )
    assert unbounded[0, 3] == 1.0  # hits the back wall
    assert bounded[0, 3] < 1.0  # segment ends before any surface
