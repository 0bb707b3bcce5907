"""End-to-end render tests (small images on CPU; exercise the full stack)."""

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend.params import (
    LIGHT_SAMPLING_VARIANT_RIS,
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    FrameConfig,
    Renderer,
)
from realtimepathtracingresearchframework_tpu.models import procedural
from realtimepathtracingresearchframework_tpu.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu.models.scene import Scene


@pytest.fixture(scope="module")
def cornell_renderer():
    scene = Scene.from_vkr_scene(procedural.cornell_box())
    r = Renderer()
    r.initialize(32, 32)
    r.set_scene(scene)
    return r


def _cam():
    return OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)


def test_render_cornell_basic(cornell_renderer):
    r = cornell_renderer
    r.reset_accumulation()
    cfg = FrameConfig(camera=_cam(), params=RenderParams(batch_spp=4, max_path_depth=4))
    stats = r.render(cfg)
    img = r.readback_accumulation()
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0.02  # light reaches the film
    assert img[..., 3].mean() > 0.9  # nearly every primary ray hits the box
    assert stats.spp == 4
    # render() keeps the ray counter device-side (rays_per_second = -1,
    # the reference default); forcing it blocks and reports the rate
    assert stats.rays_per_second == -1.0
    assert r.stats(force_rays=True).rays_per_second > 0


def test_render_deterministic(cornell_renderer):
    r = cornell_renderer
    cfg = FrameConfig(camera=_cam(), params=RenderParams(batch_spp=2, max_path_depth=3))
    r.reset_accumulation()
    r.render(cfg)
    a = r.readback_accumulation()
    r.reset_accumulation()
    r.render(cfg)
    b = r.readback_accumulation()
    np.testing.assert_array_equal(a, b)


def test_accumulation_converges(cornell_renderer):
    """More samples must reduce variance vs a high-spp reference."""
    r = cornell_renderer
    cfg = FrameConfig(camera=_cam(), params=RenderParams(batch_spp=8, max_path_depth=4))
    r.reset_accumulation()
    r.render(cfg)
    img8 = r.readback_accumulation()[..., :3]
    for _ in range(3):
        r.render(cfg)
    img32 = r.readback_accumulation()[..., :3]
    # accumulation is an average: means stay close, but they must differ
    assert abs(img8.mean() - img32.mean()) < 0.15
    assert not np.array_equal(img8, img32)


def test_unroll_variant_matches_dynamic(cornell_renderer):
    """unroll_bounces is a perf knob, not a semantic one (same image)."""
    r = cornell_renderer
    cfg = FrameConfig(camera=_cam(), params=RenderParams(batch_spp=2, max_path_depth=3))
    r.reset_accumulation()
    r.render(cfg)
    dynamic = r.readback_accumulation()

    r.configure_for(r.options.replace(unroll_bounces=True))
    r.reset_accumulation()
    r.render(cfg)
    unrolled = r.readback_accumulation()
    r.configure_for(r.options.replace(unroll_bounces=False))
    # XLA reassociates float math differently between the unrolled and
    # fori-loop programs; images agree to ~1e-3, not bit-exactly.
    np.testing.assert_allclose(dynamic, unrolled, atol=5e-3)


@pytest.mark.slow
def test_ris_binned_lights_consistent():
    """RIS binned sampling must agree with uniform light sampling in mean."""
    scene = Scene.from_vkr_scene(procedural.cornell_box())
    cam = _cam()
    params = RenderParams(batch_spp=64, max_path_depth=2)

    imgs = {}
    for variant in (0, LIGHT_SAMPLING_VARIANT_RIS):
        r = Renderer()
        r.options = r.options.replace(light_sampling_variant=variant)
        r.initialize(24, 24)
        r.set_scene(scene)
        r.render(FrameConfig(camera=cam, params=params))
        imgs[variant] = r.readback_accumulation()[..., :3]

    m0 = imgs[0].mean()
    m1 = imgs[LIGHT_SAMPLING_VARIANT_RIS].mean()
    assert abs(m0 - m1) / max(m0, 1e-9) < 0.12


def test_emissive_visible_directly(cornell_renderer):
    """The area light panel must be visible (emitter-hit MIS path)."""
    r = cornell_renderer
    cam = OrientedCamera.look_at([0, 1.0, 0.5], [0, 2.0, 0.3], fovy=60)
    r.reset_accumulation()
    r.render(FrameConfig(camera=cam, params=RenderParams(batch_spp=4, max_path_depth=2)))
    img = r.readback_accumulation()
    assert img[..., :3].max() > 3.0  # emitter radiance 12 * color


def test_ray_queries(cornell_renderer):
    r = cornell_renderer
    t, tri, u, v = r.render_ray_queries(
        np.array([[0.0, 1.8, 4.0], [0.0, 1.0, 10.0]], np.float32),
        np.array([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]], np.float32),
    )
    assert tri[0] >= 0 and t[0] == pytest.approx(5.0, abs=1e-3)
    assert tri[1] == -1


def test_sun_sky_outdoor():
    """Sky-only scene: up-facing camera sees blue-ish sky, sun lights a plane."""
    scene = Scene.from_vkr_scene(procedural.single_triangle())
    r = Renderer()
    r.initialize(16, 16)
    r.set_scene(scene, SceneConfig(sun_dir=(0.3, 0.8, 0.2)))
    cam = OrientedCamera.look_at([0, 0, 5], [0, 5, 4], fovy=60)
    r.render(FrameConfig(camera=cam, params=RenderParams(batch_spp=2, max_path_depth=2)))
    img = r.readback_accumulation()
    sky_px = img[..., :3][img[..., 3] < 0.5]
    assert len(sky_px) > 0
    assert sky_px.mean(axis=0)[2] > sky_px.mean(axis=0)[0]  # blue > red
    assert np.isfinite(img).all()


def test_wavefront_matches_megakernel(cornell_renderer):
    """The wavefront restructures each bounce into a merged two-queue
    intersect dispatch + deferred NEE resolution; same samples and
    accumulation order, but XLA's FMA fusion differs across the two
    graphs, so the gate is the reference's own image-parity bar:
    per-channel relative error <= 1e-6 (compare_exr.cpp:75-97, the
    validation-mode correctness gate)."""
    from realtimepathtracingresearchframework_tpu.backend.renderer import (
        VARIANT_MEGAKERNEL,
        VARIANT_WAVEFRONT,
    )
    from realtimepathtracingresearchframework_tpu.utils.compare import (
        compare_images,
    )

    r = cornell_renderer
    cfg = FrameConfig(camera=_cam(), params=RenderParams(batch_spp=2, max_path_depth=4))
    r.active_variant = VARIANT_MEGAKERNEL
    r.reset_accumulation()
    r.render(cfg)
    mega = r.readback_accumulation()

    r.active_variant = VARIANT_WAVEFRONT
    r.reset_accumulation()
    r.render(cfg)
    wave = r.readback_accumulation()
    r.active_variant = VARIANT_MEGAKERNEL

    result = compare_images(
        wave[..., :3].astype(np.float32), mega[..., :3].astype(np.float32),
        threshold=1e-6,
    )
    assert result.passed, f"max rel err {result.max_rel_error:.3e}"
    # alpha is untouched by NEE restructuring: exact
    np.testing.assert_array_equal(mega[..., 3], wave[..., 3])


@pytest.mark.slow
def test_wavefront_renders_textured_scene():
    """Regression: the wavefront carry holds BOTH the pending-NEE queue
    and the texture footprint; the post-loop flush must unpack by index
    (a fixed-arity unpack crashed on any textured scene)."""
    from realtimepathtracingresearchframework_tpu.backend.renderer import (
        Renderer,
        VARIANT_WAVEFRONT,
    )
    from realtimepathtracingresearchframework_tpu.models import procedural
    from realtimepathtracingresearchframework_tpu.models.scene import Scene
    from realtimepathtracingresearchframework_tpu.models.texture import (
        Texture,
        build_mip_chain,
    )

    sv = procedural.cornell_box()
    tex = np.zeros((8, 8, 4), np.float32)
    tex[..., 0] = 0.8
    tex[..., 3] = 1.0
    sv.materials[0].tex_base_color = Texture(
        8, 8, 37, mips=build_mip_chain(tex), srgb=False
    )
    r = Renderer()
    r.initialize(24, 24)
    r.set_scene(Scene.from_vkr_scene(sv))
    assert r._has_textures
    r.set_variant(VARIANT_WAVEFRONT)
    r.render(FrameConfig(camera=_cam(), params=RenderParams(max_path_depth=3)))
    img = r.readback_accumulation()
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0.01


def test_freeze_frame_pins_sample_sequence(cornell_renderer):
    """--freeze-frame: frame_id stays pinned so every frame re-renders
    the same sample sequence (render_vulkan.cpp:2152-2154)."""
    r = cornell_renderer
    cfg = FrameConfig(
        camera=_cam(), params=RenderParams(batch_spp=2, max_path_depth=3)
    )
    r.freeze_frame = True
    try:
        r.reset_accumulation()
        r.render(cfg)
        a = r.readback_accumulation()
        assert r.frame_id == 0
        r.render(cfg)  # NOT reset: same samples again, same average
        b = r.readback_accumulation()
        np.testing.assert_array_equal(a, b)
    finally:
        r.freeze_frame = False


def test_accumulate_history_batch_mean_weighting():
    """accumulate_history blends a batch MEAN: weight batch/(base+batch)
    (a 1/n weight under-counts every multi-sample batch by batch_size)."""
    from realtimepathtracingresearchframework_tpu.ops import resolve

    import jax.numpy as jnp

    h = jnp.full((2, 2, 4), 1.0, jnp.float32)  # mean of 4 base samples
    m = jnp.full((2, 2, 4), 3.0, jnp.float32)  # mean of 4 new samples
    out = resolve.accumulate_history(h, m, jnp.int32(4), jnp.int32(4))
    np.testing.assert_allclose(np.asarray(out), 2.0)  # true 8-sample mean
    # base 0 resets to the new batch
    out0 = resolve.accumulate_history(h, m, jnp.int32(0), jnp.int32(4))
    np.testing.assert_allclose(np.asarray(out0), 3.0)
