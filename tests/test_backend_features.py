"""Backend feature parity: dedup, checkpoint/resume, variant registry,
config recovery, ray-stats image, debug variants, watchdogs."""

import copy
import os

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend.params import (
    RenderParams,
)
from realtimepathtracingresearchframework_tpu.backend.renderer import (
    FrameConfig,
    Renderer,
    VARIANT_GBUFFER,
    VARIANT_MEGAKERNEL,
    VARIANT_PT,
    VARIANT_RQ_CLOSEST,
    VARIANT_RT_DEBUG,
)
from realtimepathtracingresearchframework_tpu.models import procedural
from realtimepathtracingresearchframework_tpu.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu.models.scene import Scene


def _cornell():
    return Scene.from_vkr_scene(procedural.cornell_box())


def _small_renderer(scene=None, w=32, h=32):
    r = Renderer()
    r.initialize(w, h)
    r.set_scene(scene or _cornell())
    return r


def _config():
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    return FrameConfig(camera=cam, params=RenderParams(max_path_depth=3))


# ---------------------------------------------------------------------------
# scene dedup / GC
# ---------------------------------------------------------------------------


def test_deduplicate_merges_identical_meshes():
    scene = _cornell()
    # duplicate every mesh + parameterized mesh, instances keep pointing at
    # the originals -> dups are pure garbage to collect
    n_m = len(scene.meshes)
    n_pm = len(scene.parameterized_meshes)
    scene.meshes.extend(copy.deepcopy(scene.meshes))
    from realtimepathtracingresearchframework_tpu.models.scene import (
        ParameterizedMesh,
    )

    dups = [
        ParameterizedMesh(
            mesh_id=pm.mesh_id + n_m,
            material_offset=pm.material_offset,
            per_triangle_materials=pm.per_triangle_materials,
        )
        for pm in scene.parameterized_meshes
    ]
    scene.parameterized_meshes.extend(dups)
    ref = _cornell().flatten_world(frame=0)
    res = scene.deduplicate()
    assert res["meshes_removed"] == n_m
    assert res["pmeshes_removed"] == n_pm
    flat = scene.flatten_world(frame=0)
    np.testing.assert_array_equal(flat.v0, ref.v0)
    np.testing.assert_array_equal(flat.material_id, ref.material_id)


def test_deduplicate_noop_on_clean_scene():
    scene = _cornell()
    res = scene.deduplicate()
    assert res == {"meshes_removed": 0, "pmeshes_removed": 0}


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    cfg = _config()
    r1 = _small_renderer()
    for _ in range(4):
        r1.render(cfg)
    ref = np.asarray(r1.accum)

    r2 = _small_renderer()
    for _ in range(2):
        r2.render(cfg)
    ckpt = os.path.join(tmp_path, "state.npz")
    r2.save_state(ckpt)

    r3 = _small_renderer()
    r3.load_state(ckpt)
    assert r3.frame_id == 2
    for _ in range(2):
        r3.render(cfg)
    np.testing.assert_allclose(np.asarray(r3.accum), ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# variant registry
# ---------------------------------------------------------------------------


def test_variant_registry_and_fallback():
    r = _small_renderer()
    vs = r.variants()
    assert VARIANT_MEGAKERNEL in vs and VARIANT_RT_DEBUG in vs
    assert VARIANT_RQ_CLOSEST in vs
    assert VARIANT_RQ_CLOSEST not in r.supported_variants()
    assert r.set_variant(VARIANT_PT)  # alias of the megakernel
    assert r.active_variant == VARIANT_PT
    assert not r.set_variant("NO_SUCH_VARIANT")
    assert r.active_variant == VARIANT_MEGAKERNEL


@pytest.mark.slow
def test_megakernel_alias_variants_bit_identical():
    cfg = _config()
    r = _small_renderer()
    r.set_variant(VARIANT_MEGAKERNEL)
    r.render(cfg)
    ref = np.asarray(r.framebuffer)
    r2 = _small_renderer()
    r2.set_variant(VARIANT_PT)
    r2.render(cfg)
    np.testing.assert_array_equal(np.asarray(r2.framebuffer), ref)


@pytest.mark.slow
def test_rt_debug_and_gbuffer_variants():
    cfg = _config()
    r = _small_renderer()
    r.set_variant(VARIANT_RT_DEBUG)
    r.render(cfg)
    fb = np.asarray(r.framebuffer)
    assert fb.shape == (32, 32, 4)
    # normals map to [0,1]; nearly all pixels hit (open cornell front lets
    # a few edge rays escape)
    assert (fb[..., 3] == 1.0).mean() > 0.9
    assert fb[..., :3].min() >= 0.0 and fb[..., :3].max() <= 1.0

    r.set_variant(VARIANT_GBUFFER)
    r.render(cfg)
    gb = np.asarray(r.framebuffer)
    assert gb.shape == (32, 32, 4)
    assert gb[..., :3].max() > 0.1  # albedo present


# ---------------------------------------------------------------------------
# config recovery
# ---------------------------------------------------------------------------


def test_configure_for_auto_adjusts_invalid_options():
    r = _small_renderer()
    bad = r.options.replace(rng_variant=99, light_sampling_bucket_count=0)
    ok = r.configure_for(bad)
    assert not ok  # did not apply unmodified
    assert r.options.rng_variant == 3
    assert r.options.light_sampling_bucket_count == 1
    good = r.options.replace(rng_variant=0, light_sampling_bucket_count=16)
    assert r.configure_for(good)


# ---------------------------------------------------------------------------
# ray stats image
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_ray_stats_image():
    r = _small_renderer()
    img = r.render_ray_stats(_config())
    assert img.shape == (32, 32)
    # every pixel traces at least the primary ray; hits add shadow rays
    assert img.min() >= 1
    assert (img >= 2).mean() > 0.9
    assert img.max() <= 2 * 3  # <= closest+shadow per bounce


# ---------------------------------------------------------------------------
# watchdogs
# ---------------------------------------------------------------------------


def test_assert_all_finite():
    from realtimepathtracingresearchframework_tpu.utils.debug import (
        assert_all_finite,
    )

    assert_all_finite({"a": np.ones(4)}, "ok")
    with pytest.raises(Exception):
        assert_all_finite({"a": np.array([1.0, np.nan])}, "bad")


def test_rebuild_watcher(tmp_path):
    from realtimepathtracingresearchframework_tpu.app.relaunch import (
        RebuildWatcher,
    )

    f = tmp_path / "mod.py"
    f.write_text("x = 1\n")
    w = RebuildWatcher([str(f)], min_interval_s=0.0)
    assert not w.changed()
    os.utime(f, (0, 0))
    assert w.changed()


def test_hot_reload_reloads_stale_modules():
    """hot_reload must re-import edited rendering-core modules (the
    reference recompiles stale shader sources on F5 —
    gpu_programs.cpp:180-229), not just clear the jit caches."""
    import sys

    r = Renderer()
    r.hot_reload()  # records baseline source mtimes
    pkg = "realtimepathtracingresearchframework_tpu"
    vec3 = sys.modules[f"{pkg}.ops.vec3"]
    orig_cross = vec3.cross
    vec3.cross = None  # "edit": break a symbol; reload must restore it
    vec3.__hot_mtime__ = 0.0  # pretend the source file is newer
    r.hot_reload()
    vec3_new = sys.modules[f"{pkg}.ops.vec3"]
    assert callable(vec3_new.cross), "module not reloaded"
    assert vec3_new.cross is not orig_cross or vec3_new.cross is not None
    # downstream modules reloaded in cascade and renderer symbols rebound
    import realtimepathtracingresearchframework_tpu.backend.renderer as rmod

    integ = sys.modules[f"{pkg}.ops.integrator"]
    assert rmod.make_pass_fn is integ.make_pass_fn
    # a no-edit call is a no-op reload (mtimes all current)
    integ.__hot_probe__ = True
    r.hot_reload()
    assert getattr(sys.modules[f"{pkg}.ops.integrator"], "__hot_probe__", False)


@pytest.mark.slow
def test_debug_mode_heatmaps():
    """DEBUG_MODE_* heatmap images (render_params.glsl.h:63-70): bounce
    count on an opaque scene, any-hit evaluation counts on an
    alpha-tested scene (zero on opaque — the any-hit shader only runs on
    alpha-testable candidates, any_hit.glsl:43-59)."""
    from realtimepathtracingresearchframework_tpu.backend.params import (
        DEBUG_MODE_ANY_HIT_COUNT_FULL_PATH,
        DEBUG_MODE_ANY_HIT_COUNT_PRIMARY_VISIBILITY,
        DEBUG_MODE_BOUNCE_COUNT,
    )

    r = _small_renderer(w=16, h=16)
    cfg = _config()
    r.configure_for(r.options.replace(debug_mode=DEBUG_MODE_BOUNCE_COUNT))
    img = r.render_debug_image(cfg)
    assert img.shape == (16, 16)
    # most primaries hit (the open cornell front lets edge rays escape)
    assert (img >= 1).mean() > 0.8
    assert img.max() <= cfg.params.max_path_depth

    # opaque scene: any-hit count is identically zero
    r.configure_for(
        r.options.replace(debug_mode=DEBUG_MODE_ANY_HIT_COUNT_FULL_PATH)
    )
    assert r.render_debug_image(cfg).max() == 0

    # alpha-tested scene: nonzero counts; primary-only <= full-path
    from tests.test_alpha_test import _alpha_scene

    r2 = Renderer()
    r2.initialize(16, 16)
    r2.set_scene(_alpha_scene(alpha_checker=True))
    cam = OrientedCamera.look_at([0, 0, 3], [0, 0, -1], fovy=45)
    acfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=2))
    r2.configure_for(
        r2.options.replace(debug_mode=DEBUG_MODE_ANY_HIT_COUNT_FULL_PATH)
    )
    full = r2.render_debug_image(acfg)
    assert full.max() >= 1, "alpha-tested candidates not counted"
    r2.configure_for(
        r2.options.replace(
            debug_mode=DEBUG_MODE_ANY_HIT_COUNT_PRIMARY_VISIBILITY
        )
    )
    prim = r2.render_debug_image(acfg)
    assert prim.max() >= 1
    assert (prim <= full).all()

    r.configure_for(r.options.replace(debug_mode=0))
    with pytest.raises(ValueError):
        r.render_debug_image(cfg)


@pytest.mark.slow
def test_thin_transmission_material_renders():
    """_SHADERMATERIAL_THIN_TRANSMISSION (THIN_TRANSMISSION_HIT,
    vulkan/CMakeLists.txt:38-39): the keyword sets the thin flag, the
    renderer enables the thin BSDF path, and a rough thin pane scatters
    transmitted light differently from the plain transmission path."""
    from realtimepathtracingresearchframework_tpu.models import procedural, vkr
    from realtimepathtracingresearchframework_tpu.models.material import (
        BASE_MATERIAL_THIN,
    )
    from realtimepathtracingresearchframework_tpu.models.scene import Scene

    def pane_scene(name):
        wall = procedural.make_mesh(
            "wall",
            procedural._quad([-4, -4, -1], [4, -4, -1], [4, 4, -1], [-4, 4, -1]),
        )
        pane = procedural.make_mesh(
            "pane",
            procedural._quad([-2, -2, 1], [2, -2, 1], [2, 2, 1], [-2, 2, 1]),
        )
        mats = [
            vkr.VkrMaterial(
                name="wall",
                emitter_base_color=np.array([1.0, 1.0, 1.0], np.float32),
                emission_intensity=5.0,
            ),
            vkr.VkrMaterial(
                name=name,
                base_color=np.array([1.0, 1.0, 1.0], np.float32),
                ior_eta=1.5,
            ),
        ]
        vs = procedural.identity_scene([wall, pane], mats)
        scene = Scene.from_vkr_scene(vs)
        scene.parameterized_meshes[1].material_offset = 1
        # the .vks format carries roughness via textures; set the
        # translated material's constants directly for the test
        scene.materials[1].roughness = 0.7
        scene.materials[1].clearcoat_gloss = 0.0025  # sqrt -> 0.05
        return scene

    thin_scene = pane_scene("glass_SHADERMATERIAL_THIN_TRANSMISSION")
    assert thin_scene.materials[1].flags & BASE_MATERIAL_THIN
    assert thin_scene.materials[1].specular_transmission == 1.0
    plain_scene = pane_scene("glass_SHADERMATERIAL_TRANSMISSION")
    assert not (plain_scene.materials[1].flags & BASE_MATERIAL_THIN)

    cam = OrientedCamera.look_at([0, 0, 3], [0, 0, -1], fovy=45)
    cfg = FrameConfig(camera=cam, params=RenderParams(max_path_depth=3))
    imgs = []
    for sc in (thin_scene, plain_scene):
        r = Renderer()
        r.initialize(16, 16)
        r.set_scene(sc)
        for _ in range(4):
            r.render(cfg)
        img = np.asarray(r.accum)[..., :3]
        assert np.isfinite(img).all()
        assert img.max() > 0.05, "no light transmitted through the pane"
        imgs.append(img)
    assert not np.allclose(imgs[0], imgs[1]), (
        "thin transmission did not change shading"
    )


def test_configure_for_keeps_scene_config():
    """configure_for re-uploads lights/sky with the SceneConfig from
    set_scene (app.cpp:397-432 applies options, not lighting): a default
    SceneConfig() here would silently reset a custom sun/turbidity."""
    from realtimepathtracingresearchframework_tpu.backend.params import (
        SceneConfig,
    )

    r = Renderer()
    r.initialize(8, 8)
    sc = SceneConfig(sun_dir=(0.3, 0.8, 0.5), turbidity=8.0)
    r.set_scene(_cornell(), scene_config=sc)
    key_before = r._sky_cache_key
    assert r.configure_for(r.options.replace(light_sampling_bucket_count=8))
    assert r._sky_cache_key == key_before  # custom sun survived

    # set_animation_frame without an explicit config keeps it too
    r.set_animation_frame(0)
    assert r._sky_cache_key == key_before


def test_configure_for_rebuilds_for_cpu_stage_options():
    """CPU-stage scene options (use_tlas) change what
    _rebuild_scene builds; configure_for must rebuild, not just
    re-upload (RBO_STAGES_CPU_ONLY, render_params.glsl.h:107-114)."""
    r = _small_renderer(w=8, h=8)
    assert not r._use_two_level
    assert r.configure_for(r.options.replace(use_tlas=True))
    assert r._use_two_level
    assert r._tlas_buffers is not None
    # closest-hit queries traverse the TLAS path end-to-end
    t, tri, _, _ = r.render_ray_queries(
        np.array([[0.0, 1.0, 3.2]], np.float32),
        np.array([[0.0, 0.0, -1.0]], np.float32),
    )
    assert tri[0] >= 0
    assert r.configure_for(r.options.replace(use_tlas=False))
    assert not r._use_two_level


def test_render_accepts_none_scene_config():
    """FrameConfig(scene_config=None) is legal everywhere in render()."""
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    cfg = FrameConfig(
        camera=cam, params=RenderParams(max_path_depth=2),
        scene_config=None,
    )
    r = _small_renderer(w=8, h=8)
    stats = r.render(cfg)
    assert stats is not None


def test_deduplicate_keeps_lod_variant_meshes():
    """LoD variant meshes are referenced only through lod_groups (the
    base level alone is instanced, append_vkr_scene); dedup GC must not
    collect them — that would silently disable LoD selection."""
    from realtimepathtracingresearchframework_tpu.models import vkr

    vs = procedural.single_triangle()
    coarse = procedural.make_mesh(
        "tri_lod1",
        np.array([[[-2, -2, 0], [2, -2, 0], [0, 2, 0]]], np.float32),
    )
    coarse.lod_group = 1
    vs.meshes[0].lod_group = 1
    vs.meshes.append(coarse)
    vs.lod_groups.append(
        vkr.VkrLodGroup(mesh_ids=[0, 1], detail_reduction=[0.0, 0.5])
    )
    scene = Scene.from_vkr_scene(vs)
    assert scene.has_lod_groups()
    n_meshes = len(scene.meshes)

    scene.deduplicate()
    assert len(scene.meshes) == n_meshes  # coarse level survives GC
    groups = [g for g in scene.lod_groups if len(g.mesh_ids) >= 2]
    assert groups, "LoD group lost its variant list"
    xform = np.zeros((3, 4), np.float32)
    xform[:, :3] = np.eye(3)
    far = scene.select_lod(0, xform, camera_pos=[0, 0, 1e5],
                           lod_threshold=0.02)
    assert far != 0  # coarse level still selectable
