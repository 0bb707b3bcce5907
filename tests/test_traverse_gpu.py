"""GPU traversal kernel (ops/traverse_gpu.py) against the plain XLA walk
(ops/traverse.py), and the renderer's choice of traversal.

On the CPU the kernel runs in Pallas interpret mode, and its lowering for
the card is checked through ``jax.export`` for CUDA at the real pass width.
The kernel and the reference compute the same float32 arithmetic in a
different order (FMA contraction), so t/u/v agree to a few ulps; hits and
triangle ids agree exactly on these scenes.
"""

import os
import shutil
import subprocess
import sys
import types

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
from realtimepathtracingresearchframework_tpu.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu.ops import traverse
from realtimepathtracingresearchframework_tpu.ops import traverse_gpu
from realtimepathtracingresearchframework_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_TOL = 1e-4  # |dt| <= T_TOL * max(1, t), as chip_smoke.py states


def _flat(vkr_scene):
    flat = Scene.from_vkr_scene(vkr_scene).flatten_world()
    return flat.v0, flat.e1, flat.e2


def _soup(n=400, seed=3):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    return v0, e1, e2


def _axis_parallel():
    """Axis-aligned quads (zero-thickness boxes) plus degenerate
    (zero-area) triangles: slab tests see flat boxes, MT sees det == 0."""
    tris = []
    for k in range(6):
        z = float(k) - 2.5
        tris.append(([-1, -1, z], [2, 0, 0], [0, 2, 0]))
        tris.append(([1, 1, z], [-2, 0, 0], [0, -2, 0]))
        tris.append(([0, 0, z], [1, 1, 0], [2, 2, 0]))  # degenerate
    tris.append(([0, -1, -1], [0, 2, 0], [0, 0, 2]))  # x = 0 plane
    a = np.asarray(tris, np.float32)
    return a[:, 0], a[:, 1], a[:, 2]


SCENES = {
    "cornell": lambda: _flat(procedural.cornell_box()),
    "soup": _soup,
    "village": lambda: _flat(procedural.village(grid=24)),
    "terrain": lambda: _flat(procedural.terrain(grid=24)),
    "axis_parallel": _axis_parallel,
}
_BUILT = {}


def _scene(name):
    if name not in _BUILT:
        v0, e1, e2 = SCENES[name]()
        tb = bvh_mod.thread_bvh(bvh_mod.build_bvh_sah(v0, e1, e2), v0, e1, e2)
        _BUILT[name] = (tb, traverse.threaded_to_device(tb))
    return _BUILT[name]


def _rays(tb, kind, n=384, seed=0):
    """Coherent: a pinhole fan at the scene from outside its box.
    Incoherent: random origins inside the box, random directions, and
    random segment lengths (so t_max bounds some hits)."""
    rng = np.random.default_rng(seed)
    lo, hi = tb.world_min, tb.world_max
    c, ext = (lo + hi) / 2, float(np.linalg.norm(hi - lo)) + 1e-3
    if kind == "coherent":
        eye = c + np.array([0.13, 0.21, 1.0], np.float32) * ext
        g = (np.arange(n) + 0.5) / n
        tgt = c + (np.stack([np.sin(37 * g), np.cos(53 * g), 0 * g], 1)
                   * 0.5 * (hi - lo))
        o = np.broadcast_to(eye, (n, 3)).astype(np.float32)
        d = tgt - eye
        t_max = np.full(n, 2e32, np.float32)
    else:
        o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3))
        d[::7, 1:] = 0.0  # axis-parallel directions (zero components)
        t_max = rng.uniform(0, ext, n).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.zeros(n, np.float32), t_max


def _run(dev, o, d, t_min, t_max, any_hit):
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
            jnp.asarray(t_max))
    if any_hit:
        ref = traverse.occluded_threaded(dev, *args)
        got = traverse_gpu.occluded_gpu(dev, *args, interpret=True)
    else:
        ref = traverse.closest_hit_threaded(dev, *args)
        got = traverse_gpu.closest_hit_gpu(dev, *args, interpret=True)
    return ref, got


def _assert_closest_close(ref, got):
    rtri, gtri = np.asarray(ref.tri), np.asarray(got.tri)
    np.testing.assert_array_equal(gtri, rtri)
    hit = rtri >= 0
    rt, gt = np.asarray(ref.t), np.asarray(got.t)
    assert np.all(gt[~hit] == np.float32(2e32))
    assert np.all(np.abs(gt - rt)[hit] <= T_TOL * np.maximum(1, rt[hit]))
    for f in ("u", "v"):
        np.testing.assert_allclose(np.asarray(getattr(got, f))[hit],
                                   np.asarray(getattr(ref, f))[hit],
                                   atol=1e-4)


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernel_matches_xla_walk(scene, any_hit, kind):
    tb, dev = _scene(scene)
    o, d, t_min, t_max = _rays(tb, kind)
    ref, got = _run(dev, o, d, t_min, t_max, any_hit)
    if any_hit:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert got.dtype == jnp.bool_
    else:
        _assert_closest_close(ref, got)
        assert np.asarray(ref.tri).max() >= 0  # the rays do hit something


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_dead_lanes_report_miss(any_hit):
    """t_max <= t_min lanes (the integrator's inactive lanes) walk
    nothing: miss / not blocked, exactly like the reference."""
    tb, dev = _scene("cornell")
    o, d, _, _ = _rays(tb, "coherent", n=64)
    t_min = np.full(64, 0.5, np.float32)
    t_max = np.where(np.arange(64) % 2 == 0, 0.0, 0.5).astype(np.float32)
    ref, got = _run(dev, o, d, t_min, t_max, any_hit)
    if any_hit:
        assert not np.asarray(got).any()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    else:
        assert np.all(np.asarray(got.tri) == -1)
        _assert_closest_close(ref, got)


def test_bounded_t_max_cuts_hits():
    """A segment that ends before the closest hit misses; one that ends
    just past it finds the same triangle."""
    tb, dev = _scene("village")
    o, d, t_min, t_max = _rays(tb, "coherent", n=128)
    full, _ = _run(dev, o, d, t_min, t_max, False)
    t_hit = np.asarray(full.t)
    hit = np.asarray(full.tri) >= 0
    assert hit.any()
    short = np.where(hit, t_hit * 0.5, 1e-3).astype(np.float32)
    ref, got = _run(dev, o, d, t_min, short, False)
    assert np.all(np.asarray(got.tri) == -1)
    _assert_closest_close(ref, got)
    longer = np.where(hit, t_hit * 1.001, 2e32).astype(np.float32)
    ref, got = _run(dev, o, d, t_min, longer, False)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(full.tri))
    blocked = traverse_gpu.occluded_gpu(dev, o, d, t_min, longer,
                                        interpret=True)
    np.testing.assert_array_equal(np.asarray(blocked), hit)


@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_ray_count_not_a_block_multiple(n):
    assert n % traverse_gpu.BLOCK != 0
    tb, dev = _scene("soup")
    o, d, t_min, t_max = _rays(tb, "incoherent", n=n, seed=n)
    ref, got = _run(dev, o, d, t_min, t_max, False)
    assert np.asarray(got.t).shape == (n,)
    _assert_closest_close(ref, got)


def test_soa_components_match_array_rays():
    """The integrator passes rays as comps=(ox, oy, oz, dx, dy, dz) with
    scalar t bounds; that form gives the same result as (N,3) arrays."""
    tb, dev = _scene("terrain")
    o, d, _, _ = _rays(tb, "incoherent", n=96)
    a = traverse_gpu.closest_hit_gpu(dev, jnp.asarray(o), jnp.asarray(d),
                                     0.0, 1e30, interpret=True)
    comps = tuple(jnp.asarray(x) for x in (*o.T, *d.T))
    b = traverse_gpu.closest_hit_gpu(dev, t_min=0.0, t_max=1e30, comps=comps,
                                     interpret=True)
    for f in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_cuda_lowering_at_pass_width(any_hit):
    """The whole Pallas -> Triton lowering for the card, at 524,288 rays
    over a village-sized BVH, runs here through jax.export."""
    from jax import export

    from realtimepathtracingresearchframework_tpu.ops.integrator import (
        RAYS_PER_PASS,
    )

    n, m, r = RAYS_PER_PASS, 48_379, 80_496
    tb = traverse.ThreadedBuffers(
        nodes=jax.ShapeDtypeStruct((m, 8), jnp.float32),
        tri_rows=jax.ShapeDtypeStruct((r, 12), jnp.float32),
        row_tri=jax.ShapeDtypeStruct((r,), jnp.int32),
    )
    lane = jax.ShapeDtypeStruct((n,), jnp.float32)
    walk = traverse_gpu.occluded_gpu if any_hit else traverse_gpu.closest_hit_gpu

    def f(tb, comps, t_min, t_max):
        return walk(tb, t_min=t_min, t_max=t_max, comps=comps)

    exp = export.export(
        jax.jit(f), platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(tb, (lane,) * 6, lane, lane)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert ("bvh_walk_anyhit" if any_hit else "bvh_walk_closest") in text
    out = exp.out_avals
    assert out[0].shape == (n,)


def test_kernel_fails_loudly_without_a_gpu():
    """No hidden fallback: outside interpret mode the kernel needs the
    card, and on the CPU the call raises instead of running elsewhere."""
    tb, dev = _scene("soup")
    o, d, t_min, t_max = _rays(tb, "incoherent", n=32)
    with pytest.raises(Exception, match="(?i)triton|gpu|cuda|interpret"):
        traverse_gpu.closest_hit_gpu(dev, jnp.asarray(o), jnp.asarray(d),
                                     t_min, t_max)


def test_gpu_kernel_on_the_card(gpu_device):
    """Compiled kernel against the XLA walk on a real GPU."""
    tb, _ = _scene("village")
    dev = jax.device_put(traverse.threaded_to_device(tb), gpu_device)
    o, d, t_min, t_max = _rays(tb, "incoherent", n=4096)
    args = [jax.device_put(jnp.asarray(x), gpu_device)
            for x in (o, d, t_min, t_max)]
    ref = traverse.closest_hit_threaded(dev, *args)
    got = traverse_gpu.closest_hit_gpu(dev, *args)
    _assert_closest_close(ref, got)


# ---------------------------------------------------------------------------
# Traversal selection and frame policies (backend/renderer.py)
# ---------------------------------------------------------------------------


def _renderer_on(platform, vkr_scene, use_tlas=False):
    """A renderer whose render device reports ``platform``; scene build
    and config selection run on the host, nothing is dispatched."""
    fake = types.SimpleNamespace(platform=platform, memory_stats=lambda: {})
    r = Renderer(device=fake)
    r.options = r.options.replace(use_tlas=use_tlas)
    r.initialize(16, 16)
    r.set_scene(Scene.from_vkr_scene(vkr_scene))
    return r


def test_selection_gpu_platform_uses_kernel():
    r = _renderer_on("gpu", procedural.cornell_box())
    cfg = r._integrator_config(RenderParams())
    assert cfg.traversal == "gpu" and not cfg.two_level


def test_selection_cpu_platform_uses_xla_walk():
    r = _renderer_on("cpu", procedural.cornell_box())
    cfg = r._integrator_config(RenderParams())
    assert cfg.traversal == "xla"
    assert not (cfg.compact_lanes or cfg.sort_shadows or cfg.compact)


def test_selection_two_level_uses_xla_nested_walk():
    r = _renderer_on("gpu", procedural.cornell_box(), use_tlas=True)
    cfg = r._integrator_config(RenderParams())
    assert cfg.two_level and cfg.traversal == "xla"
    assert not cfg.compact_lanes
    assert r._tlas_dyn_kwargs(cfg)  # TLAS side rides as call operands


def test_selection_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="no traversal for platform"):
        _renderer_on("metal", procedural.cornell_box())


def test_large_scene_keeps_compaction_and_host_wavefront():
    """Village-size scenes (>= 16,384 triangles) on the GPU traversal keep
    carry compaction, the shadow-queue sort and the host-wavefront
    executor; cornell keeps all three off."""
    big = _renderer_on("gpu", procedural.village(grid=100))
    assert big._flat.num_tris >= 16_384
    cfg = big._integrator_config(RenderParams(max_path_depth=9))
    assert cfg.compact_lanes and cfg.sort_shadows and not cfg.compact
    assert big._use_wavefront_host(cfg)

    small = _renderer_on("gpu", procedural.cornell_box())
    cfg = small._integrator_config(RenderParams(max_path_depth=9))
    assert not (cfg.compact_lanes or cfg.sort_shadows or cfg.compact)
    assert not small._use_wavefront_host(cfg)


def test_kernel_error_propagates_through_render(monkeypatch):
    """A kernel that cannot run raises out of Renderer.render; nothing on
    the render path swallows it or renders with another traversal. (The
    GPU traversal is forced onto the CPU, where the compiled kernel
    cannot lower.)"""
    monkeypatch.setattr(Renderer, "_select_traversal", lambda self: "gpu")
    r = Renderer()
    r.initialize(16, 16)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    with pytest.raises(Exception, match="(?i)triton|gpu|cuda|interpret"):
        r.render(FrameConfig(camera=cam,
                             params=RenderParams(max_path_depth=1)))


# ---------------------------------------------------------------------------
# Compile cache placement and chip_smoke.py on a machine without a GPU
# ---------------------------------------------------------------------------


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    p = _smoke(REPO)
    assert p.returncode != 0
    assert "no GPU found" in p.stderr
    assert '"ok"' not in p.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _smoke(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
