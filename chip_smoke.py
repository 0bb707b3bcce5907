"""GPU smoke test: the renderer's main path on one card, end to end.

    python chip_smoke.py            # every phase, one GPU
    python chip_smoke.py --four     # only the four-card phase

Phases (each one fails the run on failure):

1. device      the first JAX device must be a GPU; prints the card's
               ``nvidia-smi`` name and power limit.
2. kernels     the GPU traversal kernel (ops/traverse_gpu.py) against the
               plain XLA walk (ops/traverse.py) at 524,288 rays on village
               and terrain: coherent and incoherent rays, closest and
               any-hit, with both times.
3. goldens     every stored CPU golden (tests/goldens/*.pfm) rendered on
               the card and compared with utils/compare.py; a one-pixel
               camera shift must fail the same tolerance.
4. frames      the main path at full width: cli.main validation mode on
               cornell 1080p, then Renderer frames of village 1080p,
               terrain and animated instanced, with p50 frame time, Mray/s
               and the compilations inside the timed frames.

``--four`` renders village 1080p through ``Renderer(devices=4 cards)``
against the one-card image, and runs ``build_sharded_render`` over a
4-device mesh against the one-device ``render_tile``.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
it is printed only when every phase passed. Exits non-zero (and prints no
result) when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RAYS = 524_288  # ops/integrator.py RAYS_PER_PASS: one traversal dispatch
SEED = 20261016

# Kernel parity tolerance (phase 2). The kernel and the XLA walk run the
# same float32 Moller-Trumbore and slab tests; they differ only in FMA
# contraction and evaluation order, i.e. in the last bits of t/u/v. A
# last-bit change flips hit/miss only for rays that graze an edge or a
# box face, so hit/miss may disagree on at most 1e-4 of the lanes.
HIT_AGREE_MIN = 0.9999
T_REL_TOL = 1e-4  # |dt| <= T_REL_TOL * max(1, t) where both hit


def _log(msg: str) -> None:
    print(msg, flush=True)


def _gpu_line() -> str:
    """``nvidia-smi``'s name and power limit of every card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.replace("\n", " | ")


def _median_ms(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Phase 2: kernel parity at a real width
# ---------------------------------------------------------------------------


def _scene_bvh(name: str):
    """(threaded BVH, flat scene, camera eye, camera target) of a bench
    scene, built the way the renderer builds a static scene."""
    from realtimepathtracingresearchframework_tpu.models import procedural
    from realtimepathtracingresearchframework_tpu.models.scene import Scene
    from realtimepathtracingresearchframework_tpu.ops import bvh as bvh_mod

    if name == "village":
        vkr, eye, at = procedural.village(), (0, 4.0, 13.0), (0, 0.5, 0)
    else:
        vkr, eye, at = procedural.terrain(grid=500), (0, 5.0, 12.0), (0, 0, 0)
    flat = Scene.from_vkr_scene(vkr).flatten_world()
    topo = bvh_mod.build_bvh_sah(flat.v0, flat.e1, flat.e2)
    return bvh_mod.thread_bvh(topo, flat.v0, flat.e1, flat.e2), flat, eye, at


def _ray_sets(tb, flat, eye, at, closest_xla):
    """Four query sets of RAYS rays: (label, any_hit, comps, t_min, t_max).

    coherent closest: camera rays of a 1024x512 view;
    coherent any-hit: sun shadow rays from those rays' hit points;
    incoherent closest/any-hit: random directions from the hit points
    (random points of the scene box where the camera ray missed), the
    any-hit ones with a random segment length."""
    import numpy as np

    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera,
    )

    w, h = 1024, RAYS // 1024
    pos, du, dv, tl = OrientedCamera.look_at(list(eye), list(at), fovy=55) \
        .view_basis(w, h)
    px, py = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)
    d = (tl[None] + px.reshape(-1, 1) * du[None] + py.reshape(-1, 1) * dv[None])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(np.asarray(pos, np.float32), d.shape).copy()
    ref = closest_xla(o, d, np.zeros(RAYS, np.float32),
                      np.full(RAYS, 2e32, np.float32))
    t = np.asarray(ref.t)
    hit = np.asarray(ref.tri) >= 0

    rng = np.random.default_rng(SEED)
    lo, hi = flat.v0.min(0), flat.v0.max(0)
    p = np.where(hit[:, None], o + d * np.where(hit, t, 0)[:, None],
                 rng.uniform(lo, hi, (RAYS, 3))).astype(np.float32)
    eps = (np.linalg.norm(p, axis=1) * 5e-6 + 1e-6).astype(np.float32)
    sun = np.array([0.4, 0.7, 0.2], np.float32)
    sun = np.broadcast_to(sun / np.linalg.norm(sun), d.shape).astype(np.float32)
    r = rng.normal(size=(RAYS, 3))
    r = (r / np.linalg.norm(r, axis=1, keepdims=True)).astype(np.float32)
    diag = float(np.linalg.norm(hi - lo))
    seg = rng.uniform(0.0, diag, RAYS).astype(np.float32)
    inf = np.full(RAYS, 2e32, np.float32)
    zero = np.zeros(RAYS, np.float32)
    return [
        ("coherent", False, o, d, zero, inf),
        ("coherent", True, p, sun, eps, inf),
        ("incoherent", False, p, r, eps, inf),
        ("incoherent", True, p, r, eps, seg),
    ]


def _tri_t(flat, tri, o, d):
    """Float64 ray parameter of triangle ``tri`` along each ray (host)."""
    import numpy as np

    v0 = flat.v0[tri].astype(np.float64)
    e1 = flat.e1[tri].astype(np.float64)
    e2 = flat.e2[tri].astype(np.float64)
    o, d = o.astype(np.float64), d.astype(np.float64)
    pv = np.cross(d, e2)
    det = np.sum(e1 * pv, axis=1)
    q = np.cross(o - v0, e1)
    return np.sum(e2 * q, axis=1) / np.where(det == 0, 1e-300, det)


def _compare_closest(flat, o, d, ref, got) -> dict:
    import numpy as np

    rt, gt = np.asarray(ref.t), np.asarray(got.t)
    rtri, gtri = np.asarray(ref.tri), np.asarray(got.tri)
    rhit, ghit = rtri >= 0, gtri >= 0
    agree = float(np.mean(rhit == ghit))
    both = rhit & ghit
    tol = T_REL_TOL * np.maximum(1.0, np.abs(rt))
    t_bad = int(np.sum(both & (np.abs(rt - gt) > tol)))
    diff = np.nonzero(both & (rtri != gtri))[0]
    tri_bad = 0
    if len(diff):
        # a different triangle is fine only if both candidates lie at the
        # same distance within the tolerance (shared edges, coplanar)
        ta = _tri_t(flat, rtri[diff], o[diff], d[diff])
        tb_ = _tri_t(flat, gtri[diff], o[diff], d[diff])
        tri_bad = int(np.sum(np.abs(ta - tb_) > tol[diff]))
    ok = agree >= HIT_AGREE_MIN and t_bad == 0 and tri_bad == 0
    return dict(ok=ok, hit_agree=agree, hit_frac=float(rhit.mean()),
                t_bad=t_bad, tri_diff=len(diff), tri_bad=tri_bad)


def phase_kernels(scenes=("village", "terrain")) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from realtimepathtracingresearchframework_tpu.ops import traverse
    from realtimepathtracingresearchframework_tpu.ops import traverse_gpu

    ok_all = True
    for name in scenes:
        tb_host, flat, eye, at = _scene_bvh(name)
        tb = traverse.threaded_to_device(tb_host)
        fns = {
            (False, "xla"): jax.jit(traverse.closest_hit_threaded),
            (True, "xla"): jax.jit(traverse.occluded_threaded),
            (False, "gpu"): jax.jit(
                lambda tb, o, d, a, b: traverse_gpu.closest_hit_gpu(
                    tb, t_min=a, t_max=b,
                    comps=(o[:, 0], o[:, 1], o[:, 2],
                           d[:, 0], d[:, 1], d[:, 2]))),
            (True, "gpu"): jax.jit(
                lambda tb, o, d, a, b: traverse_gpu.occluded_gpu(
                    tb, t_min=a, t_max=b,
                    comps=(o[:, 0], o[:, 1], o[:, 2],
                           d[:, 0], d[:, 1], d[:, 2]))),
        }

        def closest_xla(o, d, a, b):
            return fns[(False, "xla")](tb, *map(jnp.asarray, (o, d, a, b)))

        for kind, any_hit, o, d, a, b in _ray_sets(tb_host, flat, eye, at,
                                                   closest_xla):
            args = (tb,) + tuple(jnp.asarray(x) for x in (o, d, a, b))
            ref = fns[(any_hit, "xla")](*args)
            got = fns[(any_hit, "gpu")](*args)
            if any_hit:
                r, g = np.asarray(ref), np.asarray(got)
                agree = float(np.mean(r == g))
                res = dict(ok=agree >= HIT_AGREE_MIN, agree=agree,
                           blocked_frac=float(r.mean()))
            else:
                res = _compare_closest(flat, o, d, ref, got)
            ms_x = _median_ms(fns[(any_hit, "xla")], *args)
            ms_g = _median_ms(fns[(any_hit, "gpu")], *args)
            mode = "any-hit" if any_hit else "closest"
            _log(f"[kernels] {name} ({flat.num_tris} tris) {kind} {mode} "
                 f"{RAYS} rays: kernel {ms_g:.3f} ms, xla walk {ms_x:.3f} ms "
                 f"-> {json.dumps(res)}")
            ok_all &= res["ok"]
    return ok_all


# ---------------------------------------------------------------------------
# Phase 3: the stored CPU goldens, rendered on the card
# ---------------------------------------------------------------------------

# Golden tolerance (phase 3). The goldens are 48x48, 4 spp CPU renders.
# The card runs the same float32 path math, but XLA fuses and contracts
# it differently, so values differ in the last bits. Where such a bit
# flips a discrete choice (Russian roulette, BSDF lobe, a grazing hit)
# the whole path changes and, at 4 spp, so does its pixel; elsewhere
# (texture filtering, mip selection) a last-bit change moves a pixel by
# up to a few percent. So the check is per image: at most GOLDEN_MAX_BAD
# of the pixels may have a relative error (utils/compare.py) above
# GOLDEN_PX_TOL. On an H100 the cases reach 0 to 2.7% such pixels; a
# one-pixel camera shift moves every edge and every pixel's sample, and
# reaches over 90%, so it must fail.
GOLDEN_PX_TOL = 1e-3
GOLDEN_MAX_BAD = 0.05


def _golden_cases():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import test_goldens

    return test_goldens


def _golden_check(img, ref) -> dict:
    from realtimepathtracingresearchframework_tpu.utils.compare import (
        compare_images,
    )

    res = compare_images(img, ref, threshold=GOLDEN_PX_TOL,
                         write_error_image=False)
    bad = res.num_failed / (ref.shape[0] * ref.shape[1])
    return dict(ok=bool(bad <= GOLDEN_MAX_BAD), bad_px_frac=round(bad, 6),
                max_rel=res.max_rel_error, mean_rel=res.mean_rel_error)


def phase_goldens() -> bool:
    import numpy as np

    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera,
    )
    from realtimepathtracingresearchframework_tpu.utils import image_io

    tg = _golden_cases()
    ok_all = True
    for name in sorted(tg._CASES):
        img = np.asarray(tg._CASES[name]())[..., :3].astype(np.float32)
        ref = image_io.read_pfm(os.path.join(tg.GOLDEN_DIR, f"{name}.pfm"))
        res = _golden_check(img, ref)
        res["finite"] = bool(np.isfinite(img).all())
        res["ok"] &= res["finite"]
        _log(f"[goldens] {name}: {json.dumps(res)}")
        ok_all &= res["ok"]

    # negative control: cornell_diffuse with the view moved by one pixel
    class Shifted(OrientedCamera):
        def view_basis(self, width, height):
            pos, du, dv, tl = super().view_basis(width, height)
            return pos, du, dv, tl + du / width

    base = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    shifted = Shifted(**{f: getattr(base, f)
                         for f in base.__dataclass_fields__})
    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderParams,
    )
    from realtimepathtracingresearchframework_tpu.models import procedural
    from realtimepathtracingresearchframework_tpu.models.scene import Scene

    img = tg._render(Scene.from_vkr_scene(procedural.cornell_box()), shifted,
                     RenderParams(max_path_depth=3))[..., :3]
    ref = image_io.read_pfm(os.path.join(tg.GOLDEN_DIR, "cornell_diffuse.pfm"))
    res = _golden_check(np.asarray(img, np.float32), ref)
    _log(f"[goldens] cornell_diffuse shifted one pixel (must fail): "
         f"{json.dumps(res)}")
    return ok_all and not res["ok"]


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------


class _CompileCounter:
    """Counts programs lowered for compilation (cache hits included)."""

    EVENT = "/jax/core/compile/jaxpr_to_mlir_module_duration"

    def __init__(self):
        import jax

        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if event == self.EVENT:
            self.n += 1


def _image_ok(img) -> dict:
    import numpy as np

    rgb = np.asarray(img)[..., :3]
    return dict(finite=bool(np.isfinite(rgb).all()),
                mean=float(rgb.mean()), nonblack=bool(rgb.max() > 0))


def _time_frames(r, cfg, frames: int, counter, animate=None) -> dict:
    """Warm one frame, then time ``frames`` frames one by one (each
    ends in block_until_ready). ``animate(i)`` runs before frame i."""
    import jax
    import numpy as np

    def one(i):
        if animate is not None:
            animate(i)
        r.render(cfg)
        jax.block_until_ready(r._acc_chunks if r._planar else r.framebuffer)

    t0 = time.perf_counter()
    one(0)
    setup_s = time.perf_counter() - t0
    rays0 = r.last_frame_rays()
    n0 = counter.n
    ms, rays = [], []
    for i in range(1, frames + 1):
        t0 = time.perf_counter()
        one(i)
        ms.append((time.perf_counter() - t0) * 1e3)
        rays.append(r.last_frame_rays())
    compiles = counter.n - n0
    p50 = float(np.median(ms))
    img = r.readback_accumulation()
    res = dict(first_frame_s=round(setup_s, 3), p50_ms=round(p50, 3),
               frames_ms=[round(x, 3) for x in ms],
               mray_s=round(float(np.median(rays)) / p50 / 1e3, 3),
               rays_per_frame=int(np.median(rays)), compiles_in_window=compiles,
               **_image_ok(img))
    res["ok"] = (res["finite"] and res["nonblack"] and rays0 > 0
                 and min(rays) > 0 and compiles == 0)
    return res


def _scene_renderer(name, width, height, depth, use_tlas=False, devices=None):
    """(Renderer, FrameConfig) of a bench scene at a size."""
    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderParams,
        SceneConfig,
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

    vkr, eye, at, sun = {
        "village": (procedural.village, (0, 4.0, 13.0), (0, 0.5, 0),
                    (0.35, 0.8, 0.3)),
        "terrain": (lambda: procedural.terrain(grid=500), (0, 5.0, 12.0),
                    (0, 0, 0), (0.4, 0.7, 0.2)),
        "instanced": (lambda: procedural.instanced_field(num_inst=600),
                      (0, 14.0, 30.0), (0, 0, 0), (0.4, 0.8, 0.25)),
    }[name]
    sc = SceneConfig(sun_dir=sun, turbidity=3.0)
    r = Renderer(devices=devices)
    r.options = r.options.replace(use_tlas=use_tlas)
    r.initialize(width, height)
    r.set_scene(Scene.from_vkr_scene(vkr()), scene_config=sc)
    cfg = FrameConfig(
        camera=OrientedCamera.look_at(list(eye), list(at), fovy=55),
        params=RenderParams(batch_spp=1, max_path_depth=depth),
        scene_config=sc,
    )
    return r, cfg


def _memory_analysis(r, cfg) -> str:
    """memory_analysis() of the frame's biggest program: the bounce-0
    wavefront program, else the pass program."""
    import jax.numpy as jnp

    from realtimepathtracingresearchframework_tpu.ops.integrator import (
        _swizzle_tables,
    )

    fp = r._fp_cache[1]._replace(sample_offset=jnp.uint32(0))
    view = r._view_cache[1]
    if r._wf_progs:
        progs = next(iter(r._wf_progs.values()))
        lowered = progs.bounce0_fn.lower(fp, view, jnp.uint32(0))
        what = "wavefront bounce0"
    else:
        icfg = r._integrator_config(cfg.params)
        px, py, valid, _, _, _ = _swizzle_tables(r.fb_width, r.fb_height)
        fn = next(iter(r._pass_fns.values()))
        lowered = fn.lower(fp, view, r._acc_chunks[0], px[0], py[0], valid[0],
                           jnp.uint32(0), jnp.uint32(0),
                           **r._tlas_dyn_kwargs(icfg))
        what = "pass program"
    m = lowered.compile().memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return what + " " + json.dumps(
        {k: getattr(m, k, None) for k in keys})


def phase_frames() -> bool:
    import tempfile

    import numpy as np

    from realtimepathtracingresearchframework_tpu.app import cli
    from realtimepathtracingresearchframework_tpu.utils import image_io

    card = _gpu_line()
    counter = _CompileCounter()
    ok_all = True

    # cornell through the CLI, validation mode (writes <prefix>_0001.pfm)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "cornell")
        t0 = time.perf_counter()
        rc = cli.main(["cornell", "--img", "1920", "1080", "--max-depth", "9",
                       "--spp", "1", "--validation", prefix,
                       "--validation-spp", "1", "--pfm", "--disable-ui"])
        wall = time.perf_counter() - t0
        path = prefix + "_0001.pfm"
        res = dict(rc=rc, wall_s=round(wall, 3))
        if rc == 0 and os.path.exists(path):
            img = image_io.read_pfm(path)
            res.update(_image_ok(img), shape=list(img.shape))
        res["ok"] = (rc == 0 and res.get("finite", False)
                     and res.get("nonblack", False)
                     and res.get("shape") == [1080, 1920, 3])
        _log(f"[frames] cornell 1920x1080 d9 1spp via cli.main validation: "
             f"{json.dumps(res)}")
        ok_all &= res["ok"]

    # instanced runs the XLA two-level walk (tens of seconds per frame on
    # an H100), so it times fewer frames
    for name, w, h, depth, frames, tlas in (
        ("village", 1920, 1080, 9, 8, False),
        ("terrain", 512, 384, 3, 8, False),
        ("instanced", 512, 384, 3, 2, True),
    ):
        t0 = time.perf_counter()
        r, cfg = _scene_renderer(name, w, h, depth, use_tlas=tlas)
        build_s = time.perf_counter() - t0
        animate = None
        if tlas:
            def animate(i, r=r):
                r.set_animation_frame(i % 16)
        res = _time_frames(r, cfg, frames, counter, animate=animate)
        res["scene_build_s"] = round(build_s, 3)
        res["tris"] = int(r.scene.total_tris)
        res["executor"] = ("host-wavefront" if r._wf_progs else "pass")
        _log(f"[frames] {name} {w}x{h} d{depth} ({card}): {json.dumps(res)}")
        _log(f"[frames] {name} memory_analysis: {_memory_analysis(r, cfg)}")
        ok_all &= res["ok"]
        del r
    return ok_all


def phase_ab() -> bool:
    """Whole frames with the kernel against the same frames with the XLA
    walk in its place (same executor and policies): village and terrain.
    Not in the default run; a measurement for the kernel's keep-or-drop
    decision."""
    import jax.numpy as jnp

    from realtimepathtracingresearchframework_tpu.ops import traverse
    from realtimepathtracingresearchframework_tpu.ops import traverse_gpu

    def xla_walk(walk):
        def f(tb, ro=None, rd=None, t_min=0.0, t_max=2e32, *, comps=None,
              **kw):
            if comps is not None:
                ro, rd = jnp.stack(comps[:3], 1), jnp.stack(comps[3:], 1)
            return walk(tb, ro, rd, t_min, t_max)
        return f

    counter = _CompileCounter()
    kernel = (traverse_gpu.closest_hit_gpu, traverse_gpu.occluded_gpu)
    xla = (xla_walk(traverse.closest_hit_threaded),
           xla_walk(traverse.occluded_threaded))
    ok = True
    for name, w, h, depth in (("village", 1920, 1080, 9),
                              ("terrain", 512, 384, 3)):
        for label, fns in (("kernel", kernel), ("xla", xla), ("kernel", kernel)):
            traverse_gpu.closest_hit_gpu, traverse_gpu.occluded_gpu = fns
            try:
                r, cfg = _scene_renderer(name, w, h, depth)
                res = _time_frames(r, cfg, 3, counter)
            finally:
                traverse_gpu.closest_hit_gpu, traverse_gpu.occluded_gpu = kernel
            _log(f"[ab] {name} {w}x{h} d{depth} traversal={label}: "
                 f"p50 {res['p50_ms']} ms, {res['mray_s']} Mray/s, "
                 f"first frame {res['first_frame_s']} s, "
                 f"mean {res['mean']:.6f}")
            ok &= res["ok"]
            del r
    return ok


# ---------------------------------------------------------------------------
# Phase 5 (--four): four cards
# ---------------------------------------------------------------------------


def _renderer_frame(devs, width, height):
    """One village frame (depth 9, 1 spp) through ``Renderer(devices=devs)``
    after a warm-up frame: (image, frame ms). The host-wavefront executor
    is single-device only, so the pass-program executor runs here for
    one card and for several alike."""
    import jax

    os.environ["RPTR_HOST_WAVEFRONT"] = "0"
    r, cfg = _scene_renderer("village", width, height, 9, devices=devs)
    r.render(cfg)
    jax.block_until_ready(r._acc_chunks)
    t0 = time.perf_counter()
    r.reset_accumulation()
    r.render(cfg)
    jax.block_until_ready(r._acc_chunks)
    ms = (time.perf_counter() - t0) * 1e3
    return r.readback_accumulation(), ms


def _sharded_and_tile(devs, width, height):
    """``build_sharded_render`` over a mesh of ``devs`` and the one-device
    ``render_tile`` of the same village frame: (sharded image, rays,
    tile image, rays)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderParams,
    )
    from realtimepathtracingresearchframework_tpu.ops.integrator import (
        FrameParams,
        ViewBuffers,
        render_tile,
    )
    from realtimepathtracingresearchframework_tpu.parallel.mesh import make_mesh
    from realtimepathtracingresearchframework_tpu.parallel.render_sharded import (
        build_sharded_render,
    )

    r, cfg = _scene_renderer("village", width, height, 9, devices=devs[:1])
    icfg = r._integrator_config(RenderParams(max_path_depth=9))
    pos, du, dv, tl = cfg.camera.view_basis(width, height)
    view = ViewBuffers(*(jnp.asarray(x) for x in (pos, du, dv, tl)))
    fp = FrameParams(rr_path_depth=jnp.int32(2),
                     glossy_only_mode=jnp.int32(0),
                     sample_offset=jnp.uint32(0), shot_offset=jnp.uint32(0))
    ds = r.device_scene
    one = jax.jit(lambda ds, fp, view: render_tile(ds, icfg, fp, view, width,
                                                   height, 1))
    ref, rays_ref = one(ds, fp, view)
    sharded = build_sharded_render(make_mesh(devs), icfg, width, height)
    out, rays = sharded(ds, fp, view, jnp.int32(1))
    return np.asarray(out), int(rays), np.asarray(ref), int(rays_ref)


def phase_four(width: int = 1920, height: int = 1080) -> bool:
    import jax
    import numpy as np

    devs = jax.devices()
    if len(devs) < 4:
        _log(f"[four] needs 4 devices, found {len(devs)}")
        return False
    devs = devs[:4]

    # Renderer(devices=4): chunks round-robin over per-device pass
    # programs, against the same pass program on one card
    t0 = time.perf_counter()
    a, ms_1 = _renderer_frame(devs[:1], width, height)
    b, ms_4 = _renderer_frame(devs, width, height)
    res = _golden_check(b[..., :3], a[..., :3])
    res.update(bit_identical=bool(np.array_equal(a, b)),
               ms_1card=round(ms_1, 3), ms_4cards=round(ms_4, 3),
               wall_s=round(time.perf_counter() - t0, 1), **_image_ok(b))
    res["ok"] &= res["finite"] and res["nonblack"]
    _log(f"[four] village {width}x{height} d9 Renderer(devices=4) vs one card: "
         f"{json.dumps(res)}")
    ok = res["ok"]

    # build_sharded_render over a 4-device mesh vs one-device render_tile
    t0 = time.perf_counter()
    out, rays, ref, rays_ref = _sharded_and_tile(devs, width, height)
    res = _golden_check(out[..., :3], ref[..., :3])
    res.update(bit_identical=bool(np.array_equal(ref, out)),
               rays_1=rays_ref, rays_4=rays,
               wall_s=round(time.perf_counter() - t0, 1), **_image_ok(out))
    res["ok"] &= res["finite"] and res["nonblack"] and rays > 0
    _log(f"[four] build_sharded_render 4-device mesh vs render_tile: "
         f"{json.dumps(res)}")
    return ok and res["ok"]


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--only", default="",
                    help="comma list of phases to run: kernels, goldens, "
                         "frames (the default three), ab (whole frames, "
                         "kernel against the XLA walk)")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX devices: {devs})",
              file=sys.stderr)
        return 2
    from realtimepathtracingresearchframework_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    _log(f"[device] {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
         f"nvidia-smi: {_gpu_line()}")

    phases = {"kernels": phase_kernels, "goldens": phase_goldens,
              "frames": phase_frames}
    wanted = [p for p in args.only.split(",") if p] or list(phases)
    phases.update(ab=phase_ab, four=phase_four)
    if args.four:
        wanted = ["four"]
    ok = True
    for name in wanted:
        t0 = time.perf_counter()
        passed = phases[name]()
        _log(f"[{name}] {'PASS' if passed else 'FAIL'} "
             f"({time.perf_counter() - t0:.1f} s)")
        ok &= passed
    _log(f"[device] nvidia-smi: {_gpu_line()}")
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
