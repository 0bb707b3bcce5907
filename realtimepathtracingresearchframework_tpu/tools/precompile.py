"""AOT program-lattice precompiler.

The reference precompiles its shader-variant x option cross-product at
BUILD time into a content-addressed cache (gpu_programs.cmake:228-374,
cache key gpu_programs.cpp:34-120), so a user never waits on shader
compiles at startup. XLA programs are shape-specific, so this tool
precompiles per (scene archetype, resolution, variant, option) cell into
JAX's persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else
<repo>/.jax_cache; utils/compile_cache.py) — run this once per
deployment (or after an upgrade) and every later process start hits the
cache instead of the compiler.

Cells compile on background threads (the reference's std::async
pipeline builds, render_vulkan.cpp:139-155), so scene builds and
compiles of different groups overlap.

Usage:
    python -m realtimepathtracingresearchframework_tpu.tools.precompile \
        --scenes cornell,village,terrain:500 --img 1920 1080 \
        --variants PT_MEGAKERNEL,PT_WAVEFRONT

.vks paths are accepted as scene names; resolutions repeat (--img W H
--img W H ...). Prints one line per cell and a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rptr-precompile",
        description="Precompile the render-program lattice into the "
        "persistent JAX compilation cache",
    )
    p.add_argument(
        "--scenes",
        default=(
            "cornell@1920x1080x9,village@1920x1080x9,terrain:500@512x384x3"
        ),
        help="comma list: cornell|village|terrain[:grid]|triangle|/path.vks,"
        " each optionally pinned to its production cell with @WxHxDEPTH"
        " (the default mirrors bench.py's rows exactly — an unpinned"
        " scene crosses with every --img resolution at --max-depth)",
    )
    p.add_argument(
        "--img", nargs=2, type=int, action="append", metavar=("W", "H"),
        default=None, help="resolution cell(s); default 1920x1080 + 512x384",
    )
    p.add_argument(
        "--variants", default="PT_MEGAKERNEL,PT_WAVEFRONT",
        help="comma list of integrator variants to compile",
    )
    p.add_argument(
        "--rng", default="uniform",
        help="comma list of RNG pointsets (uniform,bn,sobol,z_sbl)",
    )
    p.add_argument("--max-depth", type=int, default=9)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument(
        "--sun-dir", nargs=3, type=float, default=None,
        help="override the per-scene production sun config (sky tables "
             "are program constants — must match production exactly)",
    )
    p.add_argument("--turbidity", type=float, default=3.0)
    p.add_argument(
        "--jobs", type=int, default=4,
        help="max concurrent compile threads (each holds a full scene "
             "build; 0 = all cells at once)",
    )
    return p


def _cache_entries(cache_dir: str) -> int:
    try:
        return len(
            [f for f in os.listdir(cache_dir) if not f.startswith(".")]
        )
    except OSError:
        return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from realtimepathtracingresearchframework_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    cache_dir = enable_compile_cache()

    from realtimepathtracingresearchframework_tpu.app.cli import load_scene
    from realtimepathtracingresearchframework_tpu.backend.params import (
        RenderParams,
        SceneConfig,
    )
    from realtimepathtracingresearchframework_tpu.backend.renderer import (
        FrameConfig,
        Renderer,
    )
    from realtimepathtracingresearchframework_tpu.models.camera import (
        OrientedCamera,
    )

    rng_names = ["uniform", "bn", "sobol", "z_sbl"]
    resolutions = [tuple(r) for r in (args.img or [])] or [
        (1920, 1080), (512, 384)
    ]
    variants = [v for v in args.variants.split(",") if v]
    rngs = [r for r in args.rng.split(",") if r]

    # scene specs: "name" or "name@WxHxDEPTH" (pin to one production
    # cell — XLA programs are shape- AND depth-specific, so compiling
    # terrain at depth 9 would never hit for the depth-3 bench row)
    groups = []  # (name, w, h, depth)
    scene_names = []
    for spec in args.scenes.split(","):
        if not spec:
            continue
        if "@" in spec:
            name, cell = spec.split("@", 1)
            w, h, depth = (int(x) for x in cell.split("x"))
            groups.append((name, w, h, depth))
        else:
            name = spec
            groups.extend(
                (name, w, h, args.max_depth) for (w, h) in resolutions
            )
        if name not in scene_names:
            scene_names.append(name)

    before = _cache_entries(cache_dir)

    # scenes load once; renderers per (scene, resolution, variant, rng)
    scenes = {name: load_scene([name]) for name in scene_names}
    # the scene — INCLUDING the cooked sky tables — is captured as
    # constants in the pass programs (renderer.py make_pass_fn), so the
    # persistent-cache key covers the sun config: warming with a
    # different sun_dir than production warms NOTHING. These match
    # bench.py's rows exactly; --sun-dir/--turbidity override for
    # custom deployments.
    def scene_cfg(name):
        if args.sun_dir is not None:
            return SceneConfig(
                sun_dir=tuple(args.sun_dir), turbidity=args.turbidity
            )
        if name.startswith("terrain"):
            return SceneConfig(sun_dir=(0.4, 0.7, 0.2), turbidity=3.0)
        if name.startswith("village"):
            return SceneConfig(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)
        return SceneConfig()  # cornell/triangle: bench uses the default

    # one thread per (scene, resolution): the scene build (BVH/pack)
    # happens once there, then every variant x rng cell compiles
    # sequentially against that renderer — the compiles still overlap
    # ACROSS groups
    cells = [
        (name, w, h, depth, var, rng)
        for (name, w, h, depth) in groups for var in variants for rng in rngs
    ]

    times = {}
    errors = {}
    sem = threading.Semaphore(args.jobs) if args.jobs > 0 else None

    def compile_group(group):
        name, w, h, depth = group
        if sem:
            sem.acquire()
        try:
            sc_cfg = scene_cfg(name)
            r = Renderer()
            r.initialize(w, h)
            r.set_scene(scenes[name], scene_config=sc_cfg)
            cfg = FrameConfig(
                camera=OrientedCamera.look_at(
                    [0, 2.0, 8.0], [0, 0.5, 0.0], fovy=55
                ),
                params=RenderParams(
                    batch_spp=args.spp, max_path_depth=depth
                ),
                scene_config=sc_cfg,
            )
            for var in variants:
                for rng in rngs:
                    cell = (name, w, h, depth, var, rng)
                    t0 = time.perf_counter()
                    try:
                        r.configure_for(
                            r.options.replace(
                                rng_variant=rng_names.index(rng)
                            )
                        )
                        if not r.set_variant(var):
                            raise ValueError(f"unknown variant {var!r}")
                        r.render(cfg)
                        jax.block_until_ready(r.framebuffer)
                        times[cell] = time.perf_counter() - t0
                    except Exception as e:  # pragma: no cover
                        errors[cell] = str(e)[:200]
        except Exception as e:  # pragma: no cover - scene-level failure
            for var in variants:
                for rng in rngs:
                    errors[(name, w, h, depth, var, rng)] = str(e)[:200]
        finally:
            if sem:
                sem.release()

    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=compile_group, args=(g,)) for g in groups
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    for cell in cells:
        name, w, h, depth, var, rng = cell
        tag = f"{name} {w}x{h} d{depth} {var} rng={rng}"
        if cell in errors:
            print(f"  FAIL {tag}: {errors[cell]}", file=sys.stderr)
        elif cell in times:
            print(f"  ok   {tag}: {times[cell]:.1f}s")

    after = _cache_entries(cache_dir)
    print(json.dumps({
        "cells": len(cells),
        "failed": len(errors),
        "wall_s": round(wall, 1),
        "cache_dir": cache_dir,
        "cache_entries_before": before,
        "cache_entries_after": after,
    }))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
