"""Benchmark entry point.

Rows (the reference's workload classes, README.md:77 +
render_params.glsl.h:130-133):
- cornell 1080p 1spp depth 9, megakernel — the headline ("value"),
- village_*: ~80k-tri TEXTURED scene at 1080p depth 9,
- instanced_*: 600 animated instances with a per-frame TLAS refit,
  512x384 depth 3,
- terrain_*: 500k-tri scene at 512x384 depth 3.

All pipelines warm up on background threads (the std::async
pipeline-compile analogue, render_vulkan.cpp:139-155). compile_s reports
the warmup wall clock; compile_cache_* report persistent-cache state
(cold vs warm run).

Prints ONE JSON line: {"metric": "Mrays/sec/chip", "value": N, ...}.
vs_baseline is fps / 60 against the north star (>= 60 fps at 1080p 1spp
on one card; the reference publishes no numbers).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

def _cache_entries() -> int:
    from realtimepathtracingresearchframework_tpu.utils.compile_cache import (
        cache_dir,
    )

    try:
        return len([f for f in os.listdir(cache_dir())
                    if not f.startswith(".")])
    except OSError:
        return 0


def main() -> int:
    width = int(os.environ.get("BENCH_WIDTH", 1920))
    height = int(os.environ.get("BENCH_HEIGHT", 1080))
    spp = int(os.environ.get("BENCH_SPP", 1))
    max_depth = int(os.environ.get("BENCH_MAX_DEPTH", 9))
    frames = int(os.environ.get("BENCH_FRAMES", 16))
    do_village = os.environ.get("BENCH_VILLAGE", "1") != "0"
    do_terrain = os.environ.get("BENCH_TERRAIN", "1") != "0"
    # 500 -> 500k tris (default row); 708 -> 1.0M tris
    terrain_grid = int(os.environ.get("BENCH_TERRAIN_GRID", 500))

    import jax

    from realtimepathtracingresearchframework_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    # persistent compilation cache: warm runs hit it (the reference's
    # SPIR-V cache analogue, gpu_programs.cmake)
    enable_compile_cache()

    from realtimepathtracingresearchframework_tpu.backend.params import (
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

    cache_before = _cache_entries()

    def hard_sync(r):
        # wait for the accumulators (the last pass outputs) — the display
        # resolve is swapchain-present work the reference's
        # render_time_ms marker excludes too (render_vulkan.cpp:2229-2236)
        if r._planar:
            jax.block_until_ready(r._acc_chunks)
        else:
            jax.block_until_ready(r.framebuffer)

    # --- build all rows up front so their compiles overlap
    rows = {}

    scene = Scene.from_vkr_scene(procedural.cornell_box())
    r = Renderer()
    r.initialize(width, height)
    r.set_scene(scene)
    cfg = FrameConfig(
        camera=OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50),
        params=RenderParams(batch_spp=spp, max_path_depth=max_depth),
    )
    rows["cornell"] = (r, cfg)

    if do_village:
        vsc = SceneConfig(sun_dir=(0.35, 0.8, 0.3), turbidity=3.0)
        rv = Renderer()
        rv.initialize(width, height)
        rv.set_scene(Scene.from_vkr_scene(procedural.village()), scene_config=vsc)
        rows["village"] = (
            rv,
            FrameConfig(
                camera=OrientedCamera.look_at([0, 4.0, 13.0], [0, 0.5, 0], fovy=55),
                params=RenderParams(batch_spp=spp, max_path_depth=max_depth),
                scene_config=vsc,
            ),
        )

    do_instanced = os.environ.get("BENCH_INSTANCED", "1") != "0"
    if do_instanced:
        # instanced ANIMATED row: 600 spinning instances with a per-frame
        # TLAS refit (the XLA two-level walk, ops/tlas.py)
        isc = SceneConfig(sun_dir=(0.4, 0.8, 0.25), turbidity=3.0)
        ri = Renderer()
        ri.options = ri.options.replace(use_tlas=True)
        ri.initialize(512, 384)
        ri.set_scene(
            Scene.from_vkr_scene(procedural.instanced_field(num_inst=600)),
            scene_config=isc,
        )
        rows["instanced"] = (
            ri,
            FrameConfig(
                camera=OrientedCamera.look_at([0, 14.0, 30.0], [0, 0, 0],
                                              fovy=55),
                params=RenderParams(batch_spp=1, max_path_depth=3),
                scene_config=isc,
            ),
        )

    if do_terrain:
        tsc = SceneConfig(sun_dir=(0.4, 0.7, 0.2), turbidity=3.0)
        rt = Renderer()
        rt.initialize(512, 384)
        rt.set_scene(
            Scene.from_vkr_scene(procedural.terrain(grid=terrain_grid)),
            scene_config=tsc,
        )
        rows["terrain"] = (
            rt,
            FrameConfig(
                camera=OrientedCamera.look_at([0, 5.0, 12.0], [0, 0, 0], fovy=55),
                params=RenderParams(batch_spp=1, max_path_depth=3),
                scene_config=tsc,
            ),
        )

    # --- concurrent warmup (compile) across rows
    warm_s = {}
    errors = {}

    def warm(name):
        rr, cc = rows[name]
        t0 = time.perf_counter()
        try:
            rr.render(cc)
            hard_sync(rr)
            warm_s[name] = time.perf_counter() - t0
        except Exception as e:  # pragma: no cover - surfaced in JSON
            errors[name] = str(e)[:200]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=warm, args=(n,)) for n in rows]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    compile_s = time.perf_counter() - t0

    def measure(name, nframes):
        rr, cc = rows[name]
        rays = []
        t0 = time.perf_counter()
        for _ in range(nframes):
            rr.render(cc)
            rays.append(rr._last_rays)  # device scalars; summed after sync
        hard_sync(rr)
        total_s = time.perf_counter() - t0
        total_rays = 0
        for fr in rays:
            fr = fr if isinstance(fr, list) else [fr]
            total_rays += sum(int(x) for x in fr)
        return total_s / nframes * 1000.0, total_rays / total_s / 1e6

    # the driver parses exactly one JSON line — emit it even if the
    # headline row fails (surface the error rather than crash silently)
    try:
        if "cornell" in errors:
            raise RuntimeError(errors["cornell"])
        p50_ms, mrays = measure("cornell", frames)
    except Exception as e:
        print(json.dumps({
            "metric": "Mrays/sec/chip", "value": 0.0, "unit": "Mray/s",
            "vs_baseline": 0.0, "error": str(e)[:300],
            "compile_s": round(compile_s, 1),
        }))
        return 1
    fps = 1000.0 / p50_ms if p50_ms > 0 else 0.0

    result = {
        "metric": "Mrays/sec/chip",
        "value": round(mrays, 3),
        "unit": "Mray/s",
        "vs_baseline": round(fps / 60.0, 4),
        "p50_frame_ms": round(p50_ms, 3),
        "fps": round(fps, 3),
        "resolution": f"{width}x{height}",
        "spp": spp,
        "max_depth": max_depth,
        "device": str(jax.devices()[0]),
        "compile_s": round(compile_s, 1),
        # per-row warmup wall (compile + first frame + upload) — the
        # compile-wall diagnostic: a warm run whose
        # row time stays high despite unchanged cache entries is a cache
        # MISS for that row's program cells
        "warm_row_s": {k: round(v, 1) for k, v in sorted(warm_s.items())},
        "compile_cache_entries_before": cache_before,
        "compile_cache_entries_after": _cache_entries(),
        "compile_cold": cache_before == 0,
    }

    if "village" in rows and "village" not in errors:
        try:
            vr, _ = rows["village"]
            vms, vmrays = measure("village", max(frames // 2, 4))
            result["village_tris"] = int(vr.scene.unique_tris)
            result["village_ms"] = round(vms, 1)
            result["village_mrays"] = round(vmrays, 3)
            result["village_traversal"] = vr._traversal
        except Exception as e:
            result["village_error"] = str(e)[:200]
    elif "village" in errors:
        result["village_error"] = errors["village"]

    if "instanced" in rows and "instanced" not in errors:
        try:
            ir, icc = rows["instanced"]
            # per-frame TLAS refit (animated transforms): the TLAS side
            # rides as call operands, zero retrace
            # (render_vulkan.cpp:1219-1366)
            nfr = 8
            rays = []
            t0 = time.perf_counter()
            for f in range(nfr):
                ir.set_animation_frame((f + 1) % 16, icc.scene_config)
                ir.render(icc)
                rays.append(ir._last_rays)
            hard_sync(ir)
            total_s = time.perf_counter() - t0
            total_rays = 0
            for fr in rays:
                fr = fr if isinstance(fr, list) else [fr]
                total_rays += sum(int(x) for x in fr)
            result["instanced_insts"] = len(ir.scene.instances)
            result["instanced_tris"] = int(ir.scene.total_tris)
            result["instanced_ms"] = round(total_s / nfr * 1000.0, 1)
            result["instanced_mrays"] = round(total_rays / total_s / 1e6, 3)
            result["instanced_traversal"] = "xla_two_level"
        except Exception as e:
            result["instanced_error"] = str(e)[:200]
    elif "instanced" in errors:
        result["instanced_error"] = errors["instanced"]

    if "terrain" in rows and "terrain" not in errors:
        try:
            tr, _ = rows["terrain"]
            tms, tmrays = measure("terrain", 4)
            result["terrain_tris"] = int(tr.scene.unique_tris)
            result["terrain_ms"] = round(tms, 1)
            result["terrain_mrays"] = round(tmrays, 3)
            result["terrain_traversal"] = tr._traversal
        except Exception as e:
            result["terrain_error"] = str(e)[:200]
    elif "terrain" in errors:
        result["terrain_error"] = errors["terrain"]

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
