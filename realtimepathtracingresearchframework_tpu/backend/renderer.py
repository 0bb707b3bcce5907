"""Renderer — the RenderBackend implementation.

Equivalent of ``RenderVulkan`` (vulkan/render_vulkan.h:36-278 +
render_vulkan.cpp): owns the device scene (SoA arrays + BVH), the
accumulation/framebuffer state, the per-variant jit cache (the
``GpuProgramCache`` analogue, librender/gpu_programs.h:31-97 — here the jit
cache keyed by (variant, device-relevant options, static shapes)), and the
frame lifecycle:

- ``set_scene``  = scene upload + BLAS/TLAS build (render_vulkan.cpp:1554),
- ``begin_frame``= view-param update (render_vulkan.cpp:1919),
- ``draw_frame`` = integrator dispatch (render_vulkan.cpp:2157),
- ``end_frame``  = sample-processing resolve + accumulation bookkeeping
  ``frame_id += batch_spp`` (render_vulkan.cpp:2017,2152-2154),
- readbacks, stats, ray queries, variants.

JAX's async dispatch plays the role of the reference's frames-in-flight
command streams; ``jax.block_until_ready`` only at readback.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from realtimepathtracingresearchframework_tpu.backend.params import (
    REPROJECTION_MODE_ACCUMULATE,
    REPROJECTION_MODE_DISCARD_HISTORY,
    RNG_VARIANT_UNIFORM,
    RenderBackendOptions,
    RenderParams,
    SceneConfig,
)
from realtimepathtracingresearchframework_tpu.models import lights as lights_mod
from realtimepathtracingresearchframework_tpu.models import sky as sky_mod
from realtimepathtracingresearchframework_tpu.models.camera import OrientedCamera
from realtimepathtracingresearchframework_tpu.models.scene import Scene
from realtimepathtracingresearchframework_tpu.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu.ops import nee as nee_mod
from realtimepathtracingresearchframework_tpu.ops import resolve as resolve_mod
from realtimepathtracingresearchframework_tpu.ops.integrator import (
    DeviceScene,
    FrameParams,
    IntegratorConfig,
    MaterialBuffers,
    ShadingBuffers,
    ViewBuffers,
    _swizzle_tables,
    image_to_planes,
    make_pass_fn,
    planes_to_image,
    render_tile,
    render_tile_host,
    tlas_frame_operands,
)
from realtimepathtracingresearchframework_tpu.ops import texture_atlas as atlas_mod
from realtimepathtracingresearchframework_tpu.ops import pointsets
from realtimepathtracingresearchframework_tpu.ops import traverse_gpu
from realtimepathtracingresearchframework_tpu.ops.traverse import (
    TriBuffers,
    closest_hit_threaded,
    threaded_to_device,
)
from realtimepathtracingresearchframework_tpu.utils.error_io import warning
from realtimepathtracingresearchframework_tpu.utils.profiling import (
    DeviceTimers,
    ProfilingMarker,
    ProfilingScope,
)

# Integrator variant registry — the RPTR_INTEGRATORS analogue
# (vulkan/CMakeLists.txt:22-69 / render_vulkan.cpp:202-226). Megakernel is
# the flagship; WAVEFRONT is the stream-compacted pipeline. The reference's
# recursion-style variants (PT_TAIL_RECURSIVE / PT_BTD_SHADE /
# PT_STACK_RECURSIVE / PT_RTP_MEGAKERNEL / PT) exist only because Vulkan RT
# offers several dispatch shapes for the same estimator; here they all
# lower to the same traced bounce loop, so they are registered as aliases
# of the megakernel program (identical images by construction).
VARIANT_MEGAKERNEL = "PT_MEGAKERNEL"
VARIANT_WAVEFRONT = "PT_WAVEFRONT"
VARIANT_PT = "PT"  # naive/independent estimator (raygen.rgen) — same math
VARIANT_TAIL_RECURSIVE = "PT_TAIL_RECURSIVE"
VARIANT_BTD_SHADE = "PT_BTD_SHADE"
VARIANT_STACK_RECURSIVE = "PT_STACK_RECURSIVE"
VARIANT_RTP_MEGAKERNEL = "PT_RTP_MEGAKERNEL"
VARIANT_RT_DEBUG = "RT_DEBUG"  # first-hit debug visualizer (rt_debug.comp)
VARIANT_GBUFFER = "GBUFFER"  # computational raytracer G-buffer dump
VARIANT_RQ_CLOSEST = "RQ_CLOSEST"  # ray-query kernel (rt_intersect.comp)

# variants that render via the megakernel bounce loop
_MEGAKERNEL_ALIASES = (
    VARIANT_MEGAKERNEL,
    VARIANT_PT,
    VARIANT_TAIL_RECURSIVE,
    VARIANT_BTD_SHADE,
    VARIANT_STACK_RECURSIVE,
    VARIANT_RTP_MEGAKERNEL,
)


@partial(jax.jit, static_argnames=("tonemap_mode",))
def _resolve_planar(acc, exposure, tonemap_mode: int):
    return resolve_mod.resolve_channels(acc, exposure, tonemap_mode)


def _triangle_buffers(flat):
    """Per-triangle geometry + shading attribute device arrays of a
    flattened scene, in triangle order (the traversals return triangle
    ids)."""
    tris = TriBuffers(
        v0=jnp.asarray(flat.v0),
        e1=jnp.asarray(flat.e1),
        e2=jnp.asarray(flat.e2),
    )
    shading = ShadingBuffers(
        n0=jnp.asarray(flat.n0),
        n1=jnp.asarray(flat.n1),
        n2=jnp.asarray(flat.n2),
        uv0=jnp.asarray(flat.uv0),
        uv1=jnp.asarray(flat.uv1),
        uv2=jnp.asarray(flat.uv2),
        material_id=jnp.asarray(flat.material_id),
        texel_density=jnp.asarray(flat.texel_density),
        tangent=jnp.asarray(flat.tangent),
    )
    return tris, shading


# Frame policies for large single-level scenes on the GPU traversal:
# carry compaction, the host-wavefront executor and the coherence sorts of
# the traversal queues. Triangle count is the proxy for how much BVH a
# ray walks that the renderer has at build time: cornell (32 triangles)
# sits below the threshold, village (80k) above it. The value was tuned
# on an earlier hardware target; it has not been measured on the GPU.
_LARGE_SCENE_MIN_TRIS = 16_384
_BRUTE_MAX_ROWS = 64  # fully-inlined XLA traversal below this row count
# (the unrolled chain is ~35 HLO ops/row/dispatch; past this the trace
# grows without bound)


@dataclass
class RenderStats:
    """librender/render_backend.h:15-24."""

    render_time: float = 0.0  # ms
    spp: int = 0
    rays_per_second: float = -1.0
    device_bytes_currently_allocated: int = 0
    max_device_bytes_allocated: int = 0
    total_device_bytes: int = 0


@dataclass
class FrameConfig:
    """Per-frame inputs negotiated by the app loop (CommandStream+config)."""

    camera: OrientedCamera = field(default_factory=OrientedCamera)
    params: RenderParams = field(default_factory=RenderParams)
    scene_config: SceneConfig = field(default_factory=SceneConfig)


class Renderer:
    """The render backend."""

    # completion-sync cadence for the pipelined fast path (see render());
    # render_time amortizes the window like the reference's 2-frame-
    # delayed GPU timestamps
    SYNC_INTERVAL = 16

    def __init__(self, device=None, devices=None):
        """``devices``: render across several devices — the frame's swizzle
        chunks round-robin over per-device pass programs with the scene
        REPLICATED into every device's memory (SURVEY §5.8: data-parallel
        over rays, collectives only at framebuffer assembly). Uses the same
        host-dispatched fast-path architecture as single-device rendering;
        image-domain paths (TAA/reprojection/upscale) fall back to the
        first device."""
        self.devices = (
            list(devices) if devices else ([device] if device else None)
        )
        if self.devices is None:
            self.devices = [jax.devices()[0]]
        self.device = self.devices[0]
        self._multi = len(self.devices) > 1
        self._device_scenes = None  # per-device replicas when _multi
        self.fb_width = 0
        self.fb_height = 0
        self.options = RenderBackendOptions()
        self.scene: Optional[Scene] = None
        self.device_scene: Optional[DeviceScene] = None
        self._bvh = None
        self._num_lights = 0
        # accumulation/framebuffer state lives in ONE of two forms:
        # - per-chunk channel buffers in swizzle order (the fast path: the
        #   pass programs accumulate into them IN PLACE, the frame loop is
        #   nothing but pass dispatches; join/resolve/reorder happen
        #   lazily at readback — the swapchain-blit point), or
        # - (H, W, 4) images (TAA / reprojection / upscale / debug paths).
        # The public .accum/.framebuffer properties always present images.
        self._planar = False
        self._acc_chunks = None  # list of per-chunk 4-tuples of buffers
        self._fb_planes = None  # lazily resolved display channels
        self._resolve_args = (jnp.float32(0.0), -1)
        self._accum_img: Optional[jnp.ndarray] = None
        self._fb_img: Optional[jnp.ndarray] = None
        self.frame_id = 0  # accumulated samples (render_vulkan.cpp:2152)
        self.shot_offset = 0
        # --freeze-frame: re-render the same sample sequence every frame
        # (frame_id pinned, render_vulkan.cpp:2152-2154; shot_offset not
        # advanced on reset, :1937-1940) — the determinism/debug tool
        self.freeze_frame = False
        self.timers = DeviceTimers()
        self._render_fns: Dict = {}  # jit cache (GpuProgramCache analogue)
        self._pass_fns: Dict = {}  # scene-capturing pass programs
        self._wf_progs: Dict = {}  # bounce-major wavefront program sets
        self._pass_fn_lock = threading.Lock()  # warmup_async vs render()
        self._device_scene_revision = 0
        self._last_rays = 0
        self._last_render_ms = 0.0
        self._scene_revision = -1
        self._use_bins = False
        self._traversal = "xla"  # single-level walk (_select_traversal)
        self._large_scene = False  # _LARGE_SCENE_MIN_TRIS policies on
        self._has_textures = False
        self._atlas = None
        self._use_two_level = False
        self._tlas_buffers = None
        self.active_variant = VARIANT_MEGAKERNEL
        # RenderExtension framework (librender/render_backend.h:126-154):
        # pointsets/binned-lights attach by default like run_app's
        # create_default_extensions call (app.cpp); processing steps
        # (TAA/profiling-tools/...) are created on demand via the factory.
        from realtimepathtracingresearchframework_tpu.backend import (
            extensions as ext_mod,
        )

        self._ext_mod = ext_mod
        self.extensions: List = ext_mod.create_default_extensions(self)
        self._processing_steps: Dict = {}
        self._aovs = None
        self._last_config = None
        self._last_upscale = 1
        self._frame_id_at_render = 0
        self._u32_cache: Dict[int, jnp.ndarray] = {}
        self.sync_interval = self.SYNC_INTERVAL
        self._frames_since_sync = 0
        self._timing_synced = False

    def _u32_const(self, v: int, device_index: int = 0):
        """Cached device u32 scalar (recurring per-frame operands would
        otherwise each pay a host->device transfer).
        ``device_index`` commits the scalar to that render device."""
        key = (v, device_index)
        c = self._u32_cache.get(key)
        if c is None:
            c = jnp.uint32(v)
            if device_index or self._multi:
                c = jax.device_put(c, self.devices[device_index])
            self._u32_cache[key] = c
        return c

    # ------------------------------------------------------------------
    # RenderExtension framework (render_vulkan_extensions.cpp:16-84)
    # ------------------------------------------------------------------

    def create_default_extensions(self) -> List:
        return self._ext_mod.create_default_extensions(self)

    def create_processing_step(self, step):
        return self._ext_mod.create_processing_step(self, step)

    def get_processing_step(self, step):
        """Cached processing-step extension (created + initialized once)."""
        ext = self._processing_steps.get(step)
        if ext is None:
            ext = self.create_processing_step(step)
            if ext is not None:
                ext.initialize(self.fb_width, self.fb_height)
            self._processing_steps[step] = ext
        return ext

    def active_extensions(self) -> List:
        return [
            e for e in self.extensions if e.is_active_for(self.options)
        ]

    # -- state the processing extensions read (render target surround) ---

    def last_aovs(self):
        """AOVs for the frame just rendered, produced on demand."""
        if self._aovs is None and self._last_config is not None:
            self._aovs = self.render_aovs(self._last_config)
        return self._aovs

    def frame_id_at_last_render(self) -> int:
        return self._frame_id_at_render

    def last_upscale(self) -> int:
        return self._last_upscale

    # ------------------------------------------------------------------
    # RenderBackend interface
    # ------------------------------------------------------------------

    def variants(self) -> List[str]:
        """Registered variant list, reference registration order
        (vulkan/CMakeLists.txt:22-69)."""
        return [
            VARIANT_TAIL_RECURSIVE,
            VARIANT_BTD_SHADE,
            VARIANT_STACK_RECURSIVE,
            VARIANT_MEGAKERNEL,
            VARIANT_RTP_MEGAKERNEL,
            VARIANT_PT,
            VARIANT_WAVEFRONT,
            VARIANT_RQ_CLOSEST,
            VARIANT_GBUFFER,
            VARIANT_RT_DEBUG,
        ]

    def supported_variants(self) -> List[str]:
        """mark_unsupported_variants analogue (render_vulkan.cpp:228-232):
        RQ_CLOSEST is a query kernel, not a frame renderer."""
        return [v for v in self.variants() if v != VARIANT_RQ_CLOSEST]

    def set_variant(self, name: str) -> bool:
        """Select the active integrator; falls back to the next supported
        variant like the UI does (app_state.cpp:117-143). Returns False if
        ``name`` was unsupported and a fallback was chosen."""
        if name in self.supported_variants():
            self.active_variant = name
            return True
        warning("unsupported variant %s; falling back to %s",
                name, VARIANT_MEGAKERNEL)
        self.active_variant = VARIANT_MEGAKERNEL
        return False

    def initialize(self, fb_width: int, fb_height: int) -> None:
        """Framebuffer (re)allocation (render_vulkan.cpp:246-370)."""
        self.fb_width = int(fb_width)
        self.fb_height = int(fb_height)
        self.accum = jnp.zeros((self.fb_height, self.fb_width, 4), jnp.float32)
        self.framebuffer = jnp.zeros_like(self._accum_img)
        self.frame_id = 0
        for ext in self.extensions:
            ext.initialize(self.fb_width, self.fb_height)
            ext.last_initialized_generation = self._device_scene_revision
        for ext in self._processing_steps.values():
            if ext is not None:
                ext.initialize(self.fb_width, self.fb_height)

    # -- accumulation/framebuffer state (planar fast path vs image) -------

    def _planes_np(self, planes) -> np.ndarray:
        """Channel tuple -> host (4, n_pad) array (readback + interleave)."""
        jax.block_until_ready(planes)
        return np.stack([np.asarray(p) for p in planes])

    def _materialize(self, planes) -> jnp.ndarray:
        """Device channel tuple -> (H, W, 4) image (host blit)."""
        img = planes_to_image(
            self._planes_np(planes), self.fb_width, self.fb_height
        )
        return jnp.asarray(img)

    def _acc_planes_lazy(self):
        """Join the per-chunk accumulators into whole-frame channel planes
        (readback-time program, off the frame loop)."""
        from realtimepathtracingresearchframework_tpu.ops.integrator import (
            join_chunk_planes,
        )

        if self._multi:
            # cross-device chunks: assemble on the host — the framebuffer
            # all-gather of the thin communication plan (SURVEY §5.8)
            return tuple(
                jnp.asarray(
                    np.concatenate(
                        [np.asarray(c[k]) for c in self._acc_chunks]
                    )
                )
                for k in range(4)
            )
        return join_chunk_planes(self._acc_chunks)

    @property
    def accum(self) -> Optional[jnp.ndarray]:
        if self._planar:
            return self._materialize(self._acc_planes_lazy())
        return self._accum_img

    @accum.setter
    def accum(self, value) -> None:
        self._accum_img = value
        self._planar = False

    def _fb_planes_lazy(self):
        """Resolve the display channels on demand (blit-time resolve)."""
        if self._fb_planes is None:
            exposure, tonemap = self._resolve_args
            t0 = time.perf_counter()
            self._fb_planes = _resolve_planar(
                self._acc_planes_lazy(), exposure, tonemap
            )
            jax.block_until_ready(self._fb_planes)
            self.timers.add(
                ProfilingMarker.PROCESSING, (time.perf_counter() - t0) * 1e3
            )
        return self._fb_planes

    @property
    def framebuffer(self) -> Optional[jnp.ndarray]:
        if self._planar:
            return self._materialize(self._fb_planes_lazy())
        return self._fb_img

    @framebuffer.setter
    def framebuffer(self, value) -> None:
        # image-domain paths set .accum first (which leaves planar mode);
        # the planar fast path writes chunk buffers directly instead
        self._fb_img = value

    def _validate_options(self, options: RenderBackendOptions):
        """Returns (ok, adjusted) — the auto-adjust strategy of the
        invalid-configuration recovery loop (app.cpp:397-432): clamp
        out-of-range values to the supported lattice instead of failing."""
        adj = {}
        if not (0 <= options.rng_variant <= 3):
            adj["rng_variant"] = min(max(options.rng_variant, 0), 3)
        if not (1 <= options.light_sampling_bucket_count <= 64):
            adj["light_sampling_bucket_count"] = min(
                max(int(options.light_sampling_bucket_count), 1), 64
            )
        if options.render_upscale_factor < 1:
            adj["render_upscale_factor"] = 1
        if not (0 <= options.aniso_taps <= 16):
            adj["aniso_taps"] = min(max(int(options.aniso_taps), 0), 16)
        return (not adj), (options.replace(**adj) if adj else options)

    def configure_for(self, options: RenderBackendOptions) -> bool:
        """Apply options with two-strategy recovery (app.cpp:397-432):
        1) auto-adjust invalid values to the supported lattice,
        2) else revert to the last-known-good options.
        Returns True iff the requested options applied unmodified."""
        ok, adjusted = self._validate_options(options)
        if not ok:
            warning("invalid render options; auto-adjusted to supported values")
        # extension option negotiation (app.cpp:391-396): each active
        # extension may clamp further before the apply
        for ext in self.extensions:
            if ext.is_active_for(adjusted):
                norm = ext.normalize_options(adjusted)
                if norm != adjusted:
                    adjusted, ok = norm, False
                if not ext.configure_for(adjusted):
                    return False
        if adjusted != self.options:
            last_good = self.options
            # CPU-stage scene options change what _rebuild_scene builds
            # (TLAS vs flattened) — a plain re-upload would silently keep
            # the old structures
            rebuild = (
                self.scene is not None
                and adjusted.use_tlas != self.options.use_tlas
            )
            # the lights/sky rebuild must use the scene's ACTUAL config
            # (sun/turbidity/albedo from set_scene), not the defaults
            sc_cfg = getattr(self, "_scene_config", None) or SceneConfig()
            try:
                self.options = adjusted
                if rebuild:
                    self._rebuild_scene(
                        sc_cfg,
                        frame=getattr(self, "_scene_frame", 0),
                        camera_pos=getattr(self, "_lod_camera_pos", None),
                    )
                elif self.scene is not None:
                    self._upload_lights_and_sky(sc_cfg)
            except Exception as e:  # revert to last-known-good
                warning("option apply failed (%s); reverting", e)
                self.options = last_good
                if self.scene is not None:
                    self._upload_lights_and_sky(sc_cfg)
                return False
        return ok

    def set_scene(self, scene: Scene, scene_config: SceneConfig = SceneConfig()) -> None:
        with ProfilingScope("set_scene"):
            self.scene = scene
            self._rebuild_scene(scene_config)
            # shell.cpp:97-126: extensions observe the scene after upload
            for ext in self.extensions:
                ext.update_scene_from_backend(scene)

    def _use_wavefront_host(self, cfg) -> bool:
        """Policy for the bounce-major host-wavefront executor
        (ops/wavefront_host.py). Default: ON for large scenes on the
        GPU traversal (_LARGE_SCENE_MIN_TRIS); RPTR_HOST_WAVEFRONT=1/0
        forces. Requires single device, no debug counters, no deferred-NEE
        carry (the wavefront VARIANT keeps the monolith), depth > 1."""
        env = os.environ.get("RPTR_HOST_WAVEFRONT", "")
        want = self._large_scene if env == "" else env != "0"
        return (
            want
            and not self._multi
            and not cfg.debug_mode
            and not cfg.wavefront
            and cfg.max_path_depth > 1
            and self.device_scene is not None
        )

    def _get_or_make_pass_fn(self, pkey, cfg):
        """The ONE pass-program creation point, shared by render() and
        warmup_async (lock: a racing pair would otherwise build two
        distinct jit instances — separate jit caches, double compile —
        and overwrite each other's dict entry). The fn is published
        BEFORE any warm call, so both sides hold the same jit instance
        and the compile happens once inside it."""
        pass_fn = self._pass_fns.get(pkey)
        if pass_fn is not None:
            return pass_fn
        with self._pass_fn_lock:
            pass_fn = self._pass_fns.get(pkey)
            if pass_fn is not None:
                return pass_fn
            # evict closures over STALE scene revisions (they pin the
            # old device scene in device memory); same-revision entries for other
            # configs stay warm
            for k in [k for k in self._pass_fns if k[3] != pkey[3]]:
                del self._pass_fns[k]
            if self._multi:
                pass_fn = [
                    make_pass_fn(ds_d, cfg, self.fb_width, self.fb_height)
                    for ds_d in self._device_scenes
                ]
            else:
                pass_fn = make_pass_fn(
                    self.device_scene, cfg, self.fb_width, self.fb_height
                )
            self._pass_fns[pkey] = pass_fn
        return pass_fn

    def warmup_async(self, params: Optional[RenderParams] = None):
        """Background-compile the pass program for the current scene +
        options — the reference's std::async pipeline builds
        (render_vulkan.cpp:139-155 wait_for_construction). Returns the
        Thread; the first render() blocks only if it outruns the warmup
        (both sides hold the same jit instance, so the compile happens
        once)."""
        params = params or RenderParams()
        cfg = self._integrator_config(params)
        if self.active_variant == VARIANT_WAVEFRONT:
            cfg = cfg._replace(wavefront=True)
        pkey = (cfg, self.fb_width, self.fb_height, self._device_scene_revision)

        def build():
            try:
                pass_fn = self._get_or_make_pass_fn(pkey, cfg)
                px_c, py_c, valid_c, _inv, _nc, chunk = _swizzle_tables(
                    self.fb_width, self.fb_height
                )
                fp = FrameParams(
                    rr_path_depth=jnp.int32(params.rr_path_depth),
                    glossy_only_mode=jnp.int32(0),
                    sample_offset=jnp.uint32(0),
                    shot_offset=jnp.uint32(0),
                )
                pos, du, dv, tl = OrientedCamera().view_basis(
                    self.fb_width, self.fb_height
                )
                view = ViewBuffers(
                    jnp.asarray(pos), jnp.asarray(du), jnp.asarray(dv),
                    jnp.asarray(tl),
                )
                fns = pass_fn if self._multi else [pass_fn]
                for di, fn in enumerate(fns):
                    dev = self.devices[di]
                    put = (lambda x: jax.device_put(x, dev)) if self._multi \
                        else (lambda x: x)
                    zero = put(jnp.zeros((chunk,), jnp.float32))
                    extra = self._tlas_dyn_kwargs(
                        cfg,
                        self._device_scenes[di] if self._multi else None,
                    )
                    out = fn(
                        put(fp), put(view),
                        (zero, zero + 0, zero + 0, zero + 0),
                        put(px_c[0]), put(py_c[0]), put(valid_c[0]),
                        put(jnp.uint32(0)), put(jnp.uint32(0)), **extra,
                    )
                    jax.block_until_ready(out)
            except Exception as e:  # warmup is best-effort
                warning("warmup_async failed: %s", e)

        th = threading.Thread(target=build, daemon=True)
        th.start()
        return th

    def _select_traversal(self) -> str:
        """Single-level traversal for the render device's platform: the
        GPU kernel (ops/traverse_gpu.py) on "gpu", the plain XLA walk
        (ops/traverse.py) on "cpu", the test platform. Any other platform
        is an error: nothing falls back silently."""
        platform = self.device.platform
        if platform == "gpu":
            return "gpu"
        if platform == "cpu":
            return "xla"
        raise RuntimeError(
            f"no traversal for platform {platform!r} (expected 'gpu' or "
            "'cpu')"
        )

    def _build_tlas_buffers(self, transforms):
        """TLAS + instance tables for one frame (the TLAS rebuild/refit of
        default_update_tlas, render_vulkan.cpp:1219-1366): instance-count
        work only, the BLASes are untouched."""
        from realtimepathtracingresearchframework_tpu.ops import tlas as tlas_mod

        mesh_ids, mat_offsets = self._inst_binding
        aabbs = tlas_mod.instance_world_aabbs(self._blas, mesh_ids, transforms)
        nodes, row_inst = tlas_mod.build_tlas_nodes(aabbs)
        tables = tlas_mod.build_instance_tables(
            self._blas, mesh_ids, mat_offsets, transforms
        )
        blas_nodes, blas_tri_rows, blas_row_tri = self._blas_dev
        return tlas_mod.TwoLevelBuffers(
            tlas_nodes=jnp.asarray(nodes),
            tlas_row_inst=jnp.asarray(row_inst),
            blas_nodes=blas_nodes,
            blas_tri_rows=blas_tri_rows,
            blas_row_tri=blas_row_tri,
            **tables,
        )

    def _rebuild_scene(self, scene_config: SceneConfig, frame: int = 0,
                       camera_pos=None) -> None:
        scene = self.scene
        # the scene's lighting config is needed by every later rebuild
        # trigger (configure_for, set_animation_frame) — rebuilding with
        # a default SceneConfig() would silently reset the sun/sky
        self._scene_config = scene_config
        self._use_two_level = bool(self.options.use_tlas)
        # two-level scenes walk the XLA nested BVH (ops/tlas.py) on every
        # platform; the platform check still applies
        traversal = self._select_traversal()
        self._traversal = "xla" if self._use_two_level else traversal
        with ProfilingScope("flatten scene"):
            flat = scene.flatten_world(
                frame=frame, camera_pos=camera_pos,
                lod_threshold=scene_config.lod_threshold,
            )
        # LoD bookkeeping: render() re-flattens when the camera's LoD
        # selection changes (util/lod.cpp distance selection; per-LoD
        # BLAS offset render_vulkan.cpp:1244-1248)
        self._lod_signature = (
            scene.lod_selection(
                camera_pos, scene_config.lod_threshold, frame
            )
            if scene.has_lod_groups() else None
        )
        # the selection inputs are needed again by set_animation_frame:
        # a refit against a flatten with a DIFFERENT LoD selection would
        # apply new vertices to a topology with mismatched indices
        self._lod_camera_pos = (
            None if camera_pos is None
            else np.asarray(camera_pos, np.float32)
        )
        self._lod_threshold = scene_config.lod_threshold
        self._scene_frame = frame
        if self._use_two_level:
            from realtimepathtracingresearchframework_tpu.ops import (
                tlas as tlas_mod,
            )

            obj_flat, mesh_tris, mesh_ids, mat_offsets = scene.flatten_meshes()
            self._inst_binding = (mesh_ids, mat_offsets)
            t0 = time.perf_counter()
            with ProfilingScope("build BLAS set"):
                self._blas = tlas_mod.build_blas_set(mesh_tris)
                # uploaded once; every TLAS update reuses these arrays
                self._blas_dev = tuple(
                    jnp.asarray(a) for a in
                    (self._blas.nodes, self._blas.tri_rows, self._blas.row_tri)
                )
            self.timers.add(
                ProfilingMarker.BUILD_BLAS, (time.perf_counter() - t0) * 1e3
            )
            t0 = time.perf_counter()
            with ProfilingScope("build TLAS"):
                self._tlas_buffers = self._build_tlas_buffers(
                    scene.instance_transforms(frame)
                )
            self.timers.add(
                ProfilingMarker.BUILD_TLAS, (time.perf_counter() - t0) * 1e3
            )
            shade_flat = obj_flat
        else:
            self._tlas_buffers = None
            shade_flat = flat
        self._large_scene = (
            self._traversal == "gpu"
            and flat.num_tris >= _LARGE_SCENE_MIN_TRIS
        )
        self._brute_rows = None
        t0 = time.perf_counter()
        if self._use_two_level:
            # every two-level consumer traverses ds.tlas, never ds.bvh;
            # keep DeviceScene.bvh structurally present as a 1-tri dummy
            # (like the 1-texel atlas) instead of building + uploading a
            # world-flatten SAH BVH nothing reads — for a large
            # instanced scene that build dominated set_scene
            dz = np.zeros((1, 3), np.float32)
            self._topology = bvh_mod.build_bvh(
                dz, dz, dz, leaf_size=bvh_mod.LEAF_SIZE
            )
            self._bvh = bvh_mod.thread_bvh(self._topology, dz, dz, dz)
        else:
            with ProfilingScope("build BVH"):
                # static scenes get the binned-SAH builder (traversal
                # quality — the reference's PREFER_FAST_TRACE BLAS,
                # vulkanrt_utils.h:55-187); animated scenes keep the
                # fast Morton median split for per-frame rebuilds
                use_sah = not any(
                    a.num_animated
                    for a in getattr(self.scene, "animation_data", [])
                )
                builder = bvh_mod.build_bvh_sah if use_sah else bvh_mod.build_bvh
                self._topology = builder(
                    flat.v0, flat.e1, flat.e2, leaf_size=bvh_mod.LEAF_SIZE
                )
                self._bvh = bvh_mod.thread_bvh(
                    self._topology, flat.v0, flat.e1, flat.e2
                )
            # tiny scenes, on request only (RPTR_BRUTE=1): a fully-inlined
            # XLA Moller-Trumbore chain over every BVH row instead of a
            # kernel dispatch, so traversal fuses into the bounce shading
            # (ops/traverse_brute.py). Not measured on the GPU.
            tri_rows = self._bvh.tri_rows
            if (
                self._traversal == "gpu"
                and os.environ.get("RPTR_BRUTE") == "1"
                and tri_rows.shape[0] <= _BRUTE_MAX_ROWS
            ):
                self._brute_rows = tuple(
                    tuple(float(x) for x in tri_rows[k, 0:9])
                    for k in range(tri_rows.shape[0])
                )
        self.timers.add(ProfilingMarker.BUILD_BLAS, (time.perf_counter() - t0) * 1e3)

        self._flat = flat
        mat_table = scene.material_table()
        self._mat_table = mat_table

        tris, shading = _triangle_buffers(shade_flat)
        self._atlas = atlas_mod.build_atlas(scene.textures)
        if self._atlas is None:
            # dummy 1-texel atlas keeps DeviceScene a uniform pytree
            from realtimepathtracingresearchframework_tpu.models.texture import (
                Texture,
            )

            dummy = Texture(1, 1, 37, mips=[np.full((1, 1, 4), 255, np.uint8)])
            self._atlas = atlas_mod.build_atlas([dummy])
            self._has_textures = False
        else:
            self._has_textures = True
        # alpha-tested any-hit only when some textured material can cut
        from realtimepathtracingresearchframework_tpu.models.material import (
            BASE_MATERIAL_NOALPHA,
        )

        self._has_alpha = self._has_textures and any(
            m.base_color_tex >= 0 and not (m.flags & BASE_MATERIAL_NOALPHA)
            for m in scene.materials
        )
        # scene info: no material transmits (candidate for BSDF
        # specialization — see IntegratorConfig.has_transmission; currently
        # kept ON because dropping the dead ops perturbs XLA fusion enough
        # to break golden bit-parity)
        self._has_transmission = any(
            float(m.specular_transmission) > 0.0 for m in scene.materials
        )
        # THIN_TRANSMISSION_HIT materials (vulkan/CMakeLists.txt:38-39)
        from realtimepathtracingresearchframework_tpu.models.material import (
            BASE_MATERIAL_THIN,
        )

        self._has_thin = any(
            (m.flags & BASE_MATERIAL_THIN) for m in scene.materials
        )
        self._tris = tris
        self._shading = shading
        self._materials = MaterialBuffers.from_table(mat_table)
        self._upload_lights_and_sky(scene_config)
        self._scene_revision = scene.revision

    def _upload_lights_and_sky(self, scene_config: SceneConfig) -> None:
        """Binned-lights extension + sky update (render_binned_lights.cpp:68-87,
        render_sky.cpp:25-72)."""
        scene = self.scene
        tl = lights_mod.collect_emitters(self._flat, self._mat_table)

        # extensions contribute their device arrays here — the XLA
        # adaptation of the bind-point uploads in render_binned_lights.cpp
        # :68-87 / render_bn.cpp:77-122 (see backend/extensions.py)
        payload = {"emitters": tl, "use_bins": False}
        for ext in self.active_extensions():
            ext.contribute_scene_payload(payload, scene_config)
        tl = payload["emitters"]
        use_bins = bool(payload["use_bins"]) and tl.count > 0

        self._num_lights = tl.count
        if tl.count == 0:
            tl = lights_mod.empty_lights()
        lights = nee_mod.TriLightBuffers(
            v0=jnp.asarray(tl.v0),
            v1=jnp.asarray(tl.v1),
            v2=jnp.asarray(tl.v2),
            radiance=jnp.asarray(tl.radiance),
        )
        # sky cook cache: animation frames re-enter here with an
        # unchanged sun/turbidity — skip the Hosek spectral integration
        # (the reference cooks only on sun changes too, render_sky.cpp:25)
        sky_key = (
            tuple(np.asarray(scene_config.sun_dir, np.float32).tolist()),
            float(scene_config.turbidity),
            tuple(np.asarray(scene_config.albedo, np.float32).ravel().tolist()),
            self._num_lights > 0,
        )
        if getattr(self, "_sky_cache_key", None) == sky_key:
            sky = self._sky_cache
        else:
            sky = sky_mod.build_sky(
                scene_config.sun_dir,
                scene_config.turbidity,
                scene_config.albedo,
                has_area_lights=self._num_lights > 0,
            )
            self._sky_cache_key = sky_key
            self._sky_cache = sky
        self._use_bins = use_bins
        bvh_buffers = threaded_to_device(self._bvh)
        from realtimepathtracingresearchframework_tpu.ops.integrator import (
            pack_attr_table,
            pack_material_table,
        )

        self.device_scene = DeviceScene(
            bvh=bvh_buffers,
            tris=self._tris,
            shading=self._shading,
            materials=self._materials,
            lights=lights,
            sky=sky,
            atlas=self._atlas,
            # table-based variants get their buffers from the pointset
            # extensions; the LCG fallback needs no tables
            rng=payload.get(
                "rng", pointsets.build_rng_buffers(RNG_VARIANT_UNIFORM)
            ),
            tlas=self._tlas_buffers if getattr(self, "_use_two_level", False) else None,
            attr_packed=pack_attr_table(self._tris, self._shading),
            mat_packed=pack_material_table(self._materials),
        )
        if self._multi:
            # replicate the scene into every device's memory (SURVEY §5.8:
            # scene arrays + flattened BVH replicated per device)
            self._device_scenes = [
                jax.device_put(self.device_scene, d) for d in self.devices
            ]
        self._device_scene_revision += 1
        self._render_fns.clear()
        self._pass_fns.clear()
        self._wf_progs.clear()

    # ------------------------------------------------------------------
    # Frame lifecycle
    # ------------------------------------------------------------------

    def reset_accumulation(self) -> None:
        self.frame_id = 0

    def _tlas_dyn_kwargs(self, cfg, ds=None):
        """Per-call operands of a two-level pass program: the frame's
        TLAS side (integrator.tlas_frame_operands), so that a TLAS refit
        reuses the compiled program. Empty for single-level scenes."""
        if not cfg.two_level:
            return {}
        ds = ds or self.device_scene
        return dict(tlas_frame=tlas_frame_operands(ds.tlas))

    def _integrator_config(self, params: RenderParams) -> IntegratorConfig:
        # large scenes on the GPU traversal (_LARGE_SCENE_MIN_TRIS): carry
        # compaction, which sorts the whole carry and so subsumes the
        # per-dispatch closest-hit sort, and the NEE shadow-queue sort.
        # RPTR_COMPACT_LANES / RPTR_COMPACT = 1/0 force either sort.
        large = self._large_scene
        cl_env = os.environ.get("RPTR_COMPACT_LANES", "")
        compact_lanes = large if cl_env == "" else cl_env != "0"
        c_env = os.environ.get("RPTR_COMPACT", "")
        compact = large if c_env == "" else c_env != "0"
        return IntegratorConfig(
            max_path_depth=int(params.max_path_depth),
            light_bin_size=int(
                getattr(
                    self, "_effective_bin_size",
                    self.options.light_sampling_bucket_count,
                )
            ),
            use_light_bins=bool(self._use_bins),
            num_lights=int(self._num_lights),
            stack_depth=0,  # unused: threaded traversal is stackless
            enable_sun_sky=True,
            unroll=bool(self.options.unroll_bounces) and not compact_lanes
            # brute-rows scenes keep the dynamic bounce loop: the inlined
            # MT chain is ~35 ops/row per dispatch and XLA's fusion pass
            # goes superlinear on the 9x-unrolled elementwise graph
            and not getattr(self, "_brute_rows", None),
            traversal=self._traversal,
            has_textures=bool(self._has_textures),
            rng_variant=int(self.options.rng_variant),
            alpha_test=bool(getattr(self, "_has_alpha", False)),
            two_level=bool(getattr(self, "_use_two_level", False)),
            enable_dof=bool(self.options.enable_raytraced_dof)
            and float(params.aperture_radius) > 0.0,
            thin_transmission=bool(getattr(self, "_has_thin", False)),
            aniso_taps=int(self.options.aniso_taps)
            if not getattr(self, "_use_two_level", False) else 0,
            compact=compact and not compact_lanes,
            sort_shadows=large,
            compact_lanes=compact_lanes,
            brute_rows=tuple(getattr(self, "_brute_rows", None) or ()),
        )

    def render(self, config: FrameConfig, batch_spp: Optional[int] = None) -> RenderStats:
        """One full frame: begin/draw/end collapsed (app.cpp:453-467)."""
        params = config.params
        spp = int(batch_spp if batch_spp is not None else params.batch_spp)

        if self.active_variant in (VARIANT_RT_DEBUG, VARIANT_GBUFFER):
            return self._render_debug_variant(config)

        # camera-driven LoD: re-flatten + rebuild only when the selected
        # LoD set actually changes (integer signature — no thrash while
        # the camera stays within a level's distance band)
        if (
            self.scene is not None
            and getattr(self, "_lod_signature", None) is not None
        ):
            sc = config.scene_config or SceneConfig()
            sig = self.scene.lod_selection(
                np.asarray(config.camera.pos, np.float32),
                sc.lod_threshold,
                getattr(self, "_scene_frame", 0),
            )
            if sig != self._lod_signature:
                self._rebuild_scene(
                    sc, frame=getattr(self, "_scene_frame", 0),
                    camera_pos=np.asarray(config.camera.pos, np.float32),
                )
                self._pass_fns.clear()
                self._wf_progs.clear()
                self._render_fns.clear()
                self.reset_accumulation()

        # view/frame params are cached device arrays: every fresh
        # jnp.asarray/jnp.float32 here is a host->device transfer; the
        # camera rarely moves and only sample_offset changes per frame
        pos, du, dv, tl = config.camera.view_basis(self.fb_width, self.fb_height)
        vkey = (pos.tobytes(), du.tobytes(), dv.tobytes(), tl.tobytes())
        cached = getattr(self, "_view_cache", None)
        if cached is not None and cached[0] == vkey:
            view = cached[1]
        else:
            view = ViewBuffers(
                cam_pos=jnp.asarray(pos),
                cam_du=jnp.asarray(du),
                cam_dv=jnp.asarray(dv),
                cam_dir_top_left=jnp.asarray(tl),
            )
            self._view_cache = (vkey, view)
        sc_cfg = config.scene_config or SceneConfig()
        fkey = (
            params.rr_path_depth, params.glossy_only_mode,
            self.shot_offset, params.pixel_radius,
            sc_cfg.bump_scale, params.aperture_radius,
            params.focus_distance,
        )
        cached = getattr(self, "_fp_cache", None)
        if cached is not None and cached[0] == fkey:
            fp = cached[1]
        else:
            fp = FrameParams(
                rr_path_depth=jnp.int32(params.rr_path_depth),
                glossy_only_mode=jnp.int32(params.glossy_only_mode),
                sample_offset=jnp.uint32(0),
                shot_offset=jnp.uint32(self.shot_offset),
                bump_scale=jnp.float32(sc_cfg.bump_scale),
                aperture_radius=jnp.float32(params.aperture_radius),
                focus_distance=jnp.float32(params.focus_distance),
                pixel_radius=jnp.float32(params.pixel_radius),
            )
            self._fp_cache = (fkey, fp)
        # only the accumulation offset changes frame to frame: 1 transfer
        fp = fp._replace(sample_offset=jnp.uint32(self.frame_id))
        cfg = self._integrator_config(params)
        if self.active_variant == VARIANT_WAVEFRONT:
            cfg = cfg._replace(wavefront=True)

        self._aovs = None  # per-frame AOV cache for processing extensions
        self._last_config = config
        self._last_upscale = int(params.render_upscale_factor)
        self._frame_id_at_render = self.frame_id
        for ext in self.active_extensions():
            ext.preprocess()

        t0 = time.perf_counter()
        # host-dispatched chunk passes: each pass runs as its own device
        # program with the scene captured as constants (XLA layout quality
        # degrades when waves share a module or the scene arrives as a
        # parameter — see integrator.make_pass_fn)
        pkey = (cfg, self.fb_width, self.fb_height, self._device_scene_revision)

        fast = (
            params.reprojection_mode != REPROJECTION_MODE_ACCUMULATE
            and not self.options.enable_taa
            and int(params.render_upscale_factor) == 1
        )
        # shared get-or-create (multi-device: one pass program per device,
        # each capturing that device's scene replica — the host-dispatch
        # fast path scaled across devices). Skipped when the bounce-major
        # wavefront executor will render this frame — building the
        # monolithic loop program too would double the compile cost.
        if not (fast and self._use_wavefront_host(cfg)):
            pass_fn = self._get_or_make_pass_fn(pkey, cfg)
        if fast:
            # chunk-resident fast path: the pass programs accumulate the
            # progressive average IN PLACE (donated buffers), so the whole
            # frame is nothing but pass dispatches. Join/resolve/unswizzle
            # run lazily at readback.
            px_c, py_c, valid_c, _inv, nc, chunk = _swizzle_tables(
                self.fb_width, self.fb_height
            )
            ndev = len(self.devices)
            if self._multi:
                # chunk c renders on devices[c % ndev]: commit its swizzle
                # tables there once (cached per framebuffer size)
                skey = (self.fb_width, self.fb_height)
                cached = getattr(self, "_swz_multi", None)
                if cached is None or cached[0] != skey:
                    px_c = [
                        jax.device_put(px_c[c], self.devices[c % ndev])
                        for c in range(nc)
                    ]
                    py_c = [
                        jax.device_put(py_c[c], self.devices[c % ndev])
                        for c in range(nc)
                    ]
                    valid_c = [
                        jax.device_put(valid_c[c], self.devices[c % ndev])
                        for c in range(nc)
                    ]
                    self._swz_multi = (skey, px_c, py_c, valid_c)
                else:
                    _, px_c, py_c, valid_c = cached
                fp_dev = [jax.device_put(fp, d) for d in self.devices]
                view_dev = [jax.device_put(view, d) for d in self.devices]
            chunks_ok = (
                self._planar
                and self._acc_chunks is not None
                and len(self._acc_chunks) == nc
                and self._acc_chunks[0][0].shape == (chunk,)
            )
            if not chunks_ok:
                if self.frame_id > 0 and self._accum_img is not None:
                    # resume from an image-form history (checkpoint load /
                    # mode switch): re-swizzle on the host, then split
                    pl = image_to_planes(
                        np.asarray(self._accum_img),
                        self.fb_width,
                        self.fb_height,
                    )
                    self._acc_chunks = [
                        tuple(
                            jax.device_put(
                                jnp.asarray(pl[k, c * chunk:(c + 1) * chunk]),
                                self.devices[c % ndev],
                            )
                            for k in range(4)
                        )
                        for c in range(nc)
                    ]
                else:
                    self._acc_chunks = [
                        tuple(
                            jax.device_put(
                                jnp.zeros((chunk,), jnp.float32),
                                self.devices[c % ndev],
                            )
                            for _ in range(4)
                        )
                        for c in range(nc)
                    ]
            # DISCARD_HISTORY (postprocess/reprojection.h:11-18): each
            # frame stands alone — blend as if the accumulator were empty
            # (k starts at 0), which overwrites the previous frame
            discard = (
                params.reprojection_mode == REPROJECTION_MODE_DISCARD_HISTORY
            )
            base_k = 0 if discard else self.frame_id
            rays_l = []
            if self._use_wavefront_host(cfg):
                # bounce-major host wavefront (ops/wavefront_host.py):
                # the host manages ONE frame-global live-lane queue and
                # dispatches exact-ladder-width bounce programs; work
                # tracks the live population across the whole frame
                # instead of per-chunk power-of-two prefixes, and the
                # giant loop+switch monolith is replaced by small
                # per-bounce programs
                from realtimepathtracingresearchframework_tpu.ops import (
                    wavefront_host,
                )

                progs = self._wf_progs.get(pkey)
                if progs is None:
                    progs = wavefront_host.build_programs(
                        self.device_scene, cfg, self.fb_width, self.fb_height
                    )
                    self._wf_progs.clear()
                    self._wf_progs[pkey] = progs
                blend_base = jnp.uint32(base_k)
                for s in range(spp):
                    accs, nr, prof = wavefront_host.render_sample(
                        progs, fp, view, list(self._acc_chunks),
                        self._u32_const(s), blend_base,
                    )
                    self._acc_chunks = accs
                    rays_l.append(nr)
                self._wf_live_profile = prof
            elif self._multi:
                blend_dev = [
                    jax.device_put(jnp.uint32(base_k), d)
                    for d in self.devices
                ]
                extra_dev = [
                    self._tlas_dyn_kwargs(cfg, self._device_scenes[di])
                    for di in range(ndev)
                ]
                for s in range(spp):
                    for c in range(nc):
                        di = c % ndev
                        self._acc_chunks[c], nr = pass_fn[di](
                            fp_dev[di], view_dev[di], self._acc_chunks[c],
                            px_c[c], py_c[c], valid_c[c],
                            self._u32_const(s, di), blend_dev[di],
                            **extra_dev[di],
                        )
                        rays_l.append(nr)
            else:
                blend_base = jnp.uint32(base_k)
                extra = self._tlas_dyn_kwargs(cfg)
                for s in range(spp):
                    s_dev = self._u32_const(s)
                    for c in range(nc):
                        self._acc_chunks[c], nr = pass_fn(
                            fp, view, self._acc_chunks[c],
                            px_c[c], py_c[c], valid_c[c],
                            s_dev, blend_base, **extra,
                        )
                        rays_l.append(nr)
            self._fb_planes = None  # display resolve deferred to readback
            self._resolve_args = (
                jnp.float32(params.exposure),
                int(params.early_tone_mapping_mode),
            )
            self._planar = True
            # frames-in-flight: do NOT wait for completion here, so the
            # next frame's dispatch overlaps this frame's execution.
            # Timing follows the reference's delayed-timestamp design
            # (render_vulkan.cpp:1974-1977): sync every SYNC_INTERVAL
            # frames and amortize the window's wall clock into the
            # per-frame render time.
            self._last_rays = rays_l  # device scalars; summed lazily
            now = time.perf_counter()
            if not hasattr(self, "_win_t0"):
                # first fast-path frame likely paid the jit compile:
                # report its dispatch wall but exclude it from the window
                self._win_t0 = now
                self._frames_since_sync = 0
                self._timing_synced = False
                self._last_render_ms = (now - t0) * 1e3
            else:
                self._frames_since_sync += 1
                if self._frames_since_sync >= self.sync_interval:
                    jax.block_until_ready(self._acc_chunks)
                    self._last_render_ms = (
                        (time.perf_counter() - self._win_t0)
                        / self._frames_since_sync * 1e3
                    )
                    self._timing_synced = True
                    self._frames_since_sync = 0
                    self._win_t0 = time.perf_counter()
                elif not self._timing_synced:
                    # pre-first-sync: provisional dispatch wall
                    self._last_render_ms = (now - t0) * 1e3
            self.timers.add(ProfilingMarker.RENDERING, self._last_render_ms)
            self.timers.end_frame()
            if not self.freeze_frame:
                self.frame_id += spp
            return self.stats()

        new_accum, rays = render_tile_host(
            self.device_scene, cfg, fp, view, self.fb_width, self.fb_height,
            spp,
            # image-domain paths (TAA/reprojection/upscale) run single-
            # device: use the first device's pass program
            pass_fn=pass_fn[0] if self._multi else pass_fn,
            pass_kwargs=self._tlas_dyn_kwargs(cfg),
        )
        if self._planar:
            # leaving the planar fast path: image-domain history
            self.accum = self._materialize(self._acc_planes_lazy())

        if params.reprojection_mode == REPROJECTION_MODE_ACCUMULATE:
            # realtime resolve: reproject linear history by the motion AOV
            # with a bounded window (postprocess/reprojection.glsl)
            from realtimepathtracingresearchframework_tpu.ops import taa as taa_mod

            aovs = self._aovs = self.render_aovs(config)
            prev_accum = self.accum
            prev_depth = getattr(self, "_prev_depth", None)
            depth = aovs.normal_depth[..., 3]
            if prev_depth is None or self.frame_id == 0:
                self.accum = new_accum
            else:
                self.accum = taa_mod.reproject_and_accumulate(
                    new_accum,
                    prev_accum,
                    aovs.motion_jitter[..., :2],
                    depth,
                    prev_depth,
                    jnp.int32(params.spp_accumulation_window),
                    jnp.int32(self.frame_id),
                    jnp.int32(spp),
                )
            self._prev_depth = depth
        elif params.reprojection_mode == REPROJECTION_MODE_DISCARD_HISTORY:
            # each frame stands alone (postprocess/reprojection.h:11-18)
            self.accum = new_accum
        else:
            # progressive history average (process_samples.comp:116-131)
            self.accum = resolve_mod.accumulate_history(
                self.accum, new_accum, jnp.int32(self.frame_id), jnp.int32(spp)
            )
        t_res = time.perf_counter()
        self.framebuffer = resolve_mod.resolve_framebuffer(
            self.accum,
            jnp.float32(params.exposure),
            tonemap_mode=int(params.early_tone_mapping_mode),
            upscale=int(params.render_upscale_factor),
        )
        self.timers.add(
            ProfilingMarker.PROCESSING, (time.perf_counter() - t_res) * 1e3
        )

        if self.options.enable_taa:
            # TAA post pass via the processing-step extension
            # (vulkan/processing/process_taa.comp)
            from realtimepathtracingresearchframework_tpu.backend.extensions import (
                RenderProcessingStep,
            )

            taa_ext = self.get_processing_step(RenderProcessingStep.TAA)
            if taa_ext is not None and taa_ext.is_active_for(self.options):
                taa_ext.process()

        jax.block_until_ready(self.framebuffer)
        dt_ms = (time.perf_counter() - t0) * 1e3

        # keep the ray counter as a device scalar: int() here would block
        # the host on frame completion, serializing next-frame dispatch
        # with device execution (the reference keeps frames in flight)
        self._last_rays = rays
        self._last_render_ms = dt_ms
        self.timers.add(ProfilingMarker.RENDERING, dt_ms)
        self.timers.end_frame()
        if not self.freeze_frame:
            self.frame_id += spp

        return self.stats()

    # ------------------------------------------------------------------
    # Readbacks (render_vulkan.cpp:2250-2294)
    # ------------------------------------------------------------------

    def readback_framebuffer(self) -> np.ndarray:
        """Display framebuffer: sRGB-encoded (H*u, W*u, 4) float. On the
        planar fast path this is the host blit (swizzle reorder during
        readback, the display_native analogue)."""
        t0 = time.perf_counter()
        if self._planar:
            out = planes_to_image(
                self._planes_np(self._fb_planes_lazy()),
                self.fb_width,
                self.fb_height,
            )
        else:
            out = np.asarray(jax.block_until_ready(self.framebuffer))
        self.timers.add(
            ProfilingMarker.READBACK, (time.perf_counter() - t0) * 1e3
        )
        # a readback is a full completion barrier: fold the elapsed window
        # into the per-frame estimate (so per-frame-readback consumers
        # like the viewer get true completion timing) and restart it
        if self._frames_since_sync > 0 and hasattr(self, "_win_t0"):
            self._last_render_ms = (
                (time.perf_counter() - self._win_t0)
                / self._frames_since_sync * 1e3
            )
            self._timing_synced = True
        self._frames_since_sync = 0
        self._win_t0 = time.perf_counter()
        return out

    def readback_accumulation(self) -> np.ndarray:
        """Linear HDR accumulation buffer (H, W, 4) float — what validation
        mode saves (app_state.cpp:341-462 save paths use the linear image)."""
        if self._planar:
            return planes_to_image(
                self._planes_np(self._acc_planes_lazy()),
                self.fb_width,
                self.fb_height,
            )
        return np.asarray(jax.block_until_ready(self.accum))

    def _render_debug_variant(self, config: FrameConfig) -> RenderStats:
        """RT_DEBUG / GBUFFER computational raytracers (rt_debug.comp /
        gpu_programs.cmake:47): first-hit visualization from the AOV pass.
        RT_DEBUG shows shading normals (0.5n+0.5) with depth-based fade;
        GBUFFER shows albedo with roughness in alpha."""
        t0 = time.perf_counter()
        aovs = self.render_aovs(config)
        if self.active_variant == VARIANT_RT_DEBUG:
            n = aovs.normal_depth[..., :3]
            depth = aovs.normal_depth[..., 3:4]
            hit = depth < 1.0e16
            rgb = jnp.where(hit, n * 0.5 + 0.5, 0.0)
            fb = jnp.concatenate(
                [rgb, jnp.where(hit, 1.0, 0.0)], axis=-1
            )
        else:
            fb = aovs.albedo_roughness
        self.accum = fb
        self.framebuffer = fb
        self._last_render_ms = (time.perf_counter() - t0) * 1e3
        self._last_rays = self.fb_width * self.fb_height
        self.frame_id += 1
        return self.stats()

    def render_ray_stats(self, config: FrameConfig) -> np.ndarray:
        """Per-pixel traced-ray-count image for one sample — the
        REPORT_RAY_STATS readback (render_vulkan.h:87-91, .cpp:321-331).
        Returns (H, W) int32."""
        from realtimepathtracingresearchframework_tpu.ops.integrator import (
            render_ray_stats_host,
        )

        params = config.params
        pos, du, dv, tl = config.camera.view_basis(self.fb_width, self.fb_height)
        view = ViewBuffers(
            cam_pos=jnp.asarray(pos),
            cam_du=jnp.asarray(du),
            cam_dv=jnp.asarray(dv),
            cam_dir_top_left=jnp.asarray(tl),
        )
        fp = FrameParams(
            rr_path_depth=jnp.int32(params.rr_path_depth),
            glossy_only_mode=jnp.int32(params.glossy_only_mode),
            sample_offset=jnp.uint32(self.frame_id),
            shot_offset=jnp.uint32(self.shot_offset),
        )
        cfg = self._integrator_config(params)
        img = render_ray_stats_host(
            self.device_scene, cfg, fp, view, self.fb_width, self.fb_height
        )
        return np.asarray(img)

    def render_debug_image(self, config: FrameConfig) -> np.ndarray:
        """DEBUG_MODE heatmap image for one sample, selected by
        ``options.debug_mode`` (render_params.glsl.h:63-70): any-hit
        (alpha-test) evaluation counts over the full path / primary
        visibility only, or per-pixel bounce count — the debug_mode_buffer
        readback (hit.rchit:459-463). Returns (H, W) int32."""
        from realtimepathtracingresearchframework_tpu.ops.integrator import (
            render_debug_host,
        )

        if int(self.options.debug_mode) == 0:
            raise ValueError("options.debug_mode is DEBUG_MODE_OFF")
        params = config.params
        pos, du, dv, tl = config.camera.view_basis(self.fb_width, self.fb_height)
        view = ViewBuffers(
            cam_pos=jnp.asarray(pos),
            cam_du=jnp.asarray(du),
            cam_dv=jnp.asarray(dv),
            cam_dir_top_left=jnp.asarray(tl),
        )
        fp = FrameParams(
            rr_path_depth=jnp.int32(params.rr_path_depth),
            glossy_only_mode=jnp.int32(params.glossy_only_mode),
            sample_offset=jnp.uint32(self.frame_id),
            shot_offset=jnp.uint32(self.shot_offset),
        )
        cfg = self._integrator_config(params)._replace(
            debug_mode=int(self.options.debug_mode)
        )
        img = render_debug_host(
            self.device_scene, cfg, fp, view, self.fb_width, self.fb_height
        )
        return np.asarray(img)

    # ------------------------------------------------------------------
    # Checkpoint / resume (SURVEY §5.4: imstate persists config; the
    # accumulation state itself is explicitly checkpointable arrays)
    # ------------------------------------------------------------------

    def save_state(self, path: str) -> None:
        """Checkpoint the progressive render: accumulation buffer + sample
        bookkeeping. Config/camera state persists separately via imstate
        (the reference's auto-serialized ini, app.cpp:587-593)."""
        np.savez_compressed(
            path,
            accum=np.asarray(self.accum),
            frame_id=self.frame_id,
            shot_offset=self.shot_offset,
            fb_width=self.fb_width,
            fb_height=self.fb_height,
        )

    def load_state(self, path: str) -> None:
        """Resume a checkpointed accumulation; render() continues adding
        samples from frame_id with identical results to an uninterrupted
        run (the RNG seeds on sample_offset = frame_id)."""
        with np.load(path) as z:
            w, h = int(z["fb_width"]), int(z["fb_height"])
            if (w, h) != (self.fb_width, self.fb_height):
                self.initialize(w, h)
            self.accum = jnp.asarray(z["accum"])
            self.frame_id = int(z["frame_id"])
            self.shot_offset = int(z["shot_offset"])
        self.framebuffer = resolve_mod.resolve_framebuffer(
            self.accum, jnp.float32(0.0), tonemap_mode=0, upscale=1
        )

    def last_frame_rays(self) -> int:
        """Total rays traced by the last frame. BLOCKS on the device
        counter — call only outside the hot frame loop (the counter is
        kept device-side so frames stay in flight)."""
        lr = self._last_rays
        if isinstance(lr, list):
            return sum(int(x) for x in lr)
        return int(lr)

    def stats(self, force_rays: bool = False) -> RenderStats:
        """MemoryStatistics analogue (vulkan_utils.h:94-104,
        render_vulkan.cpp:2229-2243): current/peak/total device bytes from
        the runtime allocator where the platform exposes them.

        ``rays_per_second`` is -1 unless ``force_rays`` (matching the
        reference default, render_vulkan.cpp:2234): converting the
        device-side ray counter is a blocking readback that would
        serialize the frame pipeline. Memory stats refresh every 16
        frames."""
        cached = getattr(self, "_mem_stats_cache", None)
        if force_rays or cached is None or self.frame_id - cached[0] >= 16:
            mem = peak = total = 0
            try:
                stats = self.device.memory_stats()
                if stats:
                    mem = stats.get("bytes_in_use", 0)
                    peak = stats.get("peak_bytes_in_use", mem)
                    total = stats.get("bytes_limit", 0)
            except Exception:
                pass
            self._mem_stats_cache = (self.frame_id, mem, peak, total)
        _, mem, peak, total = self._mem_stats_cache
        rps = (
            self.last_frame_rays() / (self._last_render_ms * 1e-3)
            if force_rays and self._last_render_ms > 0
            else -1.0
        )
        return RenderStats(
            render_time=self._last_render_ms,
            spp=self.frame_id,
            rays_per_second=rps,
            device_bytes_currently_allocated=mem,
            max_device_bytes_allocated=peak,
            total_device_bytes=total,
        )

    # ------------------------------------------------------------------
    # Ray queries (render_vulkan.cpp:430-455, 1867-1877)
    # ------------------------------------------------------------------

    def render_ray_queries(self, origins: np.ndarray, dirs: np.ndarray,
                           t_max=None, variant: Optional[str] = None,
                           spp_per_query: int = 1,
                           params: Optional[RenderParams] = None):
        """Ray-query API (render_vulkan.cpp:430-455, 1867-1877).

        Default (``variant`` None or RQ_CLOSEST): closest-hit queries
        (vulkan/rt_intersect.comp:31-68) returning (t, tri_index, u, v)
        arrays with tri_index -1 on miss.

        With an integrator variant (e.g. PT_MEGAKERNEL): dispatches the
        FULL active integrator over the query buffer with
        ``spp_per_query`` samples per query — the denoiser-training
        radiance capture path (pt_megakernel.glsl:276-283, progressive
        per-query accumulation accumulate.glsl:31-42). Queries map onto a
        virtual sqrt screen square for RNG/pixel locality
        (render_vulkan.cpp:3050-3056). Returns an (N, 4) float32 RGBA
        result (alpha 1 where the primary segment hit anything)."""
        if variant not in (None, VARIANT_RQ_CLOSEST):
            return self._render_integrator_queries(
                origins, dirs, t_max, variant, spp_per_query, params
            )
        ds = self.device_scene
        t_max_arr = (
            jnp.asarray(t_max, jnp.float32)
            if t_max is not None
            else jnp.full((len(origins),), 2.0e32, jnp.float32)
        )
        if self._use_two_level:
            from realtimepathtracingresearchframework_tpu.ops import (
                tlas as tlas_mod,
            )

            hit = tlas_mod.closest_hit_two_level(
                ds.tlas,
                jnp.asarray(origins, jnp.float32),
                jnp.asarray(dirs, jnp.float32),
                t_max=t_max_arr,
            )
        elif self._traversal == "gpu":
            hit = traverse_gpu.closest_hit_gpu(
                ds.bvh,
                jnp.asarray(origins, jnp.float32),
                jnp.asarray(dirs, jnp.float32),
                t_max=t_max_arr,
            )
        else:
            hit = closest_hit_threaded(
                ds.bvh,
                jnp.asarray(origins, jnp.float32),
                jnp.asarray(dirs, jnp.float32),
                t_max=t_max_arr,
            )
        return (
            np.asarray(hit.t),
            np.asarray(hit.tri),
            np.asarray(hit.u),
            np.asarray(hit.v),
        )

    def _render_integrator_queries(self, origins, dirs, t_max, variant,
                                   spp_per_query: int,
                                   params: Optional[RenderParams]):
        """Full-integrator ray queries (render_vulkan.cpp:1867-1877)."""
        import math

        from realtimepathtracingresearchframework_tpu.ops.integrator import (
            trace_paths,
        )
        from realtimepathtracingresearchframework_tpu.ops import vec3 as v3

        if variant not in self.variants():
            raise ValueError(f"unknown variant {variant!r}")
        params = params or RenderParams()
        cfg = self._integrator_config(params)._replace(
            wavefront=variant == VARIANT_WAVEFRONT
        )
        n = len(origins)
        side = max(int(math.ceil(math.sqrt(n))), 1)
        pad = (-n) % 256 if n > 256 else (-n) % 8

        def padv(a, fill):
            a = np.asarray(a, np.float32)
            if pad == 0:
                return a
            shape = (pad,) + a.shape[1:]
            return np.concatenate([a, np.full(shape, fill, np.float32)])

        o = padv(origins, 0.0)
        d = padv(dirs, 1.0)
        tmax_in = (
            np.broadcast_to(np.asarray(t_max, np.float32), (n,))
            if t_max is not None else np.full((n,), 2.0e32, np.float32)
        )
        tmax = jnp.asarray(padv(tmax_in, 0.0))
        n_pad = n + pad
        valid = jnp.asarray(np.arange(n_pad) < n)
        idx = np.arange(n_pad, dtype=np.uint32)
        px = jnp.asarray(idx % side)
        py = jnp.asarray(idx // side)
        ro = v3.Vec3(*(jnp.asarray(o[:, k]) for k in range(3)))
        rd = v3.Vec3(*(jnp.asarray(d[:, k]) for k in range(3)))
        fp_base = FrameParams(
            rr_path_depth=jnp.int32(params.rr_path_depth),
            glossy_only_mode=jnp.int32(params.glossy_only_mode),
            sample_offset=jnp.uint32(0),
            shot_offset=jnp.uint32(self.shot_offset),
        )
        ds = self.device_scene

        @jax.jit
        def one_sample(s):
            fp = fp_base._replace(sample_offset=jnp.uint32(s))
            state = pointsets.make_state(
                cfg.rng_variant, jnp.uint32(s), fp.shot_offset, px, py, side,
                bufs=ds.rng,
            )
            # query rays replace the camera stage; their tmax rides the
            # lane mask (dead past segment end like the reference's
            # t_max'd primary segment)
            illum, alpha, _ = trace_paths(
                ds, cfg, fp, ro, rd, state,
                lane_mask=valid & (tmax > 0.0),
                t_max0=tmax if t_max is not None else None,
            )
            return jnp.stack(
                [illum.x, illum.y, illum.z, alpha], axis=-1
            )

        acc = None
        for s in range(max(int(spp_per_query), 1)):
            res = one_sample(jnp.uint32(s))
            # progressive per-query average (accumulate.glsl:33-35)
            acc = res if acc is None else acc + (res - acc) / (s + 1.0)
        return np.asarray(acc)[:n]

    # ------------------------------------------------------------------
    # Dynamic scenes: animation + acceleration-structure refit
    # (the TLAS rebuild/refit request queue analogue,
    #  render_vulkan.cpp:1219-1366; public-release rptr ships the refit
    #  machinery but not animation playback — we support both)
    # ------------------------------------------------------------------

    def set_animation_frame(self, frame: int,
                            scene_config: Optional[SceneConfig] = None) -> None:
        """Re-pose instances at an animation frame. Same topology -> the
        acceleration structure is REFIT (AABBs recomputed over the same
        tree, vulkanrt_utils.h:92-101) unless force_bvh_rebuild or the
        triangle count is within rebuild_triangle_budget, in which case a
        full rebuild keeps quality (render_vulkan.cpp:472-545 budget).

        ``scene_config`` defaults to the one from set_scene — animating
        must not silently reset a custom sun/turbidity."""
        if scene_config is None:
            scene_config = getattr(self, "_scene_config", None) or SceneConfig()
        scene = self.scene
        if getattr(self, "_use_two_level", False):
            # two-level fast path: only the instance-count TLAS is rebuilt
            # (the reference's per-frame TLAS update, render_vulkan.cpp:1219)
            # — no host reflatten, no triangle-level BVH work
            t0 = time.perf_counter()
            with ProfilingScope("update TLAS"):
                self._tlas_buffers = self._build_tlas_buffers(
                    scene.instance_transforms(frame)
                )
            self.timers.add(
                ProfilingMarker.UPDATE_TLAS, (time.perf_counter() - t0) * 1e3
            )
            self.device_scene = self.device_scene._replace(
                tlas=self._tlas_buffers
            )
            if self._multi:
                # refresh ONLY the TLAS side of each device's replica —
                # without this, multi-device renders keep frame-0
                # instance transforms forever
                self._device_scenes = [
                    ds._replace(tlas=jax.device_put(self._tlas_buffers, d))
                    for ds, d in zip(self._device_scenes, self.devices)
                ]
            # the pass programs take every refit-dependent array as a call
            # operand (make_pass_fn's ``tlas_frame``) and stay valid: a
            # per-frame TLAS update costs no retrace, like the reference's
            # TLAS update queue (render_vulkan.cpp:1219-1366). TLAS and
            # instance-table shapes are frame-invariant (same instances).
            self._scene_frame = frame
            self._render_fns.clear()
            self.reset_accumulation()
            return
        # LoD scenes: the flatten must reuse the selection the topology
        # was built over (same camera/threshold), or the refit would pair
        # new vertex arrays with mismatched leaf/row indices; if the new
        # frame itself changes the selection, refit is invalid — rebuild
        lod_cam = getattr(self, "_lod_camera_pos", None)
        lod_thr = getattr(
            self, "_lod_threshold", scene_config.lod_threshold
        )
        if scene.has_lod_groups():
            sig = scene.lod_selection(lod_cam, lod_thr, frame)
            if sig != getattr(self, "_lod_signature", None):
                self._rebuild_scene(
                    scene_config, frame=frame, camera_pos=lod_cam
                )
                self._pass_fns.clear()
                self._wf_progs.clear()
                self._render_fns.clear()
                self.reset_accumulation()
                return
        with ProfilingScope("animate flatten"):
            flat = scene.flatten_world(
                frame=frame, camera_pos=lod_cam, lod_threshold=lod_thr
            )
        rebuild = (
            self.options.force_bvh_rebuild
            or flat.num_tris <= self.options.rebuild_triangle_budget
        )
        t0 = time.perf_counter()
        if rebuild:
            self._topology = bvh_mod.build_bvh(
                flat.v0, flat.e1, flat.e2, leaf_size=self._bvh.leaf_size
            )
            marker = ProfilingMarker.BUILD_TLAS
        else:
            self._topology = bvh_mod.refit_bvh(
                self._topology, flat.v0, flat.e1, flat.e2
            )
            marker = ProfilingMarker.UPDATE_TLAS
        self._bvh = bvh_mod.thread_bvh(
            self._topology, flat.v0, flat.e1, flat.e2
        )
        self.timers.add(marker, (time.perf_counter() - t0) * 1e3)

        self._flat = flat
        self._tris, self._shading = _triangle_buffers(flat)
        self._upload_lights_and_sky(scene_config)
        # keep the render loop's LoD bookkeeping on the posed frame —
        # otherwise a camera-triggered rebuild would revert the pose
        self._scene_frame = frame
        self.reset_accumulation()

    def render_raster_gbuffer(self, config: FrameConfig):
        """Optional raster G-buffer path (the ENABLE_RASTER pipeline,
        vulkan/pipeline_raster/raster_scene_vulkan.cpp + basic.vert/frag):
        z-buffered albedo/normal/depth/tri-id without ray tracing — a
        debug/compat surface rasterized as dense array math (ops/raster.py)."""
        from realtimepathtracingresearchframework_tpu.ops import raster

        pos, du, dv, tl = config.camera.view_basis(self.fb_width, self.fb_height)
        flat = self._flat
        return raster.raster_gbuffer(
            jnp.asarray(flat.v0), jnp.asarray(flat.e1), jnp.asarray(flat.e2),
            jnp.asarray(flat.n0), jnp.asarray(flat.n1), jnp.asarray(flat.n2),
            self.device_scene.materials.base_color,
            jnp.asarray(flat.material_id, jnp.int32),
            jnp.asarray(pos), jnp.asarray(du), jnp.asarray(dv),
            jnp.asarray(tl),
            self.fb_width, self.fb_height,
        )

    # AOV buffer indices (util/display/render_graphic.h:12-18)
    AOV_ALBEDO_ROUGHNESS = 0
    AOV_NORMAL_DEPTH = 1
    AOV_MOTION_JITTER = 2

    def render_aovs(self, config: FrameConfig):
        """First-hit AOV pass (ENABLE_AOV_BUFFERS analogue); caches the
        previous frame's view for motion vectors."""
        from realtimepathtracingresearchframework_tpu.ops.aov import render_aovs

        params = config.params
        pos, du, dv, tl = config.camera.view_basis(self.fb_width, self.fb_height)
        view = ViewBuffers(
            cam_pos=jnp.asarray(pos),
            cam_du=jnp.asarray(du),
            cam_dv=jnp.asarray(dv),
            cam_dir_top_left=jnp.asarray(tl),
        )
        prev_view = getattr(self, "_prev_view", None)
        if prev_view is None:
            prev_view = view
        fp = FrameParams(
            rr_path_depth=jnp.int32(params.rr_path_depth),
            glossy_only_mode=jnp.int32(params.glossy_only_mode),
            sample_offset=jnp.uint32(self.frame_id),
            shot_offset=jnp.uint32(self.shot_offset),
        )
        cfg = self._integrator_config(params)
        aovs = render_aovs(
            self.device_scene, cfg, fp, view, prev_view, self.fb_width, self.fb_height
        )
        self._prev_view = view
        self._aovs = aovs
        return aovs

    def readback_aov(self, aov_index: int) -> np.ndarray:
        """readback_aov analogue (render_graphic.h:40)."""
        aovs = getattr(self, "_aovs", None)
        if aovs is None:
            raise RuntimeError("render_aovs() has not been called")
        arr = [aovs.albedo_roughness, aovs.normal_depth, aovs.motion_jitter][aov_index]
        return np.asarray(jax.block_until_ready(arr))

    # rendering-core modules eligible for hot reload, in dependency order
    # (leaves first). The analogue of the reference's shader-source dep
    # staleness check + glslc recompile (gpu_programs.cpp:180-229).
    _HOT_RELOAD_MODULES = (
        "ops.vec3", "ops.rng", "ops.sobol", "ops.pointsets",
        "ops.smallgather", "ops.texture_atlas", "ops.bsdf_gltf",
        "ops.nee", "ops.resolve", "ops.aov", "ops.taa",
        "ops.traverse", "ops.traverse_brute", "ops.traverse_gpu",
        "ops.raysort", "ops.tlas", "ops.integrator",
    )

    def hot_reload(self) -> None:
        """Reload edited rendering-core Python modules, then drop all
        compiled pipelines so the next frame traces the NEW bytecode
        (render_vulkan.cpp:2646-2648; staleness-checked source recompile
        like gpu_programs.cpp:180-229). Modules are reloaded in
        dependency order only when their source mtime is newer than the
        loaded module, and the few integrator symbols this module binds
        by name are rebound afterwards."""
        import importlib
        import sys

        pkg = "realtimepathtracingresearchframework_tpu"
        stale = False
        for rel in self._HOT_RELOAD_MODULES:
            name = f"{pkg}.{rel}"
            mod = sys.modules.get(name)
            if mod is None or not getattr(mod, "__file__", None):
                continue
            try:
                src_mtime = os.path.getmtime(mod.__file__)
            except OSError:
                continue
            loaded = getattr(mod, "__hot_mtime__", None)
            if loaded is None and not stale:
                mod.__hot_mtime__ = src_mtime
                continue
            if stale or (loaded is not None and src_mtime > loaded):
                importlib.reload(mod)
                mod.__hot_mtime__ = os.path.getmtime(mod.__file__)
                stale = True  # reload everything downstream of an edit
        if stale:
            integ = sys.modules[f"{pkg}.ops.integrator"]
            g = globals()
            for sym in (
                "DeviceScene", "FrameParams", "IntegratorConfig",
                "MaterialBuffers", "ShadingBuffers", "ViewBuffers",
                "_swizzle_tables", "image_to_planes", "make_pass_fn",
                "planes_to_image", "render_tile", "render_tile_host",
            ):
                g[sym] = getattr(integ, sym)
        self._render_fns.clear()
        self._pass_fns.clear()
        self._wf_progs.clear()
