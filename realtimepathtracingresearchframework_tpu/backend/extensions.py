"""RenderExtension framework: the backend's extensibility surface.

Equivalent of ``RenderExtension``
(librender/render_backend.h:126-154) plus the processing-step enum and
factory (render_vulkan_extensions.cpp:16-84). Lifecycle hooks keep the
reference names and call order:

  initialize -> load_resources -> update_scene_from_backend ->
  [per frame] is_active_for / normalize_options / configure_for ->
  preprocess -> (render) -> process

One adaptation for the XLA model: where a Vulkan extension uploads
resources to bind points that pipelines read later (render_bn.cpp:77-122,
render_binned_lights.cpp:68-87), an XLA "upload" means contributing
arrays to the immutable DeviceScene pytree before the render closures
capture it. Extensions do that in ``contribute_scene_payload``, which the
renderer calls while assembling the device scene; the standard lifecycle
hooks drive when those contributions are recomputed.
"""

from __future__ import annotations

import enum
import time
from typing import Dict, List, Optional

import numpy as np

from realtimepathtracingresearchframework_tpu.backend.params import (
    LIGHT_SAMPLING_VARIANT_RIS,
    RNG_VARIANT_BN,
    RNG_VARIANT_SOBOL,
    RNG_VARIANT_Z_SBL,
    RenderBackendOptions,
)
from realtimepathtracingresearchframework_tpu.utils.profiling import (
    ProfilingMarker,
)


class RenderExtension:
    """Base lifecycle (librender/render_backend.h:126-154)."""

    def __init__(self, backend):
        self.backend = backend
        self.last_initialized_generation: Optional[int] = None
        self.mute_flag = False

    # -- identity / setup ------------------------------------------------
    def name(self) -> str:
        raise NotImplementedError

    def initialize(self, fb_width: int, fb_height: int) -> None:
        """Called after backend initialize (and on reinitialize)."""

    def load_resources(self, resource_dir: str) -> None:
        """Load external resources (tables, tiles, weights)."""

    def ui_and_state(self, state) -> bool:
        """Expose UI/persistent state; True = render restart required."""
        return False

    def variant_names(self) -> Optional[List[str]]:
        return None

    def variant_index(self, name: str) -> int:
        return 0

    # -- scene ------------------------------------------------------------
    def update_scene_from_backend(self, scene) -> None:
        """Called after set_scene on the backend."""

    def contribute_scene_payload(self, payload: Dict, scene_config) -> None:
        """Counterpart of the bind-point upload: add arrays to the
        DeviceScene assembly (see module docstring)."""

    # -- options ----------------------------------------------------------
    def is_active_for(self, rbo: RenderBackendOptions) -> bool:
        return not self.mute_flag

    def normalize_options(self, rbo: RenderBackendOptions) -> RenderBackendOptions:
        """Clamp/adjust options to what this extension supports."""
        return rbo

    def configure_for(self, rbo: RenderBackendOptions, available=None) -> bool:
        return True

    # -- per-frame --------------------------------------------------------
    def preprocess(self, variant_idx: int = 0) -> None:
        """Before the frame's render dispatches (app.cpp:454-456)."""

    def process(self, variant_idx: int = 0) -> None:
        """After resolve — post passes (app.cpp:487-521)."""

    def release_mapped_display_resources(self) -> None:
        pass

    def release_mapped_scene_resources(self, scene=None) -> None:
        pass


class RenderProcessingStep(enum.Enum):
    """render_backend.h:160-176 RENDER_PROCESSING_STEPS."""

    TAA = "TAA"
    EXAMPLE = "Example"
    UBER_POST = "UberPost"
    PROFILING_TOOLS = "ProfilingTools"
    DEPTH_OF_FIELD = "DepthOfField"
    OIDN2 = "OIDN2"
    DL_DENOISING = "DLDenoising"
    RESTIR = "ReStir"


# ---------------------------------------------------------------------------
# Pointset extensions (vulkan/pointsets/render_bn.cpp, render_sobol.cpp)
# ---------------------------------------------------------------------------


class PointsetsExtension(RenderExtension):
    """Uploads RNG pointset tables for one family of rng variants. BN and
    Sobol are separate extensions like the reference's; each contributes
    the rng buffers only when its variant is selected
    (render_bn.cpp:59-61)."""

    VARIANTS: tuple = ()

    def contribute_scene_payload(self, payload, scene_config) -> None:
        from realtimepathtracingresearchframework_tpu.ops import pointsets

        payload["rng"] = pointsets.build_rng_buffers(
            self.backend.options.rng_variant
        )

    def is_active_for(self, rbo: RenderBackendOptions) -> bool:
        return not self.mute_flag and rbo.rng_variant in self.VARIANTS


class BlueNoisePointsetsExtension(PointsetsExtension):
    VARIANTS = (RNG_VARIANT_BN,)

    def name(self) -> str:
        return "bn pointsets"


class SobolPointsetsExtension(PointsetsExtension):
    VARIANTS = (RNG_VARIANT_SOBOL, RNG_VARIANT_Z_SBL)

    def name(self) -> str:
        return "sobol pointsets"


# ---------------------------------------------------------------------------
# Binned lights (vulkan/light_sampling/render_binned_lights.cpp)
# ---------------------------------------------------------------------------


class BinnedLightsExtension(RenderExtension):
    """Builds equal-weight RIS light bins on scene load / options change
    and uploads the TriLightData array (render_binned_lights.cpp:68-87);
    active iff light_sampling_variant == RIS (:58-60)."""

    def name(self) -> str:
        return "binned lights"

    def is_active_for(self, rbo: RenderBackendOptions) -> bool:
        return (
            not self.mute_flag
            and rbo.light_sampling_variant == LIGHT_SAMPLING_VARIANT_RIS
        )

    def normalize_options(self, rbo: RenderBackendOptions) -> RenderBackendOptions:
        from dataclasses import replace

        n = max(1, int(rbo.light_sampling_bucket_count))
        if n != rbo.light_sampling_bucket_count:
            rbo = replace(rbo, light_sampling_bucket_count=n)
        return rbo

    def contribute_scene_payload(self, payload, scene_config) -> None:
        from realtimepathtracingresearchframework_tpu.models import (
            lights as lights_mod,
        )

        tl = payload.get("emitters")
        if tl is None or tl.count == 0:
            return
        # clamp the bin width to the real emitter count: a 16-slot bin
        # holding 2 lights + 14 zero-radiance pads selects identically
        # (zero scores never win) but pays 8x the RIS scoring math per
        # shadow-ray candidate
        bs = min(
            int(self.backend.options.light_sampling_bucket_count),
            max(int(tl.count), 1),
        )
        payload["emitters"] = lights_mod.equalize_emitter_bins(tl, bs)
        payload["use_bins"] = True
        payload["bin_size"] = bs
        self.backend._effective_bin_size = bs


# ---------------------------------------------------------------------------
# TAA processing step (vulkan/processing/process_taa.comp)
# ---------------------------------------------------------------------------


class TAAExtension(RenderExtension):
    """Post-resolve temporal AA over render target + history + motion
    (process_taa.cpp:93-136). Holds the history framebuffer."""

    def __init__(self, backend):
        super().__init__(backend)
        self._history = None

    def name(self) -> str:
        return "TAA"

    def is_active_for(self, rbo: RenderBackendOptions) -> bool:
        return not self.mute_flag and rbo.enable_taa

    def initialize(self, fb_width: int, fb_height: int) -> None:
        self._history = None

    def process(self, variant_idx: int = 0) -> None:
        import jax.numpy as jnp

        from realtimepathtracingresearchframework_tpu.ops import taa as taa_mod

        r = self.backend
        aovs = r.last_aovs()
        if aovs is None:
            return
        hist = self._history
        if hist is None or r.frame_id_at_last_render() == 0:
            hist = r.framebuffer
        up = r.last_upscale()
        motion = aovs.motion_jitter[..., :2]
        if up > 1:
            motion = jnp.repeat(jnp.repeat(motion, up, axis=0), up, axis=1)
        t0 = time.perf_counter()
        r.framebuffer = taa_mod.taa_resolve(r.framebuffer, hist, motion)
        r.timers.add(ProfilingMarker.TAA, (time.perf_counter() - t0) * 1e3)
        self._history = r.framebuffer


# ---------------------------------------------------------------------------
# Example processing step (vulkan/processing/process_example.*)
# ---------------------------------------------------------------------------


class ExampleExtension(RenderExtension):
    """The ENABLE_EXAMPLES processing step (processing/example.comp):
    squares + tints the accumulation buffer, fades it toward a warm floor
    by screen height, and composites an animated escape-time fractal
    background where alpha < 1 (example.comp:19-57). The template for
    new post passes."""

    def name(self) -> str:
        return "example"

    def process(self, variant_idx: int = 0) -> None:
        import jax.numpy as jnp

        r = self.backend
        acc = r.accum
        if acc is None:
            return
        h, w = acc.shape[0], acc.shape[1]
        t = float(getattr(r, "frame_id", 0)) / 60.0  # view_params.time
        rgb = acc[..., :3]
        a = acc[..., 3:4]
        rgb = rgb * rgb * (0.5 * jnp.asarray([0.7, 0.3, 0.1], acc.dtype))
        yfrac = (jnp.arange(h, dtype=acc.dtype) / h)[:, None, None]
        rgb = (
            jnp.asarray([0.1, 0.005, 0.0], acc.dtype) * (0.1 + 0.9 * yfrac)
            + rgb * (0.9 - 0.9 * yfrac)
        )
        # test_background (example.comp:19-37): rotated-quadratic escape set
        ix = (jnp.arange(w, dtype=acc.dtype) + 0.0) / w
        iy = (jnp.arange(h, dtype=acc.dtype) + 0.0) / h
        px = (2.0 * ix[None, :] - 1.0) * (w / h)
        py = -2.0 * iy[:, None] + 1.0 + jnp.zeros_like(px)
        yterm = 0.2 * jnp.clip(-py / 0.5, 0.0, 1.0)
        qx = 0.0123 * px - 1.156
        qy = 0.0123 * py + 0.2735
        ax = jnp.zeros_like(qx)
        ay = jnp.zeros_like(qy)
        for i in range(30):
            ang = 0.0001 * i * np.cos(3.7 * t)
            c, sn = np.cos(ang), np.sin(ang)
            rx = c * ax + sn * ay
            ry = -sn * ax + c * ay
            ax = rx * rx - ry * ry + qx + rx
            ay = 2.0 * rx * ry + qy + ry
            # bound divergence: GLSL tolerates inf here because the f=0
            # multiply happens on hardware that flushes; keep finite
            ax = jnp.clip(ax, -1e6, 1e6)
            ay = jnp.clip(ay, -1e6, 1e6)
        f = (jnp.sqrt(ax * ax + ay * ay) <= 4.0).astype(acc.dtype)
        bg = jnp.stack(
            [
                f * (0.55 + 0.45 * jnp.cos(ax + 0.433 * t)),
                f * jnp.sin(ay + 1.3 * t),
                ax * f + yterm,
            ],
            axis=-1,
        )
        bg = jnp.maximum(bg, 0.0)
        blend = jnp.clip(a, 0.0, 1.0)
        use_bg = (a >= 0.0) & (a < 1.0)
        rgb = jnp.where(use_bg, bg * (1 - blend) + rgb * blend, rgb)
        r.accum = jnp.concatenate([rgb, a], axis=-1)


# ---------------------------------------------------------------------------
# Profiling tools (vulkan/processing/process_profiling_tools.*)
# ---------------------------------------------------------------------------


class ProfilingToolsExtension(RenderExtension):
    """32-frame stabilized per-marker timings + benchmark CSV columns
    (process_profiling_tools.h:26-43, csv hookup :61-62). Reads the
    backend's DeviceTimers sliding window."""

    CSV_MARKERS = (
        ProfilingMarker.BUILD_BLAS,
        ProfilingMarker.BUILD_TLAS,
        ProfilingMarker.RENDERING,
        ProfilingMarker.PROCESSING,
        ProfilingMarker.TAA,
        ProfilingMarker.READBACK,
    )

    def name(self) -> str:
        return "profiling tools"

    # BenchmarkCSVSource protocol (app/benchmark.py)
    def csv_header(self) -> List[str]:
        cols = []
        for m in self.CSV_MARKERS:
            base = m.value.lower().replace(" ", "_")
            cols += [f"{base}_avg_ms", f"{base}_min_ms", f"{base}_max_ms",
                     f"{base}_stddev_ms"]
        return cols

    def csv_values(self) -> List[float]:
        vals: List[float] = []
        for m in self.CSV_MARKERS:
            avg, mn, mx, sd = self.backend.timers.window_stats(m)
            vals += [avg, mn, mx, sd]
        return vals


# ---------------------------------------------------------------------------
# Factory (render_vulkan_extensions.cpp:16-84)
# ---------------------------------------------------------------------------


def create_default_extensions(backend) -> List[RenderExtension]:
    """create_default_extensions (render_vulkan_extensions.cpp:16-25):
    pointsets + light-sampling extensions."""
    return [
        BlueNoisePointsetsExtension(backend),
        SobolPointsetsExtension(backend),
        BinnedLightsExtension(backend),
    ]


_STEP_FACTORIES = {
    RenderProcessingStep.TAA: TAAExtension,
    RenderProcessingStep.EXAMPLE: ExampleExtension,
    RenderProcessingStep.PROFILING_TOOLS: ProfilingToolsExtension,
}


def create_processing_step(backend, step: RenderProcessingStep):
    """create_processing_step (render_vulkan_extensions.cpp:37-68);
    returns None for steps not available in this build (the reference
    compiles those out: UberPost/DoF/OIDN*/ReStir are enum+factory stubs
    whose sources are absent from the public release)."""
    cls = _STEP_FACTORIES.get(step)
    return cls(backend) if cls is not None else None
