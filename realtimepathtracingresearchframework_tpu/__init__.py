"""Real-time path tracing research framework in JAX.

A ground-up rebuild of the capabilities of
intel/RealTimePathTracingResearchFramework ("rptr"): instead of Vulkan
ray-tracing pipelines and GLSL megakernels, rendering is expressed as
jitted JAX/XLA programs (with a Pallas-Triton BVH traversal kernel on the
GPU) over flattened, device-resident scene and BVH arrays, scaled across
devices with ``jax.sharding`` meshes.

Layer map (mirrors SURVEY.md section 1):
  - ``utils``    : image IO, profiling, logging, stats      (reference: util/)
  - ``models``   : scene/mesh/material/lights/camera/sky    (reference: librender/, ext/libvkr)
  - ``ops``      : device kernels - BVH, traversal, BSDFs,
                   RNG pointsets, NEE, integrators, resolve (reference: rendering/, vulkan/*.glsl)
  - ``backend``  : renderer + options/params system         (reference: librender/render_backend.*)
  - ``parallel`` : multi-device tile sharding               (new axis; reference is single-GPU)
  - ``app``      : CLI, config/keyframes, run modes         (reference: main.cpp, app.cpp, imstate.*)
"""

__version__ = "0.1.0"

from realtimepathtracingresearchframework_tpu.backend.params import (  # noqa: F401
    RenderBackendOptions,
    RenderParams,
    SceneConfig,
    LightSamplingConfig,
)
