"""AOV (arbitrary output variable) rendering.

The reference's ENABLE_AOV_BUFFERS path stores first-bounce channels during
the main integrator (store_material_aovs/store_geometry_aovs,
pt_megakernel.glsl:482-486, shade_base_material.glsl:29-31); output
channels are OUTPUT_CHANNEL_* (render_params.glsl.h:45-53):
- ALBEDO_ROUGHNESS: rgb = throughput x base_color, a = roughness,
- NORMAL_DEPTH: rgb = shading normal, a = hit distance,
- MOTION_JITTER: xy = screen-space motion vector (prev-frame reprojection),
  zw = subpixel jitter.

Here AOVs render as a dedicated first-hit pass (one traversal; denoiser
data capture is an offline mode, app_state.cpp:499-530).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from realtimepathtracingresearchframework_tpu.ops import pointsets
from realtimepathtracingresearchframework_tpu.ops import tlas as tlas_mod
from realtimepathtracingresearchframework_tpu.ops import traverse_gpu
from realtimepathtracingresearchframework_tpu.ops.bsdf_gltf import (
    material_from_table,
)
from realtimepathtracingresearchframework_tpu.ops.integrator import (
    DeviceScene,
    FrameParams,
    IntegratorConfig,
    ViewBuffers,
    camera_rays,
)
from realtimepathtracingresearchframework_tpu.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu.ops.traverse import (
    closest_hit_threaded,
)


class AOVs(NamedTuple):
    albedo_roughness: jnp.ndarray  # (H,W,4)
    normal_depth: jnp.ndarray  # (H,W,4)
    motion_jitter: jnp.ndarray  # (H,W,4)


def render_aovs(
    ds: DeviceScene,
    cfg: IntegratorConfig,
    fp: FrameParams,
    view: ViewBuffers,
    prev_view: ViewBuffers,
    width: int,
    height: int,
) -> AOVs:
    """First-hit AOV pass at sample 0 (deterministic jitter)."""
    px = jnp.broadcast_to(jnp.arange(width)[None, :], (height, width)).reshape(-1)
    py = jnp.broadcast_to(jnp.arange(height)[:, None], (height, width)).reshape(-1)
    dims = jnp.array([width, height], jnp.float32)

    state = pointsets.make_state(
        cfg.rng_variant, fp.sample_offset, fp.shot_offset, px, py, width,
        bufs=ds.rng,
    )
    state, jitter = pointsets.draw2(cfg.rng_variant, ds.rng, state, jnp.int32(0))
    ro, rd = camera_rays(view, px, py, dims, jitter)

    if cfg.two_level:
        hit = tlas_mod.closest_hit_two_level(ds.tlas, ro, rd)
    elif cfg.traversal == "gpu":
        hit = traverse_gpu.closest_hit_gpu(ds.bvh, ro, rd)
    else:
        hit = closest_hit_threaded(ds.bvh, ro, rd)
    was_hit = hit.tri >= 0
    tri = jnp.maximum(hit.tri, 0)

    b1, b2 = hit.u, hit.v
    b0 = 1.0 - b1 - b2
    n_sh = (
        ds.shading.n0[tri] * b0[..., None]
        + ds.shading.n1[tri] * b1[..., None]
        + ds.shading.n2[tri] * b2[..., None]
    )
    mid = ds.shading.material_id[tri]
    if cfg.two_level:
        # object -> world, per instance (see integrator visit_hit)
        inst = jnp.maximum(hit.inst, 0)
        Ait = ds.tlas.inst_inv_t[inst].reshape(-1, 3, 3)
        # elementwise, not a matmul: a float32 matmul may run in TF32
        n_sh = jnp.sum(Ait * n_sh[:, None, :], axis=-1)
        mid = mid + ds.tlas.inst_mat_offset[inst]
    n_sh = n_sh / jnp.maximum(jnp.linalg.norm(n_sh, axis=-1, keepdims=True), 1e-20)
    mat = material_from_table(ds.materials, mid)

    albedo = jnp.where(was_hit[..., None], mat.base_color, 0.0)
    rough = jnp.where(was_hit, mat.roughness, 1.0)
    normal = jnp.where(was_hit[..., None], n_sh, 0.0)
    depth = jnp.where(was_hit, hit.t, jnp.float32(2.0e32))

    # motion vector: reproject the hit point with the previous view
    # (process_taa-compatible convention: NDC delta)
    p = ro + hit.t[..., None] * rd

    def project(v: ViewBuffers, p):
        rel = p - v.cam_pos
        # solve rel ~ a*du + b*dv + c*top_left with c scaling: use basis
        # inversion via matrix solve (3x3 per frame, precomputed host-side
        # would be cheaper; fine at AOV rates)
        m = jnp.stack([v.cam_du, v.cam_dv, v.cam_dir_top_left], axis=1)
        coeffs = jnp.linalg.solve(
            jnp.broadcast_to(m, p.shape[:-1] + (3, 3)), rel[..., None]
        )[..., 0]
        w = coeffs[..., 2]
        return jnp.stack(
            [coeffs[..., 0] / w, coeffs[..., 1] / w], axis=-1
        )

    uv_now = project(view, p)
    uv_prev = project(prev_view, p)
    # motion rides in NDC units ([-1,1] spans the screen) like the
    # reference's motion AOV — its TAA reprojects with
    # `start + 0.5 * motion` in UV space (process_taa.comp:75), and
    # ops/taa.py mirrors that 0.5; a UV-unit delta here would reproject
    # at HALF the true offset
    motion = jnp.where(was_hit[..., None], 2.0 * (uv_prev - uv_now), 0.0)
    jit_out = (jitter - 0.5) * 2.0 / dims  # jitter in NDC-ish units

    ar = jnp.concatenate([albedo, rough[..., None]], axis=-1)
    nd = jnp.concatenate([normal, depth[..., None]], axis=-1)
    mj = jnp.concatenate([motion, jit_out], axis=-1)
    return AOVs(
        albedo_roughness=ar.reshape(height, width, 4),
        normal_depth=nd.reshape(height, width, 4),
        motion_jitter=mj.reshape(height, width, 4),
    )
