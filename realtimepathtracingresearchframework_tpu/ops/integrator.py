"""Megakernel path-tracing integrator (jitted JAX).

The JAX counterpart of the flagship ``PT_MEGAKERNEL`` compute integrator
(vulkan/pt_megakernel.glsl): one traced program per sample batch that
generates camera rays, then runs a statically-unrolled bounce loop of
{traverse -> hit attributes -> emitter MIS -> NEE + shadow ray -> BSDF
sample -> Russian roulette}, with lane masks instead of the reference's
EXPLICIT_MASK subgroup trick (pt_megakernel.glsl:369-415).

Semantics ported 1:1 (so validation images are self-consistent across our
variants, like the reference's integrator variants):
- camera ray setup + box pixel filter (pt_megakernel.glsl:311-326,
  gpu_params.glsl:42),
- LCG RNG sequence order: pixel filter, then per bounce NEE position,
  light selection, BSDF lobe, BSDF direction, RR
  (mc/shade_base_material.glsl:60-84, pt_megakernel.glsl:713-730),
- normal facing rules for two-sided materials (pt_megakernel.glsl:622-634),
- emitter-hit MIS with prev-bounce pdf init 2e16
  (mc/shading_interface.glsl:20-22, shade_base_material.glsl:33-39),
- NEE sun/area selection by sun_radiance.w with balance heuristic
  (mc/nee.glsl:40-90),
- ray epsilon (|origin| + total_t) * 5e-6 (vulkan/geometry.glsl:76-78),
- RR from rr_path_depth, prob clamped to 0.95 beyond bounce 6
  (pt_megakernel.glsl:713-730),
- alpha = 0 for primary miss else 1 (pt_megakernel.glsl:737).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from realtimepathtracingresearchframework_tpu.models.material import (
    BASE_MATERIAL_NOALPHA,
    BASE_MATERIAL_ONESIDED,
)
from realtimepathtracingresearchframework_tpu.models.sky import (
    SkyParams,
    sky_radiance_v,
)
from realtimepathtracingresearchframework_tpu.ops import nee as nee_mod
from realtimepathtracingresearchframework_tpu.ops import pointsets
from realtimepathtracingresearchframework_tpu.ops import vec3 as v3
from realtimepathtracingresearchframework_tpu.ops.vec3 import Vec3
from realtimepathtracingresearchframework_tpu.ops.bsdf_gltf import (
    GLTFMaterial,
    gltf_bsdf_v,
    gltf_wpdf_v,
    sample_gltf_brdf_v,
)
from realtimepathtracingresearchframework_tpu.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu.ops.traverse import (
    ThreadedBuffers,
    TriBuffers,
    closest_hit_threaded,
    occluded_threaded,
)
from realtimepathtracingresearchframework_tpu.ops import raysort
from realtimepathtracingresearchframework_tpu.ops import tlas as tlas_mod
from realtimepathtracingresearchframework_tpu.ops import traverse_brute
from realtimepathtracingresearchframework_tpu.ops import traverse_gpu
from realtimepathtracingresearchframework_tpu.ops.texture_atlas import (
    TextureAtlas,
    sample_atlas,
    sample_atlas_aniso,
)

RAY_EPSILON = 5.0e-6  # vulkan/gpu_params.glsl:28
RAYS_PER_PASS = 524288  # lanes per integrator pass (a 1080p frame is 4
# passes); carried over from an earlier hardware target and not
# measured on the GPU yet


class MaterialBuffers(NamedTuple):
    base_color: jnp.ndarray
    roughness: jnp.ndarray
    specular: jnp.ndarray
    metallic: jnp.ndarray
    ior: jnp.ndarray
    specular_transmission: jnp.ndarray
    emission_intensity: jnp.ndarray
    flags: jnp.ndarray
    base_color_tex: jnp.ndarray  # i32, -1 = constant
    specular_tex: jnp.ndarray  # .g roughness, .b metallic (scene.cpp:946-951)
    normal_tex: jnp.ndarray
    clearcoat_gloss: jnp.ndarray  # thin-transmission reflective roughness²

    @staticmethod
    def from_table(table) -> "MaterialBuffers":
        return MaterialBuffers(
            base_color=jnp.asarray(table.base_color),
            roughness=jnp.asarray(table.roughness),
            specular=jnp.asarray(table.specular),
            metallic=jnp.asarray(table.metallic),
            ior=jnp.asarray(table.ior),
            specular_transmission=jnp.asarray(table.specular_transmission),
            emission_intensity=jnp.asarray(table.emission_intensity),
            flags=jnp.asarray(table.flags),
            base_color_tex=jnp.asarray(table.base_color_tex),
            specular_tex=jnp.asarray(table.specular_tex),
            normal_tex=jnp.asarray(table.normal_tex),
            clearcoat_gloss=jnp.asarray(table.clearcoat_gloss),
        )


class ShadingBuffers(NamedTuple):
    """Per-triangle shading attributes (SoA)."""

    n0: jnp.ndarray  # (T,3)
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # (T,2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    material_id: jnp.ndarray  # (T,)
    texel_density: jnp.ndarray  # (T,) uv-units per world-unit
    tangent: jnp.ndarray  # (T,4) tangent xyz + handedness


class DeviceScene(NamedTuple):
    """Everything the integrator needs, as one pytree of device arrays."""

    bvh: ThreadedBuffers
    tris: TriBuffers
    shading: ShadingBuffers
    materials: MaterialBuffers
    lights: nee_mod.TriLightBuffers
    sky: SkyParams
    atlas: TextureAtlas  # dummy 1-texel atlas when cfg.has_textures is False
    rng: pointsets.RngBuffers  # pointset tables (dummy for the LCG variant)
    tlas: object = None  # TwoLevelBuffers when cfg.two_level (else None)
    attr_packed: object = None  # (T, ATTR_W) f32 fused per-tri attribute rows
    mat_packed: object = None  # (M, MAT_W) f32 fused material rows


# ---------------------------------------------------------------------------
# Packed attribute/material tables, stored TRANSPOSED as (W, T) f32. The
# per-bounce attribute fetch (edges, normals, uvs, tangent, material id +
# 11 material fields) is fused into one table fetch producing (W, N) —
# every column is then a contiguous 1-D array (the SoA layout the shading
# math wants, ops/vec3.py). This layout was chosen for an earlier
# hardware target on which each gather index vector was expensive; it
# has not been measured against plain gathers on the GPU. Integer
# columns are stored as float VALUES (exact below 2^24), never bitcast
# (bitcast patterns are denormals, which a matrix unit may flush to zero
# on the one-hot path). Fetch strategy is size-adaptive (_fetch_cols).
# ---------------------------------------------------------------------------

ATTR_W = 32
ATTR_SOA_MAX = 256  # one-hot operand cap: T x 262K x 4B = 256MB at 256
_A_E1, _A_E2 = 0, 3
_A_N0, _A_N1, _A_N2 = 6, 9, 12
_A_UV0, _A_UV1, _A_UV2 = 15, 17, 19
_A_TAN = 21  # 4 wide (xyz + handedness)
_A_DENS = 25
_A_MID = 26  # material id as float value

MAT_W = 16
_M_BASE = 0  # 3 wide
_M_ROUGH, _M_SPEC, _M_METAL, _M_IOR = 3, 4, 5, 6
_M_STRANS, _M_EMIT = 7, 8
_M_FLAGS, _M_BCTEX, _M_SPTEX, _M_NMTEX = 9, 10, 11, 12  # float values
_M_CCGLOSS = 13  # clearcoat_gloss (thin-transmission reflective roughness)


def pack_attr_table(tris: TriBuffers, shading: ShadingBuffers) -> jnp.ndarray:
    """Fuse the per-triangle shading attributes into an (ATTR_W, T) f32
    column table (transposed storage: row k holds attribute k for all
    triangles). Integer columns (material id) are stored as float VALUES
    (exact below 2^24), never bitcast: bitcast patterns are denormals that
    a matrix unit may flush to zero on the one-hot fetch path."""
    cols = [
        tris.e1, tris.e2, shading.n0, shading.n1, shading.n2,
        shading.uv0, shading.uv1, shading.uv2, shading.tangent,
        shading.texel_density[:, None],
        jnp.asarray(shading.material_id, jnp.float32)[:, None],
    ]
    packed = jnp.concatenate([jnp.asarray(c, jnp.float32) for c in cols], axis=1)
    pad = ATTR_W - packed.shape[1]
    return jnp.pad(packed, ((0, 0), (0, pad))).T


def pack_material_table(mats: MaterialBuffers) -> jnp.ndarray:
    """Fuse the material fields into an (MAT_W, M) f32 column table.
    Integer columns stored as float values (see pack_attr_table)."""

    def as_f32(a):
        return jnp.asarray(a, jnp.float32)[:, None]

    cols = [
        jnp.asarray(mats.base_color, jnp.float32),
        as_f32(mats.roughness),
        as_f32(mats.specular),
        as_f32(mats.metallic),
        as_f32(mats.ior),
        as_f32(mats.specular_transmission),
        as_f32(mats.emission_intensity),
        as_f32(mats.flags),
        as_f32(mats.base_color_tex),
        as_f32(mats.specular_tex),
        as_f32(mats.normal_tex),
        as_f32(mats.clearcoat_gloss),
    ]
    packed = jnp.concatenate(cols, axis=1)
    pad = MAT_W - packed.shape[1]
    return jnp.pad(packed, ((0, 0), (0, pad))).T


def _fetch_cols_ranges(tbl_t, idx, ranges):
    """Row-subset fused fetch: slice the (W, T) column table to the rows
    the caller actually reads (static slices of a captured scene constant
    — they fold at compile time), then do ONE fused fetch. Returns a dict
    {absolute_row: (N,) column} so call sites keep indexing by the _A_*/
    _M_* layout constants.

    The (W_used, N) fetch result is a large materialized intermediate
    (2 MB per row per 524,288 rays), so fetching only the rows a
    configuration reads cuts memory traffic, not just flops."""
    rows = [r for a, b in ranges for r in range(a, b)]
    sub = jnp.concatenate([tbl_t[a:b] for a, b in ranges], axis=0)
    cols = _fetch_cols(sub, idx)
    return {r: cols[i] for i, r in enumerate(rows)}


def _fetch_cols(tbl_t, idx):
    """(W, T) column table + (N,) index -> tuple of W (N,) columns.

    Small tables fetch via a one-hot matmul:
    (W, T) @ one_hot(idx).T -> (W, N). Each one-hot row selects exactly one
    table entry, and Precision.HIGHEST keeps f32 values exact (no TF32 or
    bf16 rounding), so this is a bit-exact select with the result laid
    out rays-on-lanes (the SoA layout the shading math wants). It replaces
    ~30 separate gathers per bounce; whether that pays on the GPU is not
    measured. Large tables use one trailing-axis gather producing (W, N)."""
    w, t = tbl_t.shape
    if t <= ATTR_SOA_MAX:
        oh = jax.nn.one_hot(idx, t, axis=0, dtype=jnp.float32)  # (T, N)
        g = jnp.matmul(tbl_t, oh, precision=jax.lax.Precision.HIGHEST)
        return tuple(g[k] for k in range(w))
    g = jnp.take(tbl_t, idx, axis=1)
    return tuple(g[k] for k in range(w))


def _material_from_cols(c, thin: bool = False) -> GLTFMaterial:
    """Unpack fetched material columns (tuple of (N,) arrays) into a SoA
    GLTFMaterial (Vec3 colors). ``thin``: apply the THIN_TRANSMISSION
    load rule (load_material, gltf_bsdf.glsl:47-56) on lanes flagged
    BASE_MATERIAL_THIN — transmission keeps the material roughness while
    the reflective specular lobe takes sqrt(clearcoat_gloss)."""
    base = Vec3(c[_M_BASE], c[_M_BASE + 1], c[_M_BASE + 2])
    flags = c[_M_FLAGS].astype(jnp.int32)
    roughness = c[_M_ROUGH]
    transmission_roughness = None
    if thin:
        from realtimepathtracingresearchframework_tpu.models.material import (
            BASE_MATERIAL_THIN,
        )

        thin_lane = (
            ((flags & BASE_MATERIAL_THIN) != 0)
            & (c[_M_STRANS] > 0.0)
            & (c[_M_IOR] > 1.0)
        )
        transmission_roughness = roughness
        roughness = jnp.where(thin_lane, jnp.sqrt(c[_M_CCGLOSS]), roughness)
    return GLTFMaterial(
        base_color=base,
        metallic=c[_M_METAL],
        specular=c[_M_SPEC],
        roughness=roughness,
        ior=c[_M_IOR],
        specular_transmission=c[_M_STRANS],
        transmission_color=base,
        onesided=(flags & BASE_MATERIAL_ONESIDED) != 0,
        transmission_roughness=transmission_roughness,
    )


class ViewBuffers(NamedTuple):
    """ViewParams analogue (vulkan/gpu_params.glsl:61-87)."""

    cam_pos: jnp.ndarray  # (3,)
    cam_du: jnp.ndarray
    cam_dv: jnp.ndarray
    cam_dir_top_left: jnp.ndarray


class IntegratorConfig(NamedTuple):
    """Static (trace-time) configuration — the RBO_*/compile-time subset."""

    max_path_depth: int = 9
    light_bin_size: int = 16
    use_light_bins: bool = False
    num_lights: int = 0
    stack_depth: int = 32
    enable_sun_sky: bool = True
    unroll: bool = False  # RBO unroll_bounces (render_params.glsl.h:85)
    traversal: str = "xla"  # single-level BVH walk: "xla" (ops/traverse.py,
    # any platform) or "gpu" (the Pallas-Triton kernel, ops/traverse_gpu.py)
    wavefront: bool = False  # stream-compact ray queues between bounces
    has_textures: bool = False  # trace the texture-lookup stage
    rng_variant: int = 0  # RNG_VARIANT_* (render_params.glsl.h:34-43)
    aniso_taps: int = 0  # anisotropic texture taps (0 = isotropic mip);
    # the textureGrad filtering the reference's sampler hardware does —
    # each tap costs a full gather set, so this is opt-in.
    # Ignored under two_level (attr rows hold object-space edges there).
    alpha_test: bool = False  # any-hit alpha-cutout emulation
    two_level: bool = False  # BLAS/TLAS instanced traversal (ops/tlas.py)
    enable_dof: bool = False  # thin-lens aperture sampling (RBO
    # enable_raytraced_dof; perspective.rgen:100-109). Static because it
    # switches the path-space dim map to the full camera (pathspace.h:
    # DIM_APERTURE_X/Y=4/5, DIM_CAMERA_END 2 -> 6).
    has_transmission: bool = True  # False drops all transmission BSDF
    # math (scene has no transmitting material; bit-identical there)
    thin_transmission: bool = False  # scene has BASE_MATERIAL_THIN
    # materials (THIN_TRANSMISSION_HIT, vulkan/CMakeLists.txt:38-39):
    # enables the separate transmission-roughness BSDF path
    debug_mode: int = 0  # DEBUG_MODE_* heatmaps (render_params.glsl.h:63-70):
    # 1/2 = any-hit (alpha-test) evaluation count full-path/primary-only
    # (any_hit.glsl:43-59), 3 = bounce count (hit.rchit:462-463). When set,
    # trace_paths returns a 4th per-lane count array for the debug image.
    compact: bool = False  # coherence sort (ops/raysort.py: dead-last +
    # direction octant + origin morton) of each GPU closest-hit queue past
    # bounce 0. Invisible in the results. The renderer turns it on for
    # large scenes unless carry compaction (which sorts the whole carry)
    # is on.
    sort_shadows: bool = False  # coherence-sort each NEE shadow queue by
    # its own origins before the GPU walk, where the caller asks for it
    # (sort_shadow: bounce >= 1, whose origins are scattered hit points).
    # The renderer turns it on for large scenes.
    compact_lanes: bool = False  # TRUE stream compaction: per bounce,
    # sort the WHOLE path-state carry live-first (+octant/morton
    # coherence) with one packed 2-D gather, then run the entire bounce
    # (traversal AND shading AND NEE) on the smallest power-of-two lane
    # prefix covering the live count (lax.switch over static sizes), so
    # dead lanes stop paying for gathers, texture taps, NEE and BSDF
    # math, not just traversal.
    # Semantically exact: live lanes are in every prefix and all
    # dead-lane state mutations are masked (see trace_paths); path
    # structure (hits, NEE visibility, RR decisions, ray counts) is
    # bitwise identical (tests/test_compact_lanes.py). Radiance agrees
    # to XLA program-shape rounding (~6e-6 rel) — the SAME variance the
    # unrolled-vs-dynamic loop choice already exhibits with compaction
    # off. Implies the dynamic bounce loop (the body is traced once per
    # prefix size, not per bounce); ignored when a bounded primary
    # segment (t_max0) or debug counters are in play.
    brute_rows: tuple = ()  # tiny-scene traversal: static (v0,e1,e2)
    # 9-float tuples in BVH-row order. When non-empty, every single-level
    # dispatch becomes a fully-unrolled XLA Moller-Trumbore chain over
    # ALL rows (ops/traverse_brute.py) instead of a kernel launch, so the
    # walk fuses into the bounce's shading/NEE/RNG math. Same hits as
    # the threaded walk (lower row wins exact-t ties). The renderer sets
    # this only when asked (RPTR_BRUTE=1) for scenes <= _BRUTE_MAX_ROWS
    # rows; the rows ride the config (hashable tuple) so the pass-fn
    # cache keys them.


class FrameParams(NamedTuple):
    """Dynamic per-frame params (RenderParams subset, traced values)."""

    rr_path_depth: jnp.ndarray
    glossy_only_mode: jnp.ndarray
    sample_offset: jnp.ndarray  # accumulation frame offset (uint32)
    shot_offset: jnp.ndarray  # frame_offset randomization (uint32)
    bump_scale: jnp.ndarray = jnp.float32(1.0)  # SceneConfig.bump_scale
    aperture_radius: jnp.ndarray = jnp.float32(0.0)  # thin-lens DoF
    focus_distance: jnp.ndarray = jnp.float32(1.0)  # (render_params.glsl.h)
    pixel_radius: jnp.ndarray = jnp.float32(1.0)  # mip footprint scale


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _mat3_apply(m, v: Vec3) -> Vec3:
    """Per-lane (N,3,3) matrix times SoA vector, as exact float32
    elementwise products."""
    return Vec3(
        m[:, 0, 0] * v.x + m[:, 0, 1] * v.y + m[:, 0, 2] * v.z,
        m[:, 1, 0] * v.x + m[:, 1, 1] * v.y + m[:, 1, 2] * v.z,
        m[:, 2, 0] * v.x + m[:, 2, 1] * v.y + m[:, 2, 2] * v.z,
    )


def _normalize(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _sky_illum(ds: DeviceScene, rd: Vec3, prev_pdf, cfg: IntegratorConfig) -> Vec3:
    """compute_sky_illum (pt_megakernel.glsl:113-149). SoA."""
    zero = v3.splat(jnp.zeros_like(rd.x))
    if not cfg.enable_sun_sky:
        return zero
    atm = v3.vabs(sky_radiance_v(ds.sky, rd))
    # sun disk with MIS vs NEE sun sampling
    y = rd.y
    ocean = jnp.where(y <= 0.0, 0.7 * jnp.maximum(1.0 - jnp.abs(y), 0.0) ** 5, 1.0)
    dm = v3.normalize(Vec3(rd.x, jnp.abs(y), rd.z))
    sd = ds.sky.sun_dir
    in_cap = (dm.x * sd[0] + dm.y * sd[1] + dm.z * sd[2]) >= ds.sky.sun_cos_angle
    sr = ds.sky.sun_radiance
    sun = v3.where(
        in_cap, Vec3(sr[0] * ocean, sr[1] * ocean, sr[2] * ocean), zero
    )
    light_pdf = sr[3] * nee_mod.sun_dir_pdf(ds.sky.sun_cos_angle)
    w = nee_mod.nee_mis_heuristic(1.0, prev_pdf, 1.0, light_pdf)
    return atm + v3.vabs(sun) * w


MAX_ALPHA_HOPS = 4  # candidate-hit re-trace budget (generate_candidate_hit)
ALPHA_CUTOFF = 0.5  # punch-through threshold

# DEBUG_MODE_* values — keep in sync with backend/params.py (the X-macro
# names of render_params.glsl.h:63-70)
_DBG_ANY_FULL = 1
_DBG_ANY_PRIMARY = 2
_DBG_BOUNCE = 3


def _hit_alpha_cut(ds: DeviceScene, tri, u, v, inst=None):
    """True where the hit texel is alpha-cut — the any-hit alpha test
    emulation of ``generate_candidate_hit`` (pt_megakernel.glsl:153-211,
    any_hit.glsl). Samples mip 0 of the base-color texture. ``inst``
    (two-level hits) applies the per-instance material offset."""
    t = jnp.maximum(tri, 0)
    c = _fetch_cols(ds.attr_packed, t)
    b0 = 1.0 - u - v
    uv = jnp.stack(
        [
            c[_A_UV0] * b0 + c[_A_UV1] * u + c[_A_UV2] * v,
            c[_A_UV0 + 1] * b0 + c[_A_UV1 + 1] * u + c[_A_UV2 + 1] * v,
        ],
        axis=-1,
    )
    mid = c[_A_MID].astype(jnp.int32)
    if inst is not None:
        mid = mid + ds.tlas.inst_mat_offset[jnp.maximum(inst, 0)]
    mc = _fetch_cols(ds.mat_packed, mid)
    bc_tid = mc[_M_BCTEX].astype(jnp.int32)
    flags = mc[_M_FLAGS].astype(jnp.int32)
    a = sample_atlas(ds.atlas, bc_tid, uv, jnp.zeros_like(u))[..., 3]
    can_cut = (bc_tid >= 0) & ((flags & BASE_MATERIAL_NOALPHA) == 0)
    # second result: lanes where an any-hit evaluation actually happened
    # (candidate on alpha-testable material) — the DEBUG_MODE_ANY_HIT_*
    # counting event (any_hit.glsl:43-59)
    return (tri >= 0) & can_cut & (a < ALPHA_CUTOFF), (tri >= 0) & can_cut


def _gpu_walk(ds: DeviceScene, walk, ro: Vec3, rd: Vec3, t_min, t_max,
              sort: bool):
    """One GPU kernel dispatch (ops/traverse_gpu.py), optionally on the
    coherence-sorted queue (ops/raysort.py)."""
    def run(comps, a, b):
        return walk(ds.bvh, t_min=a, t_max=b, comps=comps)

    if not sort:
        return run((*ro, *rd), t_min, t_max)
    lo, hi = _scene_bounds_of(ds)
    return raysort.sorted_walk(run, (*ro, *rd), t_min, t_max, lo, hi)


def _closest_hit_dispatch(ds: DeviceScene, cfg: IntegratorConfig, ro: Vec3,
                          rd: Vec3, t_min, t_max, compact: bool = False,
                          presorted: bool = False):
    """``compact``: coherence-sort this queue before the GPU walk;
    ``presorted``: the caller already sorted the lanes (carry-level
    compaction, trace_paths), so no sort here."""
    if cfg.two_level:
        return tlas_mod.closest_hit_two_level(
            ds.tlas, v3.to_array(ro), v3.to_array(rd),
            t_min=t_min, t_max=t_max,
        )
    if cfg.brute_rows:
        return traverse_brute.closest_hit_brute(
            cfg.brute_rows, ds.bvh.row_tri, ro, rd, t_min, t_max
        )
    if cfg.traversal == "gpu":
        return _gpu_walk(ds, traverse_gpu.closest_hit_gpu, ro, rd, t_min,
                         t_max, sort=compact and not presorted)
    return closest_hit_threaded(
        ds.bvh, v3.to_array(ro), v3.to_array(rd), t_min=t_min, t_max=t_max
    )


def closest_hit_alpha(ds: DeviceScene, cfg: IntegratorConfig, ro: Vec3,
                      rd: Vec3, t_min, t_max, compact: bool = False,
                      count_evals: bool = False, presorted: bool = False):
    """Closest hit honoring alpha-cutout textures: re-traces past cut
    texels up to MAX_ALPHA_HOPS (the reference's candidate-hit loop).
    Static no-op unless ``cfg.alpha_test``. With ``count_evals`` returns
    ``(hit, evals)`` where evals is the per-lane any-hit evaluation count
    (DEBUG_MODE_ANY_HIT_*, any_hit.glsl:43-59)."""
    hit = _closest_hit_dispatch(ds, cfg, ro, rd, t_min, t_max, compact=compact,
                                presorted=presorted)
    if not (cfg.alpha_test and cfg.has_textures):
        if count_evals:
            return hit, jnp.zeros_like(hit.tri)
        return hit
    from realtimepathtracingresearchframework_tpu.ops.traverse import Hit

    inst0 = hit.inst if cfg.two_level else jnp.zeros_like(hit.tri)
    cut0, ev0 = _hit_alpha_cut(
        ds, hit.tri, hit.u, hit.v, inst0 if cfg.two_level else None
    )

    def cond(c):
        i = c[0]
        return (i < MAX_ALPHA_HOPS) & jnp.any(c[6])

    def body(c):
        i, t, tri, u, v, inst, cut, ev = c
        eps = jnp.abs(t) * 1e-4 + 1e-5
        nxt_tmin = jnp.where(cut, t + eps, t_min)
        nxt_tmax = jnp.where(cut, t_max, 0.0)  # settled lanes trace nothing
        h = _closest_hit_dispatch(
            ds, cfg, ro, rd, nxt_tmin, nxt_tmax, compact=True
        )
        t = jnp.where(cut, h.t, t)
        tri = jnp.where(cut, h.tri, tri)
        u = jnp.where(cut, h.u, u)
        v = jnp.where(cut, h.v, v)
        if cfg.two_level:
            inst = jnp.where(cut, h.inst, inst)
        new_cut, evd = _hit_alpha_cut(
            ds, tri, u, v, inst if cfg.two_level else None
        )
        ev = ev + (cut & evd).astype(ev.dtype)
        cut = cut & new_cut
        return (i + 1, t, tri, u, v, inst, cut, ev)

    _, t, tri, u, v, inst, cut, ev = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), hit.t, hit.tri, hit.u, hit.v, inst0, cut0,
         ev0.astype(jnp.int32)),
    )
    # hops exhausted while still cut: treat as opaque (reference behavior)
    if cfg.two_level:
        hit = tlas_mod.TwoLevelHit(t=t, tri=tri, u=u, v=v, inst=inst)
    else:
        hit = Hit(t=t, tri=tri, u=u, v=v)
    if count_evals:
        return hit, ev
    return hit


def occluded_alpha(ds: DeviceScene, cfg: IntegratorConfig, ro: Vec3, rd: Vec3,
                   t_min, t_max, compact: bool = False,
                   count_evals: bool = False, sort_shadow: bool = False):
    """Shadow-ray visibility honoring alpha cutouts (any_hit.rahit): walks
    candidate hits until a solid blocker or segment end. With
    ``count_evals`` returns ``(blocked, evals)`` (see closest_hit_alpha).

    ``sort_shadow``: the caller's queue has scattered origins (bounce >= 1
    hit points); with ``cfg.sort_shadows`` the GPU walk then runs on the
    queue coherence-sorted by its own origins."""
    if not (cfg.alpha_test and cfg.has_textures):
        if cfg.two_level:
            blocked = tlas_mod.occluded_two_level(
                ds.tlas, v3.to_array(ro), v3.to_array(rd), t_min, t_max
            )
        elif cfg.brute_rows:
            blocked = traverse_brute.occluded_brute(
                cfg.brute_rows, ro, rd, t_min, t_max
            )
        elif cfg.traversal == "gpu":
            blocked = _gpu_walk(
                ds, traverse_gpu.occluded_gpu, ro, rd, t_min, t_max,
                sort=(sort_shadow and cfg.sort_shadows) or compact,
            )
        else:
            blocked = occluded_threaded(
                ds.bvh, v3.to_array(ro), v3.to_array(rd),
                t_min=t_min, t_max=t_max,
            )
        if count_evals:
            return blocked, jnp.zeros(blocked.shape, jnp.int32)
        return blocked

    hit = _closest_hit_dispatch(ds, cfg, ro, rd, t_min, t_max)
    in_seg = (hit.tri >= 0) & (hit.t < t_max)
    cut0, ev0 = _hit_alpha_cut(
        ds, hit.tri, hit.u, hit.v, hit.inst if cfg.two_level else None
    )
    blocked0 = in_seg & ~cut0
    live0 = in_seg & cut0

    def cond(c):
        i = c[0]
        return (i < MAX_ALPHA_HOPS) & jnp.any(c[3])

    def body(c):
        i, t, blocked, live, ev = c
        eps = jnp.abs(t) * 1e-4 + 1e-5
        nxt_tmin = jnp.where(live, t + eps, t_min)
        nxt_tmax = jnp.where(live, t_max, 0.0)
        h = _closest_hit_dispatch(
            ds, cfg, ro, rd, nxt_tmin, nxt_tmax, compact=True
        )
        in_seg = (h.tri >= 0) & (h.t < t_max) & live
        cut, evd = _hit_alpha_cut(
            ds, h.tri, h.u, h.v, h.inst if cfg.two_level else None
        )
        ev = ev + (live & evd).astype(ev.dtype)
        blocked = blocked | (in_seg & ~cut)
        live = in_seg & cut
        t = jnp.where(live, h.t, t)
        return (i + 1, t, blocked, live, ev)

    _, _, blocked, live, ev = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), hit.t, blocked0, live0,
         (in_seg & ev0).astype(jnp.int32)),
    )
    # hops exhausted while still inside cut geometry: treat as blocked
    blocked = blocked | live
    if count_evals:
        return blocked, ev
    return blocked


def _sample_direct_light(
    ds: DeviceScene,
    cfg: IntegratorConfig,
    hit_p: Vec3,
    hit_n: Vec3,
    hit_gn: Vec3,
    mat: GLTFMaterial,
    w_o: Vec3,
    dir_sample,
    sel_sample,
    total_t,
    compact: bool = False,
    count_evals: bool = False,
    sort_shadow: bool = False,
) -> Vec3:
    """sample_direct_light (mc/nee.glsl:32-90) + immediate visibility ray
    (the megakernel resolution of the candidate)."""
    cand = _nee_candidate(
        ds, cfg, hit_p, hit_n, hit_gn, mat, w_o, dir_sample, sel_sample,
        total_t,
    )
    blocked = occluded_alpha(
        ds, cfg, hit_p, cand.dir, t_min=cand.eps, t_max=cand.shadow_tmax,
        compact=compact, count_evals=count_evals, sort_shadow=sort_shadow,
    )
    if count_evals:
        blocked, ev = blocked
    visible = (cand.traced & ~blocked) | cand.uncond
    zero3 = v3.splat(jnp.zeros_like(cand.eps))
    contrib = v3.where(visible, cand.contrib, zero3)
    if count_evals:
        return contrib, ev
    return contrib


def _nee_candidate(
    ds: DeviceScene,
    cfg: IntegratorConfig,
    hit_p: Vec3,
    hit_n: Vec3,
    hit_gn: Vec3,
    mat: GLTFMaterial,
    w_o: Vec3,
    dir_sample,
    sel_sample,
    total_t,
) -> "NEECandidate":
    """sample_direct_light minus the visibility trace. SoA:
    positions/normals are Vec3, samples are (u0, u1) tuples."""
    sun_w = ds.sky.sun_radiance[3]

    # --- sun branch
    sun_sel = sel_sample[0] <= sun_w
    sun_dir = nee_mod.sample_sun_dir_v(
        ds.sky.sun_dir, ds.sky.sun_cos_angle, dir_sample[0], dir_sample[1]
    )
    sun_pdf = nee_mod.sun_dir_pdf(ds.sky.sun_cos_angle)
    sr = ds.sky.sun_radiance
    sun_scale = 1.0 / (jnp.maximum(sun_w, 1e-9) * sun_pdf)
    sun_illum = Vec3(sr[0] * sun_scale, sr[1] * sun_scale, sr[2] * sun_scale)
    sun_light_pdf = sun_pdf * sun_w

    if cfg.num_lights > 0:
        # --- area branch (renormalized selector)
        sel2 = (
            jnp.clip(
                (sel_sample[0] - sun_w) / jnp.maximum(1.0 - sun_w, 1e-9),
                0.0,
                1.0,
            ),
            sel_sample[1],
        )
        ls = nee_mod.sample_tri_lights_v(
            ds.lights,
            hit_p,
            hit_n,
            dir_sample,
            sel2,
            cfg.light_bin_size,
            cfg.use_light_bins,
        )
        inv_area_w = 1.0 / jnp.maximum(1.0 - sun_w, 1e-9)
        tri_illum = ls.illum * inv_area_w
        tri_light_pdf = ls.pdf * (1.0 - sun_w)
        tri_mis_pdf = ls.mis_wpdf * (1.0 - sun_w)

        illum = v3.where(sun_sel, sun_illum, tri_illum)
        light_dir = v3.where(sun_sel, sun_dir, ls.dir)
        light_dist = jnp.where(sun_sel, 2.0e16, ls.dist)
        light_pdf = jnp.where(sun_sel, sun_light_pdf, tri_light_pdf)
        mis_pdf = jnp.where(sun_sel, sun_light_pdf, tri_mis_pdf)
    else:
        zero = jnp.zeros_like(hit_p.x)
        illum = sun_illum + v3.splat(zero)
        light_dir = sun_dir
        light_dist = zero + 2.0e16
        light_pdf = zero + sun_light_pdf
        mis_pdf = light_pdf

    # strict normals (nee.glsl:73-75)
    strict = v3.dot(light_dir, hit_gn) * v3.dot(light_dir, hit_n) > 0.0
    candidate = (light_pdf > 0.0) & strict

    # visibility segment with epsilon (pt_megakernel.glsl:216-224)
    eps = (v3.length(hit_p) + total_t) * RAY_EPSILON
    seg_ok = light_dist - 2.0 * eps > 0.0
    shadow_tmax = jnp.maximum(light_dist - eps, eps)
    shadow_tmax_eff = jnp.where(candidate & seg_ok, shadow_tmax, eps)

    bsdf_pdf = gltf_wpdf_v(mat, hit_n, w_o, light_dir, cfg.has_transmission,
                           cfg.thin_transmission)
    f = gltf_bsdf_v(mat, hit_n, w_o, light_dir, cfg.has_transmission,
                    cfg.thin_transmission)
    w = nee_mod.nee_mis_heuristic(1.0, mis_pdf, 1.0, bsdf_pdf)
    contrib = illum * f * (w * jnp.abs(v3.dot(light_dir, hit_n)))
    base_ok = candidate & (bsdf_pdf >= 0.0)
    zero3 = v3.splat(jnp.zeros_like(w))
    return NEECandidate(
        contrib=v3.where(base_ok, contrib, zero3),
        dir=light_dir,
        eps=eps,
        shadow_tmax=shadow_tmax_eff,
        traced=base_ok & seg_ok,  # apply iff the shadow ray is clear
        uncond=base_ok & ~seg_ok,  # degenerate segment: always visible
    )


class NEECandidate(NamedTuple):
    """An unresolved NEE sample: contribution + its occlusion ray. The
    megakernel resolves it immediately; the wavefront defers the ray to
    the next bounce's merged intersect dispatch."""

    contrib: Vec3  # MIS-weighted, NOT throughput-scaled
    dir: Vec3
    eps: jnp.ndarray  # shadow t_min
    shadow_tmax: jnp.ndarray
    traced: jnp.ndarray  # bool: needs the visibility ray
    uncond: jnp.ndarray  # bool: visible without tracing


def _permute_lanes(tree, perm):
    """Permute every (N,) leaf of a pytree along lanes with ONE packed
    2-D gather: bitcast each leaf to i32, stack to (C, N), gather
    [:, perm], unstack, bitcast back: one gather instead of one per leaf.

    The carrier is INT32, NOT f32: small integer values (ray counters,
    RNG states, bounce counts) bitcast to f32 are denormals, and a fused
    f32 kernel may flush denormals to zero, depending on fusion. Integer
    lanes never canonicalize, and f32 bit patterns ride an i32 bitcast
    losslessly in both directions."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    cols = []
    for a in leaves:
        if a.dtype == jnp.int32:
            cols.append(a)
        elif a.dtype == jnp.bool_:
            cols.append(a.astype(jnp.int32))
        else:
            cols.append(jax.lax.bitcast_convert_type(a, jnp.int32))
    packed = jnp.stack(cols)[:, perm]
    outs = []
    for i, a in enumerate(leaves):
        row = packed[i]
        if a.dtype == jnp.int32:
            outs.append(row)
        elif a.dtype == jnp.bool_:
            outs.append(row != 0)
        else:
            outs.append(jax.lax.bitcast_convert_type(row, a.dtype))
    return jax.tree_util.tree_unflatten(treedef, outs)


def _scene_bounds_of(ds: DeviceScene):
    """(lo, hi) world box for the coherence morton grid, from whatever
    BVH flavor the scene carries; (None, None) when unavailable (the
    sort then degrades to dead-last only — still correct)."""
    bvh = ds.bvh
    lo = getattr(bvh, "scene_lo", None)
    if lo is not None:
        return lo, bvh.scene_hi
    nodes = getattr(bvh, "nodes", None)
    if nodes is not None and getattr(nodes, "ndim", 0) == 2:
        return nodes[0, 0:3], nodes[0, 3:6]
    return None, None


def _carry_coherence_key(ro: Vec3, rd: Vec3, live, lo, hi):
    """u32 lane sort key for carry-level compaction (ops/raysort.py)."""
    return raysort.coherence_key(ro, rd, live, lo, hi)


# carry-compaction prefix sizes: lane counts are quantized to the
# traversal block so every prefix dispatches whole blocks
_COMPACT_LANE_QUANTUM = 1024
_COMPACT_MAX_HALVINGS = 5  # smallest prefix = n/32


def _make_bounce_fns(ds: DeviceScene, cfg: IntegratorConfig, fp,
                     t_max0=None):
    """Build the width-generic per-bounce closures (visit_hit +
    scatter_tail) — shared by the monolithic trace_paths bounce loop
    and the host-driven bounce-major wavefront executor
    (ops/wavefront_host.py). The closures are elementwise over the
    lane axis, so any caller may run them on any lane-prefix width.
    """
    num_bins = max(cfg.num_lights // max(cfg.light_bin_size, 1), 1)

    def visit_hit(carry, compact=False, presorted=False):
        """Traverse + hit attributes + emitter MIS; shared by body/epilogue.
        Returns (carry w/ miss handled, hit shading context).

        Wavefront mode (cfg.wavefront): the bounce's closest-hit queue and
        the PREVIOUS bounce's NEE occlusion queue are traversed together
        here — the two-queue structure of the wavefront design. The
        deferred NEE contribution is applied here, before this bounce's
        sky/emitter terms, preserving the megakernel's accumulation
        order bit-exactly."""
        (ro, rd, t_min, illum, throughput, active, prev_pdf,
         bounce_count, total_t, rng_state, rays) = carry[:11]
        _i = 11
        if cfg.wavefront:
            pend = carry[_i]
            _i += 1
        if cfg.has_textures:
            foot = carry[_i]
        dbg_anyhit = cfg.debug_mode in (_DBG_ANY_FULL, _DBG_ANY_PRIMARY)
        if cfg.debug_mode:
            dbg = carry[-1]
        rays = rays + active.astype(rays.dtype)  # per-lane ray counter
        tmax_eff = jnp.where(active, T_MAX, 0.0)
        if t_max0 is not None:
            # bounded primary segment (RenderRayQuery.t_max,
            # render_params.glsl.h:169); later bounces are unbounded
            tmax_eff = jnp.where(
                bounce_count == 0, jnp.where(active, t_max0, 0.0), tmax_eff
            )
        if cfg.wavefront:
            nd, ntmin, ntmax, ncontrib, ntraced = pend
            ntmax_eff = jnp.where(ntraced, ntmax, 0.0)
            # the two queues go to the device as separate traversals
            # (bit-identical to the megakernel's order)
            hit = closest_hit_alpha(
                ds, cfg, ro, rd, t_min, tmax_eff, compact=compact,
                count_evals=dbg_anyhit, presorted=presorted,
            )
            # wavefront deferred queue: origins = carry ro, which is
            # already sorted under carry compaction (presorted) —
            # sort only when the per-dispatch compact policy is on
            blocked = occluded_alpha(
                ds, cfg, ro, nd, t_min=ntmin, t_max=ntmax_eff,
                compact=compact, count_evals=dbg_anyhit,
                sort_shadow=compact,
            )
            if dbg_anyhit:
                hit, ev_c = hit
                blocked, ev_s = blocked
                if cfg.debug_mode == _DBG_ANY_FULL:
                    dbg = dbg + ev_c + ev_s
                else:  # primary-only: camera-visibility evals
                    dbg = dbg + jnp.where(bounce_count == 0, ev_c, 0)
            illum = v3.where(ntraced & ~blocked, illum + ncontrib, illum)
            # width-local empty pend (the carry may be a compacted lane
            # PREFIX under cfg.compact_lanes — the trace-level empty_pend
            # closure is full-width)
            zw = jnp.zeros_like(t_min)
            pend = (
                Vec3(zw, zw + 1.0, zw), zw, zw, Vec3(zw, zw, zw),
                jnp.zeros_like(active),
            )
        else:
            # two-level dispatch (incl. alpha-tested candidate walks)
            # happens inside closest_hit_alpha
            hit = closest_hit_alpha(
                ds, cfg, ro, rd, t_min, tmax_eff, compact=compact,
                count_evals=dbg_anyhit, presorted=presorted,
            )
            if dbg_anyhit:
                hit, ev_c = hit
                if cfg.debug_mode == _DBG_ANY_FULL:
                    dbg = dbg + ev_c
                else:
                    dbg = dbg + jnp.where(bounce_count == 0, ev_c, 0)
        was_miss = hit.tri < 0

        # ---- miss: sky (pt_megakernel.glsl:480-489)
        sky = _sky_illum(ds, rd, prev_pdf, cfg)
        illum = v3.where(active & was_miss, illum + throughput * sky, illum)
        active = active & ~was_miss

        # ---- hit attributes (rt/hit.glsl:63-92, pt_megakernel.glsl:576-580)
        # one fused column-table fetch replaces 7 split gathers (see
        # pack_attr_table)
        tri = jnp.maximum(hit.tri, 0)
        # fetch only the rows this configuration reads: e1/e2/normals/mid
        # always; uv/tangent/density only when texturing (texture-free
        # scenes fetch 16 of the 32 padded rows — half the memory traffic
        # of the integrator's biggest materialized intermediate)
        attr_ranges = (
            [(_A_E1, _A_MID + 1)] if cfg.has_textures
            else [(_A_E1, _A_UV0), (_A_MID, _A_MID + 1)]
        )
        c = _fetch_cols_ranges(ds.attr_packed, tri, attr_ranges)
        e1 = Vec3(c[_A_E1], c[_A_E1 + 1], c[_A_E1 + 2])
        e2 = Vec3(c[_A_E2], c[_A_E2 + 1], c[_A_E2 + 2])
        b1, b2 = hit.u, hit.v
        b0 = 1.0 - b1 - b2
        n_sh = Vec3(
            c[_A_N0] * b0 + c[_A_N1] * b1 + c[_A_N2] * b2,
            c[_A_N0 + 1] * b0 + c[_A_N1 + 1] * b1 + c[_A_N2 + 1] * b2,
            c[_A_N0 + 2] * b0 + c[_A_N1 + 2] * b1 + c[_A_N2 + 2] * b2,
        )
        if cfg.two_level:
            # object -> world: edges by the instance linear A, normals by
            # A^-T (correct under the format's signed-uniform scales,
            # vkr.h:15 transform encoding)
            inst = jnp.maximum(hit.inst, 0)
            A = ds.tlas.inst_linear[inst].reshape(-1, 3, 3)
            Ait = ds.tlas.inst_inv_t[inst].reshape(-1, 3, 3)
            # (elementwise products, not matmuls: a float32 matmul may
            # run in TF32 on the GPU)
            e1 = _mat3_apply(A, e1)
            e2 = _mat3_apply(A, e2)
            n_sh = _mat3_apply(Ait, n_sh)
        gn_raw = v3.cross(e1, e2)
        gn_raw = v3.where(v3.dot(n_sh, gn_raw) < 0.0, -gn_raw, gn_raw)
        gn_len = v3.length(gn_raw)  # 2*area
        gn = gn_raw * (1.0 / jnp.maximum(gn_len, 1e-20))
        # approx solid angle of the hit triangle as seen from the origin
        approx_sa = (
            (0.5 * gn_len)
            * jnp.abs(v3.dot(gn, rd))
            / jnp.maximum(hit.t * hit.t, 1e-20)
        )
        n_sh = v3.normalize(n_sh)

        mid = c[_A_MID].astype(jnp.int32)
        if cfg.two_level:
            mid = mid + ds.tlas.inst_mat_offset[inst]
        mat_ranges = (
            [(_M_BASE, _M_NMTEX + 1)] if cfg.has_textures
            else [(_M_BASE, _M_BCTEX)]
        )
        if cfg.thin_transmission:
            mat_ranges = mat_ranges + [(_M_CCGLOSS, _M_CCGLOSS + 1)]
        mc = _fetch_cols_ranges(ds.mat_packed, mid, mat_ranges)
        mat = _material_from_cols(mc, thin=cfg.thin_transmission)

        p = ro + rd * hit.t
        w_o = -rd

        # two-sided flip (pt_megakernel.glsl:622-634)
        backface = v3.dot(w_o, gn) < 0.0
        flip = backface & (mat.onesided == False)  # noqa: E712
        n_sh = v3.where(flip, -n_sh, n_sh)
        gn = v3.where(flip, -gn, gn)

        total_t = jnp.where(active, total_t + hit.t, total_t)

        # ---- texture lookups (rt/material_textures.glsl; mip from an
        # isotropic footprint-cone approximation of rt/footprint.glsl)
        if cfg.has_textures:
            uv = jnp.stack(
                [
                    c[_A_UV0] * b0 + c[_A_UV1] * b1 + c[_A_UV2] * b2,
                    c[_A_UV0 + 1] * b0 + c[_A_UV1 + 1] * b1 + c[_A_UV2 + 1] * b2,
                ],
                axis=-1,
            )
            density = c[_A_DENS]
            if cfg.two_level:
                # object-space density scales by 1/|s| in world units
                density = density / jnp.maximum(ds.tlas.inst_scale[inst], 1e-8)
            # transported ray-differential footprint -> surface-projected
            # differentials (pt_megakernel.glsl:585-604): eigen-decompose
            # the footprint, elongate along the grazing tangent, scale by
            # path length. The atlas sampler is isotropic-mip, so the
            # anisotropic duvdxy collapses to its dominant axis length.
            dpdx, dpdy = _footprint_to_dpdxy_v(rd, *foot)
            dt_un = rd - gn * v3.dot(rd, gn)
            cos2 = jnp.maximum(1.0 - v3.dot(dt_un, dt_un), 0.0)
            elong_s = 1.0 / jnp.maximum(jnp.sqrt(cos2) + cos2, 1e-6)
            ex = dt_un * elong_s
            dpdx_e = dpdx + ex * v3.dot(dpdx, dt_un)
            dpdy_e = dpdy + ex * v3.dot(dpdy, dt_un)
            footprint_world = (
                jnp.maximum(v3.length(dpdx_e), v3.length(dpdy_e)) * total_t
            )

            def tex_mip(tid):
                base_w = ds.atlas.desc[jnp.maximum(tid, 0), 0, 1].astype(
                    jnp.float32
                )
                return jnp.log2(
                    jnp.maximum(footprint_world * density * base_w, 1.0)
                )

            if cfg.aniso_taps > 0 and not cfg.two_level:
                # exact anisotropic UV derivatives: project the
                # (elongated, path-scaled) world footprint vectors onto
                # the triangle's UV parametrization via the edge metric
                # (the duvdxy the reference feeds textureGrad). Attr rows
                # hold world-space E1/E2 on the flattened path.
                e1v = Vec3(c[_A_E1], c[_A_E1 + 1], c[_A_E1 + 2])
                e2v = Vec3(c[_A_E2], c[_A_E2 + 1], c[_A_E2 + 2])
                g11 = v3.dot(e1v, e1v)
                g12 = v3.dot(e1v, e2v)
                g22 = v3.dot(e2v, e2v)
                det = jnp.maximum(g11 * g22 - g12 * g12, 1e-20)
                du1 = c[_A_UV1] - c[_A_UV0]
                dv1 = c[_A_UV1 + 1] - c[_A_UV0 + 1]
                du2 = c[_A_UV2] - c[_A_UV0]
                dv2 = c[_A_UV2 + 1] - c[_A_UV0 + 1]

                def duv_of(dp):
                    w = dp * total_t
                    p1 = v3.dot(w, e1v)
                    p2 = v3.dot(w, e2v)
                    a = (p1 * g22 - p2 * g12) / det
                    b = (p2 * g11 - p1 * g12) / det
                    return jnp.stack(
                        [a * du1 + b * du2, a * dv1 + b * dv2], axis=-1
                    )

                duvdx = duv_of(dpdx_e)
                duvdy = duv_of(dpdy_e)

                def tex_sample(tid):
                    return sample_atlas_aniso(
                        ds.atlas, tid, uv, duvdx, duvdy,
                        taps=int(cfg.aniso_taps),
                    )
            else:
                def tex_sample(tid):
                    return sample_atlas(ds.atlas, tid, uv, tex_mip(tid))

            bc_tid = mc[_M_BCTEX].astype(jnp.int32)
            bc = tex_sample(bc_tid)
            base = v3.where(
                bc_tid >= 0, v3.from_array(bc[..., :3]), mat.base_color
            )
            mat = mat._replace(base_color=base, transmission_color=base)

            sp_tid = mc[_M_SPTEX].astype(jnp.int32)
            sp = tex_sample(sp_tid)
            has_sp = sp_tid >= 0
            mat = mat._replace(
                roughness=jnp.where(has_sp, sp[..., 1], mat.roughness),
                metallic=jnp.where(has_sp, sp[..., 2], mat.metallic),
            )

            # normal mapping in the uv tangent frame
            # (pt_megakernel.glsl:636-648)
            nm_tid = mc[_M_NMTEX].astype(jnp.int32)
            nm = tex_sample(nm_tid)
            tn = Vec3(
                (nm[..., 0] * 2.0 - 1.0) * fp.bump_scale,
                (nm[..., 1] * 2.0 - 1.0) * fp.bump_scale,
                nm[..., 2] * 2.0 - 1.0,
            )
            tang = Vec3(c[_A_TAN], c[_A_TAN + 1], c[_A_TAN + 2])
            if cfg.two_level:
                tang = _mat3_apply(A, tang)
            tang = v3.normalize(tang - n_sh * v3.dot(tang, n_sh))
            hand = c[_A_TAN + 3]
            if cfg.two_level:
                hand = hand * ds.tlas.inst_sign[inst]
            bitan = v3.cross(n_sh, tang) * hand
            n_mapped = v3.normalize(tang * tn.x + bitan * tn.y + n_sh * tn.z)
            ok_nm = (nm_tid >= 0) & (v3.length(tn) > 1e-4)
            n_sh = v3.where(ok_nm, n_mapped, n_sh)

        # ---- emitter hit MIS (shade_base_material.glsl:33-39)
        emit_intensity = mc[_M_EMIT]
        emit_radiance = mat.base_color * emit_intensity
        has_emit = emit_intensity > 0.0
        wpdf_light = (1.0 - ds.sky.sun_radiance[3]) * nee_mod.approx_tri_lights_pdf(
            approx_sa, max(cfg.num_lights, 1), num_bins, cfg.use_light_bins
        )
        w_emit = nee_mod.nee_mis_heuristic(1.0, prev_pdf, 1.0, wpdf_light)
        illum = v3.where(
            active & has_emit,
            illum + throughput * emit_radiance * w_emit,
            illum,
        )

        bounce_count = jnp.where(active, bounce_count + 1, bounce_count)

        carry = (ro, rd, t_min, illum, throughput, active, prev_pdf,
                 bounce_count, total_t, rng_state, rays)
        if cfg.wavefront:
            carry = carry + (pend,)
        if cfg.has_textures:
            carry = carry + (foot,)
        if cfg.debug_mode:
            carry = carry + (dbg,)
        ctx = (p, n_sh, gn, mat, w_o)
        return carry, ctx

    def scatter_tail(args, compact=False, sort_shadow=False):
        """NEE + BSDF sample + RR — skipped on the final bounce.

        ``sort_shadow``: this bounce's NEE occlusion queue (origins =
        fresh hit points) gets its own coherence sort before the GPU
        walk — see occluded_alpha. Static per call site: bounce 0's
        primary-hit origins are already swizzle-coherent."""
        carry, ctx, bounce_i = args
        (ro, rd, t_min, illum, throughput, active, prev_pdf,
         bounce_count, total_t, rng_state, rays) = carry[:11]
        _i = 11
        if cfg.wavefront:
            pend = carry[_i]
            _i += 1
        if cfg.has_textures:
            foot = carry[_i]
        if cfg.debug_mode:
            dbg = carry[-1]
        p, n_sh, gn, mat, w_o = ctx

        # ---- RNG draws in reference order (shade_base_material.glsl:60-84)
        # with pathspace dims (pathspace.h): bounce block = 2 + 8b, light
        # dims first {sel:+0, pos:+2} then vertex dims {dir:+4, lobe:+6},
        # RR reusing the free-path slot {+7}
        dim_base = jnp.int32(DIM_CAMERA_END(cfg)) + jnp.int32(8) * bounce_i
        rv = cfg.rng_variant
        rng_state, pos_sample = pointsets.draw2t(rv, ds.rng, rng_state, dim_base + 2)
        rng_state, sel_sample = pointsets.draw2t(rv, ds.rng, rng_state, dim_base + 0)
        rng_state, lobe_sample = pointsets.draw2t(rv, ds.rng, rng_state, dim_base + 6)
        rng_state, dir_sample = pointsets.draw2t(rv, ds.rng, rng_state, dim_base + 4)

        # ---- NEE (one shadow ray per active lane)
        rays = rays + active.astype(rays.dtype)
        if cfg.wavefront:
            # wavefront: queue the candidate's occlusion ray for the next
            # bounce's merged intersect dispatch (resolved in visit_hit);
            # degenerate-segment candidates are visible without tracing
            # and apply right here (per-lane it is one or the other, so
            # the megakernel's accumulation order is preserved)
            cand = _nee_candidate(
                ds, cfg, p, n_sh, gn, mat, w_o, pos_sample, sel_sample,
                total_t,
            )
            scaled = throughput * cand.contrib
            illum = v3.where(cand.uncond & active, illum + scaled, illum)
            had_nee = active  # lanes owning a queued occlusion ray
            pend = (
                cand.dir,
                cand.eps,
                cand.shadow_tmax,
                scaled,
                cand.traced & active,
            )
        else:
            dbg_full = cfg.debug_mode == _DBG_ANY_FULL
            nee_contrib = _sample_direct_light(
                ds, cfg, p, n_sh, gn, mat, w_o, pos_sample, sel_sample,
                total_t, compact=compact, count_evals=dbg_full,
                sort_shadow=sort_shadow,
            )
            if dbg_full:
                nee_contrib, ev_s = nee_contrib
                dbg = dbg + ev_s
            illum = v3.where(active, illum + throughput * nee_contrib, illum)

        # glossy-only debug mode (shade_base_material.glsl:69-70)
        glossy_cut = (fp.glossy_only_mode != 0) & ~(
            (mat.roughness < 0.1) & (mat.ior != 1.0)
        )
        active = active & ~glossy_cut

        # ---- BSDF sample
        vx, vy = nee_mod.ortho_frame_v(n_sh)
        weight, w_i, spdf, mis_wpdf = sample_gltf_brdf_v(
            mat, n_sh, w_o, vx, vy, dir_sample, lobe_sample,
            cfg.has_transmission, cfg.thin_transmission,
        )
        valid_dir = v3.dot(w_i, n_sh) * v3.dot(w_i, gn) > 0.0
        weight_zero = (weight.x == 0.0) & (weight.y == 0.0) & (weight.z == 0.0)
        terminate = (mis_wpdf == 0.0) | weight_zero | ~valid_dir
        keep = active & ~terminate
        throughput = v3.where(keep, throughput * weight, throughput)
        prev_pdf = jnp.where(keep, mis_wpdf, prev_pdf)
        active = keep

        if cfg.has_textures:
            # transport the texture footprint across the bounce
            # (pt_megakernel.glsl:698-701)
            do_ref = active & (
                v3.dot(w_i, n_sh) * v3.dot(w_o, n_sh) > -0.999
            )
            ra, rb, rc = _reflect_footprint_v(w_i, rd, *foot)
            foot = (
                jnp.where(do_ref, ra, foot[0]),
                jnp.where(do_ref, rb, foot[1]),
                jnp.where(do_ref, rc, foot[2]),
            )

        rd = v3.where(active, w_i, rd)
        if cfg.wavefront:
            # the deferred NEE occlusion ray of the NEXT visit starts at
            # THIS hit point — including lanes whose path just terminated
            # (their pend.traced is still set); dead lanes' ro is
            # otherwise unused, so moving it to p is safe
            ro = v3.where(active | had_nee, p, ro)
        else:
            ro = v3.where(active, p, ro)
        t_min = (v3.length(ro) + total_t) * RAY_EPSILON

        # ---- Russian roulette (pt_megakernel.glsl:713-730)
        rng_state, rr_sample = pointsets.draw1(
            cfg.rng_variant, ds.rng, rng_state, dim_base + 7
        )
        prefix = v3.max_component(throughput)
        rr_prob = jnp.where(
            bounce_count > 6, jnp.minimum(0.95, prefix), jnp.minimum(1.0, prefix)
        )
        do_rr = active & (bounce_count >= fp.rr_path_depth)
        survive = rr_sample < rr_prob
        throughput = v3.where(
            do_rr & survive,
            throughput * (1.0 / jnp.maximum(rr_prob, 1e-9)),
            throughput,
        )
        active = active & (~do_rr | survive)

        out = (ro, rd, t_min, illum, throughput, active, prev_pdf,
               bounce_count, total_t, rng_state, rays)
        if cfg.wavefront:
            out = out + (pend,)
        if cfg.has_textures:
            out = out + (foot,)
        if cfg.debug_mode:
            out = out + (dbg,)
        return out

    return visit_hit, scatter_tail


def trace_paths(
    ds: DeviceScene,
    cfg: IntegratorConfig,
    fp: FrameParams,
    ro,
    rd,
    rng_state,
    lane_mask=None,
    footprint0=None,
    t_max0=None,
):
    """Trace a batch of paths; returns (rgb Vec3, alpha (N,), rays (N,)).

    ``ro``/``rd`` are Vec3 SoA triples (ops/vec3.py): every per-ray vector
    lives as three 1-D arrays, the layout the shading math and the
    traversal kernel's ray operands both take, so no relayout copies.

    ``rays`` is the per-lane traced-ray count (closest + shadow) — the
    REPORT_RAY_STATS per-pixel image (render_vulkan.h:87-91); sum it for
    the aggregate counter.

    The bounce loop runs as ``lax.fori_loop`` by default (the reference's
    DYNAMIC_LOOP_BOUNCES mode) or statically unrolled when ``cfg.unroll``
    (the self-#include unroll, pt_megakernel.glsl:390-415). The last bounce
    is an epilogue doing only traverse + emitter/sky — NEE/BSDF work is cut
    there (shade_base_material.glsl:56-57).
    """
    n = ro.x.shape[0]
    num_bins = max(cfg.num_lights // max(cfg.light_bin_size, 1), 1)
    # carry layout: 0 ro, 1 rd, 2 t_min, 3 illum, 4 throughput, 5 active,
    # 6 prev_pdf, 7 bounce_count, 8 total_t, 9 rng_state, 10 rays
    # [+ 11 pending NEE queue in wavefront mode]
    _ACTIVE = 5
    zero_n = jnp.zeros((n,), jnp.float32)
    false_n = jnp.zeros((n,), bool)
    # pending NEE queue (wavefront): only candidates that NEED a
    # visibility ray are deferred — degenerate-segment (uncond) ones are
    # applied at scatter time, and the traced flag is folded into the
    # tmax sign-free encoding (tmax <= tmin means dead). 8 carry arrays.
    empty_pend = (
        Vec3(zero_n, zero_n + 1.0, zero_n),  # shadow dir (unit dummy)
        zero_n,  # shadow t_min (candidate eps)
        zero_n,  # shadow tmax (0 = dead/no candidate)
        Vec3(zero_n, zero_n, zero_n),  # throughput-scaled contribution
        false_n,  # traced: pending visibility ray for this lane
    )

    visit_hit, scatter_tail = _make_bounce_fns(ds, cfg, fp, t_max0)

    def bounce_body(i, carry):
        # live-lane compaction engages once lanes can be dead: from
        # bounce 1 (unrolled; bounce 0 is all-live) or always in the
        # dynamic loop (the flag must be trace-static there)
        compact = cfg.compact and ((i > 0) if isinstance(i, int) else True)

        def live_body(carry):
            carry, ctx = visit_hit(carry, compact=compact)
            if isinstance(i, int):
                # unrolled: final-bounce cut resolved in Python
                # (shade_base_material.glsl:56-57)
                if i < cfg.max_path_depth - 1:
                    carry = scatter_tail(
                        (carry, ctx, jnp.int32(i)), compact=compact,
                        sort_shadow=i > 0,
                    )
            else:
                # dynamic loop: scalar predicate, real branch.
                # sort_shadow unconditionally — the bounce index is
                # traced here, and sorting the bounce-0 queue as well
                # costs one extra sort, while leaving the scattered
                # bounce>=1 origins unsorted costs a divergent walk
                carry = jax.lax.cond(
                    i < cfg.max_path_depth - 1,
                    partial(scatter_tail, compact=compact,
                            sort_shadow=True),
                    lambda args: args[0],
                    (carry, ctx, jnp.asarray(i, jnp.int32)),
                )
            return carry

        # whole-wave early out: once every lane is dead (RR/absorption/sky)
        # AND no NEE occlusion rays are pending, the remaining bounces are
        # skipped in one scalar branch — the fixed-shape analogue of the
        # reference's per-thread loop break (pt_megakernel.glsl:445-449)
        live = jnp.any(carry[_ACTIVE])
        if cfg.wavefront:
            live = live | jnp.any(carry[11][4])
        carry = jax.lax.cond(live, live_body, lambda c: c, carry)
        return carry

    active0 = (
        jnp.ones((n,), bool) if lane_mask is None else jnp.asarray(lane_mask)
    )
    zero = jnp.zeros((n,), jnp.float32)
    one = jnp.ones((n,), jnp.float32)
    carry = (
        ro,
        rd,
        zero,  # t_min
        Vec3(zero, zero, zero),  # illum
        Vec3(one, one, one),  # throughput
        active0,  # active (padded/invalid lanes start dead)
        jnp.full((n,), 2.0e16, jnp.float32),  # prev_pdf (shading_interface:21)
        jnp.zeros((n,), jnp.int32),  # bounce_count
        zero,  # total_t
        rng_state,
        jnp.zeros((n,), jnp.int32),  # per-lane rays traced
    )
    if cfg.wavefront:
        carry = carry + (empty_pend,)
    if cfg.has_textures:
        if footprint0 is None:
            footprint0 = (zero, zero, zero)
        else:
            footprint0 = tuple(
                jnp.broadcast_to(f, (n,)) for f in footprint0
            )
        carry = carry + (footprint0,)
    if cfg.debug_mode:
        carry = carry + (jnp.zeros((n,), jnp.int32),)  # debug counter
    # carry-level compaction (cfg.compact_lanes): see the config-field
    # comment. Gated off for bounded primary segments (t_max0 rides a
    # full-width closure) and debug counters (dead-lane evals differ).
    use_lane_compact = (
        cfg.compact_lanes and t_max0 is None and not cfg.debug_mode
        and cfg.max_path_depth > 1
    )
    sizes = []
    if use_lane_compact:
        sizes = [
            n >> j
            for j in range(_COMPACT_MAX_HALVINGS + 1)
            if (n >> j) >= _COMPACT_LANE_QUANTUM
            and (n >> j) % _COMPACT_LANE_QUANTUM == 0
        ]
        use_lane_compact = len(sizes) > 1
    lane_id = None
    if use_lane_compact:
        blo, bhi = _scene_bounds_of(ds)

        def live_run(b_i, carry):
            # live_run only serves bounces >= 1 (bounce 0 goes through
            # bounce_body below): the NEE occlusion queue's origins are
            # fresh hit points, so it always gets its own sort
            carry, ctx = visit_hit(carry, compact=False, presorted=True)
            return jax.lax.cond(
                b_i < cfg.max_path_depth - 1,
                partial(scatter_tail, compact=False, sort_shadow=True),
                lambda args: args[0],
                (carry, ctx, jnp.asarray(b_i, jnp.int32)),
            )

        def body2(b_i, state):
            carry_, lid = state
            live = carry_[_ACTIVE]
            if cfg.wavefront:
                live = live | carry_[11][4]

            def do(state):
                carry_, lid = state
                key = _carry_coherence_key(
                    carry_[0], carry_[1], live, blo, bhi
                )
                perm = jnp.argsort(key, stable=True)
                carry_ = _permute_lanes(carry_, perm)
                lid = lid[perm]
                live_cnt = jnp.sum(live.astype(jnp.int32))
                kidx = jnp.zeros((), jnp.int32)
                for j in range(1, len(sizes)):
                    kidx = kidx + (live_cnt <= sizes[j]).astype(jnp.int32)

                def make_branch(m):
                    def br(carry_):
                        head = jax.tree_util.tree_map(
                            lambda a: a[:m], carry_
                        )
                        head = live_run(b_i, head)
                        if m == n:
                            return head
                        return jax.tree_util.tree_map(
                            lambda h, a: jnp.concatenate([h, a[m:]]),
                            head, carry_,
                        )
                    return br

                carry_ = jax.lax.switch(
                    kidx, [make_branch(m) for m in sizes], carry_
                )
                return carry_, lid

            return jax.lax.cond(jnp.any(live), do, lambda s: s, state)

        # bounce 0 at full width (all-live, swizzle-coherent primaries —
        # sorting would only scramble them); int index -> unrolled
        # semantics in bounce_body
        carry = bounce_body(0, carry)
        lane_id = jnp.arange(n, dtype=jnp.int32)
        carry, lane_id = jax.lax.fori_loop(
            1, cfg.max_path_depth, body2, (carry, lane_id)
        )
    elif cfg.unroll:
        for i in range(cfg.max_path_depth):
            carry = bounce_body(i, carry)
    else:
        carry = jax.lax.fori_loop(0, cfg.max_path_depth, bounce_body, carry)

    illum = carry[3]
    bounce_count = carry[7]
    rays_traced = carry[10]
    if cfg.wavefront:
        # flush: the last bounce may have queued NEE occlusion rays that
        # no further visit_hit resolved (only reachable when the loop ran
        # a scatter_tail on its final iteration, i.e. never with the
        # standard depth schedule, but kept for safety — a scalar cond
        # skips the dispatch entirely when the queue is empty). Index
        # unpack: the carry may also hold the texture footprint after pend.
        ro_f = carry[0]
        pend = carry[11]
        nd, ntmin, ntmax, ncontrib, ntraced = pend

        def flush(illum):
            ntmax_eff = jnp.where(ntraced, ntmax, 0.0)
            blocked = occluded_alpha(
                ds, cfg, ro_f, nd, t_min=ntmin, t_max=ntmax_eff
            )
            return v3.where(ntraced & ~blocked, illum + ncontrib, illum)

        illum = jax.lax.cond(jnp.any(ntraced), flush, lambda x: x, illum)
    if use_lane_compact:
        # the carry is in (cumulative) sorted order; lane_id maps sorted
        # slot -> original lane, so its argsort is the inverse gather
        inv = jnp.argsort(lane_id)
        illum, bounce_count, rays_traced = _permute_lanes(
            (illum, bounce_count, rays_traced), inv
        )
    alpha = jnp.where(bounce_count == 0, 0.0, 1.0)
    if cfg.debug_mode:
        # DEBUG_MODE_* image value (hit.rchit:459-463): any-hit evaluation
        # count (epilogue NEE flush not counted) or bounce count
        dbg = bounce_count if cfg.debug_mode == _DBG_BOUNCE else carry[-1]
        return illum, alpha, rays_traced, dbg
    return illum, alpha, rays_traced


def camera_rays_v(view: ViewBuffers, px, py, dims, j0, j1):
    """Primary rays (pt_megakernel.glsl:315-323), SoA: px/py int arrays,
    (j0, j1) jitter components in [0,1). Returns (ro, rd) Vec3."""
    point_x = (px.astype(jnp.float32) + 0.5 + (j0 - 0.5)) / dims[0]
    point_y = (py.astype(jnp.float32) + 0.5 + (j1 - 0.5)) / dims[1]
    du, dv, tl = view.cam_du, view.cam_dv, view.cam_dir_top_left
    rd = v3.normalize(
        Vec3(
            point_x * du[0] + point_y * dv[0] + tl[0],
            point_x * du[1] + point_y * dv[1] + tl[1],
            point_x * du[2] + point_y * dv[2] + tl[2],
        )
    )
    shape = px.shape
    ro = Vec3(
        jnp.broadcast_to(view.cam_pos[0], shape),
        jnp.broadcast_to(view.cam_pos[1], shape),
        jnp.broadcast_to(view.cam_pos[2], shape),
    )
    return ro, rd


# ---------------------------------------------------------------------------
# Ray-differential texture footprint (rt/footprint.glsl), SoA
# ---------------------------------------------------------------------------


def _dpdxy_to_footprint_v(rd: Vec3, dpdx: Vec3, dpdy: Vec3):
    """dpdxy_to_footprint (footprint.glsl:10-15): the symmetric 2x2
    covariance of the pixel differentials in the ray-perpendicular basis,
    stored as (F00, F11, F01)."""
    t, b = nee_mod.ortho_frame_v(rd)
    tx, ty = v3.dot(t, dpdx), v3.dot(t, dpdy)
    bx, by = v3.dot(b, dpdx), v3.dot(b, dpdy)
    return tx * tx + ty * ty, bx * bx + by * by, tx * bx + ty * by


def _footprint_to_dpdxy_v(rd: Vec3, fa, fb, fc):
    """footprint_to_dpdxy (footprint.glsl:44-61): eigen-decompose F back
    into two world-space differential vectors."""
    B = fa + fb
    C = fa * fb - fc * fc
    D = jnp.sqrt(jnp.maximum(B * B * 0.25 - C, 0.0))
    ev0 = 0.5 * B - D
    ev1 = 0.5 * B + D
    use = jnp.abs(fc) > 3.0e-39
    x0x = jnp.where(use, fc, 1.0)
    x0y = jnp.where(use, ev0 - fa, 0.0)
    x1x = jnp.where(use, ev1 - fb, 0.0)
    x1y = jnp.where(use, fc, 1.0)
    inv0 = 1.0 / jnp.maximum(jnp.sqrt(x0x * x0x + x0y * x0y), 1e-30)
    inv1 = 1.0 / jnp.maximum(jnp.sqrt(x1x * x1x + x1y * x1y), 1e-30)
    s0 = jnp.sqrt(jnp.maximum(ev0, 0.0)) * inv0
    s1 = jnp.sqrt(jnp.maximum(ev1, 0.0)) * inv1
    t, b = nee_mod.ortho_frame_v(rd)
    dpdx = Vec3(
        (t.x * x0x + b.x * x0y) * s0,
        (t.y * x0x + b.y * x0y) * s0,
        (t.z * x0x + b.z * x0y) * s0,
    )
    dpdy = Vec3(
        (t.x * x1x + b.x * x1y) * s1,
        (t.y * x1x + b.y * x1y) * s1,
        (t.z * x1x + b.z * x1y) * s1,
    )
    return dpdx, dpdy


def _reflect_footprint_v(w_i: Vec3, rd: Vec3, fa, fb, fc):
    """reflect_footprint (footprint.glsl:37-42): mirror the footprint
    across the half-vector and re-express it in the new ray's basis."""
    n = v3.normalize(w_i - rd)
    ts, bs = nee_mod.ortho_frame_v(rd)
    rt = ts - n * (2.0 * v3.dot(n, ts))
    rb = bs - n * (2.0 * v3.dot(n, bs))
    td, bd = nee_mod.ortho_frame_v(w_i)
    t00, t01 = v3.dot(td, rt), v3.dot(td, rb)
    t10, t11 = v3.dot(bd, rt), v3.dot(bd, rb)
    m00 = t00 * fa + t01 * fc
    m01 = t00 * fc + t01 * fb
    m10 = t10 * fa + t11 * fc
    m11 = t10 * fc + t11 * fb
    return (
        m00 * t00 + m01 * t01,
        m10 * t10 + m11 * t11,
        m00 * t10 + m01 * t11,
    )


def camera_footprint0(cfg: IntegratorConfig, fp: FrameParams,
                      view: ViewBuffers, dims, rd: Vec3):
    """Initial texture footprint from the pixel differentials
    (pt_megakernel.glsl:340-351): dpdx = cam_du/W * pixel_radius etc.
    None unless the config traces textures."""
    if not cfg.has_textures:
        return None
    sx = fp.pixel_radius / dims[0]
    sy = fp.pixel_radius / dims[1]
    dpdx = Vec3(view.cam_du[0] * sx, view.cam_du[1] * sx, view.cam_du[2] * sx)
    dpdy = Vec3(view.cam_dv[0] * sy, view.cam_dv[1] * sy, view.cam_dv[2] * sy)
    return _dpdxy_to_footprint_v(rd, dpdx, dpdy)


def DIM_CAMERA_END(cfg: IntegratorConfig) -> int:
    """Path-space camera dimension count (pathspace.h): the simplified
    camera uses dims 0-1; thin-lens DoF switches to the full camera with
    aperture at dims 4-5 (DIM_APERTURE_X/Y) and bounces from dim 6."""
    return 6 if cfg.enable_dof else 2


def camera_setup(ds: DeviceScene, cfg: IntegratorConfig, fp: FrameParams,
                 view: ViewBuffers, px, py, dims, state):
    """Pixel jitter draw + primary ray + optional thin-lens aperture
    sampling (perspective.rgen:95-109). Returns (state, ro, rd)."""
    state, (j0, j1) = pointsets.draw2t(
        cfg.rng_variant, ds.rng, state, jnp.int32(0)
    )
    ro, rd = camera_rays_v(view, px, py, dims, j0, j1)
    if not cfg.enable_dof:
        return state, ro, rd
    # thin lens: focus plane at focus_distance along the ray; offset the
    # origin by a concentric disk sample scaled by aperture_radius in the
    # normalized (du, dv) screen basis, re-aim at the focus point
    state, (r0, r1) = pointsets.draw2t(
        cfg.rng_variant, ds.rng, state, jnp.int32(4)
    )
    focus = ro + rd * fp.focus_distance
    phi = (2.0 * np.pi) * r0
    r = jnp.sqrt(r1) * fp.aperture_radius
    lx, ly = jnp.cos(phi) * r, jnp.sin(phi) * r
    du = view.cam_du / jnp.maximum(jnp.linalg.norm(view.cam_du), 1e-20)
    dv = view.cam_dv / jnp.maximum(jnp.linalg.norm(view.cam_dv), 1e-20)
    ro = Vec3(
        ro.x + lx * du[0] + ly * dv[0],
        ro.y + lx * du[1] + ly * dv[1],
        ro.z + lx * du[2] + ly * dv[2],
    )
    return state, ro, v3.normalize(focus - ro)


def camera_rays(view: ViewBuffers, px, py, dims, jitter):
    """Array wrapper: jitter (...,2); returns (..., 3) arrays."""
    ro, rd = camera_rays_v(view, px, py, dims, jitter[..., 0], jitter[..., 1])
    return v3.to_array(ro), v3.to_array(rd)


def render_tile(
    ds: DeviceScene,
    cfg: IntegratorConfig,
    fp: FrameParams,
    view: ViewBuffers,
    width: int,
    height: int,
    spp: int,
    y0=0,
    tile_h: Optional[int] = None,
    x0=0,
    tile_w: Optional[int] = None,
):
    """Render a pixel tile: returns accum (tile_h, tile_w, 4) = mean over
    the spp batch (radiance, alpha). ``y0``/``x0`` may be traced — the
    unit of multi-device work distribution (parallel/render_sharded.py:
    1-D row bands or a 2-D (rows, cols) tile mesh), the counterpart of the
    reference's SIMT dispatch grid (vulkan/setup_pixel_assignment.glsl).
    ``width``/``height`` stay the FULL frame dims (camera mapping + RNG
    pixel keying are global)."""
    tile_h = tile_h if tile_h is not None else height
    tile_w = tile_w if tile_w is not None else width

    # 16x16 pixel tiles -> 256-ray packets, the counterpart of the
    # reference's 32x16 workgroup + pixel swizzle
    # (vulkan/setup_pixel_assignment.glsl:18-25): neighbouring lanes hold
    # neighbouring primary rays, which keeps traversal divergence low.
    #
    # Chunks accumulate CONTIGUOUSLY in swizzle order (one
    # dynamic_update_slice per pass — an in-place row-block write) and the
    # frame is unswizzled with a single constant-index gather at the end;
    # a per-chunk scatter-add into pixel order would serialize where the
    # gather pipelines.
    px_rel_np, py_rel_np, valid_np, _lin, inv_np, num_chunks, chunk = (
        _swizzle_host(tile_w, tile_h)
    )
    n_pad = num_chunks * chunk
    px_c = jnp.asarray(px_rel_np.reshape(num_chunks, chunk)) + x0
    py_c = jnp.asarray(py_rel_np.reshape(num_chunks, chunk)) + y0
    valid_c = jnp.asarray(valid_np.reshape(num_chunks, chunk))
    dims = jnp.array([width, height], jnp.float32)
    inv = jnp.asarray(inv_np)

    def one_pass(i, carry):
        # SoA accumulators: one buffer per channel, so the pass never
        # stacks an (N, 4) sample
        acc_sw, rays = carry
        s = (i // num_chunks).astype(jnp.uint32)
        c = i % num_chunks
        px = px_c[c]
        py = py_c[c]
        valid = valid_c[c]
        sample_index = fp.sample_offset + s
        state = pointsets.make_state(
            cfg.rng_variant, sample_index, fp.shot_offset, px, py, width,
            bufs=ds.rng,
        )
        state, ro, rd = camera_setup(ds, cfg, fp, view, px, py, dims, state)
        rgb, alpha, nrays = trace_paths(
            ds, cfg, fp, ro, rd, state, lane_mask=valid,
            footprint0=camera_footprint0(cfg, fp, view, dims, rd),
        )
        sample = (rgb.x, rgb.y, rgb.z, alpha)
        nrays = nrays.sum()
        start = c * chunk
        acc_sw = tuple(
            jax.lax.dynamic_update_slice(
                a,
                jax.lax.dynamic_slice(a, (start,), (chunk,))
                + jnp.where(valid, smp, 0.0),
                (start,),
            )
            for a, smp in zip(acc_sw, sample)
        )
        return acc_sw, rays + nrays

    acc_sw = tuple(jnp.zeros((n_pad,), jnp.float32) for _ in range(4))
    rays0 = jnp.zeros((), jnp.int32)
    acc_sw, rays = jax.lax.fori_loop(0, spp * num_chunks, one_pass, (acc_sw, rays0))
    inv_spp = 1.0 / jnp.maximum(spp, 1).astype(jnp.float32)
    # one (N, 4) materialization per frame, at the very end
    acc = jnp.stack([a[inv] * inv_spp for a in acc_sw], axis=-1)
    return acc.reshape(tile_h, tile_w, 4), rays


# ---------------------------------------------------------------------------
# Host-driven frame loop (single-device fast path)
# ---------------------------------------------------------------------------

_TABLE_CACHE: dict = {}
_MAP_CACHE: dict = {}


def _swizzle_host(tile_w: int, tile_h: int):
    """The single host-side construction of the 16x16 packet swizzle for a
    (tile_w, tile_h) tile — shared by render_tile's pass tables, the planar
    fast path's device tables (_swizzle_tables) and the readback blit maps
    (swizzle_maps). Precomputed on the host because leaving it as traced
    arange-chains makes XLA constant-fold it element by element, which
    dominates compile time at 1080p.

    Returns ``(px, py, valid, lin, inv, nc, chunk)``: px/py/valid/lin are
    padded to ``nc * chunk`` slots (in-flight rays per pass bounded by
    RAYS_PER_PASS — all per-bounce intermediates scale with pass size, the
    analogue of the reference's bounded dispatch grid); ``lin[slot]`` is the
    slot's linear pixel (== tile_h * tile_w for invalid/padding slots);
    ``inv[pixel]`` is the pixel's slot."""
    ts = 16
    bw = -(-tile_w // ts)
    bh = -(-tile_h // ts)
    n_rays = bw * bh * ts * ts
    idx = np.arange(n_rays)
    block = idx // (ts * ts)
    within = idx % (ts * ts)
    px = (block % bw) * ts + within % ts
    py = (block // bw) * ts + within // ts
    valid = (px < tile_w) & (py < tile_h)
    px = np.minimum(px, tile_w - 1).astype(np.int32)
    py = np.minimum(py, tile_h - 1).astype(np.int32)
    lin = np.where(valid, py * tile_w + px, tile_h * tile_w).astype(np.int32)
    chunk = min(n_rays, RAYS_PER_PASS)
    n_pad = n_rays + ((-n_rays) % chunk)

    def pad(a, fill):
        if n_pad == n_rays:
            return a
        return np.concatenate([a, np.full(n_pad - n_rays, fill, a.dtype)])

    px, py = pad(px, 0), pad(py, 0)
    valid = pad(valid, False)
    lin = pad(lin, tile_h * tile_w)
    inv = np.zeros(tile_h * tile_w, np.int32)
    inv[lin[valid]] = np.nonzero(valid)[0].astype(np.int32)
    return px, py, valid, lin, inv, n_pad // chunk, chunk


def swizzle_maps(width: int, tile_h: int):
    """Host-side swizzle maps for (width, tile_h): (inv_np, lin_np, n_pad).

    ``inv_np[pixel]`` = the pixel's slot in the swizzle-ordered planar
    buffer; ``lin_np[slot]`` = the slot's linear pixel index (== tile_h *
    width for padding slots). Used by the host blit that reorders the
    device's planar-swizzled framebuffer into an (H, W, 4) image at
    readback, and by the inverse re-swizzle on checkpoint resume."""
    key = (width, tile_h)
    hit = _MAP_CACHE.get(key)
    if hit is not None:
        return hit
    _, _, _, lin_np, inv_np, nc, chunk = _swizzle_host(width, tile_h)
    out = (inv_np, lin_np, nc * chunk)
    _MAP_CACHE[key] = out
    return out


def planes_to_image(planes_np: np.ndarray, width: int, tile_h: int) -> np.ndarray:
    """Host blit: planar-swizzled (4, n_pad) -> (tile_h, width, 4)."""
    inv_np, _, _ = swizzle_maps(width, tile_h)
    return np.ascontiguousarray(planes_np[:, inv_np].T).reshape(tile_h, width, 4)


def image_to_planes(img: np.ndarray, width: int, tile_h: int) -> np.ndarray:
    """Host re-swizzle: (tile_h, width, 4) -> planar-swizzled (4, n_pad)."""
    _, lin_np, n_pad = swizzle_maps(width, tile_h)
    flat = np.concatenate(
        [img.reshape(-1, 4), np.zeros((1, 4), img.dtype)], axis=0
    )
    return np.ascontiguousarray(flat[lin_np].T)


def _swizzle_tables(width: int, tile_h: int):
    """Device-resident swizzle tables for (width, tile_h), cached. Same
    16x16-tile traversal order as render_tile."""
    key = (width, tile_h)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    px_np, py_np, valid_np, _lin, inv_np, nc, chunk = _swizzle_host(
        width, tile_h
    )
    out = (
        [jnp.asarray(px_np.reshape(nc, chunk)[c]) for c in range(nc)],
        [jnp.asarray(py_np.reshape(nc, chunk)[c]) for c in range(nc)],
        [jnp.asarray(valid_np.reshape(nc, chunk)[c]) for c in range(nc)],
        jnp.asarray(inv_np),
        nc,
        chunk,
    )
    _TABLE_CACHE[key] = out
    return out


# two-level scenes: the BLAS arrays stay captured in the pass program;
# everything a TLAS refit changes rides as a call operand
_TLAS_STATIC_FIELDS = ("blas_nodes", "blas_tri_rows", "blas_row_tri")


def tlas_frame_operands(tlas):
    """The per-frame part of a TwoLevelBuffers (BLAS fields set to None):
    what ``make_pass_fn``'s ``tlas_frame`` argument takes."""
    return tlas._replace(**{f: None for f in _TLAS_STATIC_FIELDS})


def make_pass_fn(ds: DeviceScene, cfg: IntegratorConfig, width: int, height: int):
    """Build the jitted single-pass program for a scene.

    One pass (one sample batch over one chunk of RAYS_PER_PASS lanes) is
    one device program; the frame loop lives on the host and dispatches
    it per chunk. The scene is captured as constants, so callers rebuild
    on scene change (the renderer keys its cache on the scene revision).
    The exception is a two-level scene's TLAS side: its per-frame arrays
    come in as ``tlas_frame`` (see tlas_frame_operands), so a per-frame
    TLAS refit (Renderer.set_animation_frame, the reference's TLAS update
    queue, render_vulkan.cpp:1219-1366) never retraces the program."""
    dims = jnp.array([width, height], jnp.float32)

    @partial(jax.jit, donate_argnames=("acc",))
    def pass_fn(fp, view, acc, px, py, valid, s, blend_base, tlas_frame=None):
        dsl = ds
        if tlas_frame is not None:
            dsl = ds._replace(tlas=tlas_frame._replace(
                **{f: getattr(ds.tlas, f) for f in _TLAS_STATIC_FIELDS}))
        return _pass_body(dsl, fp, view, acc, px, py, valid, s, blend_base)

    def _pass_body(ds, fp, view, acc, px, py, valid, s, blend_base):
        """One sample batch over one chunk, accumulated IN PLACE.

        ``acc`` is a 4-tuple of (chunk,) channel buffers, donated and
        blended with the progressive average
        ``acc += (x - acc) / (k + 1)`` (process_samples.comp:116-131,
        applied per sample instead of per batch — same mean). Keeping the
        accumulate inside the pass makes the whole frame loop N pass
        dispatches with no extra device programs.

        ``s`` is the in-batch sample index and ``blend_base`` the number
        of samples already in ``acc`` before this batch; the RNG sample
        index (fp.sample_offset + s) and blend count (blend_base + s)
        are derived in-graph from cacheable device scalars."""
        sample_index = fp.sample_offset + s
        blend_k = blend_base + s
        state = pointsets.make_state(
            cfg.rng_variant, sample_index, fp.shot_offset, px, py, width,
            bufs=ds.rng,
        )
        state, ro, rd = camera_setup(ds, cfg, fp, view, px, py, dims, state)
        rgb, alpha, nrays = trace_paths(
            ds, cfg, fp, ro, rd, state, lane_mask=valid,
            footprint0=camera_footprint0(cfg, fp, view, dims, rd),
        )
        w = 1.0 / (blend_k.astype(jnp.float32) + 1.0)
        fresh = blend_k == 0  # exact overwrite: a+(x-a)/1 rounds
        acc = tuple(
            jnp.where(
                fresh,
                jnp.where(valid, smp, 0.0),
                a + (jnp.where(valid, smp, a) - a) * w,
            )
            for a, smp in zip(acc, (rgb.x, rgb.y, rgb.z, alpha))
        )
        return acc, nrays.sum()

    return pass_fn


def make_ray_stats_fn(ds: DeviceScene, cfg: IntegratorConfig, width: int, height: int):
    """Per-pixel traced-ray-count pass — the REPORT_RAY_STATS image
    (render_vulkan.h:87-91, readback render_vulkan.cpp:321-331)."""
    dims = jnp.array([width, height], jnp.float32)

    @jax.jit
    def stats_fn(fp, view, px, py, valid, sample_index):
        state = pointsets.make_state(
            cfg.rng_variant, sample_index, fp.shot_offset, px, py, width,
            bufs=ds.rng,
        )
        state, ro, rd = camera_setup(ds, cfg, fp, view, px, py, dims, state)
        _, _, nrays = trace_paths(
            ds, cfg, fp, ro, rd, state, lane_mask=valid,
            footprint0=camera_footprint0(cfg, fp, view, dims, rd),
        )
        return jnp.where(valid, nrays, 0)

    return stats_fn


def render_ray_stats_host(
    ds: DeviceScene,
    cfg: IntegratorConfig,
    fp: FrameParams,
    view: ViewBuffers,
    width: int,
    height: int,
    stats_fn=None,
):
    """One-sample ray-stats image (H, W) int32."""
    if stats_fn is None:
        stats_fn = make_ray_stats_fn(ds, cfg, width, height)
    px_c, py_c, valid_c, inv, nc, chunk = _swizzle_tables(width, height)
    counts = [
        stats_fn(fp, view, px_c[c], py_c[c], valid_c[c], fp.sample_offset)
        for c in range(nc)
    ]
    img = jnp.concatenate(counts)[inv].reshape(height, width)
    return img


def make_debug_fn(ds: DeviceScene, cfg: IntegratorConfig, width: int, height: int):
    """Per-pixel DEBUG_MODE heatmap pass (render_params.glsl.h:63-70;
    counts written per pixel like the r16f debug_mode_buffer,
    hit.rchit:459-463). ``cfg.debug_mode`` selects the counter."""
    assert cfg.debug_mode != 0
    dims = jnp.array([width, height], jnp.float32)

    @jax.jit
    def debug_fn(fp, view, px, py, valid, sample_index):
        state = pointsets.make_state(
            cfg.rng_variant, sample_index, fp.shot_offset, px, py, width,
            bufs=ds.rng,
        )
        state, ro, rd = camera_setup(ds, cfg, fp, view, px, py, dims, state)
        _, _, _, dbg = trace_paths(
            ds, cfg, fp, ro, rd, state, lane_mask=valid,
            footprint0=camera_footprint0(cfg, fp, view, dims, rd),
        )
        return jnp.where(valid, dbg, 0)

    return debug_fn


def render_debug_host(
    ds: DeviceScene,
    cfg: IntegratorConfig,
    fp: FrameParams,
    view: ViewBuffers,
    width: int,
    height: int,
    debug_fn=None,
):
    """One-sample DEBUG_MODE count image (H, W) int32."""
    if debug_fn is None:
        debug_fn = make_debug_fn(ds, cfg, width, height)
    px_c, py_c, valid_c, inv, nc, chunk = _swizzle_tables(width, height)
    counts = [
        debug_fn(fp, view, px_c[c], py_c[c], valid_c[c], fp.sample_offset)
        for c in range(nc)
    ]
    return jnp.concatenate(counts)[inv].reshape(height, width)


@partial(jax.jit, static_argnames=("width", "tile_h"))
def _assemble_frame(chunks, rays, inv, width: int, tile_h: int):
    """chunks: list of per-chunk 4-tuples of (chunk,) channel MEANS (the
    pass accumulates in place). Unswizzles per channel and packs the
    (H, W, 4) image once per frame."""
    planes = [jnp.concatenate([c[k] for c in chunks])[inv] for k in range(4)]
    acc = jnp.stack(planes, axis=-1)
    return acc.reshape(tile_h, width, 4), jnp.stack(rays).sum()


@jax.jit
def join_chunk_planes(chunks):
    """Per-chunk channel buffers -> 4-tuple of (n_pad,) channel planes.
    Channels stay separate 1-D arrays (the planar layout the resolve
    reads). This is a readback-time program, kept off the frame loop."""
    return tuple(jnp.concatenate([c[k] for c in chunks]) for k in range(4))


def render_tile_host(
    ds: DeviceScene,
    cfg: IntegratorConfig,
    fp: FrameParams,
    view: ViewBuffers,
    width: int,
    height: int,
    spp: int,
    y0: int = 0,
    tile_h: Optional[int] = None,
    pass_fn=None,
    assemble: bool = True,
    pass_kwargs: Optional[dict] = None,
):
    """Host-driven equivalent of render_tile: one async device dispatch per
    (sample, chunk) pass. Bit-identical results; ~3x faster frames than the
    single-module loop (see make_pass_fn). Host-side only — use render_tile
    under jit/shard_map. Callers rendering repeatedly should build
    ``pass_fn`` once via make_pass_fn and pass it in (rebuilding retraces).

    ``pass_kwargs`` are extra per-call operands of ``pass_fn`` (a
    two-level scene's ``tlas_frame``).

    ``assemble=False`` returns the frame as planar-swizzled (4, n_pad)
    channel planes instead of an (H, W, 4) image — the renderer's fast
    path keeps the whole accumulate/resolve chain planar and lets the
    host blit reorder at readback (see ops/resolve.py resolve_planes)."""
    tile_h = tile_h if tile_h is not None else height
    if pass_fn is None:
        pass_fn = make_pass_fn(ds, cfg, width, height)
    px_c, py_c, valid_c, inv, nc, chunk = _swizzle_tables(width, tile_h)
    accs = [
        tuple(jnp.zeros((chunk,), jnp.float32) for _ in range(4))
        for _ in range(nc)
    ]
    rays = []
    blend_base = jnp.uint32(0)
    for s in range(spp):
        s_dev = jnp.uint32(s)
        for c in range(nc):
            py = py_c[c] if y0 == 0 else py_c[c] + jnp.int32(y0)
            accs[c], nr = pass_fn(
                fp, view, accs[c], px_c[c], py, valid_c[c], s_dev, blend_base,
                **(pass_kwargs or {}),
            )
            rays.append(nr)
    if not assemble:
        return accs, rays
    return _assemble_frame(accs, rays, inv, width, tile_h)
