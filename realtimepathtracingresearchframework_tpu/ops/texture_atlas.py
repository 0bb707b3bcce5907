"""Device texture atlas + filtered sampling.

JAX has no texture-unit access, so the reference's sampled BCn textures
(vulkan/render_vulkan.cpp:1646-1739, rt/material_textures.glsl) become:
- load time: BCn decoded to RGBA8 mips (models/texture.py), every mip of
  every texture packed into ONE flat u32 texel array + a descriptor table
  (offset/width/height per (texture, mip)),
- shading time: gather-based bilinear with wrap addressing, sRGB decoded
  after the gather (filtering stays in texel space like the dedicated-HW
  path, then linearized), mip chosen from an isotropic ray-footprint
  estimate (a cone approximation of the reference's ray-differential
  footprint transport, rt/footprint.glsl — full anisotropic transport is a
  tracked refinement).

The sampler is built to MINIMIZE gather count per lookup (on the
hardware target this was written for, a gather cost the same whether it
fetched 4 B or a 16 B row; not measured on the GPU):

- ``texels_quad`` pre-packs each texel's bilinear 2x2 neighborhood
  (wrap-resolved at build time) into one (P, 4) row — the 4 corner
  gathers collapse to ONE row gather. Costs 4x atlas memory; gated by
  RPTR_ATLAS_QUAD / a size cap.
- ``desc4`` folds (offset, width, height, srgb) into one (T*MAX_MIPS, 4)
  row gather and removes the separate num_mips lookup entirely: build
  time already clamps missing finer mips to the last real one, so
  clipping the mip index to MAX_MIPS-1 is exact.

Everything is fixed-shape vector math + (2 gathers per lookup on the
quad path; 7 on the compatibility path).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

MAX_MIPS = 14

# quad-pack memory gate: 4x u32 per texel; 32M texels = 512 MB quad table
QUAD_PACK_MAX_TEXELS = 32 * 1024 * 1024


class TextureAtlas(NamedTuple):
    texels: jnp.ndarray  # (P,) u32 packed ABGR (r | g<<8 | b<<16 | a<<24)
    desc: jnp.ndarray  # (T, MAX_MIPS, 3) i32: offset, width, height
    num_mips: jnp.ndarray  # (T,) i32
    srgb: jnp.ndarray  # (T,) bool — decode to linear after filtering
    # fast-path tables (None => compatibility path):
    texels_quad: Optional[jnp.ndarray] = None  # (P, 4) u32 2x2 neighborhood
    desc4: Optional[jnp.ndarray] = None  # (T*MAX_MIPS, 4) i32 off/w/h/srgb

    @property
    def count(self) -> int:
        return self.desc.shape[0]


def _want_quad(total_texels: int) -> bool:
    env = os.environ.get("RPTR_ATLAS_QUAD", "")
    if env == "0":
        return False
    if env == "1":
        return True
    return total_texels <= QUAD_PACK_MAX_TEXELS


def build_atlas(textures: List) -> Optional[TextureAtlas]:
    """Pack models.texture.Texture list into a device atlas; None if empty."""
    if not textures:
        return None
    texel_parts = []
    quad_parts = []
    desc = np.zeros((len(textures), MAX_MIPS, 3), np.int64)
    num_mips = np.zeros(len(textures), np.int32)
    srgb = np.zeros(len(textures), bool)
    cursor = 0
    # first pass: total size decides whether the quad table is built
    total = 0
    for tex in textures:
        for mip in tex.mips[:MAX_MIPS]:
            total += mip.shape[0] * mip.shape[1]
    quad = _want_quad(total)
    for ti, tex in enumerate(textures):
        srgb[ti] = bool(tex.srgb)
        mips = tex.mips[:MAX_MIPS]
        if not mips:
            # an all-zero descriptor row would surface as remainder-by-0
            # and garbage texels at sample time — fail fast instead
            raise ValueError(f"texture {ti} has no mip levels")
        num_mips[ti] = len(mips)
        for mi, mip in enumerate(mips):
            h, w = mip.shape[:2]
            rgba = mip.astype(np.uint32)
            packed2d = (
                rgba[..., 0]
                | (rgba[..., 1] << 8)
                | (rgba[..., 2] << 16)
                | (rgba[..., 3] << 24)
            )
            desc[ti, mi] = (cursor, w, h)
            texel_parts.append(packed2d.reshape(-1))
            if quad:
                # 2x2 wrap-resolved neighborhood per texel: the bilinear
                # corner set for base index (y, x) is rows (y, y+1 mod h)
                # x cols (x, x+1 mod w)
                x1 = (np.arange(w) + 1) % w
                y1 = (np.arange(h) + 1) % h
                quad_parts.append(
                    np.stack(
                        [
                            packed2d,
                            packed2d[:, x1],
                            packed2d[y1, :],
                            packed2d[y1][:, x1],
                        ],
                        axis=-1,
                    ).reshape(-1, 4)
                )
            cursor += h * w
        for mi in range(len(mips), MAX_MIPS):
            desc[ti, mi] = desc[ti, len(mips) - 1]
    texels = np.concatenate(texel_parts)
    desc4 = np.concatenate(
        [
            desc.astype(np.int64),
            np.broadcast_to(
                srgb[:, None, None].astype(np.int64),
                (len(textures), MAX_MIPS, 1),
            ),
        ],
        axis=-1,
    ).reshape(-1, 4)
    return TextureAtlas(
        texels=jnp.asarray(texels, jnp.uint32),
        desc=jnp.asarray(desc, jnp.int32),
        num_mips=jnp.asarray(num_mips),
        srgb=jnp.asarray(srgb),
        texels_quad=(
            jnp.asarray(np.concatenate(quad_parts), jnp.uint32)
            if quad else None
        ),
        desc4=jnp.asarray(desc4, jnp.int32),
    )


def _unpack(px):
    px = px.astype(jnp.uint32)
    r = (px & 0xFF).astype(jnp.float32)
    g = ((px >> 8) & 0xFF).astype(jnp.float32)
    b = ((px >> 16) & 0xFF).astype(jnp.float32)
    a = ((px >> 24) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, b, a], axis=-1) * (1.0 / 255.0)


def sample_atlas(atlas: TextureAtlas, tex_id, uv, mip_level):
    """Bilinear wrap sample. tex_id (N,) i32 (>=0; callers mask), uv (N,2),
    mip_level (N,) f32 -> (N,4) linear float."""
    tid = jnp.maximum(tex_id, 0)
    mip_r = jnp.round(mip_level).astype(jnp.int32)
    if atlas.desc4 is not None:
        # one (off, w, h, srgb) row gather; mips past the last real one
        # repeat it in the table, so clipping to MAX_MIPS-1 is exact
        mip = jnp.clip(mip_r, 0, MAX_MIPS - 1)
        d = atlas.desc4[tid * MAX_MIPS + mip]
        off = d[..., 0]
        w = d[..., 1]
        h = d[..., 2]
        is_srgb = d[..., 3] > 0
    else:
        nm = atlas.num_mips[tid]
        mip = jnp.clip(mip_r, 0, nm - 1)
        dd = atlas.desc[tid, mip]  # (N,3)
        off = dd[..., 0]
        w = dd[..., 1]
        h = dd[..., 2]
        is_srgb = atlas.srgb[tid]

    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    x = uv[..., 0] * wf - 0.5
    y = uv[..., 1] * hf - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0.astype(jnp.float32))[..., None]
    fy = (y - y0.astype(jnp.float32))[..., None]

    def wrap(v, m):
        return jnp.remainder(v, m)

    x0w = wrap(x0, w)
    y0w = wrap(y0, h)

    if atlas.texels_quad is not None:
        # ONE row gather fetches the full wrap-resolved 2x2 corner set
        q = atlas.texels_quad[off + y0w * w + x0w]
        p00 = _unpack(q[..., 0])
        p10 = _unpack(q[..., 1])
        p01 = _unpack(q[..., 2])
        p11 = _unpack(q[..., 3])
    else:
        x1w = wrap(x0 + 1, w)
        y1w = wrap(y0 + 1, h)
        p00 = _unpack(atlas.texels[off + y0w * w + x0w])
        p10 = _unpack(atlas.texels[off + y0w * w + x1w])
        p01 = _unpack(atlas.texels[off + y1w * w + x0w])
        p11 = _unpack(atlas.texels[off + y1w * w + x1w])
    out = (
        p00 * (1 - fx) * (1 - fy)
        + p10 * fx * (1 - fy)
        + p01 * (1 - fx) * fy
        + p11 * fx * fy
    )
    # sRGB textures: linearize after filtering
    lin = jnp.where(
        out[..., :3] <= 0.04045,
        out[..., :3] / 12.92,
        ((out[..., :3] + 0.055) / 1.055) ** 2.4,
    )
    rgb = jnp.where(is_srgb[..., None], lin, out[..., :3])
    return jnp.concatenate([rgb, out[..., 3:4]], axis=-1)


def footprint_mip(footprint_world, texels_per_world):
    """Isotropic mip from a world-space footprint radius and the hit
    triangle's texel density (texels per world unit at mip 0 — the
    per-texture resolution is already folded into texels_per_world by
    the flatten, so no atlas lookup is needed here)."""
    texels = footprint_world * texels_per_world
    return jnp.log2(jnp.maximum(texels, 1.0))


def sample_atlas_aniso(atlas: TextureAtlas, tex_id, uv, duvdx, duvdy,
                       taps: int):
    """Anisotropic footprint sample (the textureGrad-style filtering the
    reference gets from the sampler hardware, rt/material_textures.glsl
    + rt/footprint.glsl): ``taps`` bilinear samples distributed along
    the major footprint axis at the mip matching the MINOR axis, so
    grazing views keep detail across the narrow direction instead of
    blurring isotropically.

    duvdx/duvdy are (N,2) UV-space footprint derivative vectors. The
    effective minor length is clamped to major/taps (hardware MAX_ANISO
    clamp) so the tap line always covers the footprint. There is no
    sampler hardware here, so each tap is a full gather set — callers gate
    this behind an option (cost scales linearly with taps)."""
    tid = jnp.maximum(tex_id, 0)
    d0 = atlas.desc[tid, 0]
    wf = d0[..., 1].astype(jnp.float32)
    hf = d0[..., 2].astype(jnp.float32)

    # base-mip texel-space footprint vectors
    ex_u = duvdx[..., 0] * wf
    ex_v = duvdx[..., 1] * hf
    ey_u = duvdy[..., 0] * wf
    ey_v = duvdy[..., 1] * hf
    lx = jnp.sqrt(ex_u * ex_u + ex_v * ex_v)
    ly = jnp.sqrt(ey_u * ey_u + ey_v * ey_v)
    x_major = lx >= ly
    lmaj = jnp.maximum(lx, ly)
    lmin = jnp.minimum(lx, ly)
    # MAX_ANISO = taps: mip covers major/taps when the ratio exceeds it
    lmin_eff = jnp.maximum(lmin, lmaj / jnp.float32(max(taps, 1)))
    mip = jnp.log2(jnp.maximum(lmin_eff, 1.0))

    # major axis in UV space (not texel space: sample offsets are UV)
    mu = jnp.where(x_major, duvdx[..., 0], duvdy[..., 0])
    mv = jnp.where(x_major, duvdx[..., 1], duvdy[..., 1])
    acc = None
    for i in range(taps):
        s = (i + 0.5) / taps - 0.5
        p = sample_atlas(
            atlas, tex_id,
            jnp.stack([uv[..., 0] + mu * s, uv[..., 1] + mv * s], axis=-1),
            mip,
        )
        acc = p if acc is None else acc + p
    return acc * (1.0 / taps)
