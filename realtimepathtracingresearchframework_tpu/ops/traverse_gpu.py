"""GPU BVH traversal kernel (Pallas, Triton route).

One ray per thread over the threaded BVH of ops/bvh.py (``ThreadedBVH``,
device form ``ThreadedBuffers``): every lane keeps its own skip-link
cursor, gathers its own 32-byte node record and, at a leaf, its own
triangle rows, and walks until its cursor leaves the tree. Shadow rays
stop at their first hit (the terminate-on-first-hit ray query the
reference uses for NEE visibility, vulkan/pt_megakernel.glsl:440-478).

The whole walk is one kernel launch per dispatch; ``ops/traverse.py``'s
vmapped ``lax.while_loop`` is the plain reference it must agree with
(``closest_hit_threaded`` / ``occluded_threaded``), and the results have
exactly the same form, so callers can use either.

Static sizes (leaf size) are Python ints outside the buffer pytree.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from realtimepathtracingresearchframework_tpu.ops.bvh import LEAF_SIZE
from realtimepathtracingresearchframework_tpu.ops.intersect import EPS_DET, T_MAX
from realtimepathtracingresearchframework_tpu.ops.traverse import (
    Hit,
    ThreadedBuffers,
)

BLOCK = 32  # rays per program: one warp, one ray per thread. A program
# runs until its slowest ray is done, so the smallest block wins (swept
# 32-256 on an H100)
_NODE_W = 8  # [bmin xyz, bmax xyz, bitcast skip, bitcast leaf_row]
_ROW_W = 12  # [v0 xyz, e1 xyz, e2 xyz, pad]
_T_MISS = float(T_MAX)  # a Python float: kernels take no array constants


def _walk_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmin_ref,
                 tmax_ref, nodes_ref, rows_ref, row_tri_ref, *out_refs,
                 any_hit: bool, leaf_size: int, num_nodes: int):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    t_min = tmin_ref[...]
    t_max = tmax_ref[...]

    def inv(d):  # intersect.safe_inv_dir
        return jnp.where(d >= 0.0, 1.0, -1.0) / jnp.maximum(jnp.abs(d), 1e-20)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)

    def gather(ref, idx, mask, other):
        return plgpu.load(ref.at[idx], mask=mask, other=other)

    def body(c):
        cur, t_best, best_row, best_u, best_v, live = c
        on = live > 0
        base = jnp.where(on, cur, 0) * _NODE_W
        rec = [gather(nodes_ref, base + k, on, 0.0) for k in range(6)]
        skip = jax.lax.bitcast_convert_type(
            gather(nodes_ref, base + 6, on, 0.0), jnp.int32)
        leaf_row = jax.lax.bitcast_convert_type(
            gather(nodes_ref, base + 7, on, 0.0), jnp.int32)

        # slab test against the running closest t (intersect.ray_aabb)
        t0x, t1x = (rec[0] - ox) * ix, (rec[3] - ox) * ix
        t0y, t1y = (rec[1] - oy) * iy, (rec[4] - oy) * iy
        t0z, t1z = (rec[2] - oz) * iz, (rec[5] - oz) * iz
        t_enter = jnp.maximum(
            jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                    jnp.minimum(t0y, t1y)),
                        jnp.minimum(t0z, t1z)),
            t_min)
        t_exit = jnp.minimum(
            jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                    jnp.maximum(t0y, t1y)),
                        jnp.maximum(t0z, t1z)),
            t_best)
        hit_box = on & (t_enter <= t_exit)
        is_leaf = leaf_row >= 0
        at_leaf = hit_box & is_leaf

        found = jnp.zeros_like(on)
        for k in range(leaf_size):
            # Moller-Trumbore against row leaf_row + k (intersect.ray_tri);
            # sequential strict updates pick the same winner as the
            # reference's argmin over the leaf (lowest k on exact ties)
            row = jnp.where(at_leaf, leaf_row + k, 0) * _ROW_W
            v = [gather(rows_ref, row + j, at_leaf, 0.0) for j in range(9)]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = v
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok_det = jnp.abs(det) > EPS_DET
            inv_det = jnp.where(ok_det, 1.0 / det, 0.0)
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            w = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            h = (at_leaf & ok_det & (u >= 0.0) & (w >= 0.0) & (u + w <= 1.0)
                 & (t > t_min) & (t < t_best))
            t_best = jnp.where(h, t, t_best)
            best_row = jnp.where(h, leaf_row + k, best_row)
            best_u = jnp.where(h, u, best_u)
            best_v = jnp.where(h, w, best_v)
            found = found | h

        nxt = jnp.where(hit_box & ~is_leaf, cur + 1, skip)
        cur = jnp.where(on, nxt, cur)
        still = on & (cur < num_nodes)
        if any_hit:
            still = still & ~found
        return cur, t_best, best_row, best_u, best_v, still.astype(jnp.int32)

    def cond(c):
        return jnp.max(c[5]) > 0

    n = ox.shape[0]
    init = (
        jnp.zeros((n,), jnp.int32),
        t_max,
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        (t_max > t_min).astype(jnp.int32),
    )
    _, t_best, best_row, best_u, best_v, _ = jax.lax.while_loop(
        cond, body, init)
    miss = best_row < 0
    if any_hit:
        (blocked_ref,) = out_refs
        blocked_ref[...] = jnp.where(miss, 0, 1).astype(jnp.int32)
        return
    t_ref, tri_ref, u_ref, v_ref = out_refs
    tri = gather(row_tri_ref, jnp.where(miss, 0, best_row), ~miss, -1)
    t_ref[...] = jnp.where(miss, _T_MISS, t_best)
    tri_ref[...] = jnp.where(miss, -1, tri)
    u_ref[...] = best_u
    v_ref[...] = best_v


@partial(jax.jit, static_argnames=("any_hit", "leaf_size", "interpret"))
def _walk(tb: ThreadedBuffers, comps, t_min, t_max, *, any_hit: bool,
          leaf_size: int, interpret: bool):
    n = comps[0].shape[0]
    pad = (-n) % BLOCK
    n_pad = n + pad

    def prep(a, fill):
        a = jnp.broadcast_to(jnp.asarray(a, jnp.float32), (n,))
        return jnp.pad(a, (0, pad), constant_values=fill) if pad else a

    # padded lanes are dead (t_max <= t_min): they walk nothing
    ins = [prep(c, 1.0) for c in comps] + [prep(t_min, 0.0), prep(t_max, 0.0)]
    num_nodes = tb.nodes.shape[0]
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = pl.no_block_spec
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.int32)]
    else:
        out_shape = [
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        ]
    kernel = partial(_walk_kernel, any_hit=any_hit, leaf_size=leaf_size,
                     num_nodes=num_nodes)
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_pad // BLOCK,),
        in_specs=[lane] * 8 + [whole] * 3,
        out_specs=[lane] * len(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="bvh_walk_anyhit" if any_hit else "bvh_walk_closest",
    )(*ins, tb.nodes.reshape(-1), tb.tri_rows.reshape(-1), tb.row_tri)
    if any_hit:
        return outs[0][:n] != 0
    t, tri, u, v = (o[:n] for o in outs)
    return Hit(t=t, tri=tri, u=u, v=v)


def _components(ro, rd, comps):
    if comps is not None:
        return tuple(comps)
    return (ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2])


def closest_hit_gpu(tb: ThreadedBuffers, ro=None, rd=None, t_min=0.0,
                    t_max=T_MAX, *, comps=None, leaf_size: int = LEAF_SIZE,
                    interpret: bool = False) -> Hit:
    """Closest hit of (N,) rays; same result as
    ``traverse.closest_hit_threaded``. Rays come as ro/rd (N,3) arrays or
    as the six SoA components ``comps=(ox, oy, oz, dx, dy, dz)``."""
    return _walk(tb, _components(ro, rd, comps), t_min, t_max,
                 any_hit=False, leaf_size=leaf_size, interpret=interpret)


def occluded_gpu(tb: ThreadedBuffers, ro=None, rd=None, t_min=0.0,
                 t_max=T_MAX, *, comps=None, leaf_size: int = LEAF_SIZE,
                 interpret: bool = False):
    """Any-hit visibility, True where blocked; same result as
    ``traverse.occluded_threaded``."""
    return _walk(tb, _components(ro, rd, comps), t_min, t_max,
                 any_hit=True, leaf_size=leaf_size, interpret=interpret)
