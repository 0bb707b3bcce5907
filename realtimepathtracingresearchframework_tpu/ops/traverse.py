"""BVH traversal on device (JAX, vmapped lockstep).

Replaces Vulkan ray queries (``rayQueryEXT`` traversal in
vulkan/pt_megakernel.glsl:440-478) with an explicit stack-based traversal
of the flattened BVH2 from ops/bvh.py:

- Every ray runs the same while_loop in lockstep under ``vmap``; the
  balanced builder bounds the stack to the (static) tree depth.
- Each iteration pops one *internal* node, slab-tests both child AABBs and
  either pushes internal children (near child popped first) or intersects
  the fixed-width leaf (LEAF_SIZE triangles) inline — so an iteration is a
  fixed-shape vector op with no data-dependent branches, only masks
  (the counterpart of the reference's EXPLICIT_MASK divergence handling,
  pt_megakernel.glsl:369-388).
- ``any_hit`` mode early-outs for NEE shadow rays
  (raytrace_test_visibility, rendering/mc/nee.glsl:32).

All shapes are static; traversal jits once per (scene size, stack depth).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from realtimepathtracingresearchframework_tpu.ops.bvh import (
    BVH,
    LEAF_SIZE,
    ThreadedBVH,
)
from realtimepathtracingresearchframework_tpu.ops.intersect import (
    T_MAX,
    ray_aabb,
    ray_tri,
    safe_inv_dir,
)


class BVHBuffers(NamedTuple):
    child: jnp.ndarray  # (N,2) i32
    cmin: jnp.ndarray  # (N,2,3) f32
    cmax: jnp.ndarray  # (N,2,3) f32
    leaf_tris: jnp.ndarray  # (L,LEAF_SIZE) i32


class TriBuffers(NamedTuple):
    v0: jnp.ndarray  # (T,3)
    e1: jnp.ndarray
    e2: jnp.ndarray


class Hit(NamedTuple):
    t: jnp.ndarray  # T_MAX on miss
    tri: jnp.ndarray  # -1 on miss
    u: jnp.ndarray
    v: jnp.ndarray

    @property
    def valid(self):
        return self.tri >= 0


def bvh_to_device(bvh: BVH) -> BVHBuffers:
    return BVHBuffers(
        child=jnp.asarray(bvh.child),
        cmin=jnp.asarray(bvh.cmin),
        cmax=jnp.asarray(bvh.cmax),
        leaf_tris=jnp.asarray(bvh.leaf_tris),
    )


class ThreadedBuffers(NamedTuple):
    """Device arrays of the threaded layout (ops/bvh.py ThreadedBVH)."""

    nodes: jnp.ndarray  # (M,8) f32
    tri_rows: jnp.ndarray  # (4L,12) f32
    row_tri: jnp.ndarray  # (4L,) i32


def threaded_to_device(tb: ThreadedBVH) -> ThreadedBuffers:
    return ThreadedBuffers(
        nodes=jnp.asarray(tb.nodes),
        tri_rows=jnp.asarray(tb.tri_rows),
        row_tri=jnp.asarray(tb.row_tri),
    )


def _traverse_threaded_single(tb: ThreadedBuffers, ro, rd, t_min, t_max,
                              any_hit: bool, leaf_size: int = LEAF_SIZE):
    """Stackless skip-link traversal of one ray (vmapped by callers).

    Per step: one contiguous 8-float node gather, one slab test, and for
    leaves one contiguous (leaf_size, 12) triangle-row slice + fixed-width
    Moller-Trumbore. No scatters, no stack — the state is (cursor, best).
    ``leaf_size`` MUST match the tree the buffers were built from.
    """
    inv_rd = safe_inv_dir(rd)
    m = tb.nodes.shape[0]

    def cond(c):
        cur = c[0]
        done = c[5]
        return (cur < m) & ~done

    def body(c):
        cur, t_best, best_row, best_u, best_v, done = c
        rec = tb.nodes[cur]
        bmin = rec[0:3]
        bmax = rec[3:6]
        skip = jax.lax.bitcast_convert_type(rec[6], jnp.int32)
        leaf_row = jax.lax.bitcast_convert_type(rec[7], jnp.int32)

        hit_box, _ = ray_aabb(ro, inv_rd, bmin, bmax, t_min, t_best)
        is_leaf = leaf_row >= 0

        rows = jax.lax.dynamic_slice(
            tb.tri_rows, (jnp.maximum(leaf_row, 0), 0), (leaf_size, 12)
        )
        h, t, u, v = ray_tri(
            ro[None, :], rd[None, :], rows[:, 0:3], rows[:, 3:6], rows[:, 6:9],
            t_min, t_best,
        )
        h = h & is_leaf & hit_box
        t = jnp.where(h, t, T_MAX)
        k = jnp.argmin(t)
        tk = t[k]
        better = tk < t_best
        t_best = jnp.where(better, tk, t_best)
        best_row = jnp.where(better, leaf_row + k.astype(jnp.int32), best_row)
        best_u = jnp.where(better, u[k], best_u)
        best_v = jnp.where(better, v[k], best_v)

        nxt = jnp.where(hit_box & ~is_leaf, cur + 1, skip)
        if any_hit:
            done = done | jnp.any(h)
        return (nxt, t_best, best_row, best_u, best_v, done)

    init = (
        jnp.int32(0),
        jnp.asarray(t_max, jnp.float32),
        jnp.int32(-1),
        jnp.float32(0.0),
        jnp.float32(0.0),
        jnp.bool_(False),
    )
    cur, t_best, best_row, best_u, best_v, done = jax.lax.while_loop(
        cond, body, init
    )
    if any_hit:
        return done
    miss = best_row < 0
    tri = jnp.where(miss, -1, tb.row_tri[jnp.maximum(best_row, 0)])
    return Hit(t=jnp.where(miss, T_MAX, t_best), tri=tri, u=best_u, v=best_v)


def closest_hit_threaded(
    tb: ThreadedBuffers, ro, rd, t_min=0.0, t_max=T_MAX,
    leaf_size: int = LEAF_SIZE,
) -> Hit:
    """Batched stackless closest-hit: ro/rd (N,3) -> Hit of (N,) arrays."""
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), ro.shape[:-1])
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), ro.shape[:-1])
    f = lambda o, d, tn, tf: _traverse_threaded_single(
        tb, o, d, tn, tf, False, leaf_size=leaf_size
    )
    return jax.vmap(f)(ro, rd, t_min, t_max)


def occluded_threaded(tb: ThreadedBuffers, ro, rd, t_min=0.0, t_max=T_MAX,
                      leaf_size: int = LEAF_SIZE):
    """Batched stackless any-hit visibility: True where blocked."""
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), ro.shape[:-1])
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), ro.shape[:-1])
    f = lambda o, d, tn, tf: _traverse_threaded_single(
        tb, o, d, tn, tf, True, leaf_size=leaf_size
    )
    return jax.vmap(f)(ro, rd, t_min, t_max)


def _traverse_single(
    bvh: BVHBuffers,
    tris: TriBuffers,
    ro,
    rd,
    t_min,
    t_max,
    stack_depth: int,
    any_hit: bool,
):
    """Single-ray traversal; vmap over rays."""
    inv_rd = safe_inv_dir(rd)

    def leaf_intersect(leaf_mask, child, best_t, best):
        """Intersect both children's leaves where leaf_mask; returns updated
        (best_t, (tri, u, v))."""
        leaf_ids = jnp.where(leaf_mask, -(child + 1), 0)
        tri_idx = bvh.leaf_tris[leaf_ids]  # (2,LEAF)
        flat_idx = tri_idx.reshape(-1)  # (2*LEAF,)
        v0 = tris.v0[flat_idx]
        e1 = tris.e1[flat_idx]
        e2 = tris.e2[flat_idx]
        h, t, u, v = ray_tri(ro[None, :], rd[None, :], v0, e1, e2, t_min, best_t)
        h = h & jnp.repeat(leaf_mask, LEAF_SIZE)
        t = jnp.where(h, t, T_MAX)
        k = jnp.argmin(t)
        tbest = t[k]
        improved = tbest < best_t
        best_t = jnp.where(improved, tbest, best_t)
        best = (
            jnp.where(improved, flat_idx[k], best[0]),
            jnp.where(improved, u[k], best[1]),
            jnp.where(improved, v[k], best[2]),
        )
        return best_t, best, jnp.any(h)

    def cond(carry):
        sp, stack, best_t, best, done = carry
        return (sp > 0) & ~done

    def body(carry):
        sp, stack, best_t, best, done = carry
        node = stack[sp - 1]
        sp = sp - 1

        child = bvh.child[node]  # (2,)
        bmin = bvh.cmin[node]  # (2,3)
        bmax = bvh.cmax[node]
        hit_c, t_c = ray_aabb(ro[None, :], inv_rd[None, :], bmin, bmax, t_min, best_t)

        is_leaf = child < 0
        leaf_mask = hit_c & is_leaf
        best_t, best, found = leaf_intersect(leaf_mask, child, best_t, best)

        # push internal children, far first so the near child pops first
        push = hit_c & ~is_leaf
        far_idx = jnp.where(t_c[0] <= t_c[1], 1, 0)
        near_idx = 1 - far_idx
        for k in (far_idx, near_idx):
            do = push[k]
            stack = stack.at[sp].set(jnp.where(do, child[k], stack[sp]))
            sp = sp + do.astype(jnp.int32)

        if any_hit:
            done = done | found
        return sp, stack, best_t, best, done

    stack0 = jnp.zeros(stack_depth, jnp.int32)
    best0 = (jnp.int32(-1), jnp.float32(0.0), jnp.float32(0.0))
    sp0 = jnp.int32(1)
    done0 = jnp.bool_(False)

    sp, stack, best_t, best, done = jax.lax.while_loop(
        cond, body, (sp0, stack0, jnp.float32(t_max), best0, done0)
    )
    if any_hit:
        return done
    miss = best[0] < 0
    return Hit(
        t=jnp.where(miss, T_MAX, best_t), tri=best[0], u=best[1], v=best[2]
    )


def closest_hit(
    bvh: BVHBuffers,
    tris: TriBuffers,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    t_min=0.0,
    t_max=T_MAX,
    stack_depth: int = 32,
) -> Hit:
    """Batched closest-hit: ro/rd (N,3) -> Hit of (N,) arrays.

    The RQ_CLOSEST analogue (vulkan/rt_intersect.comp:31-68).
    """
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), ro.shape[:-1])
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), ro.shape[:-1])
    f = lambda o, d, tn, tf: _traverse_single(
        bvh, tris, o, d, tn, tf, stack_depth, any_hit=False
    )
    return jax.vmap(f)(ro, rd, t_min, t_max)


def occluded(
    bvh: BVHBuffers,
    tris: TriBuffers,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    t_min=0.0,
    t_max=T_MAX,
    stack_depth: int = 32,
) -> jnp.ndarray:
    """Batched any-hit visibility test: True where the segment is blocked.

    Matches raytrace_test_visibility's semantics (nee.glsl:32, inverted).
    """
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), ro.shape[:-1])
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), ro.shape[:-1])
    f = lambda o, d, tn, tf: _traverse_single(
        bvh, tris, o, d, tn, tf, stack_depth, any_hit=True
    )
    return jax.vmap(f)(ro, rd, t_min, t_max)
