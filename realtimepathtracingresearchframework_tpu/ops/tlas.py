"""Two-level acceleration structure: object-space BLAS per unique mesh +
TLAS over instances.

The reference's BLAS/TLAS split (vulkan/vulkanrt_utils.h:55-187:
``TriangleMesh`` BLAS over geometries, ``TopLevelBVH`` from the instance
buffer, refit support; TLAS rebuild/refit queue render_vulkan.cpp:1219-1366)
re-expressed for a software walk:

- each unique mesh gets a **threaded BLAS** in object space, built once and
  concatenated into shared arrays (node links are BLAS-local);
- the **TLAS is the same threaded structure built over instance AABBs**: an
  instance's world bounds become a degenerate "triangle" (v0 = aabb min,
  v0+e1 = aabb max, v0+e2 = centre) whose triangle AABB is exactly the
  instance AABB, so ``build_threaded_bvh(..., leaf_size=1)`` is reused
  verbatim and ``row_tri`` maps leaf rows back to instance ids;
- traversal is a nested stackless walk: the outer cursor threads the TLAS;
  at an instance leaf the ray is taken to object space with the full
  inverse affine — applied WITHOUT renormalizing the direction, which
  preserves the world ``t`` parametrization exactly (p_o = M·p_w =
  M·o_w + t·(A⁻¹ d_w)), so hit distances from different instances compare
  directly and no per-level t rescaling exists;
- animation = rebuild only the tiny TLAS (instance count, not triangle
  count) — the analogue of the reference's per-frame TLAS refit while the
  BLASes stay untouched.

Attribute transforms use the stored world linear A (tangents, edges), its
inverse transpose (normals — correct under the format's signed-uniform
scale, including reflections), and |det|^(1/3) style uniform scale for
texel densities.
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from realtimepathtracingresearchframework_tpu.ops.bvh import (
    LEAF_SIZE,
    build_threaded_bvh,
)
from realtimepathtracingresearchframework_tpu.ops.intersect import (
    T_MAX,
    ray_aabb,
    ray_tri,
    safe_inv_dir,
)


class TwoLevelHit(NamedTuple):
    t: jnp.ndarray
    tri: jnp.ndarray  # global shading row (mesh_tri_base + local tri), -1 miss
    u: jnp.ndarray
    v: jnp.ndarray
    inst: jnp.ndarray  # instance id, -1 miss

    @property
    def valid(self):
        return self.tri >= 0


class TwoLevelBuffers(NamedTuple):
    """Device arrays for nested traversal + instance attribute transforms."""

    tlas_nodes: jnp.ndarray  # (Mt,8) f32, threaded; col7 = instance leaf row
    tlas_row_inst: jnp.ndarray  # (Lt,) i32 leaf row -> instance id
    inst_inv: jnp.ndarray  # (I,12) object_from_world affine (row-major 3x4)
    inst_linear: jnp.ndarray  # (I,9) world_from_object linear A
    inst_inv_t: jnp.ndarray  # (I,9) A^-T (normal transform)
    inst_scale: jnp.ndarray  # (I,) cbrt|det A| (texel-density scale)
    inst_sign: jnp.ndarray  # (I,) handedness sign(det A)
    inst_mesh: jnp.ndarray  # (I,) i32
    inst_mat_offset: jnp.ndarray  # (I,) i32
    inst_node_start: jnp.ndarray  # (I,) i32 BLAS node range start
    inst_node_count: jnp.ndarray  # (I,) i32
    inst_row_start: jnp.ndarray  # (I,) i32 BLAS tri-row offset
    inst_tri_base: jnp.ndarray  # (I,) i32 global shading-row base
    blas_nodes: jnp.ndarray  # (Mb,8) f32, links BLAS-local
    blas_tri_rows: jnp.ndarray  # (R,12) f32 object space
    blas_row_tri: jnp.ndarray  # (R,) i32 mesh-local tri


class BlasSet(NamedTuple):
    """Host-side concatenated BLAS arrays (built once per scene)."""

    nodes: np.ndarray
    tri_rows: np.ndarray
    row_tri: np.ndarray
    node_start: np.ndarray  # (num_meshes,)
    node_count: np.ndarray
    row_start: np.ndarray
    tri_base: np.ndarray  # global shading-row base per mesh
    root_min: np.ndarray  # (num_meshes,3) object-space root AABB
    root_max: np.ndarray


def build_blas_set(mesh_tris: List) -> BlasSet:
    """mesh_tris: list of (v0, e1, e2) object-space arrays per unique mesh.
    The BLAS build/post-build/compaction flow (vulkanrt_utils.h:55-187)
    collapses to one packed build per mesh here."""
    nodes, rows, row_tri = [], [], []
    node_start, node_count, row_start, tri_base = [], [], [], []
    root_min, root_max = [], []
    n_off = r_off = t_off = 0
    for v0, e1, e2 in mesh_tris:
        tb = build_threaded_bvh(v0, e1, e2, leaf_size=LEAF_SIZE)
        nodes.append(tb.nodes)
        rows.append(tb.tri_rows)
        row_tri.append(tb.row_tri)
        node_start.append(n_off)
        node_count.append(tb.nodes.shape[0])
        row_start.append(r_off)
        tri_base.append(t_off)
        root_min.append(tb.world_min)
        root_max.append(tb.world_max)
        n_off += tb.nodes.shape[0]
        r_off += tb.tri_rows.shape[0]
        t_off += len(v0)
    return BlasSet(
        nodes=np.concatenate(nodes),
        tri_rows=np.concatenate(rows),
        row_tri=np.concatenate(row_tri).astype(np.int32),
        node_start=np.asarray(node_start, np.int32),
        node_count=np.asarray(node_count, np.int32),
        row_start=np.asarray(row_start, np.int32),
        tri_base=np.asarray(tri_base, np.int32),
        root_min=np.stack(root_min),
        root_max=np.stack(root_max),
    )


def instance_world_aabbs(blas: BlasSet, mesh_ids, transforms) -> np.ndarray:
    """(I, 2, 3) world AABBs: transform the 8 corners of each BLAS root box
    (default_update_tlas instance bounds, render_vulkan.cpp:1219-1322)."""
    mesh_ids = np.asarray(mesh_ids, np.int64)
    xf = np.asarray(transforms, np.float32)  # (I,3,4)
    bmin = blas.root_min[mesh_ids]
    bmax = blas.root_max[mesh_ids]
    corners = np.empty((len(mesh_ids), 8, 3), np.float32)
    for k in range(8):
        sel = np.array([(k >> j) & 1 for j in range(3)], bool)
        corners[:, k] = np.where(sel, bmax, bmin)
    wc = np.einsum("iab,ikb->ika", xf[:, :, :3], corners) + xf[:, None, :, 3]
    return np.stack([wc.min(axis=1), wc.max(axis=1)], axis=1)


def build_tlas_nodes(aabbs: np.ndarray):
    """Threaded TLAS over instance AABBs (I,2,3) via the degenerate-triangle
    trick; returns (nodes (Mt,8), row_inst (Lt,))."""
    amin = aabbs[:, 0]
    amax = aabbs[:, 1]
    mid = 0.5 * (amin + amax)
    tb = build_threaded_bvh(amin, amax - amin, mid - amin, leaf_size=1)
    return tb.nodes, tb.row_tri.astype(np.int32)


def build_instance_tables(blas: BlasSet, mesh_ids, mat_offsets, transforms):
    """Per-instance device tables: inverse affine, linear, normal transform,
    scale/sign, BLAS ranges."""
    mesh_ids = np.asarray(mesh_ids, np.int64)
    xf = np.asarray(transforms, np.float64)  # (I,3,4)
    A = xf[:, :, :3]
    t = xf[:, :, 3]
    Ainv = np.linalg.inv(A)
    tinv = -np.einsum("iab,ib->ia", Ainv, t)
    det = np.linalg.det(A)
    scale = np.cbrt(np.abs(det))
    inv12 = np.concatenate([Ainv.reshape(-1, 9), tinv], axis=1).astype(np.float32)
    return dict(
        inst_inv=jnp.asarray(inv12),
        inst_linear=jnp.asarray(A.reshape(-1, 9).astype(np.float32)),
        inst_inv_t=jnp.asarray(
            np.transpose(Ainv, (0, 2, 1)).reshape(-1, 9).astype(np.float32)
        ),
        inst_scale=jnp.asarray(scale.astype(np.float32)),
        inst_sign=jnp.asarray(np.sign(det).astype(np.float32)),
        inst_mesh=jnp.asarray(mesh_ids.astype(np.int32)),
        inst_mat_offset=jnp.asarray(np.asarray(mat_offsets, np.int32)),
        inst_node_start=jnp.asarray(blas.node_start[mesh_ids]),
        inst_node_count=jnp.asarray(blas.node_count[mesh_ids]),
        inst_row_start=jnp.asarray(blas.row_start[mesh_ids]),
        inst_tri_base=jnp.asarray(blas.tri_base[mesh_ids]),
    )


# ---------------------------------------------------------------------------
# Nested stackless traversal
# ---------------------------------------------------------------------------


def _blas_walk(tb: TwoLevelBuffers, inst, ro_w, rd_w, t_min, t_best_in,
               best, any_hit: bool):
    """Walk one instance's BLAS in object space; world-t parametrized."""
    inv = tb.inst_inv[inst]
    Ai = inv[0:9].reshape(3, 3)
    ti = inv[9:12]
    # elementwise products, not matmuls (a float32 matmul may run in TF32)
    ro = jnp.sum(Ai * ro_w[None, :], axis=-1) + ti
    rd = jnp.sum(Ai * rd_w[None, :], axis=-1)  # NOT normalized: world t
    inv_rd = safe_inv_dir(rd)
    start = tb.inst_node_start[inst]
    count = tb.inst_node_count[inst]
    row0 = tb.inst_row_start[inst]

    def cond(c):
        cur, _, _, _, _, done = c
        return (cur < count) & ~done

    def body(c):
        cur, t_best, best_row, best_u, best_v, done = c
        rec = tb.blas_nodes[start + cur]
        bmin = rec[0:3]
        bmax = rec[3:6]
        skip = jax.lax.bitcast_convert_type(rec[6], jnp.int32)
        leaf_row = jax.lax.bitcast_convert_type(rec[7], jnp.int32)
        hit_box, _ = ray_aabb(ro, inv_rd, bmin, bmax, t_min, t_best)
        is_leaf = leaf_row >= 0
        rows = jax.lax.dynamic_slice(
            tb.blas_tri_rows,
            (row0 + jnp.maximum(leaf_row, 0), 0),
            (LEAF_SIZE, 12),
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
        best_row = jnp.where(
            better, row0 + leaf_row + k.astype(jnp.int32), best_row
        )
        best_u = jnp.where(better, u[k], best_u)
        best_v = jnp.where(better, v[k], best_v)
        if any_hit:
            done = done | jnp.any(h)
        nxt = jnp.where(hit_box & ~is_leaf, cur + 1, skip)
        return (nxt, t_best, best_row, best_u, best_v, done)

    t_best, best_row, best_u, best_v, done0 = best
    init = (jnp.int32(0), t_best_in, best_row, best_u, best_v, done0)
    _, t_best, best_row, best_u, best_v, done = jax.lax.while_loop(
        cond, body, init
    )
    return t_best, best_row, best_u, best_v, done


def _traverse_two_level_single(tb: TwoLevelBuffers, ro, rd, t_min, t_max,
                               any_hit: bool):
    inv_rd = safe_inv_dir(rd)
    mt = tb.tlas_nodes.shape[0]

    def cond(c):
        return (c[0] < mt) & ~c[6]

    def body(c):
        cur, t_best, best_row, best_u, best_v, best_inst, done = c
        rec = tb.tlas_nodes[cur]
        bmin = rec[0:3]
        bmax = rec[3:6]
        skip = jax.lax.bitcast_convert_type(rec[6], jnp.int32)
        leaf_row = jax.lax.bitcast_convert_type(rec[7], jnp.int32)
        hit_box, _ = ray_aabb(ro, inv_rd, bmin, bmax, t_min, t_best)
        is_leaf = leaf_row >= 0
        enter = hit_box & is_leaf
        inst = tb.tlas_row_inst[jnp.maximum(leaf_row, 0)]

        def enter_blas(args):
            t_best, best_row, best_u, best_v, best_inst, done = args
            nt, nr, nu, nv, nd = _blas_walk(
                tb, inst, ro, rd, t_min, t_best,
                (t_best, best_row, best_u, best_v, done), any_hit,
            )
            improved = nt < t_best
            return (
                nt,
                jnp.where(improved, nr, best_row),
                jnp.where(improved, nu, best_u),
                jnp.where(improved, nv, best_v),
                jnp.where(improved, inst, best_inst),
                nd,
            )

        t_best, best_row, best_u, best_v, best_inst, done = jax.lax.cond(
            enter,
            enter_blas,
            lambda a: a,
            (t_best, best_row, best_u, best_v, best_inst, done),
        )
        nxt = jnp.where(hit_box & ~is_leaf, cur + 1, skip)
        return (nxt, t_best, best_row, best_u, best_v, best_inst, done)

    init = (
        jnp.int32(0),
        jnp.asarray(t_max, jnp.float32),
        jnp.int32(-1),
        jnp.float32(0.0),
        jnp.float32(0.0),
        jnp.int32(-1),
        jnp.bool_(False),
    )
    _, t_best, best_row, best_u, best_v, best_inst, _ = jax.lax.while_loop(
        cond, body, init
    )
    return t_best, best_row, best_u, best_v, best_inst


def closest_hit_two_level(tb: TwoLevelBuffers, ro, rd, t_min=0.0, t_max=T_MAX):
    """Batched nested closest hit. Returns TwoLevelHit with global shading
    rows (inst_tri_base + mesh-local tri)."""
    n = ro.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    t, row, u, v, inst = jax.vmap(
        lambda o, d, tn, tx: _traverse_two_level_single(tb, o, d, tn, tx, False)
    )(ro, rd, t_min, t_max)
    miss = row < 0
    local = tb.blas_row_tri[jnp.maximum(row, 0)]
    tri = jnp.where(
        miss, -1, tb.inst_tri_base[jnp.maximum(inst, 0)] + local
    )
    return TwoLevelHit(t=t, tri=tri, u=u, v=v, inst=jnp.where(miss, -1, inst))


def occluded_two_level(tb: TwoLevelBuffers, ro, rd, t_min=0.0, t_max=T_MAX):
    n = ro.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    _, row, _, _, _ = jax.vmap(
        lambda o, d, tn, tx: _traverse_two_level_single(tb, o, d, tn, tx, True)
    )(ro, rd, t_min, t_max)
    return row >= 0
