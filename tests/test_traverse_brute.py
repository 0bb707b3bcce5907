"""Tiny-scene brute-force XLA traversal (ops/traverse_brute.py) vs the
threaded XLA walk (ops/traverse.py), the reference traversal.

The brute chain must return the walk's hits — same per-row
Moller-Trumbore math, and on exact-t ties the lower row, which the walk
reaches first — because the renderer swaps it in transparently for
scenes under _BRUTE_MAX_ROWS (backend/renderer.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from realtimepathtracingresearchframework_tpu.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu.ops import traverse
from realtimepathtracingresearchframework_tpu.ops import traverse_brute as tbr
from realtimepathtracingresearchframework_tpu.ops.vec3 import Vec3


def _soup(rng, n=48):
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    return v0, e1, e2


def _rows(tb):
    return tuple(
        tuple(float(x) for x in tb.tri_rows[k, 0:9])
        for k in range(tb.tri_rows.shape[0])
    )


@pytest.mark.parametrize("leaf_size", [4, 32])
def test_brute_matches_threaded_walk(rng, leaf_size):
    v0, e1, e2 = _soup(rng)
    tb = bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=leaf_size)
    dev = traverse.threaded_to_device(tb)
    rows = _rows(tb)

    n = 512
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro_d, rd_d = jnp.asarray(ro), jnp.asarray(rd)
    rov = Vec3(ro_d[:, 0], ro_d[:, 1], ro_d[:, 2])
    rdv = Vec3(rd_d[:, 0], rd_d[:, 1], rd_d[:, 2])
    t_min = jnp.zeros((n,), jnp.float32)
    t_max = jnp.full((n,), 2.0e16, jnp.float32)

    hw = traverse.closest_hit_threaded(
        dev, ro_d, rd_d, t_min, t_max, leaf_size=leaf_size
    )
    hb = tbr.closest_hit_brute(rows, dev.row_tri, rov, rdv, t_min, t_max)
    assert np.array_equal(np.asarray(hw.tri), np.asarray(hb.tri))
    # the walk's vectorized ray_tri and the brute chain's scalar-row
    # form may contract FMAs differently: final-ulp drift only
    hit = np.asarray(hb.tri) >= 0
    assert hit.any()
    tw, tb_ = np.asarray(hw.t)[hit], np.asarray(hb.t)[hit]
    assert np.abs(tw - tb_).max(initial=0) <= np.abs(tw).max() * 1e-6
    assert np.allclose(np.asarray(hw.u)[hit], np.asarray(hb.u)[hit],
                       rtol=1e-5, atol=1e-6)
    assert np.allclose(np.asarray(hw.v)[hit], np.asarray(hb.v)[hit],
                       rtol=1e-5, atol=1e-6)

    # occlusion with tight per-ray segments
    t_ref = np.asarray(hw.t)
    tmax_o = jnp.asarray(
        np.where(t_ref < 1e30, t_ref * 0.999, 1e30).astype(np.float32)
    )
    ow = np.asarray(
        traverse.occluded_threaded(dev, ro_d, rd_d, t_min, tmax_o,
                                   leaf_size=leaf_size)
    )
    ob = np.asarray(tbr.occluded_brute(rows, rov, rdv, t_min, tmax_o))
    assert np.array_equal(ow, ob)


def test_brute_dead_lane_contract(rng):
    """t_max == 0 lanes (masked-off rays) must report miss / unblocked —
    the integrator encodes inactive lanes that way."""
    v0, e1, e2 = _soup(rng, n=8)
    tb = bvh_mod.build_threaded_bvh(v0, e1, e2, leaf_size=32)
    rows = _rows(tb)
    n = 64
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rov = Vec3(*(jnp.asarray(ro[:, k]) for k in range(3)))
    rdv = Vec3(*(jnp.asarray(rd[:, k]) for k in range(3)))
    zero = jnp.zeros((n,), jnp.float32)
    h = tbr.closest_hit_brute(rows, jnp.asarray(tb.row_tri), rov, rdv,
                              zero, zero)
    assert np.all(np.asarray(h.tri) == -1)
    assert np.all(np.asarray(h.t) == np.float32(2.0e32))
    assert not np.any(np.asarray(tbr.occluded_brute(rows, rov, rdv, zero, zero)))
