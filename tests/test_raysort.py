"""Ray coherence sort (ops/raysort.py) and the large-scene BVH build.

The sort only reorders a ray queue for the traversal kernel; it must be a
pure permutation whose inverse restores every result to its lane.
"""

import jax.numpy as jnp
import numpy as np

from realtimepathtracingresearchframework_tpu.models import procedural
from realtimepathtracingresearchframework_tpu.models.scene import Scene
from realtimepathtracingresearchframework_tpu.ops import bvh as bvh_mod
from realtimepathtracingresearchframework_tpu.ops import raysort, traverse


def _rays(n=2048, seed=11):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-2, 12, (3, n)).astype(np.float32)
    rd = rng.normal(size=(3, n)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    t_max = np.full((n,), 7.5, np.float32)
    t_max[::5] = 0.0  # dead lanes
    return ro, rd, t_max


def test_coherence_sort_permutation_roundtrip():
    """The coherence key is non-decreasing in sorted order, dead lanes
    sort last, and sorted_walk hands every result back to its lane."""
    ro, rd, t_max = _rays()
    lo, hi = jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray([10.0, 10.0, 10.0])
    comps = tuple(jnp.asarray(a) for a in (*ro, *rd))
    seen = {}

    def walk(c, a, b):  # identity "traversal" that records its queue
        seen["key"] = raysort.coherence_key(c[0:3], c[3:6], b > a, lo, hi)
        seen["c0"] = c[0]
        return (c[0], b)

    out = raysort.sorted_walk(walk, comps, 0.0, t_max, lo, hi)
    key_sorted = np.asarray(seen["key"]).astype(np.int64)
    assert (np.diff(key_sorted) >= 0).all()
    dead_sorted = key_sorted >> 31
    assert (np.diff(dead_sorted) >= 0).all()
    assert dead_sorted.sum() == (t_max == 0.0).sum()
    # permutation roundtrip: results land back on their own lanes
    np.testing.assert_array_equal(np.asarray(out[0]), ro[0])
    np.testing.assert_array_equal(np.asarray(out[1]), t_max)
    # the walk saw a permutation of the queue (same multiset)
    np.testing.assert_array_equal(np.sort(np.asarray(seen["c0"])),
                                  np.sort(ro[0]))


def test_sorted_walk_matches_unsorted_traversal():
    """Sorting a real traversal queue changes no hit."""
    rng = np.random.default_rng(4)
    v0 = rng.uniform(0, 10, (600, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (600, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (600, 3)).astype(np.float32)
    tb = bvh_mod.build_threaded_bvh(v0, e1, e2)
    dev = traverse.threaded_to_device(tb)
    ro, rd, t_max = _rays(n=512, seed=2)
    comps = tuple(jnp.asarray(a) for a in (*ro, *rd))

    def walk(c, a, b):
        o = jnp.stack(c[0:3], axis=1)
        d = jnp.stack(c[3:6], axis=1)
        return traverse.closest_hit_threaded(dev, o, d, a, b)

    plain = walk(comps, jnp.zeros(512), jnp.asarray(t_max))
    lo, hi = dev.nodes[0, 0:3], dev.nodes[0, 3:6]
    srt = raysort.sorted_walk(walk, comps, 0.0, t_max, lo, hi)
    for f in plain._fields:
        np.testing.assert_array_equal(np.asarray(getattr(plain, f)),
                                      np.asarray(getattr(srt, f)))


def test_terrain_scene_builds():
    scene = Scene.from_vkr_scene(procedural.terrain(grid=60))
    assert scene.unique_tris == 2 * 60 * 60
    flat = scene.flatten_world()
    tb = bvh_mod.build_threaded_bvh(flat.v0, flat.e1, flat.e2)
    assert tb.num_nodes == 2 * (-(-flat.num_tris // tb.leaf_size)) - 1
    rt = np.asarray(tb.row_tri)
    assert set(rt.tolist()) == set(range(flat.num_tris))
