"""Ray coherence sort (plain JAX).

A u32 lane key: bit 31 = dead lane (sorts last), bits 21-23 = direction
octant, bits 0-20 = origin morton code on a 128^3 grid over the scene box.
Sorting a ray queue by it groups rays that start near each other and
point the same way, so neighbouring threads of the traversal kernel walk
similar parts of the BVH. The sort is invisible in the results: every
ray's walk is independent of its neighbours.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def part1by2_u32(x):
    """Spread the low 10 bits of x two apart (morton dilation)."""
    x = x & jnp.uint32(0x3FF)
    x = (x | (x << 16)) & jnp.uint32(0x30000FF)
    x = (x | (x << 8)) & jnp.uint32(0x300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x30C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x9249249)
    return x


def coherence_key(ro, rd, live, lo, hi):
    """u32 sort key of SoA rays (``ro``/``rd`` are (x, y, z) triples of
    (N,) arrays). Without a scene box (``lo`` None) only dead-last."""
    dead = (~live).astype(jnp.uint32) << 31
    if lo is None:
        return dead
    inv = 127.0 / jnp.maximum(hi - lo, 1e-12)

    def q(v, k):
        return jnp.clip((v - lo[k]) * inv[k], 0.0, 127.0).astype(jnp.uint32)

    morton = (
        part1by2_u32(q(ro[0], 0))
        | (part1by2_u32(q(ro[1], 1)) << 1)
        | (part1by2_u32(q(ro[2], 2)) << 2)
    )
    octant = (
        (rd[0] < 0.0).astype(jnp.uint32) << 2
        | (rd[1] < 0.0).astype(jnp.uint32) << 1
        | (rd[2] < 0.0).astype(jnp.uint32)
    )
    return dead | (octant << 21) | morton


def sorted_walk(walk, comps, t_min, t_max, lo, hi):
    """Run ``walk(comps, t_min, t_max)`` on the rays in coherence order and
    return its (N,)-array pytree result in the original lane order.
    Rays with ``t_max <= t_min`` are dead and sort last."""
    n = comps[0].shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    key = coherence_key(comps[0:3], comps[3:6], t_max > t_min, lo, hi)
    perm = jnp.argsort(key, stable=True)
    rows = jnp.stack([*comps, t_min, t_max])[:, perm]  # one 2-D gather
    out = walk(tuple(rows[0:6]), rows[6], rows[7])
    inv = jnp.argsort(perm)  # a permutation's argsort is its inverse
    return jax.tree_util.tree_map(lambda a: a[inv], out)
