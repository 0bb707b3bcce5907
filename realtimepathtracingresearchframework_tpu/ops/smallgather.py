"""Small-table row selection without gather ops.

For small tables an unrolled compare+select replaces the gather with
elementwise math that fuses into its neighbours: ``sum_k (idx==k) *
table[k]`` with static k. The threshold keeps the select chain short.
Written for an earlier hardware target on which every gather index
vector was expensive; not measured against a plain gather on the GPU.
"""

from __future__ import annotations

import jax.numpy as jnp

SELECT_MAX_ROWS = 16


def select_rows(table, idx, max_rows: int = SELECT_MAX_ROWS):
    """table (M, ...) -> rows[idx] (idx (N,)); arithmetic select when M is
    small (static), plain gather otherwise."""
    m = table.shape[0]
    if m > max_rows:
        return table[idx]
    acc = None
    for k in range(m):
        mk = idx == k
        if table.ndim > 1:
            mk = mk[..., None]
        row = table[k]
        acc = jnp.where(mk, row, acc) if acc is not None else jnp.where(
            mk, row, jnp.zeros_like(row)
        )
    return acc
