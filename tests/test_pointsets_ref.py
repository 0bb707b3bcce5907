"""Reference pointset-table parity.

Golden values produced by compiling the reference's dual-compile GLSL
pointsets (rendering/pointsets/{sobol,sample_order,bn_rng}.glsl +
sobol_tables.h/bn_tables.h) as C++ and printing draw values for spot
(pixel, sample, shot, dim) tuples at 1920x1080. The table-driven
variants here must reproduce them bit-exactly."""

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.backend.params import (
    RNG_VARIANT_BN,
    RNG_VARIANT_SOBOL,
    RNG_VARIANT_Z_SBL,
)
from realtimepathtracingresearchframework_tpu.ops import pointsets
from realtimepathtracingresearchframework_tpu.ops import pointsets_tables as ptab

pytestmark = pytest.mark.skipif(
    not ptab.tables_available(), reason="pointset tables missing"
)

W, H = 1920, 1080

# (px, py, sample, shot, dim) -> value; for sobol variants the value is
# the LAST of draws 0..dim in sequence (the scramble LCG advances per
# draw, exactly like RANDOM_FLOAT1 consumption in the megakernel)
_TUPLES = [
    (0, 0, 0, 0, 0),
    (5, 3, 0, 0, 0),
    (5, 3, 0, 0, 1),
    (5, 3, 1, 0, 2),
    (100, 200, 7, 3, 5),
    (1919, 1079, 15, 1, 11),
    (17, 250, 3, 2, 9),
    (64, 64, 2, 0, 4),
]

_SOBOL_GOLD = [
    0.145855993, 0.632497013, 0.313589603, 0.493932664, 0.142596826,
    0.7838431, 0.760490775, 0.876262248,
]

_ZSOBOL_GOLD = [
    0.452433258, 0.171183258, 0.768707693, 0.407366246, 0.847355783,
    0.42349574, 0.637546122, 0.534732282,
]
_ZSOBOL_INDEX = [43690, 43696, 43696, 109488, 467065, 1011035, 212005, 171322]

_BN_GOLD = [
    0.826171875, 0.927734375, 0.966796875, 0.259765625, 0.951171875,
    0.955078125, 0.365234375, 0.349609375,
]


def _draw_seq(variant, bufs, px, py, sample, shot, last_dim):
    import jax.numpy as jnp

    state = pointsets.make_state(
        variant,
        jnp.uint32(sample),
        jnp.uint32(shot),
        jnp.array([px], jnp.uint32),
        jnp.array([py], jnp.uint32),
        W,
        bufs=bufs,
    )
    v = None
    for d in range(last_dim + 1):
        state, v = pointsets.draw1(variant, bufs, state, jnp.int32(d))
    return float(v[0]), state


def test_sobol_matches_reference():
    bufs = pointsets.build_rng_buffers(RNG_VARIANT_SOBOL, tables="always")
    assert bufs.reference_tables
    for (px, py, s, sh, d), want in zip(_TUPLES, _SOBOL_GOLD):
        got, _ = _draw_seq(RNG_VARIANT_SOBOL, bufs, px, py, s, sh, d)
        assert got == pytest.approx(want, abs=0, rel=1e-7), (px, py, s, sh, d)


def test_zsobol_matches_reference():
    bufs = pointsets.build_rng_buffers(RNG_VARIANT_Z_SBL, tables="always")
    for ((px, py, s, sh, d), want, want_idx) in zip(
        _TUPLES, _ZSOBOL_GOLD, _ZSOBOL_INDEX
    ):
        got, state = _draw_seq(RNG_VARIANT_Z_SBL, bufs, px, py, s, sh, d)
        assert int(state.s0[0]) == want_idx, (px, py, s, sh, d)
        assert got == pytest.approx(want, abs=0, rel=1e-7), (px, py, s, sh, d)


def test_bn_matches_reference():
    bufs = pointsets.build_rng_buffers(RNG_VARIANT_BN, tables="always")
    for (px, py, s, sh, d), want in zip(_TUPLES, _BN_GOLD):
        got, _ = _draw_seq(RNG_VARIANT_BN, bufs, px, py, s, sh, d)
        assert got == pytest.approx(want, abs=0, rel=1e-7), (px, py, s, sh, d)


def test_generated_variants_still_available():
    bufs = pointsets.build_rng_buffers(RNG_VARIANT_SOBOL, tables="never")
    assert not bufs.reference_tables
    got, _ = _draw_seq(RNG_VARIANT_SOBOL, bufs, 5, 3, 0, 0, 0)
    assert 0.0 <= got < 1.0
