"""Host-driven bounce-major wavefront executor.

The monolithic pass program (make_pass_fn -> trace_paths) runs the FULL
bounce loop for one 524K-lane chunk in one device program. Its
carry-level compaction (cfg.compact_lanes) can only shrink work to
power-of-two lane prefixes WITHIN a chunk, and the whole loop + the
lax.switch over prefix sizes compiles as one enormous module.

This module restructures the frame the way the reference's wavefront
design works (SURVEY §7): the HOST is the
queue manager, the device runs small fixed-width wave programs:

  bounce0   one program: camera rays for the WHOLE frame (all chunks
            concatenated), visit + scatter at full width (primaries are
            swizzle-coherent — no sort), then a live-first coherence
            sort of the carry and a live count.
  bounce[w] one program per ladder width w: slice the live-lane head
            [0, w), visit (presorted) + scatter (NEE shadow queue
            sorted by its own origins), re-sort the head live-first,
            count the live lanes. The dead tail rides along untouched.
  resolve   gather illum/alpha/rays back to pixel (lane_id) order.
  accum     per-chunk progressive-average blend into the renderer's
            planar accumulators (bit-matching make_pass_fn's blend).

Between bounces the host reads back ONE scalar (the live count) and
picks the next ladder width: the dispatch width tracks the EXACT live
population (quantized to the ladder), not a power-of-two prefix of a
chunk — at village bounce 1 that is 1.25M lanes instead of 4 x 524K.
Queues stay packed in ONE (rows, N) i32 buffer across program
boundaries (one operand per dispatch instead of one per carry leaf);
rows are bitcast views of the trace_paths carry pytree (i32, not f32 —
see _pack).

Exactness: every per-lane operation in visit/scatter is elementwise
over lanes (RNG state, BSDF, NEE, RR all ride the carry), traversal is
exact under any lane placement (every ray walks on its own), so path
structure is bitwise identical to the
monolith; radiance agrees to XLA program-shape rounding — the same
tolerance class as unrolled-vs-dynamic or compact_lanes on/off
(tests/test_wavefront_host.py).

Reference frame: the wavefront/stream-compaction design of the
reference's queue-based integrator experiments; hot loop parity target
pt_megakernel.glsl:440-478.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from realtimepathtracingresearchframework_tpu.ops import integrator as intg
from realtimepathtracingresearchframework_tpu.ops import pointsets
from realtimepathtracingresearchframework_tpu.ops import vec3 as v3
from realtimepathtracingresearchframework_tpu.ops.vec3 import Vec3

# dispatch-width ladder quantum: 262144 keeps at most ~12% padding at
# village-scale live counts while bounding the per-scene program count
# at Ntot/262144. Carried over from an earlier hardware target; not
# measured on the GPU.
LADDER_QUANTUM = 262144


def _pack(tree):
    """Pytree of (N,) arrays -> ONE (C, N) i32 buffer (bitcast rows).

    The carrier is INT32, not f32: small int32/uint32/bool values bitcast
    to f32 are denormals, and a backend may flush f32 denormals to zero
    even through pure data movement (stack + gather), which would
    silently destroy ray counters, RNG state, lane ids and live flags.
    Integer lanes have no denormal semantics, and f32 bits ride an i32
    bitcast losslessly in both directions."""
    leaves = jax.tree_util.tree_leaves(tree)
    rows = []
    for a in leaves:
        if a.dtype == jnp.int32:
            rows.append(a)
        elif a.dtype == jnp.bool_:
            rows.append(a.astype(jnp.int32))
        else:
            rows.append(jax.lax.bitcast_convert_type(a, jnp.int32))
    return jnp.stack(rows)


def _unpack(packed, template):
    """Inverse of _pack given a (treedef, dtypes) template."""
    treedef, dtypes = template
    outs = []
    for i, dt in enumerate(dtypes):
        row = packed[i]
        if dt == jnp.int32:
            outs.append(row)
        elif dt == jnp.bool_:
            outs.append(row.astype(bool))
        else:
            outs.append(jax.lax.bitcast_convert_type(row, dt))
    return jax.tree_util.tree_unflatten(treedef, outs)


class WavefrontPrograms(NamedTuple):
    bounce0_fn: object      # (fp, view, s) -> (packed, live i32)
    bounce_fns: dict        # width -> (fp, packed, b_i) -> (packed, live)
    resolve_fn: object      # packed -> (4, Ntot) pixel-order planes
    accum_fns: list         # per chunk: (planes, acc4, s, blend) -> acc4
    n_total: int
    ladder: tuple
    depth: int


def ladder_cover(ladder, live):
    """Smallest ladder width >= live (ladder ascends; live <= ladder[-1])."""
    for w in ladder:
        if live <= w:
            return w
    return ladder[-1]


def build_programs(ds, cfg, width: int, height: int) -> WavefrontPrograms:
    """Compile-lazy program set for one (scene, config, resolution).

    cfg constraints (callers fall back to the monolith otherwise): no
    debug counters, no wavefront deferred-NEE carry, no bounded primary
    segment; compact/compact_lanes are superseded by this executor and
    ignored.
    """
    if cfg.debug_mode or cfg.wavefront:
        raise ValueError("wavefront_host: debug/wavefront cfg unsupported")
    px_c, py_c, valid_c, _inv, nc, chunk = intg._swizzle_tables(width, height)
    n_total = nc * chunk
    px_all = jnp.concatenate(px_c)
    py_all = jnp.concatenate(py_c)
    valid_all = jnp.concatenate(valid_c)
    dims = jnp.array([width, height], jnp.float32)
    depth = int(cfg.max_path_depth)
    blo, bhi = intg._scene_bounds_of(ds)

    # sub-quantum rungs carry the RR tail: by bounce 2 the village frame
    # is under 40K live lanes, and a 262144-wide program pays full-width
    # shading regardless — the pow-2 rungs below the quantum cut it
    ladder = tuple(
        w for w in (32768, 65536, 131072) if w < min(LADDER_QUANTUM, n_total)
    ) + (
        tuple(w for w in range(LADDER_QUANTUM, n_total + 1, LADDER_QUANTUM))
        or (n_total,)
    )

    cfgb = cfg._replace(compact=False, compact_lanes=False, unroll=False)

    def init_carry(fp, view, s):
        sample_index = fp.sample_offset + s
        state = pointsets.make_state(
            cfg.rng_variant, sample_index, fp.shot_offset, px_all, py_all,
            width, bufs=ds.rng,
        )
        state, ro, rd = intg.camera_setup(
            ds, cfgb, fp, view, px_all, py_all, dims, state
        )
        n = n_total
        zero = jnp.zeros((n,), jnp.float32)
        one = jnp.ones((n,), jnp.float32)
        carry = (
            ro, rd, zero,
            Vec3(zero, zero, zero),
            Vec3(one, one, one),
            valid_all,
            jnp.full((n,), 2.0e16, jnp.float32),
            jnp.zeros((n,), jnp.int32),
            zero,
            state,
            jnp.zeros((n,), jnp.int32),
        )
        if cfg.has_textures:
            f0 = intg.camera_footprint0(cfgb, fp, view, dims, rd)
            carry = carry + (tuple(jnp.broadcast_to(f, (n,)) for f in f0),)
        lane_id = jnp.arange(n, dtype=jnp.int32)
        return carry, lane_id

    def sort_live_first(carry, lane_id):
        live = carry[5]
        key = intg._carry_coherence_key(carry[0], carry[1], live, blo, bhi)
        perm = jnp.argsort(key, stable=True)
        packed = _pack((carry, lane_id))[:, perm]
        return packed, jnp.sum(live.astype(jnp.int32))

    # unpack template: (treedef, dtypes) from the abstract carry shape
    dummy_fp = intg.FrameParams(
        rr_path_depth=jnp.int32(2), glossy_only_mode=jnp.int32(0),
        sample_offset=jnp.uint32(0), shot_offset=jnp.uint32(0),
    )
    dummy_view = intg.ViewBuffers(
        np.zeros(3, np.float32), np.zeros(3, np.float32),
        np.zeros(3, np.float32), np.zeros(3, np.float32),
    )
    abs_carry = jax.eval_shape(init_carry, dummy_fp, dummy_view, jnp.uint32(0))
    _leaves, _treedef = jax.tree_util.tree_flatten(abs_carry)
    template = (_treedef, [l.dtype for l in _leaves])

    @jax.jit
    def bounce0_fn(fp, view, s):
        visit_hit, scatter_tail = intg._make_bounce_fns(ds, cfgb, fp)
        carry, lane_id = init_carry(fp, view, s)
        carry, ctx = visit_hit(carry, compact=False)
        if depth > 1:
            # bounce-0 scatter: sort the NEE shadow queue like every
            # later bounce. Real NEE mixes area-light samples whose
            # directions scramble the queue's coherence, and the
            # monolith's dynamic loop already sorts unconditionally
            # (trace_paths bounce_body).
            carry = scatter_tail(
                (carry, ctx, jnp.int32(0)), compact=False, sort_shadow=True
            )
        return sort_live_first(carry, lane_id)

    def make_bounce_fn(w):
        @partial(jax.jit, donate_argnames=("packed",))
        def bounce_fn(fp, packed, b_i):
            visit_hit, scatter_tail = intg._make_bounce_fns(ds, cfgb, fp)
            head = packed[:, :w]
            carry, lane_id = _unpack(head, template)

            carry, ctx = visit_hit(carry, compact=False, presorted=True)
            carry = jax.lax.cond(
                b_i < depth - 1,
                partial(scatter_tail, compact=False, sort_shadow=True),
                lambda args: args[0],
                (carry, ctx, b_i),
            )
            head2, live = sort_live_first(carry, lane_id)
            if w == packed.shape[1]:
                return head2, live
            return jnp.concatenate([head2, packed[:, w:]], axis=1), live

        return bounce_fn

    @jax.jit
    def resolve_fn(packed):
        carry, lane_id = _unpack(packed, template)
        inv = jnp.argsort(lane_id)
        illum, bc, rays = carry[3], carry[7], carry[10]
        planes = jnp.stack(
            [
                illum.x, illum.y, illum.z,
                jnp.where(bc == 0, 0.0, 1.0),
                rays.astype(jnp.float32),
            ]
        )[:, inv]
        return planes

    def make_accum_fn(c):
        lo = c * chunk

        @partial(jax.jit, donate_argnames=("acc",))
        def accum_fn(planes, acc, s, blend_base):
            valid = valid_c[c]
            blend_k = blend_base + s
            w_ = 1.0 / (blend_k.astype(jnp.float32) + 1.0)
            fresh = blend_k == 0
            sl = planes[:, lo:lo + chunk]
            smps = (sl[0], sl[1], sl[2], sl[3])
            acc = tuple(
                jnp.where(
                    fresh,
                    jnp.where(valid, smp, 0.0),
                    a + (jnp.where(valid, smp, a) - a) * w_,
                )
                for a, smp in zip(acc, smps)
            )
            nrays = jnp.sum(sl[4].astype(jnp.int32))
            return acc, nrays

        return accum_fn

    return WavefrontPrograms(
        bounce0_fn=bounce0_fn,
        bounce_fns={w: make_bounce_fn(w) for w in ladder},
        resolve_fn=resolve_fn,
        accum_fns=[make_accum_fn(c) for c in range(nc)],
        n_total=n_total,
        ladder=ladder,
        depth=depth,
    )


def render_sample(progs: WavefrontPrograms, fp, view, accs, s, blend_base):
    """One sample batch over the whole frame, bounce-major. ``accs`` is
    the renderer's per-chunk accumulator list (donated through). Returns
    (accs, total_rays_device_scalar, live_profile list)."""
    packed, live = progs.bounce0_fn(fp, view, s)
    live_n = int(live)
    profile = [live_n]
    for b in range(1, progs.depth):
        if live_n == 0:
            break
        w = ladder_cover(progs.ladder, live_n)
        packed, live = progs.bounce_fns[w](fp, packed, jnp.int32(b))
        live_n = int(live)
        profile.append(live_n)
    planes = progs.resolve_fn(packed)
    rays = None
    for c in range(len(accs)):
        accs[c], nr = progs.accum_fns[c](planes, accs[c], s, blend_base)
        rays = nr if rays is None else rays + nr
    return accs, rays, profile
