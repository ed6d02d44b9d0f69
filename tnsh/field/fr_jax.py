"""Vectorized modular arithmetic kernels in JAX (int32 limb planes).

The compute half of the arkworks-replacement layer (SURVEY §7.1 step 1).
Every function operates on limb-major arrays of shape ``(NUM_LIMBS, *batch)``
(see tnsh.field.limbs) in Montgomery form, and is parametrized by a
``FieldSpec`` so the same kernels serve Fr (scalars, MLE tables, sum-check)
and Fq (G1 coordinates, MSM).

Algorithms and XLA-shaping decisions:
  * ``mont_mul`` — CIOS Montgomery multiplication with an (L+1)-limb lazily
    carried accumulator.  Limb magnitudes stay < 2^30 (23 iters x 2^25 +
    carries), so everything is pure int32 arithmetic.  Its L steps are one
    ``fori_loop``; carry propagation and limbwise compares are unrolled
    elementwise chains.
  * Constants are NUMPY arrays, folded into the program at trace time.
  * ``mont_mul_many`` batches independent multiplications into one kernel
    invocation by lane concatenation — the group-law kernels (msm_jax) use
    it to cut op count ~3x.

All arithmetic is exact: results are bit-identical to the host Python path
(tests/test_jax_backend.py), which is what keeps device-produced
transcripts byte-compatible with the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .limbs import (
    FQ_SPEC,
    FR_SPEC,
    LIMB_BITS,
    LIMB_MASK,
    NUM_LIMBS,
    FieldSpec,
    int_to_limbs,
)

L = NUM_LIMBS
B = LIMB_BITS
MASK = LIMB_MASK


def _unstack(t: jnp.ndarray):
    return [t[i] for i in range(t.shape[0])]


def _normalize(t: jnp.ndarray) -> jnp.ndarray:
    """Carry-propagate limb planes into [0, 2^B) (signed-safe: ``>> B`` is an
    arithmetic shift, ``& MASK`` the matching residue).  The final carry must
    be zero for in-range values (callers guarantee the bound)."""
    rows = _unstack(t)
    out = []
    carry = None
    for limb in rows:
        v = limb if carry is None else limb + carry
        carry = v >> B
        out.append(v & MASK)
    return jnp.stack(out)


def make_field_ops(spec: FieldSpec, unroll_cios: bool = False):
    """Build the jittable op namespace for one field.

    ``unroll_cios``: unroll the L CIOS steps of ``mont_mul`` in Python
    instead of looping over them (see ``mont_mul``).

    Values live in the **2p-domain**: every element is a normalized limb
    vector with integer value in [0, 2p).  CIOS output is < 2p whenever its
    inputs are (2p * 2p < p * R), so multiplication needs NO final reduction;
    add/sub reduce once against 2p.  Zero has two representations (0 and p) —
    ``is_zero`` checks both; host-side ``unpack_ints`` canonicalizes with a
    final ``% p``, so nothing downstream observes the relaxation.
    """
    p_np = np.asarray(spec.modulus_limbs(), dtype=np.int32)[:, None]
    p2_np = np.asarray(int_to_limbs(2 * spec.modulus), dtype=np.int32)[:, None]
    one_np = np.asarray(spec.one_mont_limbs(), dtype=np.int32)[:, None]
    n0 = spec.n0
    r2_int = spec.r2_mod_p

    def _cond_sub(a, m_np):
        """a - m if a >= m else a, detected by the borrow sign of a - m.
        ``a`` normalized; result normalized."""
        d = a - m_np
        rows = _unstack(d)
        out = []
        carry = None
        for limb in rows:
            v = limb if carry is None else limb + carry
            carry = v >> B
            out.append(v & MASK)
        ge = carry >= 0  # no final borrow -> a >= m
        diff = jnp.stack(out)
        return jnp.where(ge[None], diff, a)

    def add(a, b):
        return _cond_sub(_normalize(a + b), p2_np)

    def sub(a, b):
        return _cond_sub(_normalize(a - b + p2_np), p2_np)

    def neg(a):
        return _cond_sub(_normalize(p2_np - a), p2_np)

    def mont_mul(a, b):
        """CIOS Montgomery multiply, array form.

        (L+1)-limb lazily-carried accumulator; per step absorb a_i * b, pick
        m from the exact low limb, absorb m * p (limb 0 becomes divisible by
        2^B), shift down one limb carrying limb 0's high bits.  Limb
        magnitudes stay < 2^30.  Inputs < 2p -> output < 2p (no reduction).

        The L steps are a ``fori_loop`` by default: unrolled, the MSM
        tail did not compile within 240 s on the GPU, and the 2^20-lane
        generic-degree round ran no faster.  In the MSM insertion step the
        unrolled steps run ~5x faster and compile faster, so that step
        uses ``unroll_cios=True`` (PERF.md).
        """
        batch = tuple(a.shape[1:])
        zero_row = jnp.zeros((1,) + batch, dtype=jnp.int32)

        def step(i, t):
            ai = (a[i][None] if unroll_cios
                  else lax.dynamic_index_in_dim(a, i, 0, keepdims=True))
            t = t + jnp.concatenate([ai * b, zero_row], axis=0)
            m = (t[0] * n0) & MASK
            t = t + jnp.concatenate([m[None] * p_np, zero_row], axis=0)
            carry = t[0] >> B
            return jnp.concatenate([(t[1] + carry)[None], t[2:], zero_row],
                                   axis=0)

        t = jnp.zeros((L + 1,) + batch, dtype=jnp.int32)
        if unroll_cios:
            for i in range(L):
                t = step(i, t)
        else:
            t = lax.fori_loop(0, L, step, t)
        # value < 2p < 2^264 -> top limb normalizes to zero
        return _normalize(t)[:L]

    def mont_mul_many(pairs):
        """Independent muls fused into one kernel by lane concatenation.

        pairs: sequence of (a, b) with identical batch shapes.  Returns the
        list of products.  One CIOS pass over k*N lanes replaces k passes
        over N lanes — fewer HLO ops, better lane utilization for small N.
        """
        k = len(pairs)
        if k == 1:
            return [mont_mul(*pairs[0])]
        a_cat = jnp.concatenate([p[0] for p in pairs], axis=-1)
        b_cat = jnp.concatenate([p[1] for p in pairs], axis=-1)
        out = mont_mul(a_cat, b_cat)
        n = pairs[0][0].shape[-1]
        return [out[..., i * n:(i + 1) * n] for i in range(k)]

    def square(a):
        return mont_mul(a, a)

    def to_mont(a_std):
        r2 = scalar_planes(r2_int)
        return mont_mul(a_std, jnp.broadcast_to(r2, a_std.shape))

    def from_mont(a_mont):
        one_std = jnp.zeros_like(a_mont).at[0].set(1)
        return mont_mul(a_mont, one_std)

    def is_zero(a):
        # 2p-domain: zero is represented as 0 or p.
        return jnp.all(a == 0, axis=0) | jnp.all(a == p_np, axis=0)

    def canon(a):
        """Reduce a 2p-domain value to canonical [0, p)."""
        return _cond_sub(a, p_np)

    def select(cond, a, b):
        return jnp.where(cond[None, ...], a, b)

    def zero(batch_shape):
        return np.zeros((L,) + tuple(batch_shape), dtype=np.int32)

    def one(batch_shape):
        return np.ascontiguousarray(
            np.broadcast_to(one_np, (L,) + tuple(batch_shape))
        ).astype(np.int32)

    def scalar_planes(value: int) -> np.ndarray:
        """(L, 1) numpy planes of a raw (already-encoded) value."""
        return np.asarray(int_to_limbs(int(value)), dtype=np.int32)[:, None]

    def scalar_const(value: int, batch_shape):
        """Montgomery-form constant broadcast over a batch shape."""
        v = int(value) % spec.modulus
        v = v * (1 << (B * L)) % spec.modulus
        return np.ascontiguousarray(
            np.broadcast_to(scalar_planes(v), (L,) + tuple(batch_shape))
        ).astype(np.int32)

    class _Ops:
        pass

    ops = _Ops()
    ops.spec = spec
    ops.add = add
    ops.sub = sub
    ops.neg = neg
    ops.mont_mul = mont_mul
    ops.mont_mul_many = mont_mul_many
    ops.square = square
    ops.to_mont = to_mont
    ops.from_mont = from_mont
    ops.is_zero = is_zero
    ops.canon = canon
    ops.select = select
    ops.zero = zero
    ops.one = one
    ops.scalar_const = scalar_const
    ops.p_planes = p_np
    return ops


#: Shared op sets (module-level so jit caches are reused).
fr_ops = make_field_ops(FR_SPEC)
fq_ops = make_field_ops(FQ_SPEC)
fq_ops_unrolled = make_field_ops(FQ_SPEC, unroll_cios=True)


# jitted elementwise entry points for benchmarks / external use
@jax.jit
def fr_mont_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return fr_ops.mont_mul(a, b)


@jax.jit
def fr_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return fr_ops.add(a, b)


@jax.jit
def fr_sub(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return fr_ops.sub(a, b)
