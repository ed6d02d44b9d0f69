"""Device multi-scalar multiplication: batched G1 arithmetic on limb planes.

Replaces the reference's per-term scalar-mul MSM loop
(commitments.rs:173-177) with a vectorized double-and-add over all points at
once (SURVEY §7.1 step 2 / §7.3 item 3):

  * G1 points live in Jacobian coordinates, each coordinate a ``(22, N)``
    int32 limb-plane array over Fq (tnsh.field.fr_jax kernels).
  * The scalar loop is a ``lax.fori_loop`` over 254 bit planes: one batched
    doubling + one batched conditional mixed-add per bit, fully lane-parallel
    across the N points.  Independent field muls inside each group-law stage
    are fused via ``mont_mul_many`` (lane concatenation).
  * The N partials collapse through a masked in-place tree reduction
    (``jnp.roll`` partner + lane mask) — a single fori_loop of log2(N)
    steps over fixed shapes.

Group-law edge cases are lane-selected: infinity (Z = 0) on either side and
inverse points (the general formula already emits Z3 = 0).  The equal-points
branch is needed only in the tree reduction (duplicate inputs); inside the
double-and-add it cannot trigger for canonical scalars (< r), because
acc = v*P with 1 < v < r never revisits P — the v = 1 case is the infinity
branch.  All arithmetic is exact, so results match the host Pippenger MSM
bit-for-bit — device commitments feed the same transcripts.

The mesh-sharded variant (points partitioned over devices) lives in
``tnsh.parallel.mesh``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..field.fr import Fr
from ..field.g1 import G1
from ..field.fr_jax import fq_ops
from ..field.limbs import FQ_SPEC, NUM_LIMBS, pack_ints, pack_scalar_bits, unpack_ints

fq = fq_ops


# ---------------------------------------------------------------------------
# Batched Jacobian group law (branch-free, stage-fused muls)
# ---------------------------------------------------------------------------

def _pdouble(X, Y, Z):
    """2P in Jacobian coords; infinity (Z=0) maps to infinity (Z3=0)."""
    A, Bv = fq.mont_mul_many([(X, X), (Y, Y)])
    XB = fq.add(X, Bv)
    C, T, YZ = fq.mont_mul_many([(Bv, Bv), (XB, XB), (Y, Z)])
    TAC = fq.sub(fq.sub(T, A), C)
    D = fq.add(TAC, TAC)
    E = fq.add(fq.add(A, A), A)
    (F,) = fq.mont_mul_many([(E, E)])
    X3 = fq.sub(F, fq.add(D, D))
    (EDX,) = fq.mont_mul_many([(E, fq.sub(D, X3))])
    C2 = fq.add(C, C)
    C4 = fq.add(C2, C2)
    Y3 = fq.sub(EDX, fq.add(C4, C4))
    Z3 = fq.add(YZ, YZ)
    return X3, Y3, Z3


def _padd(X1, Y1, Z1, X2, Y2, Z2):
    """P + Q, general Jacobian add; handles infinity, inverse and EQUAL
    points per lane (used by the tree reduction, where duplicates occur)."""
    Z1Z1, Z2Z2 = fq.mont_mul_many([(Z1, Z1), (Z2, Z2)])
    U1, U2, T1, T2 = fq.mont_mul_many(
        [(X1, Z2Z2), (X2, Z1Z1), (Y1, Z2), (Y2, Z1)]
    )
    S1, S2 = fq.mont_mul_many([(T1, Z2Z2), (T2, Z1Z1)])
    H = fq.sub(U2, U1)
    r0 = fq.sub(S2, S1)
    r = fq.add(r0, r0)
    H2 = fq.add(H, H)
    I, RR = fq.mont_mul_many([(H2, H2), (r, r)])
    J, V, ZZ = fq.mont_mul_many([(H, I), (U1, I), (Z1, Z2)])
    X3 = fq.sub(fq.sub(RR, J), fq.add(V, V))
    RVX, SJ, ZZH = fq.mont_mul_many([(r, fq.sub(V, X3)), (S1, J), (ZZ, H)])
    Y3 = fq.sub(RVX, fq.add(SJ, SJ))
    Z3 = fq.add(ZZH, ZZH)

    p_inf = fq.is_zero(Z1)
    q_inf = fq.is_zero(Z2)
    same_point = fq.is_zero(H) & fq.is_zero(r0) & ~p_inf & ~q_inf

    dX, dY, dZ = _pdouble(X1, Y1, Z1)
    X3 = fq.select(same_point, dX, X3)
    Y3 = fq.select(same_point, dY, Y3)
    Z3 = fq.select(same_point, dZ, Z3)
    X3 = fq.select(p_inf, X2, X3)
    Y3 = fq.select(p_inf, Y2, Y3)
    Z3 = fq.select(p_inf, Z2, Z3)
    q_only = q_inf & ~p_inf
    X3 = fq.select(q_only, X1, X3)
    Y3 = fq.select(q_only, Y1, Y3)
    Z3 = fq.select(q_only, Z1, Z3)
    return X3, Y3, Z3


def _padd_mixed(X1, Y1, Z1, x2, y2, take):
    """P + Q with Q affine (Z2 = 1), NO equal-points branch (safe inside
    double-and-add; see module docstring).  ``take`` masks lanes."""
    (Z1Z1,) = fq.mont_mul_many([(Z1, Z1)])
    U2, T2 = fq.mont_mul_many([(x2, Z1Z1), (y2, Z1)])
    (S2,) = fq.mont_mul_many([(T2, Z1Z1)])
    H = fq.sub(U2, X1)
    r0 = fq.sub(S2, Y1)
    r = fq.add(r0, r0)
    H2 = fq.add(H, H)
    I, RR = fq.mont_mul_many([(H2, H2), (r, r)])
    J, V = fq.mont_mul_many([(H, I), (X1, I)])
    X3 = fq.sub(fq.sub(RR, J), fq.add(V, V))
    RVX, SJ, Z1H = fq.mont_mul_many([(r, fq.sub(V, X3)), (Y1, J), (Z1, H)])
    Y3 = fq.sub(RVX, fq.add(SJ, SJ))
    Z3 = fq.add(Z1H, Z1H)

    p_inf = fq.is_zero(Z1)
    one = fq.one(X1.shape[1:])
    X3 = fq.select(p_inf, x2, X3)
    Y3 = fq.select(p_inf, y2, Y3)
    Z3 = fq.select(p_inf, one, Z3)

    X3 = fq.select(take, X3, X1)
    Y3 = fq.select(take, Y3, Y1)
    Z3 = fq.select(take, Z3, Z1)
    return X3, Y3, Z3


def _padd_mixed_safe(X1, Y1, Z1, x2, y2, take):
    """Mixed add WITH the equal-points branch — needed where the
    accumulator can coincide with an input point (Pippenger buckets with
    duplicate/adversarial bases)."""
    X3, Y3, Z3 = _padd_mixed(X1, Y1, Z1, x2, y2, take)
    Z1Z1, = fq.mont_mul_many([(Z1, Z1)])
    U2, T2 = fq.mont_mul_many([(x2, Z1Z1), (y2, Z1)])
    S2, = fq.mont_mul_many([(T2, Z1Z1)])
    h_zero = fq.is_zero(fq.sub(U2, X1))
    r_zero = fq.is_zero(fq.sub(S2, Y1))
    p_inf = fq.is_zero(Z1)
    same = take & h_zero & r_zero & ~p_inf
    dX, dY, dZ = _pdouble(X1, Y1, Z1)
    X3 = fq.select(same, dX, X3)
    Y3 = fq.select(same, dY, Y3)
    Z3 = fq.select(same, dZ, Z3)
    return X3, Y3, Z3


def tree_reduce_points(X, Y, Z):
    """Collapse N Jacobian lanes to lane 0 by masked pairwise addition."""
    n = X.shape[-1]
    if n == 1:
        return X, Y, Z
    steps = n.bit_length() - 1
    lane = np.arange(n)

    def body(s, state):
        X, Y, Z = state
        shift = n >> (s + 1)
        Xp = jnp.roll(X, -shift, axis=1)
        Yp = jnp.roll(Y, -shift, axis=1)
        Zp = jnp.roll(Z, -shift, axis=1)
        Xn, Yn, Zn = _padd(X, Y, Z, Xp, Yp, Zp)
        active = lane < shift
        return (
            fq.select(active, Xn, X),
            fq.select(active, Yn, Y),
            fq.select(active, Zn, Z),
        )

    return lax.fori_loop(0, steps, body, (X, Y, Z))


# ---------------------------------------------------------------------------
# MSM kernel
# ---------------------------------------------------------------------------

def _msm_kernel(xs, ys, valid, bits):
    """Σ s_i P_i. xs/ys: (L, N) Fq Montgomery planes; valid: (N,) bool;
    bits: (254, N) int32 scalar bit planes (LSB first)."""
    n = xs.shape[1]
    # Derive the carry init from the inputs (xs * 0) rather than fresh
    # constants: under shard_map the fori_loop carry must share the inputs'
    # device-varying type.
    X = xs * 0
    Y = xs * 0 + np.asarray(FQ_SPEC.one_mont_limbs(), dtype=np.int32)[:, None]
    Z = xs * 0

    def body(i, state):
        X, Y, Z = state
        X, Y, Z = _pdouble(X, Y, Z)
        bit = lax.dynamic_index_in_dim(bits, 253 - i, axis=0, keepdims=False)
        take = (bit == 1) & valid
        return _padd_mixed(X, Y, Z, xs, ys, take)

    X, Y, Z = lax.fori_loop(0, 254, body, (X, Y, Z))
    X, Y, Z = tree_reduce_points(X, Y, Z)
    return X[:, :1], Y[:, :1], Z[:, :1]


@lru_cache(maxsize=32)
def _compiled_msm(n: int):
    return jax.jit(_msm_kernel)


def _next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# Host-facing API
# ---------------------------------------------------------------------------

def pack_g1_points(points: Sequence[G1]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack affine coordinates into Montgomery limb planes + validity mask.

    Identity points are marked invalid (they contribute nothing to an MSM).
    """
    n = len(points)
    xs_int: List[int] = []
    ys_int: List[int] = []
    valid = np.zeros((n,), dtype=bool)
    for i, p in enumerate(points):
        if p.is_zero():
            xs_int.append(0)
            ys_int.append(0)
        else:
            ax, ay = p.to_affine()
            xs_int.append(ax)
            ys_int.append(ay)
            valid[i] = True
    return (
        pack_ints(xs_int, FQ_SPEC),
        pack_ints(ys_int, FQ_SPEC),
        valid,
    )


class MSMContext:
    """Precomputed base points (e.g. powers of tau) for repeated MSMs.

    Host-side numpy: padding/slicing stays off-device; one transfer per msm
    call.
    """

    def __init__(self, points: Sequence[G1]):
        xs, ys, valid = pack_g1_points(points)
        self.num_points = len(points)
        self.xs = xs
        self.ys = ys
        self.valid = valid

    def msm(self, scalars: Sequence[Fr]) -> G1:
        """Σ scalars[i] * base[i] over the first len(scalars) base points."""
        n = len(scalars)
        if n == 0:
            return G1.zero()
        if n > self.num_points:
            raise ValueError("more scalars than base points")
        padded = _next_pow2(n)
        bits = np.zeros((254, padded), dtype=np.int32)
        bits[:, :n] = pack_scalar_bits([int(s) for s in scalars], num_bits=254)
        valid = np.zeros((padded,), dtype=bool)
        valid[:n] = self.valid[:n] & np.array(
            [int(s) != 0 for s in scalars], dtype=bool
        )
        xs = np.zeros((NUM_LIMBS, padded), dtype=np.int32)
        ys = np.zeros((NUM_LIMBS, padded), dtype=np.int32)
        xs[:, :n] = self.xs[:, :n]
        ys[:, :n] = self.ys[:, :n]
        fn = _compiled_msm(padded)
        X, Y, Z = fn(
            jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(valid), jnp.asarray(bits)
        )
        return _jacobian_to_g1(X, Y, Z)


def _jacobian_to_g1(X, Y, Z) -> G1:
    xv = unpack_ints(np.asarray(X), FQ_SPEC)[0]
    yv = unpack_ints(np.asarray(Y), FQ_SPEC)[0]
    zv = unpack_ints(np.asarray(Z), FQ_SPEC)[0]
    if zv == 0:
        return G1.zero()
    return G1(xv, yv, zv)


def msm_jax(points: Sequence[G1], scalars: Sequence[Fr]) -> G1:
    """One-shot device MSM (packs points per call; prefer MSMContext for
    SRS)."""
    n = min(len(points), len(scalars))
    if n == 0:
        return G1.zero()
    ctx = MSMContext(points[:n])
    return ctx.msm(scalars[:n])
