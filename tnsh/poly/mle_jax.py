"""MLE evaluation-table kernels on limb planes (device path).

Device-side twin of ``tnsh.poly.mle`` (SURVEY §7.0 "MLE as a sharded dense eval
table").  Tables are ``(22, N)`` int32 Fr limb planes (Montgomery,
2p-domain); index bit j of a lane is variable j, little-endian, matching the
reference's convention (polynomials.rs:108-122) exactly.

Kernels:
  * ``fold(table, r)`` — fix variable 0 (fastest bit): even/odd lane pairs
    combine as lo + r * (hi - lo).  This is THE sum-check round primitive;
    2^n mults total across a full fold schedule (vs the reference's O(4^n)
    partial_evaluate).
  * ``evaluate(table, point)`` — iterated fold.
  * ``sum_tree(table)`` — exact field sum of all lanes by halving tree.
  * ``product_round_evals(tables)`` — [g(0..3)] for a product-of-MLEs
    sum-check round: per-pair values at X = 0,1,2,3 from lo/hi (0 and 1 are
    free; 2 and 3 are two adds), multiplied across factors, tree-summed.

Under ``shard_map``/pjit the lane axis is block-sharded across the mesh:
blocks correspond to the SLOWEST variables, so folding variable 0 is
shard-local and the round sums reduce with one psum
(tnsh.parallel.mesh).  All arithmetic is exact — device rounds match the
host oracle bit-for-bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..field.fr import Fr
from ..field.fr_jax import fr_ops
from ..field.limbs import FR_SPEC, NUM_LIMBS, pack_ints, unpack_ints

fr = fr_ops
L = NUM_LIMBS


def pack_mle(evaluations: Sequence[Fr]) -> np.ndarray:
    """Host -> device: pack an MLE evaluation table (Montgomery planes)."""
    return pack_ints([int(e) for e in evaluations], FR_SPEC)


def unpack_fr(planes) -> List[Fr]:
    """Device -> host canonical field elements."""
    return [Fr(v) for v in unpack_ints(np.asarray(planes), FR_SPEC)]


def pack_fr_scalar(x: Fr) -> np.ndarray:
    """A single field element as (22, 1) planes."""
    return pack_ints([int(x)], FR_SPEC)


def fold(table: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Fix variable 0 to r: out[i] = t[2i] + r * (t[2i+1] - t[2i])."""
    lo = table[:, 0::2]
    hi = table[:, 1::2]
    d = fr.sub(hi, lo)
    return fr.add(lo, fr.mont_mul(jnp.broadcast_to(r, d.shape), d))


def evaluate(table: jnp.ndarray, point_planes: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Evaluate at a point given as a list of (22, 1) plane scalars."""
    for r in point_planes:
        table = fold(table, r)
    return table


def sum_tree(table: jnp.ndarray) -> jnp.ndarray:
    """Exact field sum over all lanes -> (22, 1)."""
    n = table.shape[1]
    while n > 1:
        half = n // 2
        table = fr.add(table[:, :half], table[:, half:n])
        n = half
    return table


def product_round_evals(
    tables: Sequence[jnp.ndarray], scale: jnp.ndarray = None
) -> jnp.ndarray:
    """[g(0), g(1), g(2), g(3)] for a product-of-MLEs round -> (22, 4).

    g(x) = Σ_pairs Π_f (lo_f + x (hi_f - lo_f)).  Values at 0/1 are the
    table entries; at 2/3 they extend by the pair difference.
    """
    prods = None
    for t in tables:
        lo = t[:, 0::2]
        hi = t[:, 1::2]
        d = fr.sub(hi, lo)
        v2 = fr.add(hi, d)
        v3 = fr.add(v2, d)
        vals = jnp.concatenate([lo, hi, v2, v3], axis=1)  # (L, 4*half)
        if prods is None:
            prods = vals
        else:
            prods = fr.mont_mul(prods, vals)
    if scale is not None:
        prods = fr.mont_mul(jnp.broadcast_to(scale, prods.shape), prods)
    half = prods.shape[1] // 4
    # Sum each X-block: (L, 4*half) -> four (L, 1) sums, kept adjacent.
    sums = [
        sum_tree(prods[:, k * half:(k + 1) * half]) for k in range(4)
    ]
    return jnp.concatenate(sums, axis=1)  # (L, 4)


def sum_of_products_round_evals(
    tables: Sequence[jnp.ndarray],
    coeffs: Sequence[jnp.ndarray],
    term_idxs: Tuple[Tuple[int, ...], ...],
) -> jnp.ndarray:
    """[g(0..3)] for f = Σ_t coeff_t * Π_{f in term_t} T_f -> (22, 4).

    The device oracle behind the verifier-enforced sound-mode constraints
    (tnsh.protocols.sound): per lane pair the four X-point values are
    computed ONCE per distinct table, then combined per term and
    accumulated before a single tree sum.  ``term_idxs`` is static
    structure (baked into the jitted program); tables/coeffs are operands.
    """
    vals = []
    for t in tables:
        lo = t[:, 0::2]
        hi = t[:, 1::2]
        d = fr.sub(hi, lo)
        v2 = fr.add(hi, d)
        v3 = fr.add(v2, d)
        vals.append(jnp.concatenate([lo, hi, v2, v3], axis=1))
    acc = None
    for coeff, idxs in zip(coeffs, term_idxs):
        prods = None
        for f in idxs:
            prods = vals[f] if prods is None else fr.mont_mul(prods, vals[f])
        prods = fr.mont_mul(jnp.broadcast_to(coeff, prods.shape), prods)
        acc = prods if acc is None else fr.add(acc, prods)
    half = acc.shape[1] // 4
    sums = [sum_tree(acc[:, k * half:(k + 1) * half]) for k in range(4)]
    return jnp.concatenate(sums, axis=1)  # (L, 4)


def sum_of_products_round_evals_d(
    tables: Sequence[jnp.ndarray],
    coeffs: Sequence[jnp.ndarray],
    term_idxs: Tuple[Tuple[int, ...], ...],
    npts: int,
) -> jnp.ndarray:
    """[g(0..npts-1)] for a GENERIC-DEGREE sum of products -> (22, npts).

    The device oracle behind the bit-column protocols (tnsh.protocols.
    twist_bits): identical structure to ``sum_of_products_round_evals``
    but with ``npts`` X-points per pair (round degree npts-1), extended
    incrementally (v_{x+1} = v_x + d costs one add).

    The tables are stacked and every repeated step is a ``fori_loop``, so
    the program holds one field multiply per distinct term degree: XLA's
    GPU compile time grows with the number of multiply instances in the
    program, not with the trip count."""
    return sop_d_round_evals_stacked(jnp.stack(tables), jnp.stack(coeffs),
                                     term_idxs, npts)


def sop_d_round_evals_stacked(stacked, coeff_arr, term_idxs, npts: int):
    """:func:`sum_of_products_round_evals_d` over tables stacked as
    (F, 22, N) and coefficients as (terms, 22, 1)."""
    n_tab = stacked.shape[0]
    half = stacked.shape[2] // 2

    def flat(v):  # (F, L, half) -> (L, F*half)
        return v.transpose(1, 0, 2).reshape(L, n_tab * half)

    def unflat(v):  # (L, F*half) -> (F, L, 1, half)
        return v.reshape(L, n_tab, half).transpose(1, 0, 2)[:, :, None, :]

    lo = flat(stacked[:, :, 0::2])
    hi = flat(stacked[:, :, 1::2])
    d = fr.sub(hi, lo)
    vals = jnp.zeros((n_tab, L, npts, half), jnp.int32)
    vals = lax.dynamic_update_slice_in_dim(vals, unflat(lo), 0, axis=2)
    vals = lax.dynamic_update_slice_in_dim(vals, unflat(hi), 1, axis=2)

    def extend(x, st):
        cur, vals = st
        cur = fr.add(cur, d)
        return cur, lax.dynamic_update_slice_in_dim(vals, unflat(cur), x,
                                                    axis=2)

    _, vals = lax.fori_loop(2, npts, extend, (hi, vals))
    vals = vals.reshape(n_tab, L, npts * half)  # x-major lane blocks

    acc = jnp.zeros((L, npts * half), jnp.int32)
    by_degree = {}
    for t, idxs in enumerate(term_idxs):
        by_degree.setdefault(len(idxs), []).append(t)
    for degree, terms in sorted(by_degree.items()):
        factors = jnp.asarray(
            np.asarray([term_idxs[t] for t in terms], dtype=np.int32))
        cs = coeff_arr[np.asarray(terms)]

        def term_body(i, acc, factors=factors, cs=cs, degree=degree):
            row = factors[i]

            def mul(j, prods):
                return fr.mont_mul(prods, vals[row[j]])

            prods = lax.fori_loop(1, degree, mul, vals[row[0]])
            prods = fr.mont_mul(jnp.broadcast_to(cs[i], prods.shape), prods)
            return fr.add(acc, prods)

        acc = lax.fori_loop(0, len(terms), term_body, acc)

    acc = acc.reshape(L, npts, half)
    while half > 1:
        half //= 2
        acc = fr.add(acc[:, :, :half].reshape(L, npts * half),
                     acc[:, :, half:].reshape(L, npts * half)
                     ).reshape(L, npts, half)
    return acc.reshape(L, npts)


# jitted wrappers (shapes cached by XLA)
fold_jit = jax.jit(fold)
sum_tree_jit = jax.jit(sum_tree)
product_round_evals_jit = jax.jit(product_round_evals)
sum_of_products_round_evals_jit = jax.jit(
    sum_of_products_round_evals, static_argnums=(2,)
)
sum_of_products_round_evals_d_jit = jax.jit(
    sum_of_products_round_evals_d, static_argnums=(2, 3)
)
sop_d_round_evals_stacked_jit = jax.jit(
    sop_d_round_evals_stacked, static_argnums=(2, 3)
)


@jax.jit
def fold_stacked(stacked, r):
    """Fold every table of an (F, 22, N) stack at r, keeping the length:
    lanes [0, N/2) hold the folded tables, lanes [N/2, N) zeros."""
    folded = jax.vmap(fold, in_axes=(0, None))(stacked, r)
    return jnp.concatenate([folded, jnp.zeros_like(folded)], axis=2)


@jax.jit
def product_round_step(tables, r):
    """One full sum-check round for a product oracle: returns
    ([g(0..3)] BEFORE folding, folded tables AFTER binding r).

    Callers use g from the PREVIOUS round's output, draw the challenge on
    the host transcript, then invoke with that r.
    """
    folded = [fold(t, r) for t in tables]
    evals = product_round_evals(tables)
    return evals, folded
