"""Equality tests for the device MLE kernels (tnsh.poly.mle_jax) that the
Jax sum-check oracles run, at the shapes of their round tables.

Every kernel must unpack to the SAME canonical field elements as the host
golden path (plain integer arithmetic mod r) — the backend-equality
invariant.  XLA compiles the same programs for the CPU here and for the
GPU in ``chip_smoke.py``.
"""

import numpy as np
import pytest

from tnsh.field.fr import MODULUS, Fr
from tnsh.poly import mle_jax

_P = MODULUS


def _rand_vals(rng, n):
    return [int(v) for v in rng.integers(0, 1 << 62, n)]


def _planes(vals):
    import jax.numpy as jnp

    return jnp.asarray(mle_jax.pack_mle([Fr(v) for v in vals]))


def _scalar(v):
    import jax.numpy as jnp

    return jnp.asarray(mle_jax.pack_fr_scalar(Fr(v)))


def _canon(planes):
    return [int(v) for v in mle_jax.unpack_fr(planes)]


def _host_round_evals(tables, terms, npts):
    """[g(0..npts-1)] of Σ_t c_t Π_f T_f over lane pairs, plain ints."""
    half = len(tables[0]) // 2
    out = [0] * npts
    for i in range(half):
        ext = []
        for t in tables:
            lo, hi = t[2 * i], t[2 * i + 1]
            ext.append([(lo + x * (hi - lo)) % _P for x in range(npts)])
        for c, idxs in terms:
            for x in range(npts):
                prod = c
                for f in idxs:
                    prod = prod * ext[f][x] % _P
                out[x] += prod
    return [v % _P for v in out]


def test_fold_matches_host():
    rng = np.random.default_rng(5)
    t = _rand_vals(rng, 8192)
    r = 0x1234567890ABCDEF
    got = _canon(mle_jax.fold_jit(_planes(t), _scalar(r)))
    want = [(t[2 * i] + r * (t[2 * i + 1] - t[2 * i])) % _P
            for i in range(4096)]
    assert got == want


@pytest.mark.parametrize("scale", [None, 987654321123456789])
def test_product_round_evals_matches_host(scale):
    rng = np.random.default_rng(6)
    tabs = [_rand_vals(rng, 8192) for _ in range(3)]
    s = None if scale is None else _scalar(scale)
    got = _canon(mle_jax.product_round_evals_jit([_planes(t) for t in tabs],
                                                 s))
    want = _host_round_evals(tabs, [(1 if scale is None else scale,
                                     (0, 1, 2))], 4)
    assert got == want


def test_sop_round_evals_matches_host():
    rng = np.random.default_rng(7)
    tabs = [_rand_vals(rng, 4096) for _ in range(3)]
    coeffs = (1, _P - 1, 7)
    idxs = ((0, 1, 2), (0, 1), (2,))
    got = _canon(mle_jax.sum_of_products_round_evals_jit(
        [_planes(t) for t in tabs], [_scalar(c) for c in coeffs], idxs))
    assert got == _host_round_evals(tabs, list(zip(coeffs, idxs)), 4)


def test_sop_d_round_evals_matches_host():
    """Generic degree with terms of several degrees (the loop structure
    groups terms by degree) and a repeated factor."""
    rng = np.random.default_rng(8)
    tabs = [_rand_vals(rng, 512) for _ in range(6)]
    tabs[3] = [v % 2 for v in tabs[3]]
    coeffs = (3, _P - 5, 11, 13, _P - 13)
    idxs = ((0, 1, 2, 3, 4), (1, 5), (2, 3, 4, 5, 0), (3, 3, 1), (3,))
    npts = 7
    got = _canon(mle_jax.sum_of_products_round_evals_d_jit(
        [_planes(t) for t in tabs], [_scalar(c) for c in coeffs], idxs,
        npts))
    assert got == _host_round_evals(tabs, list(zip(coeffs, idxs)), npts)


def test_round_evals_and_fold_at_two_lanes():
    """The last round of a sum-check: one lane pair, no tree levels."""
    rng = np.random.default_rng(9)
    tabs = [_rand_vals(rng, 2) for _ in range(2)]
    idxs = ((0, 1), (1,))
    coeffs = (5, 9)
    got = _canon(mle_jax.sum_of_products_round_evals_d_jit(
        [_planes(t) for t in tabs], [_scalar(c) for c in coeffs], idxs, 4))
    assert got == _host_round_evals(tabs, list(zip(coeffs, idxs)), 4)
    r = 42424242
    t = tabs[0]
    assert _canon(mle_jax.fold_jit(_planes(t), _scalar(r))) == [
        (t[0] + r * (t[1] - t[0])) % _P]


def test_mont_mul_chain_matches_host():
    import jax

    from tnsh.field.fr_jax import fr_mont_mul

    rng = np.random.default_rng(10)
    x = _rand_vals(rng, 2048)
    y = _rand_vals(rng, 2048)
    iters = 5
    chain = jax.jit(lambda a, b: jax.lax.fori_loop(
        0, iters, lambda i, r: fr_mont_mul(r, b), a))
    got = _canon(chain(_planes(x), _planes(y)))
    assert got == [a * pow(b, iters, _P) % _P for a, b in zip(x, y)]


@pytest.mark.parametrize("montgomery", [True, False])
def test_pack_ints_limbs(montgomery):
    """pack_ints writes v (times R mod p in Montgomery form) as 12-bit
    limbs, reducing inputs at or above p; unpack_ints inverts it."""
    from tnsh.field.limbs import (
        FR_SPEC, LIMB_BITS, NUM_LIMBS, R_LIMB, pack_ints, unpack_ints,
    )

    vals = [0, 1, _P - 1, _P, _P + 5, 2 ** 254 - 1, 123456789 ** 5]
    planes = pack_ints(vals, FR_SPEC, montgomery=montgomery)
    assert planes.shape == (NUM_LIMBS, len(vals))
    for j, v in enumerate(vals):
        w = v % _P * (R_LIMB if montgomery else 1) % _P
        assert [int(x) for x in planes[:, j]] == [
            (w >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1)
            for i in range(NUM_LIMBS)]
    assert unpack_ints(planes, FR_SPEC, montgomery=montgomery) == [
        v % _P for v in vals]


def test_fold_stacked_keeps_length():
    """fold_stacked folds every table of the stack and zero-fills the
    upper half, so the stack keeps its compiled length."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    tabs = [_rand_vals(rng, 64) for _ in range(3)]
    r = 0xC0FFEE
    out = mle_jax.fold_stacked(jnp.stack([_planes(t) for t in tabs]),
                               _scalar(r))
    assert out.shape == (3, 22, 64)
    for k, t in enumerate(tabs):
        want = [(t[2 * i] + r * (t[2 * i + 1] - t[2 * i])) % _P
                for i in range(32)]
        assert _canon(out[k]) == want + [0] * 32


def test_jax_oracle_cuts_stack_by_level(monkeypatch):
    """JaxSopOracleD keeps its stack length until the live length is
    2^-LEVEL of it, then cuts it; every round still equals the dense
    oracle's."""
    from tnsh.iop.sumcheck_d import DenseSopOracleD, JaxSopOracleD

    monkeypatch.setattr(JaxSopOracleD, "LEVEL", 4)
    rng = np.random.default_rng(13)
    n = 6
    tabs = [_rand_vals(rng, 1 << n) for _ in range(3)]
    terms = [(3, [tabs[0], tabs[1], tabs[2]]), (_P - 2, [tabs[1]])]
    dense = DenseSopOracleD(n, terms, degree=3)
    dev = JaxSopOracleD(n, terms, degree=3)
    lengths = []
    for rd in range(n):
        assert [int(v) for v in dev.round_evaluations(rd)] == [
            int(v) for v in dense.round_evaluations(rd)]
        c = Fr(0xABC + rd)
        dev.bind(c)
        dense.bind(c)
        lengths.append(dev._stack.shape[2])
    assert lengths == [64, 64, 64, 4, 4, 4]
    assert int(dev.final_evaluation([])) == int(dense.final_evaluation([]))
