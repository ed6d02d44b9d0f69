"""Generic-degree sum-check — the engine behind the bit-column protocols.

The core ``SumCheck`` engine (tnsh.iop.sumcheck) is pinned to degree-3
rounds (4 evaluations) for bit-exact parity with the reference
(sumcheck.rs:46-153).  The bit-column sound protocols
(tnsh.protocols.twist_bits) expand one-hot address matrices algebraically
into products of log K committed bit columns, so their round polynomials
reach degree log K + 3 — this module generalizes the same protocol shape
(evaluation-form round messages, Fiat-Shamir round labels, fold binding)
to arbitrary degree:

  * round messages are the coefficient vectors of degree-``degree``
    polynomials interpolated from evaluations at X = 0..degree
    (Lagrange, exactly like the degree-3 engine);
  * transcript labels reuse the ``sumcheck_round_i`` /
    ``sumcheck_challenge_i`` scheme — proofs live in a new wire format,
    so there is no cross-protocol label collision;
  * ``DenseSopOracleD`` is the matching prover oracle: a sum of
    coefficient-weighted products of dense evaluation tables, with the
    X-point table values extended incrementally (v_{x+1} = v_x + d per
    pair) so a round costs (factors x degree) muls per lane pair.

No part of the reference corresponds to this engine (its sum-check is
degree-3 only); it re-designs the high-degree sum-check of the Twist/
Shout papers' "one-hot expanded" provers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..core.transcript import Transcript
from ..errors import SumCheckError
from ..field.fr import MODULUS, Fr
from ..poly.interp import lagrange_interpolate

_P = MODULUS


@dataclass
class SumCheckDProof:
    """Round polynomials (degree+1 coefficients each) + final evaluation."""

    degree: int
    round_polynomials: List[List[Fr]]
    final_evaluation: Fr


def _eval_poly(coeffs: Sequence[Fr], point) -> int:
    acc = 0
    p = int(point)
    for c in reversed(coeffs):
        acc = (acc * p + int(c)) % _P
    return acc


class DenseSopOracleD:
    """Σ_t coeff_t · Π_m T_{t,m}(x) over {0,1}^num_vars, dense tables,
    arbitrary per-round degree (= max factors per term).

    Tables passed by identity are deduplicated (shared tables fold once
    per round).  All arithmetic is exact integer math mod p.
    """

    def __init__(self, num_vars: int, terms, degree: int = None):
        size = 1 << num_vars
        self.num_vars = num_vars
        self._tables: List[List[int]] = []
        self._terms: List[tuple] = []
        seen = {}
        max_deg = 1
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                key = id(t)
                if key not in seen:
                    if len(t) != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(self._tables)
                    self._tables.append([int(v) % _P for v in t])
                idxs.append(seen[key])
            self._terms.append((int(coeff) % _P, tuple(idxs)))
            max_deg = max(max_deg, len(idxs))
        if not self._terms:
            raise SumCheckError("DenseSopOracleD needs at least one term")
        self.degree = max_deg if degree is None else degree
        if self.degree < max_deg:
            raise SumCheckError("declared degree below term degree")

    def hypercube_sum(self) -> Fr:
        total = 0
        size = len(self._tables[0])
        for i in range(size):
            for coeff, idxs in self._terms:
                prod = coeff
                for f in idxs:
                    prod = prod * self._tables[f][i] % _P
                total += prod
        return Fr(total % _P)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        npts = self.degree + 1
        acc = [0] * npts
        half = len(self._tables[0]) // 2
        tabs = self._tables
        for i in range(half):
            # X-point values per table, extended incrementally
            vals = []
            for t in tabs:
                lo = t[2 * i]
                hi = t[2 * i + 1]
                d = (hi - lo) % _P
                row = [lo, hi]
                v = hi
                for _ in range(npts - 2):
                    v = (v + d) % _P
                    row.append(v)
                vals.append(row)
            for coeff, idxs in self._terms:
                for x in range(npts):
                    prod = coeff
                    for f in idxs:
                        prod = prod * vals[f][x] % _P
                    acc[x] += prod
        return [Fr(v % _P) for v in acc]

    def bind(self, challenge: Fr) -> None:
        r = int(challenge)
        for t in self._tables:
            half = len(t) // 2
            for i in range(half):
                lo = t[2 * i]
                t[i] = (lo + r * (t[2 * i + 1] - lo)) % _P
            del t[half:]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        total = 0
        for coeff, idxs in self._terms:
            prod = coeff
            for f in idxs:
                prod = prod * self._tables[f][0] % _P
            total += prod
        return Fr(total % _P)


class NativeSopOracleD:
    """Native (C++) twin of ``DenseSopOracleD``: tables live in native
    memory in Montgomery form (tnsh_native.cpp ``sopd_*``), every round is
    one OpenMP-parallel generic-degree evaluation and Python only sees
    degree+1 field elements per round.  Bit-identical proofs (exact
    arithmetic; tests/test_twist_bits.py pins the equality)."""

    def __init__(self, num_vars: int, terms, degree: int = None):
        from .. import _native

        size = 1 << num_vars
        self.num_vars = num_vars
        tables: List = []
        idx_terms: List[tuple] = []
        seen = {}
        max_deg = 1
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                key = id(t)
                if key not in seen:
                    if len(t) != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(tables)
                    tables.append(t)
                idxs.append(seen[key])
            idx_terms.append((int(coeff) % _P, idxs))
            max_deg = max(max_deg, len(idxs))
        if not idx_terms:
            raise SumCheckError("NativeSopOracleD needs at least one term")
        self.degree = max_deg if degree is None else degree
        if self.degree < max_deg:
            raise SumCheckError("declared degree below term degree")
        self._native_id = _native.sopd_create(
            tables, idx_terms, self.degree + 1
        )

    @classmethod
    def _from_handle(cls, num_vars: int, handle: int, degree: int
                     ) -> "NativeSopOracleD":
        """Wrap an already-built native sopd handle (e.g. from
        _native.tbk_make_sopd) without marshalling any tables."""
        o = cls.__new__(cls)
        o.num_vars = num_vars
        o.degree = degree
        o._native_id = handle
        return o

    def release(self) -> None:
        """Free the native handle deterministically (idempotent).  The
        provers call this in a ``finally`` so the C++ tables are returned
        even while the Python GC is paused (the finalizer alone only runs
        when a cycle collector passes)."""
        if getattr(self, "_native_id", None) is not None:
            from .. import _native

            _native.sop_free(self._native_id)
            self._native_id = None

    def __del__(self):  # pragma: no cover - finalizer
        if getattr(self, "_native_id", None) is not None:
            try:
                from .. import _native

                _native.sop_free(self._native_id)
            except Exception:
                pass

    def round_evaluations(self, round_index: int) -> List[Fr]:
        from .. import _native

        return _native.sopd_round_evals(self._native_id, self.degree + 1)

    def bind(self, challenge: Fr) -> None:
        from .. import _native

        _native.sop_bind(self._native_id, challenge)

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        from .. import _native

        return _native.sop_final(self._native_id)


def make_sopd_oracle(num_vars: int, terms, degree: int):
    """Route a generic-degree sum-of-products oracle to a backend: native
    C++ (default — OpenMP-parallel, one host call per round), the JAX
    device oracle (opt-in via TNSH_BITS_FORCE_JAX=1, or automatic above
    TNSH_BITS_JAX_MIN variables when native is unavailable), or the
    pure-Python dense oracle (TNSH_NO_NATIVE golden path).  Identical
    proofs on every backend (exact arithmetic; tested)."""
    import os

    no_native = bool(os.environ.get("TNSH_NO_NATIVE"))
    no_jax = bool(os.environ.get("TNSH_NO_JAX"))
    try:
        jax_min = int(os.environ.get("TNSH_BITS_JAX_MIN", ""))
    except ValueError:
        jax_min = 16
    force_jax = bool(os.environ.get("TNSH_BITS_FORCE_JAX"))
    if not no_jax and (force_jax or (no_native and num_vars >= jax_min)):
        return JaxSopOracleD(num_vars, terms, degree=degree)
    if not no_native:
        from .. import _native

        if _native.available:
            return NativeSopOracleD(num_vars, terms, degree=degree)
    return DenseSopOracleD(num_vars, terms, degree=degree)


class JaxSopOracleD:
    """Device-backed twin of ``DenseSopOracleD`` (tnsh.poly.mle_jax
    kernels, compiled by XLA).

    Tables live stacked as one (F, 22, N) array of limb planes; every
    round is one jitted generic-degree computation and one jitted fold of
    the whole stack.  Each new table length is a new compile, so a fold
    keeps the stored length and leaves zeros in the upper half, which add
    nothing to any round sum (every term has a factor, and all factors
    vanish there); the stack is cut to its live length once that is
    2^-LEVEL of the stored one.  Outputs unpack
    to canonical host field elements before touching the transcript, so
    proofs are bit-identical to ``DenseSopOracleD``'s (asserted in
    tests/test_twist_bits.py)."""

    #: The stack is cut once its live length is 2^-LEVEL of the stored
    #: one: a T=2^18 j phase compiles two lengths instead of eighteen.
    LEVEL = 9

    def __init__(self, num_vars: int, terms, degree: int = None):
        import jax.numpy as jnp

        from ..poly import mle_jax

        self._m = mle_jax
        size = 1 << num_vars
        self.num_vars = num_vars
        tables = []
        coeffs = []
        idxs_list = []
        seen = {}
        max_deg = 1
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                key = id(t)
                if key not in seen:
                    if len(t) != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(tables)
                    tables.append(mle_jax.pack_mle(t))
                idxs.append(seen[key])
            coeffs.append(mle_jax.pack_fr_scalar(Fr(int(coeff) % _P)))
            idxs_list.append(tuple(idxs))
            max_deg = max(max_deg, len(idxs))
        if not idxs_list:
            raise SumCheckError("JaxSopOracleD needs at least one term")
        self._stack = jnp.asarray(np.stack(tables))
        self._coeffs = jnp.asarray(np.stack(coeffs))
        self._idxs = tuple(idxs_list)
        self._live = size
        self.degree = max_deg if degree is None else degree
        if self.degree < max_deg:
            raise SumCheckError("declared degree below term degree")

    def round_evaluations(self, round_index: int) -> List[Fr]:
        evals = self._m.sop_d_round_evals_stacked_jit(
            self._stack, self._coeffs, self._idxs, self.degree + 1
        )
        return self._m.unpack_fr(evals)

    def bind(self, challenge: Fr) -> None:
        import jax.numpy as jnp

        r = jnp.asarray(self._m.pack_fr_scalar(challenge))
        self._stack = self._m.fold_stacked(self._stack, r)
        self._live //= 2
        if self._live << self.LEVEL <= self._stack.shape[2]:
            self._stack = self._stack[:, :, :max(self._live, 2)]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        finals = [int(v) for v in self._m.unpack_fr(self._stack[:, :, 0].T)]
        coeff_vals = [int(v) for v in
                      self._m.unpack_fr(self._coeffs[:, :, 0].T)]
        total = 0
        for coeff, idxs in zip(coeff_vals, self._idxs):
            prod = coeff
            for f in idxs:
                prod = prod * finals[f] % _P
            total += prod
        return Fr(total % _P)


class SumCheckD:
    """Sum-check at an explicit round degree (evaluations at 0..degree)."""

    def __init__(self, num_vars: int, claimed_sum: Fr, degree: int):
        self.num_vars = num_vars
        self.claimed_sum = Fr(claimed_sum)
        self.degree = degree
        self._xs = [Fr(x) for x in range(degree + 1)]

    def prove_with_challenges(self, oracle, transcript: Transcript):
        round_polys: List[List[Fr]] = []
        current = int(self.claimed_sum)
        challenges: List[Fr] = []
        for rd in range(self.num_vars):
            evals = oracle.round_evaluations(rd)
            if len(evals) != self.degree + 1:
                raise SumCheckError("oracle degree mismatch")
            poly = lagrange_interpolate(list(zip(self._xs, evals)))
            if (int(evals[0]) + int(evals[1])) % _P != current:
                raise SumCheckError(f"round {rd} consistency check failed")
            round_polys.append(poly)
            transcript.append_field_elements(
                f"sumcheck_round_{rd}".encode(), poly
            )
            c = transcript.challenge_field_element(
                f"sumcheck_challenge_{rd}".encode()
            )
            challenges.append(c)
            oracle.bind(c)
            current = _eval_poly(poly, c)
        final = oracle.final_evaluation(challenges)
        return SumCheckDProof(self.degree, round_polys, final), challenges

    def verify(self, proof: SumCheckDProof, transcript: Transcript):
        if (proof.degree != self.degree
                or len(proof.round_polynomials) != self.num_vars):
            return False, []
        current = int(self.claimed_sum)
        challenges: List[Fr] = []
        for rd, poly in enumerate(proof.round_polynomials):
            if len(poly) != self.degree + 1:
                return False, challenges
            if (_eval_poly(poly, 0) + _eval_poly(poly, 1)) % _P != current:
                return False, challenges
            transcript.append_field_elements(
                f"sumcheck_round_{rd}".encode(), poly
            )
            c = transcript.challenge_field_element(
                f"sumcheck_challenge_{rd}".encode()
            )
            challenges.append(c)
            current = _eval_poly(poly, c)
        return current == int(proof.final_evaluation), challenges
