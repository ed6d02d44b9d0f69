"""Sum-check protocol engine.

Port of ``SumCheck`` (reference sumcheck.rs:14-213) with the closure-based
prover generalized into *oracles* (SURVEY §7.0 "Sum-check engine"):

  * ``CallableOracle`` — reference-exact semantics: an opaque function over
    points; per round the prover enumerates the suffix hypercube in
    little-endian bit order and evaluates at X = 0..3
    (sumcheck.rs:166-198).  Used by tests and arbitrary polynomials.
  * ``ZeroOracle`` — the identically-zero polynomial; this is what the
    reference's Twist/Shout consistency closures compute (they always return
    zero — twist.rs:212, shout.rs:182), so the default protocol path uses it
    and produces bit-identical (all-zero) round polynomials without touching
    the MLE tables.
  * ``ProductMLEOracle`` — product of MLE factors evaluated by table folding:
    O(2^n) per round instead of the reference's O(4^n)-ish re-evaluation.
    This powers sound-mode constraints and the device-sharded prover
    (tnsh.parallel.mesh folds shard-locally and psums round evaluations).

Round polynomials are degree-<=3 univariates represented by 4 coefficients,
interpolated from evaluations at X = 0,1,2,3 exactly like the reference
(sumcheck.rs:175, 200-206).  Transcript labels are byte-identical:
``sumcheck_round_{r}`` and ``sumcheck_challenge_{r}`` (sumcheck.rs:91, 95).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from ..core.transcript import Transcript
from ..errors import SumCheckError
from ..field.fr import MODULUS, Fr
from ..poly.interp import lagrange_interpolate
from ..poly.mle import MultilinearExtension

_P = MODULUS

#: Evaluation points for each round polynomial (degree <= 3).
_ROUND_XS = (Fr(0), Fr(1), Fr(2), Fr(3))


@dataclass
class SumCheckProof:
    """Round polynomials (4 coefficients each) + final evaluation
    (reference sumcheck.rs:25-31)."""

    round_polynomials: List[List[Fr]]
    final_evaluation: Fr


@dataclass
class SumCheckVerifier:
    """Verifier state struct — declared for API parity with the reference
    (sumcheck.rs:35-44), which also never uses it."""

    num_vars: int
    challenges: List[Fr] = field(default_factory=list)
    expected_sum: Fr = Fr(0)


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

class SumcheckOracle:
    """Prover-side polynomial interface consumed by ``SumCheck.prove``."""

    def round_evaluations(self, round_index: int) -> List[Fr]:
        """[g(0), g(1), g(2), g(3)] for the current round."""
        raise NotImplementedError

    def bind(self, challenge: Fr) -> None:
        """Fix the current variable to ``challenge`` and advance a round."""
        raise NotImplementedError

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        """f(challenges) after all rounds."""
        raise NotImplementedError


class CallableOracle(SumcheckOracle):
    """Reference-exact oracle over an opaque callable
    (reference sumcheck.rs:156-207)."""

    def __init__(self, func: Callable[[List[Fr]], Fr], num_vars: int):
        self.func = func
        self.num_vars = num_vars
        self.fixed: List[Fr] = []

    def round_evaluations(self, round_index: int) -> List[Fr]:
        remaining = self.num_vars - len(self.fixed) - 1
        num_points = 1 << remaining
        evals: List[Fr] = []
        for x in _ROUND_XS:
            total = 0
            for suffix in range(num_points):
                point = list(self.fixed)
                point.append(x)
                for bit in range(remaining):
                    point.append(Fr(1) if (suffix >> bit) & 1 else Fr(0))
                total += int(self.func(point))
            evals.append(Fr(total))
        return evals

    def bind(self, challenge: Fr) -> None:
        self.fixed.append(challenge)

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        return self.func(list(challenges))


class ZeroOracle(SumcheckOracle):
    """The identically-zero polynomial — what the reference's stub
    consistency closures compute (twist.rs:186-214, shout.rs:160-184)."""

    def __init__(self, num_vars: int):
        self.num_vars = num_vars

    def round_evaluations(self, round_index: int) -> List[Fr]:
        return [Fr(0), Fr(0), Fr(0), Fr(0)]

    def bind(self, challenge: Fr) -> None:
        pass

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        return Fr(0)


class ProductMLEOracle(SumcheckOracle):
    """Product of MLE factors (optionally scaled), evaluated by folding.

    Folds the FIRST (fastest) variable each round, matching the reference's
    variable order.  Per-round cost is O(4 * k * 2^remaining) field mults
    where k = number of factors — the classic linear-time sum-check prover.
    """

    def __init__(self, factors: Sequence[MultilinearExtension], scale: Fr = Fr(1)):
        if not factors:
            raise SumCheckError("ProductMLEOracle needs at least one factor")
        self.num_vars = factors[0].num_vars
        for f in factors:
            if f.num_vars != self.num_vars:
                raise SumCheckError("factor num_vars mismatch")
        self.tables: List[List[int]] = [
            [int(e) for e in f.evaluations] for f in factors
        ]
        self.scale = int(scale)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        half = len(self.tables[0]) // 2
        sums = [0, 0, 0, 0]
        for s in range(half):
            lo_hi = [(t[2 * s], t[2 * s + 1]) for t in self.tables]
            for xi in range(4):
                prod = self.scale
                for lo, hi in lo_hi:
                    prod = prod * ((lo + xi * (hi - lo)) % _P) % _P
                sums[xi] += prod
        return [Fr(v) for v in sums]

    def bind(self, challenge: Fr) -> None:
        r = int(challenge)
        self.tables = [
            [
                (t[2 * i] + r * (t[2 * i + 1] - t[2 * i])) % _P
                for i in range(len(t) // 2)
            ]
            for t in self.tables
        ]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        prod = self.scale
        for t in self.tables:
            prod = prod * t[0] % _P
        return Fr(prod)


class SumOfProductsOracle(SumcheckOracle):
    """Linear combination of products of dense tables:

        f(x) = sum_t coeff_t * prod_m T_{t,m}(x)

    over {0,1}^num_vars, evaluated by table folding like
    ``ProductMLEOracle``.  Tables passed by identity are deduplicated so a
    table shared between terms is folded exactly once per round.  This is
    the oracle for the verifier-enforced sound-mode constraint systems
    (tnsh.protocols.sound), whose checks are small sums of degree-<=3
    products (eq * witness * witness).
    """

    #: Table sizes at or above this route to the native C++ evaluator
    #: (per-round work is O(size * factors) big-int mults in Python).
    NATIVE_THRESHOLD = 1 << 10

    def __init__(self, num_vars: int, terms):
        """``terms``: sequence of ``(coeff, [table, ...])`` where each table
        is a list of ints/Fr of length ``2^num_vars``."""
        import os

        size = 1 << num_vars
        self.num_vars = num_vars
        self._tables: List[List[int]] = []
        self._terms: List[tuple] = []
        self._native_id = None
        seen = {}
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                key = id(t)
                if key not in seen:
                    if len(t) != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(self._tables)
                    # bytes-backed FrTable payloads (native eq/lt tables)
                    # pass through to the native marshal untouched
                    self._tables.append(
                        t if hasattr(t, "raw")
                        else [int(v) % _P for v in t]
                    )
                idxs.append(seen[key])
            self._terms.append((int(coeff) % _P, idxs))
        if not self._terms:
            raise SumCheckError("SumOfProductsOracle needs at least one term")
        if size >= self.NATIVE_THRESHOLD and not os.environ.get(
            "TNSH_NO_NATIVE"
        ):
            from .. import _native

            if _native.available:
                self._native_id = _native.sop_create(
                    self._tables, self._terms
                )
                self._tables = []  # tables live native-side

    @classmethod
    def _from_native_id(cls, num_vars: int, native_id: int
                        ) -> "SumOfProductsOracle":
        """Wrap an already-built native sop handle (e.g. from
        _native.sco_make_sop) without marshalling any tables."""
        o = cls.__new__(cls)
        o.num_vars = num_vars
        o._tables = []
        o._terms = []
        o._native_id = native_id
        return o

    def __del__(self):  # pragma: no cover - finalizer
        if getattr(self, "_native_id", None) is not None:
            try:
                from .. import _native

                _native.sop_free(self._native_id)
            except Exception:
                pass

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._native_id is not None:
            from .. import _native

            return _native.sop_round_evals(self._native_id)
        half = len(self._tables[0]) // 2
        sums = [0, 0, 0, 0]
        for s in range(half):
            lo_hi = [(t[2 * s], t[2 * s + 1]) for t in self._tables]
            for xi in range(4):
                pt_vals = [
                    (lo + xi * (hi - lo)) % _P for lo, hi in lo_hi
                ]
                total = 0
                for coeff, idxs in self._terms:
                    prod = coeff
                    for m in idxs:
                        prod = prod * pt_vals[m] % _P
                    total += prod
                sums[xi] += total
        return [Fr(v) for v in sums]

    def bind(self, challenge: Fr) -> None:
        if self._native_id is not None:
            from .. import _native

            _native.sop_bind(self._native_id, challenge)
            return
        r = int(challenge)
        self._tables = [
            [
                (t[2 * i] + r * (t[2 * i + 1] - t[2 * i])) % _P
                for i in range(len(t) // 2)
            ]
            for t in self._tables
        ]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        if self._native_id is not None:
            from .. import _native

            return _native.sop_final(self._native_id)
        total = 0
        for coeff, idxs in self._terms:
            prod = coeff
            for m in idxs:
                prod = prod * self._tables[m][0] % _P
            total += prod
        return Fr(total % _P)


class JaxSumOfProductsOracle(SumcheckOracle):
    """Device-backed sum-of-products oracle (tnsh.poly.mle_jax kernels).

    Device twin of ``SumOfProductsOracle`` for the verifier-enforced
    sound-mode constraint sum-checks: tables live on device as limb
    planes, every round is one fused XLA computation (per-table X-point
    values shared across terms), and the fold binds all tables in one
    call.  Outputs unpack to canonical host field elements before
    touching the transcript, so proofs are bit-identical to the host and
    native oracles (asserted in tests/test_jax_backend.py).
    """

    def __init__(self, num_vars: int, terms):
        import jax.numpy as jnp

        from ..poly import mle_jax

        self._m = mle_jax
        size = 1 << num_vars
        self.num_vars = num_vars
        self.tables = []
        self._coeffs = []
        self._idxs: List[tuple] = []
        seen = {}
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                key = id(t)
                if key not in seen:
                    if len(t) != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(self.tables)
                    self.tables.append(
                        jnp.asarray(
                            mle_jax.pack_mle([Fr(int(v) % _P) for v in t])
                        )
                    )
                idxs.append(seen[key])
            self._coeffs.append(
                jnp.asarray(mle_jax.pack_fr_scalar(Fr(int(coeff) % _P)))
            )
            self._idxs.append(tuple(idxs))
        if not self._idxs:
            raise SumCheckError("JaxSumOfProductsOracle needs a term")
        self._idxs = tuple(self._idxs)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        evals = self._m.sum_of_products_round_evals_jit(
            self.tables, self._coeffs, self._idxs
        )
        return self._m.unpack_fr(evals)

    def bind(self, challenge: Fr) -> None:
        import jax.numpy as jnp

        r = jnp.asarray(self._m.pack_fr_scalar(challenge))
        self.tables = [self._m.fold_jit(t, r) for t in self.tables]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        finals = [int(self._m.unpack_fr(t)[0]) for t in self.tables]
        coeff_vals = [
            int(self._m.unpack_fr(c)[0]) for c in self._coeffs
        ]
        total = 0
        for coeff, idxs in zip(coeff_vals, self._idxs):
            prod = coeff
            for f in idxs:
                prod = prod * finals[f] % _P
            total += prod
        return Fr(total % _P)


class JaxProductMLEOracle(SumcheckOracle):
    """Device-backed product-of-MLEs oracle (tnsh.poly.mle_jax kernels).

    Same math as ``ProductMLEOracle`` — fold-based linear-time rounds — but
    the tables live on device as limb planes and each round is one fused
    XLA computation.  Outputs are unpacked to canonical host field elements
    before touching the transcript, so proofs are bit-identical to the host
    oracle (asserted in tests/test_jax_backend.py).
    """

    def __init__(self, factors: Sequence[MultilinearExtension], scale: Fr = Fr(1)):
        import jax.numpy as jnp

        from ..poly import mle_jax

        self._m = mle_jax
        if not factors:
            raise SumCheckError("JaxProductMLEOracle needs at least one factor")
        self.num_vars = factors[0].num_vars
        for f in factors:
            if f.num_vars != self.num_vars:
                raise SumCheckError("factor num_vars mismatch")
        self.tables = [jnp.asarray(mle_jax.pack_mle(f.evaluations)) for f in factors]
        self._scale = (
            None if scale == Fr(1) else jnp.asarray(mle_jax.pack_fr_scalar(scale))
        )

    def round_evaluations(self, round_index: int) -> List[Fr]:
        evals = self._m.product_round_evals_jit(self.tables, self._scale)
        return self._m.unpack_fr(evals)

    def bind(self, challenge: Fr) -> None:
        import jax.numpy as jnp

        r = jnp.asarray(self._m.pack_fr_scalar(challenge))
        self.tables = [self._m.fold_jit(t, r) for t in self.tables]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        vals = [self._m.unpack_fr(t)[0] for t in self.tables]
        prod = Fr(1)
        for v in vals:
            prod = prod * v
        return prod


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

def _evaluate_round_polynomial(coeffs: Sequence[Fr], point: Fr) -> Fr:
    acc = 0
    p = int(point)
    for c in reversed(coeffs):
        acc = (acc * p + int(c)) % _P
    return Fr(acc)


class SumCheck:
    """Sum-check instance: claim Σ_{x in {0,1}^n} f(x) = claimed_sum
    (reference sumcheck.rs:46-153)."""

    def __init__(self, num_vars: int, claimed_sum: Fr):
        self.num_vars = num_vars
        self.claimed_sum = Fr(claimed_sum)

    def prove(self, polynomial, transcript: Transcript) -> SumCheckProof:
        """``polynomial`` is a ``SumcheckOracle`` or a plain callable
        (wrapped in ``CallableOracle`` with reference-exact semantics)."""
        proof, _ = self.prove_with_challenges(polynomial, transcript)
        return proof

    def prove_with_challenges(self, polynomial, transcript: Transcript):
        """Like ``prove`` but also returns the verifier challenge vector —
        sound-mode callers open PCS commitments at exactly this point."""
        oracle = (
            polynomial
            if isinstance(polynomial, SumcheckOracle)
            else CallableOracle(polynomial, self.num_vars)
        )
        round_polynomials: List[List[Fr]] = []
        current_sum = self.claimed_sum
        challenges: List[Fr] = []

        for round_index in range(self.num_vars):
            evals = oracle.round_evaluations(round_index)
            round_poly = lagrange_interpolate(
                list(zip(_ROUND_XS, evals))
            )
            g_0 = _evaluate_round_polynomial(round_poly, Fr(0))
            g_1 = _evaluate_round_polynomial(round_poly, Fr(1))
            if g_0 + g_1 != current_sum:
                raise SumCheckError(
                    f"Round {round_index} consistency check failed"
                )
            round_polynomials.append(round_poly)

            transcript.append_field_elements(
                f"sumcheck_round_{round_index}".encode(), round_poly
            )
            challenge = transcript.challenge_field_element(
                f"sumcheck_challenge_{round_index}".encode()
            )
            challenges.append(challenge)
            oracle.bind(challenge)
            current_sum = _evaluate_round_polynomial(round_poly, challenge)

        final_evaluation = oracle.final_evaluation(challenges)
        return SumCheckProof(round_polynomials, final_evaluation), challenges

    def verify(self, proof: SumCheckProof, transcript: Transcript):
        """Returns ``(is_valid, challenges)`` (reference sumcheck.rs:113-153)."""
        if len(proof.round_polynomials) != self.num_vars:
            raise SumCheckError("Proof has wrong number of rounds")

        current_sum = self.claimed_sum
        challenges: List[Fr] = []
        for round_index, round_poly in enumerate(proof.round_polynomials):
            g_0 = _evaluate_round_polynomial(round_poly, Fr(0))
            g_1 = _evaluate_round_polynomial(round_poly, Fr(1))
            if g_0 + g_1 != current_sum:
                return False, challenges
            transcript.append_field_elements(
                f"sumcheck_round_{round_index}".encode(), round_poly
            )
            challenge = transcript.challenge_field_element(
                f"sumcheck_challenge_{round_index}".encode()
            )
            challenges.append(challenge)
            current_sum = _evaluate_round_polynomial(round_poly, challenge)

        return current_sum == proof.final_evaluation, challenges
