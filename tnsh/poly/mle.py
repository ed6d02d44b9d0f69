"""Multilinear extensions over the boolean hypercube.

Port of ``MultilinearExtension`` (reference polynomials.rs:18-196) with the
O(4^n) naivete designed out (SURVEY §7.0):

  * ``evaluate`` uses iterated variable folding — O(2^n) field mults instead
    of the reference's basis-product O(n * 2^n) (polynomials.rs:85-122).
  * ``partial_evaluate`` fixes the FIRST k variables (same convention as
    polynomials.rs:126-161) by folding — O(2^n) instead of O(4^n).

Bit order matches the reference exactly: index bit j (little-endian) is
variable j, so variable 0 is the *fastest-varying* index bit
(polynomials.rs:108-122).  Folding variable 0 therefore combines adjacent
pairs (stride-2 view); this is the convention every device kernel in
``tnsh.poly.mle_jax`` and the sharded sum-check must preserve for transcript
compatibility.

Field arithmetic is exact, so these algorithm changes produce bit-identical
values to the reference on every input.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.fr import MODULUS, Fr

_P = MODULUS


class MultilinearExtension:
    """Dense MLE: evaluations over {0,1}^num_vars, little-endian indexing."""

    __slots__ = ("num_vars", "evaluations")

    def __init__(self, num_vars: int, evaluations: List[Fr]):
        self.num_vars = num_vars
        self.evaluations = evaluations

    # -- constructors (reference polynomials.rs:28-82) ---------------------
    @classmethod
    def from_evaluations(cls, evaluations: Sequence[Fr]) -> "MultilinearExtension":
        n = len(evaluations)
        num_vars = max(n, 1).bit_length() - 1
        if (1 << num_vars) != n:
            raise AssertionError(
                "Evaluation vector length must be a power of 2"
            )
        return cls(num_vars, [Fr(e) for e in evaluations])

    @classmethod
    def from_evaluations_vec(
        cls, num_vars: int, evaluations: Sequence[Fr]
    ) -> "MultilinearExtension":
        expected = 1 << num_vars
        evals = [Fr(e) for e in evaluations[:expected]]
        if len(evals) < expected:
            evals.extend([Fr(0)] * (expected - len(evals)))
        return cls(num_vars, evals)

    @classmethod
    def from_sparse(
        cls, num_vars: int, sparse_entries: Sequence[Tuple[int, Fr]]
    ) -> "MultilinearExtension":
        size = 1 << num_vars
        evals = [Fr(0)] * size
        for index, value in sparse_entries:
            if index >= size:
                raise AssertionError(
                    f"Index {index} out of bounds for size {size}"
                )
            evals[index] = Fr(value)
        return cls(num_vars, evals)

    @classmethod
    def one_hot(cls, num_vars: int, index: int) -> "MultilinearExtension":
        size = 1 << num_vars
        if index >= size:
            raise AssertionError(f"Index {index} out of bounds for size {size}")
        evals = [Fr(0)] * size
        evals[index] = Fr(1)
        return cls(num_vars, evals)

    # -- evaluation --------------------------------------------------------
    def evaluate(self, point: Sequence[Fr]) -> Fr:
        """f(r) by folding one variable at a time — O(2^n) mults."""
        if len(point) != self.num_vars:
            raise AssertionError(
                "Point dimension must match number of variables"
            )
        table = [int(e) for e in self.evaluations]
        for r in point:  # fold variable 0 (fastest bit) first
            ri = int(r)
            table = [
                (table[2 * i] + ri * (table[2 * i + 1] - table[2 * i])) % _P
                for i in range(len(table) // 2)
            ]
        return Fr(table[0])

    def partial_evaluate(self, fixed_values: Sequence[Fr]) -> "MultilinearExtension":
        """Fix the FIRST k variables (reference polynomials.rs:126-161)."""
        k = len(fixed_values)
        if k > self.num_vars:
            raise AssertionError("Cannot fix more variables than available")
        if k == 0:
            return MultilinearExtension(self.num_vars, list(self.evaluations))
        table = [int(e) for e in self.evaluations]
        for r in fixed_values:
            ri = int(r)
            table = [
                (table[2 * i] + ri * (table[2 * i + 1] - table[2 * i])) % _P
                for i in range(len(table) // 2)
            ]
        return MultilinearExtension(self.num_vars - k, [Fr(v) for v in table])

    def fix_last_variable(self, r: Fr) -> "MultilinearExtension":
        """Fix the LAST variable (slowest bit) — shard-local on a mesh.

        Not in the reference API; the sum-check engine folds trailing
        variables so that hypercube-sharded tables (leading bits = shard
        axis) fold without cross-device traffic (SURVEY §5 long-context row).
        """
        half = len(self.evaluations) // 2
        ri = int(r)
        lo = self.evaluations
        table = [
            Fr((int(lo[i]) + ri * (int(lo[half + i]) - int(lo[i]))) % _P)
            for i in range(half)
        ]
        return MultilinearExtension(self.num_vars - 1, table)

    # -- arithmetic (reference polynomials.rs:164-195) ---------------------
    def add(self, other: "MultilinearExtension") -> "MultilinearExtension":
        if self.num_vars != other.num_vars:
            raise AssertionError("Number of variables must match")
        return MultilinearExtension(
            self.num_vars,
            [Fr(int(a) + int(b)) for a, b in zip(self.evaluations, other.evaluations)],
        )

    def scalar_mul(self, scalar: Fr) -> "MultilinearExtension":
        s = int(scalar)
        return MultilinearExtension(
            self.num_vars, [Fr(int(e) * s) for e in self.evaluations]
        )

    def sum_evaluations(self) -> Fr:
        return Fr(sum(int(e) for e in self.evaluations))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, MultilinearExtension):
            return NotImplemented
        return (
            self.num_vars == other.num_vars
            and self.evaluations == other.evaluations
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"MultilinearExtension(num_vars={self.num_vars})"
