"""Shout — read-only lookup memory checking protocol.

Port of ``shout.rs`` (reference shout.rs:16-286).  Isomorphic to Twist with
(table, indices) in place of (addresses, values); transcript labels are
``table_commitment`` / ``index_commitment`` (shout.rs:144-145).  Padding:
the table pads to next_pow2 of the table length, the index vector to
next_pow2 of the lookup count with a minimum of 1 (shout.rs:104-118); the
sum-check runs over log2(lookups) variables (shout.rs:138-139).

The reference's lookup-correctness closure always returns zero
(shout.rs:182; SURVEY caveat 1) — the default oracle is ``ZeroOracle``
(bit-identical proofs); ``sound_mode=True`` substitutes an honest
err-vector constraint (tnsh extension; changes the proof).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..commit.kzg import KZGCommitment, KZGCommitmentValue, KZGProof
from ..core.params import ProverParams, VerifierParams
from ..core.transcript import Transcript
from ..errors import InvalidParametersError
from ..field.fr import Fr
from ..iop.sumcheck import (
    ProductMLEOracle,
    SumCheck,
    SumCheckProof,
    ZeroOracle,
)
from ..poly.interp import interpolate_on_range
from ..poly.mle import MultilinearExtension


@dataclass(frozen=True)
class LookupOp:
    """A single lookup: index + value observed (reference shout.rs:16-22)."""

    index: int
    value: Fr


class LookupTable:
    """Read-only table with a lookup log (reference shout.rs:24-60)."""

    def __init__(self, entries: List[Fr]):
        self.entries = [Fr(e) for e in entries]
        self.lookups: List[LookupOp] = []

    def lookup(self, index: int) -> Fr:
        if index >= len(self.entries):
            raise InvalidParametersError("Lookup index out of bounds")
        value = self.entries[index]
        self.lookups.append(LookupOp(index, value))
        return value

    def size(self) -> int:
        return len(self.entries)


@dataclass
class ShoutProof:
    """Shout proof (reference shout.rs:62-79)."""

    table_commitment: KZGCommitmentValue
    index_commitment: KZGCommitmentValue
    lookup_proof: SumCheckProof
    opening_proofs: List[KZGProof]
    final_evaluations: List[Fr]


def _next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class Shout:
    """Shout prover/verifier (reference shout.rs:81-286)."""

    def __init__(self, prover_params: ProverParams):
        self.prover_params = prover_params

    def prove(self, table: LookupTable, sound_mode: bool = False) -> ShoutProof:
        if len(table.lookups) > self.prover_params.max_operations:
            raise InvalidParametersError("Too many lookup operations")

        table_size = _next_power_of_two(len(table.entries))
        padded_table = list(table.entries) + [Fr(0)] * (
            table_size - len(table.entries)
        )

        indices = [Fr(lk.index) for lk in table.lookups]
        lookups_size = max(_next_power_of_two(len(indices)), 1)
        padded_indices = indices + [Fr(0)] * (lookups_size - len(indices))

        # Evaluation-basis commitments (identical group elements, no O(n^2)
        # interpolation; see tnsh.commit.kzg.commit_evals).
        cp = self.prover_params.commitment_params
        table_commitment = KZGCommitment.commit_evals(cp, padded_table)
        index_commitment = KZGCommitment.commit_evals(cp, padded_indices)

        log_lookups = lookups_size.bit_length() - 1
        sumcheck = SumCheck(log_lookups, Fr(0))

        transcript = Transcript(self.prover_params.fiat_shamir_seed)
        transcript.append_field_element(
            b"table_commitment", table_commitment.hash()
        )
        transcript.append_field_element(
            b"index_commitment", index_commitment.hash()
        )

        if sound_mode:
            oracle = self._sound_lookup_oracle(
                log_lookups, padded_table, table.lookups
            )
        else:
            # Reference closure is identically zero (shout.rs:160-184).
            oracle = ZeroOracle(log_lookups)
        lookup_proof = sumcheck.prove(oracle, transcript)

        challenges = transcript.challenge_field_elements(
            b"opening_challenges", log_lookups
        )

        opening_proofs: List[KZGProof] = []
        final_evaluations: List[Fr] = []
        if challenges:
            table_eval, table_opening = KZGCommitment.open_evals(
                cp, padded_table, challenges[0]
            )
            index_eval, index_opening = KZGCommitment.open_evals(
                cp, padded_indices, challenges[0]
            )
            opening_proofs = [table_opening, index_opening]
            final_evaluations = [table_eval, index_eval]

        return ShoutProof(
            table_commitment=table_commitment,
            index_commitment=index_commitment,
            lookup_proof=lookup_proof,
            opening_proofs=opening_proofs,
            final_evaluations=final_evaluations,
        )

    def verify(
        self,
        proof: ShoutProof,
        verifier_params: VerifierParams,
        strict: bool = False,
        fast: bool = False,
    ) -> bool:
        """Verify a proof.  ``strict=False`` reproduces the reference's
        lenient shape handling (openings optional — SURVEY caveat 4);
        ``strict=True`` requires both opening proofs/evaluations whenever
        lookups are non-trivial; ``fast=True`` batches both opening checks
        into one pairing product (see Twist.verify).  tnsh extensions."""
        transcript = Transcript(verifier_params.fiat_shamir_seed)
        transcript.append_field_element(
            b"table_commitment", proof.table_commitment.hash()
        )
        transcript.append_field_element(
            b"index_commitment", proof.index_commitment.hash()
        )

        num_vars = len(proof.lookup_proof.round_polynomials)
        if strict and num_vars > 0 and (
            len(proof.opening_proofs) < 2 or len(proof.final_evaluations) < 2
        ):
            return False
        sumcheck = SumCheck(num_vars, Fr(0))
        sumcheck_valid, _ = sumcheck.verify(proof.lookup_proof, transcript)
        if not sumcheck_valid:
            return False

        opening_challenges = transcript.challenge_field_elements(
            b"opening_challenges", num_vars
        )

        if (
            opening_challenges
            and len(proof.opening_proofs) >= 2
            and len(proof.final_evaluations) >= 2
        ):
            vk = verifier_params.commitment_vk
            if fast:
                from ..commit.kzg import verify_openings_batched

                return verify_openings_batched(
                    vk,
                    [proof.table_commitment, proof.index_commitment],
                    opening_challenges[0],
                    proof.final_evaluations[:2],
                    proof.opening_proofs[:2],
                )
            if not KZGCommitment.verify(
                vk,
                proof.table_commitment,
                opening_challenges[0],
                proof.final_evaluations[0],
                proof.opening_proofs[0],
            ):
                return False
            if not KZGCommitment.verify(
                vk,
                proof.index_commitment,
                opening_challenges[0],
                proof.final_evaluations[1],
                proof.opening_proofs[1],
            ):
                return False
        return True

    def vector_to_polynomial(self, vector: List[Fr]) -> List[Fr]:
        """Interpolation over {0..n-1} (reference shout.rs:277-286)."""
        return interpolate_on_range([Fr(v) for v in vector])

    # -- sound mode (tnsh extension) --------------------------------------
    @staticmethod
    def _sound_lookup_oracle(
        log_lookups: int,
        padded_table: List[Fr],
        lookups: List[LookupOp],
    ) -> ProductMLEOracle:
        """Honest constraint: err(i) = claimed_value(i) - table[index(i)];
        correct lookups give the zero vector, so Σ err = 0."""
        size = 1 << log_lookups
        err: List[Fr] = []
        for i in range(size):
            if i < len(lookups):
                lk = lookups[i]
                err.append(lk.value - padded_table[lk.index])
            else:
                err.append(Fr(0))
        mle = MultilinearExtension.from_evaluations_vec(log_lookups, err)
        # NOTE: the host oracle is O(n) total for this degree-1 single-factor
        # sum-check and avoids per-round-shape XLA recompiles; the device oracle
        # (JaxProductMLEOracle) pays off for multi-factor constraints and is
        # available by explicit injection.
        return ProductMLEOracle([mle])
