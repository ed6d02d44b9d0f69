"""Twist — read-write memory checking protocol.

Port of ``twist.rs`` (reference twist.rs:16-316).  Pipeline order, transcript
labels, padding rules and the proof shape are byte-compatible:

  prove (reference twist.rs:107-251):
    1. op-count guard against ``max_operations`` (twist.rs:108-112)
    2. extract address / value / op-type columns (twist.rs:114-138)
    3. pad all three to next_pow2 (0-ops pads to size 1) (twist.rs:140-148)
    4. interpolate address+value vectors over {0..n-1} (twist.rs:151-152)
    5. KZG-commit both polynomials (twist.rs:155-163)
    6. transcript <- "address_commitment" / "value_commitment" hashes
       (twist.rs:173-174)
    7. sum-check over log2(padded) vars, claimed sum 0 (twist.rs:167-216).
       The reference's consistency closure ALWAYS returns zero
       (twist.rs:212; SURVEY caveat 1), so the default oracle here is
       ``ZeroOracle`` — bit-identical round polynomials, none of the wasted
       MLE evaluation.  ``sound_mode=True`` runs an honest-prover
       consistency self-check instead (value + lt-ordering error vectors; a
       tnsh extension that changes the proof).  NOTE: like the reference,
       neither mode cryptographically binds the sum-check polynomial to the
       committed trace — full Twist soundness (one-hot address encodings
       bound to the commitments) is future work.
    8. draw ``opening_challenges`` and KZG-open both polys at challenge[0]
       (twist.rs:219-243)

  verify (reference twist.rs:255-304): replay transcript, verify sum-check
  with num_vars TAKEN FROM THE PROOF (twist.rs:263 — proof-controlled,
  SURVEY caveat 4), re-derive challenges, check openings only when present.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple

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


class MemoryOpKind(Enum):
    READ = 0
    WRITE = 1


@dataclass(frozen=True)
class MemoryOp:
    """A single read or write (reference twist.rs:16-20)."""

    kind: MemoryOpKind
    address: int
    value: Fr

    @staticmethod
    def read(address: int, value: Fr) -> "MemoryOp":
        return MemoryOp(MemoryOpKind.READ, address, value)

    @staticmethod
    def write(address: int, value: Fr) -> "MemoryOp":
        return MemoryOp(MemoryOpKind.WRITE, address, value)

    @property
    def is_write(self) -> bool:
        return self.kind is MemoryOpKind.WRITE

    @property
    def is_read(self) -> bool:
        return self.kind is MemoryOpKind.READ


class MemoryTrace:
    """Power-of-two-sized memory with an operation log
    (reference twist.rs:23-72)."""

    def __init__(self, memory_size: int):
        if memory_size <= 0 or memory_size & (memory_size - 1):
            raise AssertionError("Memory size must be power of 2")
        self.memory_size = memory_size
        self.operations: List[MemoryOp] = []
        self._memory: List[Fr] = [Fr(0)] * memory_size

    def write(self, address: int, value: Fr) -> None:
        if address >= self.memory_size:
            raise InvalidParametersError("Address out of bounds")
        value = Fr(value)
        self._memory[address] = value
        self.operations.append(MemoryOp.write(address, value))

    def read(self, address: int) -> Fr:
        if address >= self.memory_size:
            raise InvalidParametersError("Address out of bounds")
        value = self._memory[address]
        self.operations.append(MemoryOp.read(address, value))
        return value


@dataclass
class TwistProof:
    """Twist proof (reference twist.rs:74-89)."""

    address_commitment: KZGCommitmentValue
    value_commitment: KZGCommitmentValue
    consistency_proof: SumCheckProof
    opening_proofs: List[KZGProof]
    final_evaluations: List[Fr]


def _next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class Twist:
    """Twist prover/verifier (reference twist.rs:91-316)."""

    def __init__(self, prover_params: ProverParams):
        self.prover_params = prover_params

    def prove(self, trace: MemoryTrace, sound_mode: bool = False) -> TwistProof:
        if len(trace.operations) > self.prover_params.max_operations:
            raise InvalidParametersError("Too many operations")

        addresses = [Fr(op.address) for op in trace.operations]
        values = [Fr(op.value) for op in trace.operations]
        op_types = [Fr(1) if op.is_write else Fr(0) for op in trace.operations]

        padded_size = max(_next_power_of_two(len(addresses)), 1)
        addresses = addresses + [Fr(0)] * (padded_size - len(addresses))
        values = values + [Fr(0)] * (padded_size - len(values))
        op_types = op_types + [Fr(0)] * (padded_size - len(op_types))

        # Evaluation-basis commitments: same group elements as committing to
        # interpolate_on_range(...) but without the O(n^2) interpolation
        # (reference twist.rs:151-163 pays it; SURVEY §7.3 item 6).
        cp = self.prover_params.commitment_params
        address_commitment = KZGCommitment.commit_evals(cp, addresses)
        value_commitment = KZGCommitment.commit_evals(cp, values)

        log_ops = padded_size.bit_length() - 1
        sumcheck = SumCheck(log_ops, Fr(0))

        transcript = Transcript(self.prover_params.fiat_shamir_seed)
        transcript.append_field_element(
            b"address_commitment", address_commitment.hash()
        )
        transcript.append_field_element(
            b"value_commitment", value_commitment.hash()
        )

        if sound_mode:
            oracle = self._sound_consistency_oracle(
                log_ops, addresses, values, op_types,
                num_real_ops=len(trace.operations),
            )
        else:
            # The reference's consistency closure is identically zero
            # (twist.rs:186-214); ZeroOracle reproduces it bit-exactly.
            oracle = ZeroOracle(log_ops)
        consistency_proof = sumcheck.prove(oracle, transcript)

        challenges = transcript.challenge_field_elements(
            b"opening_challenges", log_ops
        )

        opening_proofs: List[KZGProof] = []
        final_evaluations: List[Fr] = []
        if challenges:
            address_eval, address_opening = KZGCommitment.open_evals(
                cp, addresses, challenges[0]
            )
            value_eval, value_opening = KZGCommitment.open_evals(
                cp, values, challenges[0]
            )
            opening_proofs = [address_opening, value_opening]
            final_evaluations = [address_eval, value_eval]

        return TwistProof(
            address_commitment=address_commitment,
            value_commitment=value_commitment,
            consistency_proof=consistency_proof,
            opening_proofs=opening_proofs,
            final_evaluations=final_evaluations,
        )

    def verify(
        self,
        proof: TwistProof,
        verifier_params: VerifierParams,
        strict: bool = False,
        fast: bool = False,
    ) -> bool:
        """Verify a proof.  ``strict=False`` reproduces the reference's
        lenient shape handling (openings optional, round count taken from
        the proof — SURVEY caveat 4); ``strict=True`` additionally requires
        both opening proofs/evaluations whenever the trace is non-trivial.
        ``fast=True`` checks both openings with one batched pairing-product
        (2 Miller loops + 1 final exp instead of 4 + 2; RLC weights from a
        transcript over the statement).  Both are tnsh extensions; accepted
        proofs are the same set up to the RLC soundness error ~1/r."""
        transcript = Transcript(verifier_params.fiat_shamir_seed)
        transcript.append_field_element(
            b"address_commitment", proof.address_commitment.hash()
        )
        transcript.append_field_element(
            b"value_commitment", proof.value_commitment.hash()
        )

        num_vars = len(proof.consistency_proof.round_polynomials)
        if strict and num_vars > 0 and (
            len(proof.opening_proofs) < 2 or len(proof.final_evaluations) < 2
        ):
            return False
        sumcheck = SumCheck(num_vars, Fr(0))
        sumcheck_valid, _ = sumcheck.verify(proof.consistency_proof, transcript)
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
                    [proof.address_commitment, proof.value_commitment],
                    opening_challenges[0],
                    proof.final_evaluations[:2],
                    proof.opening_proofs[:2],
                )
            if not KZGCommitment.verify(
                vk,
                proof.address_commitment,
                opening_challenges[0],
                proof.final_evaluations[0],
                proof.opening_proofs[0],
            ):
                return False
            if not KZGCommitment.verify(
                vk,
                proof.value_commitment,
                opening_challenges[0],
                proof.final_evaluations[1],
                proof.opening_proofs[1],
            ):
                return False
        return True

    def vector_to_polynomial(self, vector: List[Fr]) -> List[Fr]:
        """Interpolation over {0..n-1} (reference twist.rs:307-316)."""
        return interpolate_on_range([Fr(v) for v in vector])

    # -- sound mode (tnsh extension) --------------------------------------
    @staticmethod
    def _sound_consistency_oracle(
        log_ops: int,
        addresses: List[Fr],
        values: List[Fr],
        op_types: List[Fr],
        num_real_ops: int = None,
    ):
        """A real (non-stub) consistency constraint with zero hypercube sum.

        Two per-op error terms, both identically zero on honest traces:

          * value consistency — for each read i of address a with last write
            j: err_val(i) = value(i) - value(j) (reads of unwritten cells
            expect 0), matching the reference's documented read-semantics
            (twist.rs:61-71);
          * write ordering — err_ord(i) = read_flag(i) * (1 - lt(j, i)) where
            lt is ``LessThanPolynomial`` over *big-endian* bit strings, whose
            lexicographic comparison then coincides with numeric j < i.  This
            wires the ordering polynomial into proving, which the reference
            advertises (README.md:80) but never does (SURVEY caveat 2).

        The oracle is the MLE of err_val + err_ord; sum-check proves
        Σ err = 0 with an honest polynomial rather than the reference's
        hardwired zero closure (twist.rs:186-214).  Large instances run the
        rounds on the device oracle.
        """
        from ..poly.lt import LessThanPolynomial

        size = 1 << log_ops
        lt = LessThanPolynomial(max(log_ops, 1))

        def bits_be(x: int) -> List[bool]:
            le = [bool((x >> b) & 1) for b in range(max(log_ops, 1))]
            return le[::-1]

        if num_real_ops is None:
            num_real_ops = size
        mem: dict = {}  # addr -> (last value, last write index)
        err: List[Fr] = []
        for i in range(size):
            if i >= num_real_ops:
                # Padding rows (twist.rs:140-148 zero-fill) are not memory
                # operations; they must not be scored as reads of address 0.
                err.append(Fr(0))
                continue
            addr = int(addresses[i])
            if int(op_types[i]) == 1:
                mem[addr] = (values[i], i)
                err.append(Fr(0))
            else:
                expected, j = mem.get(addr, (Fr(0), None))
                e = values[i] - expected
                if j is not None:
                    ordering = lt.evaluate_at_bits(bits_be(j), bits_be(i))
                    e = e + (Fr(1) - ordering)
                err.append(e)
        mle = MultilinearExtension.from_evaluations_vec(log_ops, err)
        # NOTE: the host oracle is O(n) total for this degree-1 single-factor
        # sum-check and avoids per-round-shape XLA recompiles; the device oracle
        # (JaxProductMLEOracle) pays off for multi-factor constraints and is
        # available by explicit injection.
        return ProductMLEOracle([mle])
