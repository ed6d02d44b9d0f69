"""Verifier-enforced Twist/Shout — the paper-grade constraint systems.

The reference's consistency sum-checks prove "zero sums to zero"
(twist.rs:186-214, shout.rs:160-184; SURVEY caveat 1), and its univariate
KZG openings are never tied to the sum-check claim (twist.rs:219-243).
``Twist.prove(sound_mode=True)`` upgraded that to an honest-prover
self-check, but the verifier still could not reject a lying prover.

This module closes the gap: the verifier checks every constraint against
PST multilinear-KZG openings (tnsh.commit.mkzg), so a forged trace/lookup
log is rejected cryptographically.  The encodings follow the Twist/Shout
papers' shape — one-hot read/write address matrices bound by booleanity +
row-sum checks, value evolution via increment bookkeeping, and a less-than
ordering kernel for the prefix sums.

Protocol (format v2, the BATCHED design): every
constraint folds into ONE degree-<=3 sum-check over the (k, j) cube with
total claim ZERO, by two standard moves:

  * column constraints lift to the cube with a 1/K coefficient
    (sum_{k,j} (1/K) * h(j) = sum_j h(j)), so claims like
    "rv(j) = sum_k ra*Val" become cube terms instead of separate openings;
  * point evaluations rewrite as eq-weighted sums
    (Val~(tau) = sum_{k,j} eq(tau,(k,j)) Val(k,j) — a column-incremental
    term with no sparse factor, the oracle's "class I").

Shout (read-only lookups; public table T), batching challenge alpha:
  0 = sum_{k,j}  eq(rho_r,j) ra T~(k) - (1/K) eq(rho_r,j) rv(j)   READ
     + a   [ eq(rho_b,(k,j)) ra (ra-1) ]                           BOOL
     + a^2 [ eq(rho_o,j) ra - (1/K) eq(rho_o,j) ]                  ONE-HOT

Twist (read-write memory), batching challenge alpha:
  0 = sum_{k,j}  eq(rho1,j) ra Val - (1/K) eq(rho1,j) rv(j)        READ
     + a   [ eq(tau,(k,j)) Val - eq(tau_k,k) lt~(j,tau_j) Inc ]    VAL
     + a^2 [ eq(sigma,(k,j)) (Inc - wa wv + wa Val) ]              INC
     + a^3 [ eq(rho4,(k,j)) ra (ra-1) ]                            BOOL ra
     + a^4 [ eq(rho5,(k,j)) wa (wa-1) ]                            BOOL wa
     + a^5 [ eq(rho6,j) ot (ot-1) ]                                BOOL ot
     + a^6 [ eq(rho7,j) ra + (1/K) eq(rho7,j) (ot-1) ]             ROW ra
     + a^7 [ eq(rho8,j) wa - (1/K) eq(rho8,j) ot ]                 ROW wa

The sum-check reduces the whole statement to ONE evaluation point r; the
verifier recomputes the final evaluation from eq/lt closed forms (O(log)
field work) and from the claimed polynomial values at r, then pairing-checks
those values with just TWO batched PST openings: a gamma-RLC of the cube
polynomials (ra, wa, inc, val) at r and a gamma-RLC of the time columns
(ot, rv, wv) at r_j.  The claimed values are bound into the transcript
BEFORE gamma is drawn (adaptive-value forgeries on the RLC are otherwise
possible).  All challenges come from the same Fiat-Shamir transcript stack
as the parity protocols, so proofs are deterministic and replayable.

(Format v1 — eight separate sum-checks and 16 individual openings — was
retired in round 3; 11 of its 14.2 warm seconds at K=2^10 T=2^16 were
opening MSMs the batching above removes.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..commit.kzg import KZGCommitmentValue
from ..commit.mkzg import (
    MLOpeningProof,
    MultilinearKZG,
    has_external_multilinear_srs,
    multilinear_verification_key,
    setup_multilinear_params,
)
from ..commit.mkzg_sparse import (
    IncrementalCubeTable,
    SparseCubeTable,
    commit_incremental,
    commit_sparse,
    cube_params,
    eq_table_ints,
    open_combined,
    open_dense_cube,
    open_sparse,
    sparse_mle_eval,
)
from ..iop.sparse_oracle import SparseCubeOracle
from ..core.params import ProverParams, VerifierParams
from ..core.transcript import Transcript
from ..errors import InvalidParametersError
from ..field.fr import MODULUS, Fr
from ..field.g1 import G1
from ..iop.sumcheck import SumCheck, SumCheckProof, SumOfProductsOracle
from ..poly.eq import eq_eval, eq_table, lt_eval, lt_partial_table
from .shout import LookupTable
from .twist import MemoryTrace

_P = MODULUS

#: Cube sizes with at least this many variables route to the sparse prover
#: (factorized PST commits + SparseCubeOracle): identical proofs, O((K+T)
#: polylog) prover instead of O(K*T) — the dense path would also have to
#: materialize a 2^n-point SRS.
_SPARSE_MIN_VARS = 14


def _incremental_mle_eval(table: IncrementalCubeTable, point: Sequence[Fr],
                          log_k: int) -> Fr:
    """~table(point) for a column-incremental cube table, O(T log K)."""
    from ..commit.mkzg_sparse import incremental_mle_eval

    return incremental_mle_eval(table, point)


@dataclass
class MLOpening:
    """A claimed PST evaluation with its proof; the opening point is
    recomputed by the verifier from the transcript."""

    value: Fr
    proof: MLOpeningProof


def _next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _mle_eval(table: Sequence, point: Sequence[Fr]) -> Fr:
    """~table(point) by O(2^n) folding (little-endian variable order)."""
    import os

    if len(table) >= 1024 and point and not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native

        if _native.available:
            value, _ = _native.fr_ml_open(list(table), point)
            return value
    vals = [int(v) % _P for v in table]
    for r in point:
        ri = int(r)
        vals = [
            (vals[2 * i] + ri * (vals[2 * i + 1] - vals[2 * i])) % _P
            for i in range(len(vals) // 2)
        ]
    return Fr(vals[0])


def _lift_j(col: Sequence[int], k_size: int) -> List[int]:
    """Lift a column over j to the (k,j) cube (k fastest)."""
    out: List[int] = []
    for v in col:
        out.extend([v] * k_size)
    return out


def _lift_k(col: Sequence[int], t_size: int) -> List[int]:
    """Lift a column over k to the (k,j) cube (k fastest)."""
    return list(col) * t_size


def _open_cube_dense(params_n, log_k: int, log_t: int, table, point):
    """Open a dense (k, j) cube table: j-first factorized order under the
    deterministic SRS (~(T+K) point-ops, byte-identical to the sparse
    prover), falling back to suffix-order MultilinearKZG.open under an
    external ceremony SRS (where tau_k is unknown)."""
    if has_external_multilinear_srs(log_k + log_t):
        return MultilinearKZG.open(params_n, table, point)
    return open_dense_cube(cube_params(log_k, log_t), table, point)


def _rlc_tables(tables: Sequence[Sequence[int]], gamma: int):
    """Pointwise sum_i gamma^i * tables[i] mod p (bytes-backed FrTable on
    the native path; a plain int list otherwise)."""
    import os

    if (len(tables[0]) >= 1024
            and not os.environ.get("TNSH_NO_NATIVE")):
        from .. import _native

        if _native.available:
            from ..field.fr import FrTable

            return FrTable(_native.fr_rlc(tables, gamma))
    out = [int(v) % _P for v in tables[0]]
    w = 1
    for tab in tables[1:]:
        w = w * gamma % _P
        for i, v in enumerate(tab):
            out[i] = (out[i] + w * int(v)) % _P
    return out


def _mle_eval_many(tables: Sequence[Sequence], point: Sequence[Fr]
                   ) -> List[Fr]:
    """[~table(point) for each table] — one native batch call when
    available (the bit-column provers evaluate 2logK+4 columns at once)."""
    import os

    if (tables and len(tables[0]) >= 1024 and point
            and not os.environ.get("TNSH_NO_NATIVE")):
        from .. import _native

        if _native.available:
            return _native.fr_mle_eval_many(tables, point)
    return [Fr(_mle_eval(t, point)) for t in tables]


def _kinv(log_k: int) -> int:
    """1/K mod p — the lift coefficient for column constraints."""
    return pow((1 << log_k) % _P, _P - 2, _P)


def prewarm_sound(log_k: int, log_t: int,
                  device_msm: Optional[bool] = None) -> None:
    """Build every lru-cached SRS a sound prove at (K=2^log_k, T=2^log_t)
    will touch — the whole cold-vs-warm prover gap.  Call once at setup
    time; subsequent proves at this shape start warm.  Safe under an
    external ceremony SRS (the factorized cube setup is skipped there,
    matching the prover's routing).

    ``device_msm``: additionally compile and time the device scheduled
    Pippenger for the prove's commit-sized MSM buckets
    (``kzg.prewarm_device_msm``), so the adaptive host+device hybrid
    engages from the FIRST prove instead of staying host-only.  Default:
    auto — on when the device gate is on and T reaches the hybrid
    threshold.  The first call per process pays the kernel compile
    (a persistent compile cache makes later processes start warm)."""
    n = log_k + log_t
    params_t, _ = setup_multilinear_params(log_t)
    multilinear_verification_key(log_t)
    multilinear_verification_key(n)
    cp = None
    if n >= _SPARSE_MIN_VARS and not has_external_multilinear_srs(n):
        cp = cube_params(log_k, log_t)
    elif not has_external_multilinear_srs(n):
        setup_multilinear_params(n)
        if n >= 1:  # dense cube opens still ride the factorized order
            cp = cube_params(log_k, log_t)

    from ..commit import kzg
    from ..core.device import device_msm_enabled
    from ..core.params import NativeSRS

    t_size = 1 << log_t
    if device_msm is None:
        device_msm = device_msm_enabled() and t_size >= kzg._DEVICE_MSM_MIN
    if device_msm:
        seg = params_t.basis[0]
        if isinstance(seg, NativeSRS):
            kzg.prewarm_device_msm(seg.srs_id, t_size)
        if cp is not None and isinstance(cp.j_bases[0], NativeSRS):
            kzg.prewarm_device_msm(cp.j_bases[0].srs_id, t_size)


# ===========================================================================
# Shout
# ===========================================================================

@dataclass
class ShoutSoundProof:
    log_table: int
    log_lookups: int
    ra_commitment: KZGCommitmentValue
    rv_commitment: KZGCommitmentValue
    #: the single batched sum-check (claim 0)
    check: SumCheckProof
    #: ra~(r) with its PST proof (r = the sum-check point)
    ra_at_r: MLOpening
    #: rv~(r_j) with its PST proof
    rv_at_r: MLOpening


class ShoutSound:
    """Verifier-enforced Shout: binding lookup argument against a public
    table (contrast reference shout.rs:160-184, whose closure is zero)."""

    @staticmethod
    def prove(table: LookupTable, prover_params: ProverParams,
              sparse: Optional[bool] = None) -> ShoutSoundProof:
        from .twist_bits import _gc_paused

        return _gc_paused(ShoutSound._prove_impl)(
            table, prover_params, sparse
        )

    @staticmethod
    def _prove_impl(table: LookupTable, prover_params: ProverParams,
                    sparse: Optional[bool] = None) -> ShoutSoundProof:
        entries = [int(e) for e in table.entries]
        if not entries:
            raise InvalidParametersError("Sound Shout needs a non-empty table")
        k_size = _next_power_of_two(len(entries))
        entries = entries + [0] * (k_size - len(entries))
        ops = list(table.lookups)
        t_size = _next_power_of_two(max(len(ops), 1))
        log_k = k_size.bit_length() - 1
        log_t = t_size.bit_length() - 1
        n = log_k + log_t
        if sparse is None:
            sparse = (n >= _SPARSE_MIN_VARS
                      and not has_external_multilinear_srs(n))
        if sparse:
            return ShoutSound._prove_sparse(
                entries, ops, log_k, log_t, prover_params
            )

        ra = [0] * (k_size * t_size)
        rv = [0] * t_size
        for j in range(t_size):
            if j < len(ops):
                idx, val = ops[j].index, int(ops[j].value)
            else:
                idx, val = 0, entries[0]  # padding: look up slot 0
            ra[j * k_size + idx] = 1
            rv[j] = val

        params_n, _ = setup_multilinear_params(n)
        params_t, _ = setup_multilinear_params(log_t)
        c_ra = MultilinearKZG.commit(params_n, ra)
        c_rv = MultilinearKZG.commit(params_t, rv)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _shout_bind_statement(transcript, log_k, log_t, entries, c_ra, c_rv)
        rho_r, rho_b, rho_o, alpha = _shout_challenges(transcript, log_k, log_t)

        a, a2 = int(alpha), int(alpha) ** 2 % _P
        kinv = _kinv(log_k)
        eq_r = _lift_j(eq_table(rho_r), k_size)
        eq_b = eq_table(rho_b)
        eq_o = _lift_j(eq_table(rho_o), k_size)
        tab_k = _lift_k(entries, t_size)
        rv_l = _lift_j(rv, k_size)
        oracle = SumOfProductsOracle(n, [
            (1, [eq_r, ra, tab_k]),
            (_P - kinv, [eq_r, rv_l]),
            (a, [eq_b, ra, ra]),
            (_P - a, [eq_b, ra]),
            (a2, [eq_o, ra]),
            (a2 * (_P - kinv) % _P, [eq_o]),
        ])
        check, r = SumCheck(n, Fr(0)).prove_with_challenges(oracle, transcript)

        v_ra = _mle_eval(ra, r)
        v_rv = _mle_eval(rv, r[log_k:])
        ra_val, ra_proof = _open_cube_dense(params_n, log_k, log_t, ra, r)
        rv_val, rv_proof = MultilinearKZG.open(params_t, rv, r[log_k:])
        assert int(ra_val) == int(v_ra) and int(rv_val) == int(v_rv)

        return ShoutSoundProof(
            log_table=log_k,
            log_lookups=log_t,
            ra_commitment=c_ra,
            rv_commitment=c_rv,
            check=check,
            ra_at_r=MLOpening(v_ra, ra_proof),
            rv_at_r=MLOpening(v_rv, rv_proof),
        )

    @staticmethod
    def _prove_sparse(entries, ops, log_k: int, log_t: int,
                      prover_params: ProverParams) -> ShoutSoundProof:
        """Sparse prover: identical proof bytes to the dense path, but
        O(T + K) memory and O((K + T) polylog) work — commits are T-point
        MSMs over the factorized cube SRS (tnsh.commit.mkzg_sparse) and
        the batched sum-check runs on SparseCubeOracle."""
        if has_external_multilinear_srs(log_k + log_t):
            raise InvalidParametersError(
                "sparse sound proving needs the deterministic factorized "
                "SRS (tau_k); an external ceremony SRS is installed for "
                "this variable count — use the dense prover (sparse=False)"
            )
        t_size = 1 << log_t
        n = log_k + log_t
        ra = SparseCubeTable(log_k, log_t)
        rv = [0] * t_size
        for j in range(t_size):
            if j < len(ops):
                idx, val = ops[j].index, int(ops[j].value)
            else:
                idx, val = 0, entries[0]
            ra.set(j, idx, 1)
            rv[j] = val

        cp = cube_params(log_k, log_t)
        params_t, _ = setup_multilinear_params(log_t)
        c_ra = commit_sparse(cp, ra)
        c_rv = MultilinearKZG.commit(params_t, rv)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _shout_bind_statement(transcript, log_k, log_t, entries, c_ra, c_rv)
        rho_r, rho_b, rho_o, alpha = _shout_challenges(transcript, log_k, log_t)

        a, a2 = int(alpha), int(alpha) ** 2 % _P
        kinv = _kinv(log_k)
        eq_r = eq_table(rho_r)
        ekb = eq_table(rho_b[:log_k])
        ejb = eq_table(rho_b[log_k:])
        eq_o = eq_table(rho_o)
        oracle = SparseCubeOracle(log_k, log_t, [
            (1, [("eqj", eq_r), ("colsparse", ra), ("eqk", entries)]),
            (_P - kinv, [("eqj", eq_r), ("eqj", rv)]),
            (a, [("eqk", ekb), ("eqj", ejb), ("colsparse", ra),
                 ("colsparse", ra)]),
            (_P - a, [("eqk", ekb), ("eqj", ejb), ("colsparse", ra)]),
            (a2, [("eqj", eq_o), ("colsparse", ra)]),
            (a2 * (_P - kinv) % _P, [("eqj", eq_o)]),
        ])
        check, r = SumCheck(n, Fr(0)).prove_with_challenges(oracle, transcript)

        v_ra = sparse_mle_eval(ra, r)
        v_rv = _mle_eval(rv, r[log_k:])
        ra_val, ra_proof = open_sparse(cp, ra, r)
        rv_val, rv_proof = MultilinearKZG.open(params_t, rv, r[log_k:])
        assert int(ra_val) == int(v_ra) and int(rv_val) == int(v_rv)

        return ShoutSoundProof(
            log_table=log_k,
            log_lookups=log_t,
            ra_commitment=c_ra,
            rv_commitment=c_rv,
            check=check,
            ra_at_r=MLOpening(v_ra, ra_proof),
            rv_at_r=MLOpening(v_rv, rv_proof),
        )

    @staticmethod
    def verify(
        proof: ShoutSoundProof,
        table_entries: Sequence[Fr],
        verifier_params: VerifierParams,
    ) -> bool:
        log_k, log_t = proof.log_table, proof.log_lookups
        # bound untrusted u64 size fields before the 1 << log_k allocation
        # and the challenge-draw loops
        if log_k > 48 or log_t > 48:
            return False
        n = log_k + log_t
        entries = [int(e) for e in table_entries]
        k_size = 1 << log_k
        if not entries or _next_power_of_two(len(entries)) != k_size:
            return False
        entries = entries + [0] * (k_size - len(entries))

        transcript = Transcript(verifier_params.fiat_shamir_seed)
        _shout_bind_statement(
            transcript, log_k, log_t, entries,
            proof.ra_commitment, proof.rv_commitment,
        )
        rho_r, rho_b, rho_o, alpha = _shout_challenges(transcript, log_k, log_t)

        ok, r = SumCheck(n, Fr(0)).verify(proof.check, transcript)
        if not ok:
            return False
        r_k, r_j = r[:log_k], r[log_k:]

        # Final-evaluation binding (the check the reference lacks).
        a = int(alpha)
        a2 = a * a % _P
        kinv = _kinv(log_k)
        v_ra = int(proof.ra_at_r.value)
        v_rv = int(proof.rv_at_r.value)
        e_r = int(eq_eval(rho_r, r_j))
        e_o = int(eq_eval(rho_o, r_j))
        want = (
            e_r * v_ra % _P * int(_mle_eval(entries, r_k))
            - kinv * e_r % _P * v_rv
            + a * int(eq_eval(rho_b, r)) % _P * v_ra % _P * ((v_ra - 1) % _P)
            + a2 * e_o % _P * v_ra
            - a2 * kinv % _P * e_o
        ) % _P
        if int(proof.check.final_evaluation) != want:
            return False

        from ..commit.mkzg import batch_verify_openings

        vk_n = multilinear_verification_key(n)
        vk_t = multilinear_verification_key(log_t)
        return batch_verify_openings([
            (vk_n, proof.ra_commitment, r,
             proof.ra_at_r.value, proof.ra_at_r.proof),
            (vk_t, proof.rv_commitment, r_j,
             proof.rv_at_r.value, proof.rv_at_r.proof),
        ])


def _shout_bind_statement(
    transcript: Transcript,
    log_k: int,
    log_t: int,
    entries: Sequence[int],
    c_ra: KZGCommitmentValue,
    c_rv: KZGCommitmentValue,
) -> None:
    transcript.append_field_element(b"ssound_version", Fr(2))
    transcript.append_field_element(b"ssound_log_table", Fr(log_k))
    transcript.append_field_element(b"ssound_log_lookups", Fr(log_t))
    transcript.append_field_elements(
        b"ssound_table", [Fr(e) for e in entries]
    )
    transcript.append_field_element(b"ssound_ra_commitment", c_ra.hash())
    transcript.append_field_element(b"ssound_rv_commitment", c_rv.hash())


def _shout_challenges(transcript: Transcript, log_k: int, log_t: int):
    n = log_k + log_t
    rho_r = transcript.challenge_field_elements(b"ssound_rho_read", log_t)
    rho_b = transcript.challenge_field_elements(b"ssound_rho_bool", n)
    rho_o = transcript.challenge_field_elements(b"ssound_rho_onehot", log_t)
    alpha = transcript.challenge_field_element(b"ssound_alpha")
    return rho_r, rho_b, rho_o, alpha


# ===========================================================================
# Twist
# ===========================================================================

@dataclass
class TwistSoundProof:
    log_memory: int
    log_ops: int
    ra_commitment: KZGCommitmentValue
    wa_commitment: KZGCommitmentValue
    inc_commitment: KZGCommitmentValue
    val_commitment: KZGCommitmentValue
    ot_commitment: KZGCommitmentValue
    rv_commitment: KZGCommitmentValue
    wv_commitment: KZGCommitmentValue
    #: the single batched sum-check (claim 0)
    check: SumCheckProof
    #: [ra~(r), wa~(r), inc~(r), val~(r)] — backed by cube_proof
    cube_values: List[Fr]
    #: [ot~(r_j), rv~(r_j), wv~(r_j)] — backed by col_proof
    col_values: List[Fr]
    #: PST proof for the gamma-RLC of (ra, wa, inc, val) at r
    cube_proof: MLOpeningProof
    #: PST proof for the gamma-RLC of (ot, rv, wv) at r_j
    col_proof: MLOpeningProof


class TwistSound:
    """Verifier-enforced Twist: binding read-write memory checking
    (contrast reference twist.rs:186-214, whose closure is zero)."""

    @staticmethod
    def prove(trace: MemoryTrace, prover_params: ProverParams,
              sparse: Optional[bool] = None) -> TwistSoundProof:
        # Pause the cyclic GC for the prove body (same allocation-burst
        # profile as the bits tier); lazy import avoids
        # the sound <-> twist_bits import cycle.
        from .twist_bits import _gc_paused

        return _gc_paused(TwistSound._prove_impl)(
            trace, prover_params, sparse
        )

    @staticmethod
    def _prove_impl(trace: MemoryTrace, prover_params: ProverParams,
                    sparse: Optional[bool] = None) -> TwistSoundProof:
        k_size = trace.memory_size
        log_k = k_size.bit_length() - 1
        ops = list(trace.operations)
        t_size = _next_power_of_two(max(len(ops), 1))
        log_t = t_size.bit_length() - 1
        n = log_k + log_t
        if sparse is None:
            sparse = (n >= _SPARSE_MIN_VARS
                      and not has_external_multilinear_srs(n))
        if sparse:
            return TwistSound._prove_sparse(
                trace, ops, log_k, log_t, prover_params
            )

        # --- build witness tables by honest simulation -------------------
        ra = [0] * (k_size * t_size)
        wa = [0] * (k_size * t_size)
        inc = [0] * (k_size * t_size)
        val = [0] * (k_size * t_size)
        ot = [0] * t_size
        rv = [0] * t_size
        wv = [0] * t_size
        mem = [0] * k_size
        for j in range(t_size):
            for k in range(k_size):
                val[j * k_size + k] = mem[k]
            if j < len(ops):
                op = ops[j]
                a = op.address
                if op.is_write:
                    v = int(op.value) % _P
                    ot[j] = 1
                    wa[j * k_size + a] = 1
                    wv[j] = v
                    inc[j * k_size + a] = (v - mem[a]) % _P
                    mem[a] = v
                else:
                    ra[j * k_size + a] = 1
                    rv[j] = mem[a]
            else:
                # padding rows read cell 0 (ot = 0, no state change)
                ra[j * k_size] = 1
                rv[j] = mem[0]

        params_n, _ = setup_multilinear_params(n)
        params_t, _ = setup_multilinear_params(log_t)
        c_ra = MultilinearKZG.commit(params_n, ra)
        c_wa = MultilinearKZG.commit(params_n, wa)
        c_inc = MultilinearKZG.commit(params_n, inc)
        c_val = MultilinearKZG.commit(params_n, val)
        c_ot = MultilinearKZG.commit(params_t, ot)
        c_rv = MultilinearKZG.commit(params_t, rv)
        c_wv = MultilinearKZG.commit(params_t, wv)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _twist_bind_statement(
            transcript, log_k, log_t,
            c_ra, c_wa, c_inc, c_val, c_ot, c_rv, c_wv,
        )
        ch = _twist_challenges(transcript, log_k, log_t)
        (rho1, tau, sigma, rho4, rho5, rho6, rho7, rho8, alpha) = ch
        ap = _alpha_powers(alpha)
        kinv = _kinv(log_k)

        eq1 = _lift_j(eq_table(rho1), k_size)
        rv_l = _lift_j(rv, k_size)
        eq_tau = eq_table(tau)
        eq_tk = _lift_k(eq_table(tau[:log_k]), t_size)
        lt_tj = _lift_j(lt_partial_table(log_t, tau[log_k:]), k_size)
        eq_s = eq_table(sigma)
        wv_l = _lift_j(wv, k_size)
        eq4 = eq_table(rho4)
        eq5 = eq_table(rho5)
        eq6 = _lift_j(eq_table(rho6), k_size)
        ot_l = _lift_j(ot, k_size)
        eq7 = _lift_j(eq_table(rho7), k_size)
        eq8 = _lift_j(eq_table(rho8), k_size)
        oracle = SumOfProductsOracle(n, [
            # READ
            (1, [eq1, ra, val]),
            (_P - kinv, [eq1, rv_l]),
            # VAL
            (ap[1], [eq_tau, val]),
            (_P - ap[1], [eq_tk, lt_tj, inc]),
            # INC
            (ap[2], [eq_s, inc]),
            (_P - ap[2], [eq_s, wa, wv_l]),
            (ap[2], [eq_s, wa, val]),
            # BOOL ra / wa / ot
            (ap[3], [eq4, ra, ra]),
            (_P - ap[3], [eq4, ra]),
            (ap[4], [eq5, wa, wa]),
            (_P - ap[4], [eq5, wa]),
            (ap[5], [eq6, ot_l, ot_l]),
            (_P - ap[5], [eq6, ot_l]),
            # ROW-SUM ra / wa
            (ap[6], [eq7, ra]),
            (ap[6] * kinv % _P, [eq7, ot_l]),
            (ap[6] * (_P - kinv) % _P, [eq7]),
            (ap[7], [eq8, wa]),
            (ap[7] * (_P - kinv) % _P, [eq8, ot_l]),
        ])
        check, r = SumCheck(n, Fr(0)).prove_with_challenges(oracle, transcript)
        r_j = r[log_k:]

        cube_values = [_mle_eval(t, r) for t in (ra, wa, inc, val)]
        col_values = [_mle_eval(t, r_j) for t in (ot, rv, wv)]
        gamma = _bind_values_draw_gamma(transcript, cube_values, col_values)
        g = int(gamma)

        cube_rlc = _rlc_tables([ra, wa, inc, val], g)
        cube_val, cube_proof = _open_cube_dense(
            params_n, log_k, log_t, cube_rlc, r
        )
        col_rlc = _rlc_tables([ot, rv, wv], g)
        col_val, col_proof = MultilinearKZG.open(params_t, col_rlc, r_j)
        assert int(cube_val) == _rlc_values(cube_values, g)
        assert int(col_val) == _rlc_values(col_values, g)

        return TwistSoundProof(
            log_memory=log_k,
            log_ops=log_t,
            ra_commitment=c_ra,
            wa_commitment=c_wa,
            inc_commitment=c_inc,
            val_commitment=c_val,
            ot_commitment=c_ot,
            rv_commitment=c_rv,
            wv_commitment=c_wv,
            check=check,
            cube_values=cube_values,
            col_values=col_values,
            cube_proof=cube_proof,
            col_proof=col_proof,
        )

    @staticmethod
    def _prove_sparse(trace: MemoryTrace, ops, log_k: int, log_t: int,
                      prover_params: ProverParams) -> TwistSoundProof:
        """Sparse prover: identical proof bytes to the dense path with
        O(T + K) memory — ra/wa/inc are column-sparse one-hots, Val is
        column-incremental (one write per cycle), commits/opens ride the
        factorized cube SRS, and the batched sum-check runs on
        SparseCubeOracle."""
        if has_external_multilinear_srs(log_k + log_t):
            raise InvalidParametersError(
                "sparse sound proving needs the deterministic factorized "
                "SRS (tau_k); an external ceremony SRS is installed for "
                "this variable count — use the dense prover (sparse=False)"
            )
        k_size, t_size = 1 << log_k, 1 << log_t
        n = log_k + log_t
        ra = SparseCubeTable(log_k, log_t)
        wa = SparseCubeTable(log_k, log_t)
        inc = SparseCubeTable(log_k, log_t)
        val = IncrementalCubeTable(log_k, log_t)
        ot = [0] * t_size
        rv = [0] * t_size
        wv = [0] * t_size
        mem = [0] * k_size
        for j in range(t_size):
            if j < len(ops):
                op = ops[j]
                a = op.address
                if op.is_write:
                    v = int(op.value) % _P
                    ot[j] = 1
                    wa.set(j, a, 1)
                    wv[j] = v
                    delta = (v - mem[a]) % _P
                    inc.set(j, a, delta)
                    val.add_update(j, a, delta)
                    mem[a] = v
                else:
                    ra.set(j, a, 1)
                    rv[j] = mem[a]
            else:
                ra.set(j, 0, 1)
                rv[j] = mem[0]

        cp = cube_params(log_k, log_t)
        params_t, _ = setup_multilinear_params(log_t)
        # one burst: all four cube-commit MSMs dispatch their device parts
        # before any host MSM runs (identical group elements)
        from ..commit.mkzg_sparse import commit_cube_batch

        c_ra, c_wa, c_inc, c_val = commit_cube_batch(
            cp, [ra, wa, inc, val]
        )
        c_ot = MultilinearKZG.commit(params_t, ot)
        c_rv = MultilinearKZG.commit(params_t, rv)
        c_wv = MultilinearKZG.commit(params_t, wv)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _twist_bind_statement(
            transcript, log_k, log_t,
            c_ra, c_wa, c_inc, c_val, c_ot, c_rv, c_wv,
        )
        ch = _twist_challenges(transcript, log_k, log_t)
        (rho1, tau, sigma, rho4, rho5, rho6, rho7, rho8, alpha) = ch
        ap = _alpha_powers(alpha)
        kinv = _kinv(log_k)

        eq1 = eq_table(rho1)
        eq_tauk = eq_table(tau[:log_k])
        eq_tauj = eq_table(tau[log_k:])
        lt_tj = lt_partial_table(log_t, tau[log_k:])
        ek_s = eq_table(sigma[:log_k])
        ej_s = eq_table(sigma[log_k:])
        ek4 = eq_table(rho4[:log_k])
        ej4 = eq_table(rho4[log_k:])
        ek5 = eq_table(rho5[:log_k])
        ej5 = eq_table(rho5[log_k:])
        eq6 = eq_table(rho6)
        eq7 = eq_table(rho7)
        eq8 = eq_table(rho8)
        oracle = SparseCubeOracle(log_k, log_t, [
            # READ
            (1, [("eqj", eq1), ("colsparse", ra), ("colinc", val)]),
            (_P - kinv, [("eqj", eq1), ("eqj", rv)]),
            # VAL (first term: class I — colinc with no colsparse)
            (ap[1], [("eqk", eq_tauk), ("eqj", eq_tauj), ("colinc", val)]),
            (_P - ap[1], [("eqk", eq_tauk), ("eqj", lt_tj),
                          ("colsparse", inc)]),
            # INC
            (ap[2], [("eqk", ek_s), ("eqj", ej_s), ("colsparse", inc)]),
            (_P - ap[2], [("eqk", ek_s), ("eqj", ej_s), ("eqj", wv),
                          ("colsparse", wa)]),
            (ap[2], [("eqk", ek_s), ("eqj", ej_s), ("colsparse", wa),
                     ("colinc", val)]),
            # BOOL ra / wa / ot (ot: class E — j-only factors)
            (ap[3], [("eqk", ek4), ("eqj", ej4), ("colsparse", ra),
                     ("colsparse", ra)]),
            (_P - ap[3], [("eqk", ek4), ("eqj", ej4), ("colsparse", ra)]),
            (ap[4], [("eqk", ek5), ("eqj", ej5), ("colsparse", wa),
                     ("colsparse", wa)]),
            (_P - ap[4], [("eqk", ek5), ("eqj", ej5), ("colsparse", wa)]),
            (ap[5], [("eqj", eq6), ("eqj", ot), ("eqj", ot)]),
            (_P - ap[5], [("eqj", eq6), ("eqj", ot)]),
            # ROW-SUM ra / wa
            (ap[6], [("eqj", eq7), ("colsparse", ra)]),
            (ap[6] * kinv % _P, [("eqj", eq7), ("eqj", ot)]),
            (ap[6] * (_P - kinv) % _P, [("eqj", eq7)]),
            (ap[7], [("eqj", eq8), ("colsparse", wa)]),
            (ap[7] * (_P - kinv) % _P, [("eqj", eq8), ("eqj", ot)]),
        ])
        check, r = SumCheck(n, Fr(0)).prove_with_challenges(oracle, transcript)
        r_j = r[log_k:]

        cube_values = [
            sparse_mle_eval(ra, r),
            sparse_mle_eval(wa, r),
            sparse_mle_eval(inc, r),
            _incremental_mle_eval(val, r, log_k),
        ]
        col_values = [_mle_eval(t, r_j) for t in (ot, rv, wv)]
        gamma = _bind_values_draw_gamma(transcript, cube_values, col_values)
        g = int(gamma)

        cube_val, cube_proof = open_combined(
            cp,
            [(1, ra), (g, wa), (g * g % _P, inc)],
            [(pow(g, 3, _P), val)],
            r,
        )
        col_rlc = _rlc_tables([ot, rv, wv], g)
        col_val, col_proof = MultilinearKZG.open(params_t, col_rlc, r_j)
        assert int(cube_val) == _rlc_values(cube_values, g)
        assert int(col_val) == _rlc_values(col_values, g)

        return TwistSoundProof(
            log_memory=log_k,
            log_ops=log_t,
            ra_commitment=c_ra,
            wa_commitment=c_wa,
            inc_commitment=c_inc,
            val_commitment=c_val,
            ot_commitment=c_ot,
            rv_commitment=c_rv,
            wv_commitment=c_wv,
            check=check,
            cube_values=cube_values,
            col_values=col_values,
            cube_proof=cube_proof,
            col_proof=col_proof,
        )

    @staticmethod
    def verify(proof: TwistSoundProof, verifier_params: VerifierParams) -> bool:
        log_k, log_t = proof.log_memory, proof.log_ops
        if log_k > 48 or log_t > 48:  # untrusted u64 fields
            return False
        n = log_k + log_t
        if len(proof.cube_values) != 4 or len(proof.col_values) != 3:
            return False

        transcript = Transcript(verifier_params.fiat_shamir_seed)
        _twist_bind_statement(
            transcript, log_k, log_t,
            proof.ra_commitment, proof.wa_commitment, proof.inc_commitment,
            proof.val_commitment, proof.ot_commitment, proof.rv_commitment,
            proof.wv_commitment,
        )
        ch = _twist_challenges(transcript, log_k, log_t)
        (rho1, tau, sigma, rho4, rho5, rho6, rho7, rho8, alpha) = ch

        ok, r = SumCheck(n, Fr(0)).verify(proof.check, transcript)
        if not ok:
            return False
        r_k, r_j = r[:log_k], r[log_k:]
        gamma = _bind_values_draw_gamma(
            transcript, proof.cube_values, proof.col_values
        )
        g = int(gamma)

        # Final-evaluation binding: recompute the batched constraint
        # polynomial at r from the claimed values and eq/lt closed forms.
        ap = _alpha_powers(alpha)
        kinv = _kinv(log_k)
        v_ra, v_wa, v_inc, v_val = (int(v) % _P for v in proof.cube_values)
        v_ot, v_rv, v_wv = (int(v) % _P for v in proof.col_values)
        e1 = int(eq_eval(rho1, r_j))
        e_tau = int(eq_eval(tau, r))
        e_tk = int(eq_eval(tau[:log_k], r_k))
        lt_v = int(lt_eval(r_j, tau[log_k:]))
        e_s = int(eq_eval(sigma, r))
        e4 = int(eq_eval(rho4, r))
        e5 = int(eq_eval(rho5, r))
        e6 = int(eq_eval(rho6, r_j))
        e7 = int(eq_eval(rho7, r_j))
        e8 = int(eq_eval(rho8, r_j))
        want = (
            e1 * v_ra % _P * v_val
            - kinv * e1 % _P * v_rv
            + ap[1] * (e_tau * v_val - e_tk * lt_v % _P * v_inc) % _P
            + ap[2] * e_s % _P * (v_inc - v_wa * v_wv + v_wa * v_val) % _P
            + ap[3] * e4 % _P * v_ra % _P * ((v_ra - 1) % _P)
            + ap[4] * e5 % _P * v_wa % _P * ((v_wa - 1) % _P)
            + ap[5] * e6 % _P * v_ot % _P * ((v_ot - 1) % _P)
            + ap[6] * e7 % _P * ((v_ra + kinv * (v_ot - 1)) % _P)
            + ap[7] * e8 % _P * ((v_wa - kinv * v_ot) % _P)
        ) % _P
        if int(proof.check.final_evaluation) != want:
            return False

        # Two batched PST pairing checks back all seven claimed values.
        from ..commit.mkzg import batch_verify_openings

        vk_n = multilinear_verification_key(n)
        vk_t = multilinear_verification_key(log_t)
        cube_comm = _rlc_commitments(
            [proof.ra_commitment, proof.wa_commitment,
             proof.inc_commitment, proof.val_commitment], g
        )
        col_comm = _rlc_commitments(
            [proof.ot_commitment, proof.rv_commitment,
             proof.wv_commitment], g
        )
        return batch_verify_openings([
            (vk_n, cube_comm, r,
             Fr(_rlc_values(proof.cube_values, g)), proof.cube_proof),
            (vk_t, col_comm, r_j,
             Fr(_rlc_values(proof.col_values, g)), proof.col_proof),
        ])


def _twist_bind_statement(
    transcript: Transcript, log_k: int, log_t: int, *commitments
) -> None:
    transcript.append_field_element(b"tsound_version", Fr(2))
    transcript.append_field_element(b"tsound_log_memory", Fr(log_k))
    transcript.append_field_element(b"tsound_log_ops", Fr(log_t))
    labels = (
        b"tsound_ra_commitment", b"tsound_wa_commitment",
        b"tsound_inc_commitment", b"tsound_val_commitment",
        b"tsound_ot_commitment", b"tsound_rv_commitment",
        b"tsound_wv_commitment",
    )
    for label, c in zip(labels, commitments):
        transcript.append_field_element(label, c.hash())


def _twist_challenges(transcript: Transcript, log_k: int, log_t: int):
    n = log_k + log_t
    rho1 = transcript.challenge_field_elements(b"tsound_rho_read", log_t)
    tau = transcript.challenge_field_elements(b"tsound_tau", n)
    sigma = transcript.challenge_field_elements(b"tsound_sigma", n)
    rho4 = transcript.challenge_field_elements(b"tsound_rho_bool_ra", n)
    rho5 = transcript.challenge_field_elements(b"tsound_rho_bool_wa", n)
    rho6 = transcript.challenge_field_elements(b"tsound_rho_bool_ot", log_t)
    rho7 = transcript.challenge_field_elements(b"tsound_rho_rowsum_ra", log_t)
    rho8 = transcript.challenge_field_elements(b"tsound_rho_rowsum_wa", log_t)
    alpha = transcript.challenge_field_element(b"tsound_alpha")
    return rho1, tau, sigma, rho4, rho5, rho6, rho7, rho8, alpha


def _alpha_powers(alpha: Fr) -> List[int]:
    a = int(alpha)
    out = [1]
    for _ in range(7):
        out.append(out[-1] * a % _P)
    return out


def _bind_values_draw_gamma(
    transcript: Transcript, cube_values: Sequence[Fr], col_values: Sequence[Fr]
) -> Fr:
    """Bind the claimed polynomial values BEFORE drawing the RLC challenge
    — otherwise a prover could pick values adaptively after seeing gamma
    and satisfy the batched pairing check with a forged combination."""
    transcript.append_field_elements(b"tsound_cube_values", list(cube_values))
    transcript.append_field_elements(b"tsound_col_values", list(col_values))
    return transcript.challenge_field_element(b"tsound_gamma")


def _rlc_values(values: Sequence[Fr], gamma: int) -> int:
    acc = 0
    w = 1
    for v in values:
        acc = (acc + w * int(v)) % _P
        w = w * gamma % _P
    return acc


def _rlc_commitments(
    comms: Sequence[KZGCommitmentValue], gamma: int
) -> KZGCommitmentValue:
    import os

    def smul(p: G1, s: int) -> G1:
        if s == 1:
            return p
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                return _native.g1_scalar_mul(p, Fr(s))
        return p.scalar_mul(s)

    acc = comms[0].commitment
    w = 1
    for c in comms[1:]:
        w = w * gamma % _P
        acc = acc.add(smul(c.commitment, w))
    return KZGCommitmentValue(acc)
