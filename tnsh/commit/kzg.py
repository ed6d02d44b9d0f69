"""KZG polynomial and vector commitments over BN254.

Port of ``commitments.rs`` (reference commitments.rs:15-483):

  * ``CommitmentScheme`` — abstract interface (commitments.rs:15-59).
  * ``KZGCommitment`` — commit/open/verify/batch_verify (commitments.rs:156-301).
    ``commit`` uses a Pippenger bucket MSM instead of the reference's per-term
    scalar-mul loop (commitments.rs:173-177) — the resulting group element is
    identical.  ``open`` computes the quotient (P(x) - v)/(x - z) by synthetic
    (Horner) division, equivalent to the reference's long division
    (commitments.rs:317-375) including the empty-quotient convention for
    constant polynomials.
  * ``KZGCommitmentValue.hash()`` — affine x-coordinate bytes reduced into Fr
    (commitments.rs:72-85); identity hashes to Fr(0) because ark's affine
    infinity carries x = 0.
  * ``batch_verify`` — random linear combination with a FIXED-seed ChaCha20
    (NOT the transcript), reproducing the reference's quirk
    (commitments.rs:249-255).
  * ``KZGVectorCommitment`` — vector commitment via interpolation over
    {0..n-1} (commitments.rs:407-483).

The device MSMs for proving-scale commitments live in
``tnsh.commit.msm_sched`` and ``tnsh.commit.msm_jax``; this module is the
exact host path and the golden reference for them.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

from ..core.device import device_msm_enabled
from ..core.params import CommitmentParams, CommitmentVerificationKey
from ..core.rng import ChaCha20Rng, fr_rand
from ..core.serialize import g1_from_bytes, g1_to_bytes
from ..errors import CommitmentError, PolynomialError
from ..field.fr import Fr
from ..field.g1 import G1
from ..field.pairing import pairing
from ..poly.interp import interpolate_on_range


# ---------------------------------------------------------------------------
# Host-side Pippenger MSM (golden path) and the host+device hybrid
# ---------------------------------------------------------------------------

#: Minimum MSM size for the hybrid host+device scheduled-Pippenger path:
#: below it the host native Pippenger is used alone.
_DEVICE_MSM_MIN = int(os.environ.get("TNSH_DEVICE_MSM_MIN", str(1 << 18)))
#: Explicit device share (0..1); unset = ADAPTIVE: host-only until the
#: (srs, size-bucket) kernel is compiled, then split by measured engine
#: throughput.
_DEVICE_MSM_FRACTION = os.environ.get("TNSH_DEVICE_MSM_FRACTION")
_device_msm_contexts: dict = {}
#: (srs_id, bucket) -> {"host": rate_ema | None, "device": rate_ema | None,
#:                      "device_points": int}
_device_msm_stats: dict = {}


def _device_srs_context(srs_id: int):
    ctx = _device_msm_contexts.get(srs_id)
    if ctx is None:
        from .msm_sched import ScheduledMsmContext

        ctx = ScheduledMsmContext.from_native_srs(srs_id)
        _device_msm_contexts[srs_id] = ctx
    return ctx


def _msm_bucket(srs_id: int, n_sc: int):
    return (srs_id, n_sc.bit_length())


def _bucket_stats(srs_id: int, n_sc: int) -> dict:
    return _device_msm_stats.setdefault(
        _msm_bucket(srs_id, n_sc),
        {"host": None, "device": None, "device_points": 0},
    )


def prewarm_device_msm(srs_id: int, n_sc: int) -> float:
    """Compile and time the device scheduled Pippenger for this (srs, size
    bucket), so that later ``msm`` calls split adaptively from the first
    one.  Returns the measured device rate (points/s).  Blocking — call at
    setup time."""
    import time

    import numpy as np

    ctx = _device_srs_context(srs_id)
    # full-width scalars (< 2^253): the largest schedule capacity a prove's
    # MSMs of this size need, which smaller scalars then reuse
    raw = np.random.default_rng(n_sc).integers(0, 256, (n_sc, 32),
                                               dtype=np.uint8)
    raw[:, 31] &= 0x1F
    blob = raw.tobytes()
    ctx.msm(blob)  # compile + first run
    t0 = time.perf_counter()
    ctx.msm(blob)
    rate = n_sc / max(time.perf_counter() - t0, 1e-9)
    _bucket_stats(srs_id, n_sc)["device"] = rate
    return rate


def _hybrid_srs_msm(srs_id: int, scalars, n_sc: int) -> G1:
    """Adaptive host+device split for one large SRS MSM — see
    :func:`hybrid_srs_msm_many`."""
    return hybrid_srs_msm_many(srs_id, [scalars], n_sc)[0]


def hybrid_srs_msm_many(srs_id: int, scalars_list, n_sc: int) -> list:
    """Adaptive host+device split for a BATCH of same-size large SRS MSMs.

    The device takes the first ``split`` points of each MSM, the native
    host Pippenger the rest, concurrently.  The device part is padded with
    zero scalars to the full ``n_sc`` points, so it runs the kernel shape
    that :func:`prewarm_device_msm` compiled.  The device participates
    only when that kernel shape is already compiled (``msm_async(...,
    only_if_compiled=True)``); a cold shape runs host-only rather than
    stall a prove on a compile.  Once warm, the split fraction tracks the
    measured engine throughput EMAs, so the hybrid approaches
    n/(r_host + r_device).  Every device part is dispatched before any
    host work and finished after it.  Results are the identical group
    elements any path produces."""
    import time

    from .. import _native

    st = _bucket_stats(srs_id, n_sc)

    if _DEVICE_MSM_FRACTION is not None:
        frac = min(max(float(_DEVICE_MSM_FRACTION), 0.0), 1.0)
    elif st["device"] is not None and st["host"]:
        frac = st["device"] / (st["device"] + st["host"])
    else:
        frac = 0.4  # first warm call: a starting point the EMAs correct
    split = int(n_sc * frac)

    parts = []
    for scalars in scalars_list:
        if not isinstance(scalars, (bytes, bytearray)):
            scalars = _native._fr_vec_bytes(list(scalars)[:n_sc])
        parts.append((bytes(scalars[: 32 * split]) + bytes(32 * (n_sc - split)),
                      bytes(32 * split) + bytes(scalars[32 * split:]),
                      scalars))

    fins = []
    if split >= 1:
        ctx = _device_srs_context(srs_id)
        for dev_part, _, _ in parts:
            fin = ctx.msm_async(
                dev_part, only_if_compiled=_DEVICE_MSM_FRACTION is None
            )
            if fin is None:
                fins = None
                break
            fins.append(fin)
    else:
        fins = None
    if fins is None:
        t0 = time.perf_counter()
        out = [_native.srs_msm(srs_id, scalars)
               for _, _, scalars in parts]
        hr = (len(parts) * n_sc
              / max(time.perf_counter() - t0, 1e-9))
        st["host"] = hr if st["host"] is None else 0.7 * st["host"] + 0.3 * hr
        return out
    t0 = time.perf_counter()
    host_res = [_native.srs_msm(srs_id, host_part)
                for _, host_part, _ in parts]
    t_host = max(time.perf_counter() - t0, 1e-9)
    out = [h.add(f()) for h, f in zip(host_res, fins)]
    st["device_points"] += len(parts) * split
    if _DEVICE_MSM_FRACTION is None:
        # update throughput EMAs (device elapsed is bounded below by the
        # overlapped host part, so the estimate is conservative)
        t_all = max(time.perf_counter() - t0, 1e-9)
        hr = len(parts) * (n_sc - split) / t_host
        dr = len(parts) * split / t_all
        st["host"] = hr if st["host"] is None else 0.7 * st["host"] + 0.3 * hr
        st["device"] = (dr if st["device"] is None
                        else 0.7 * st["device"] + 0.3 * dr)
    return out


def msm(points: Sequence[G1], scalars: Sequence[Fr]) -> G1:
    """Σ s_i · P_i via windowed bucket accumulation.

    Large MSMs against native-resident SRS views run as a hybrid: a
    measured fraction of the points dispatches to the device scheduled
    Pippenger (tnsh.commit.msm_sched) while the host native Pippenger
    covers the rest concurrently; smaller MSMs go straight to the C++
    native path.  All paths produce the identical group element.
    """
    from ..core.params import NativeSRS

    if isinstance(points, NativeSRS):
        from .. import _native

        n_sc = (
            len(scalars) // 32
            if isinstance(scalars, (bytes, bytearray))
            else len(scalars)
        )
        if n_sc >= _DEVICE_MSM_MIN and device_msm_enabled():
            return _hybrid_srs_msm(points.srs_id, scalars, n_sc)
        return _native.srs_msm(points.srs_id, scalars)
    if isinstance(scalars, (bytes, bytearray)):
        from ..field.fr import Fr as _Fr

        scalars = [
            _Fr(int.from_bytes(scalars[32 * i:32 * i + 32], "little"))
            for i in range(len(scalars) // 32)
        ]
    n = min(len(points), len(scalars))
    if n >= 4 and not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native

        if _native.available:
            return _native.msm(points[:n], scalars[:n])
    pairs = [(points[i], int(scalars[i])) for i in range(n) if int(scalars[i])]
    if not pairs:
        return G1.zero()
    if len(pairs) <= 4:
        acc = G1.zero()
        for p, s in pairs:
            acc = acc.add(p.scalar_mul(s))
        return acc
    c = max(2, len(pairs).bit_length() - 1)
    c = min(c, 13)
    num_windows = (254 + c - 1) // c
    mask = (1 << c) - 1
    result = G1.zero()
    for w in range(num_windows - 1, -1, -1):
        if not result.is_zero():
            for _ in range(c):
                result = result.double()
        buckets: List[G1] = [G1.zero()] * (mask + 1)
        shift = w * c
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = buckets[d].add(p)
        acc = G1.zero()
        running = G1.zero()
        for d in range(mask, 0, -1):
            running = running.add(buckets[d])
            acc = acc.add(running)
        result = result.add(acc)
    return result


# ---------------------------------------------------------------------------
# Lagrange SRS over the domain {0..n-1}  (evaluation-basis KZG)
# ---------------------------------------------------------------------------
#
# The reference's dominant prover cost is the O(n^2)-O(n^3) Lagrange
# interpolation feeding every commitment (SURVEY caveat 5, §7.3 item 6).
# Committing in the *evaluation basis* removes it entirely:
#
#     C = [P(tau)]_1 = Σ v_i [L_i(tau)]_1
#
# so with the per-size Lagrange SRS {[L_i(tau)]_1} precomputed once, commit
# is a single MSM over the raw vector, and the opening quotient at z is
# evaluation-local: Q(i) = (v_i - P(z)) / (i - z), P(z) by barycentric
# evaluation — O(n) field work.  The group elements are IDENTICAL to the
# coefficient-basis path (same polynomial), so transcripts don't change.
# The SRS derives from the retained tau (utils.rs:62 keeps it in params by
# design parity); L_i(tau) = Π_{j≠i}(tau-j) / ((-1)^(n-1-i) i! (n-1-i)!).

@lru_cache(maxsize=64)
def _range_factorial_denoms(n: int) -> tuple:
    """denom_i = (-1)^(n-1-i) * i! * (n-1-i)!  for the domain {0..n-1}."""
    from ..field.fr import MODULUS

    fact = [1] * n
    for k in range(1, n):
        fact[k] = fact[k - 1] * k % MODULUS
    out = []
    for i in range(n):
        d = fact[i] * fact[n - 1 - i] % MODULUS
        if (n - 1 - i) % 2 == 1:
            d = MODULUS - d
        out.append(Fr(d))
    return tuple(out)


def lagrange_srs(params: CommitmentParams, n: int) -> List[G1]:
    """[L_i(tau)]_1 for the domain {0..n-1}; cached on the params object."""
    cache = getattr(params, "_lagrange_srs_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(params, "_lagrange_srs_cache", cache)
    if n in cache:
        return cache[n]
    if params.tau is None:
        raise CommitmentError("Lagrange SRS requires tau in params")
    g = G1.generator()
    if not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native
        from ..core.params import LARGE_SRS_THRESHOLD, NativeSRS

        if _native.available:
            # L_i(tau) scalars computed natively (bytes stay native-side
            # through the fixed-base build — no per-element Fr objects).
            scalar_bytes = _native.fr_lagrange_tau(params.tau, n)
            if n >= LARGE_SRS_THRESHOLD:
                points = NativeSRS(
                    _native.srs_create_fixed_base(g, scalar_bytes)
                )
            else:
                points = _native.fixed_base_batch(
                    g,
                    [
                        Fr(int.from_bytes(scalar_bytes[32 * i:32 * i + 32],
                                          "little"))
                        for i in range(n)
                    ],
                )
            cache[n] = points
            return points

    from ..field.fr import MODULUS, batch_inverse

    tau = int(params.tau)
    t = [Fr((tau - i) % MODULUS) for i in range(n)]
    prefix = [Fr(1)] * (n + 1)
    for i in range(n):
        prefix[i + 1] = prefix[i] * t[i]
    denoms = _range_factorial_denoms(n)
    inv_dt = batch_inverse([denoms[i] * t[i] for i in range(n)])
    full = prefix[n]  # Π (tau - j)
    scalars = [full * inv_dt[i] for i in range(n)]
    points = [g.scalar_mul(s) for s in scalars]
    cache[n] = points
    return points


@lru_cache(maxsize=64)
def _barycentric_weights(n: int) -> tuple:
    """w_i = 1 / denom_i for the domain {0..n-1}."""
    from ..field.fr import batch_inverse

    return tuple(batch_inverse(list(_range_factorial_denoms(n))))


def barycentric_eval(values: Sequence[Fr], z: Fr) -> Fr:
    """P(z) for the interpolant of ``values`` on {0..n-1}; z not in domain."""
    from ..field.fr import MODULUS, batch_inverse

    n = len(values)
    if n == 0:
        return Fr(0)
    zi = int(z)
    diffs = [Fr((zi - i) % MODULUS) for i in range(n)]
    inv_diffs = batch_inverse(diffs)
    weights = _barycentric_weights(n)
    acc = 0
    for i in range(n):
        acc += int(values[i]) * int(weights[i]) * int(inv_diffs[i])
    full = 1
    for d in diffs:
        full = full * int(d) % MODULUS
    return Fr(acc % MODULUS * full)


# ---------------------------------------------------------------------------
# Commitment values and proofs
# ---------------------------------------------------------------------------

@dataclass
class KZGCommitmentValue:
    """A KZG commitment — a point in G1 (reference commitments.rs:66-85)."""

    commitment: G1

    def hash(self) -> Fr:
        """Affine x-coordinate LE bytes → Fr mod order
        (reference commitments.rs:73-84)."""
        x, _ = self.commitment.to_affine()
        return Fr.from_le_bytes_mod_order(x.to_bytes(32, "little"))

    def serialize_compressed(self) -> bytes:
        return g1_to_bytes(self.commitment, compress=True)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "KZGCommitmentValue":
        return cls(g1_from_bytes(data, compressed=True))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, KZGCommitmentValue):
            return NotImplemented
        return self.commitment == other.commitment


@dataclass
class KZGProof:
    """A KZG opening proof — a point in G1 (reference commitments.rs:88-91)."""

    proof: G1

    def serialize_compressed(self) -> bytes:
        return g1_to_bytes(self.proof, compress=True)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "KZGProof":
        return cls(g1_from_bytes(data, compressed=True))


# ---------------------------------------------------------------------------
# Scheme interface (reference commitments.rs:15-59)
# ---------------------------------------------------------------------------

class CommitmentScheme(ABC):
    """Abstract polynomial commitment scheme."""

    @staticmethod
    @abstractmethod
    def commit(params, polynomial: Sequence[Fr]):
        ...

    @staticmethod
    @abstractmethod
    def open(params, polynomial: Sequence[Fr], point: Fr):
        ...

    @staticmethod
    @abstractmethod
    def verify(vk, commitment, point: Fr, value: Fr, proof) -> bool:
        ...

    @classmethod
    def batch_verify(cls, vk, commitments, points, values, proofs) -> bool:
        """Default: verify each proof individually (commitments.rs:44-58)."""
        for c, z, v, pi in zip(commitments, points, values, proofs):
            if not cls.verify(vk, c, z, v, pi):
                return False
        return True


# ---------------------------------------------------------------------------
# Polynomial helpers
# ---------------------------------------------------------------------------

def evaluate_polynomial(coeffs: Sequence[Fr], point: Fr) -> Fr:
    """Horner evaluation; empty -> 0 (reference commitments.rs:304-313)."""
    acc = Fr(0)
    for c in reversed(coeffs):
        acc = acc * point + c
    return acc


def compute_quotient_polynomial(
    poly: Sequence[Fr], point: Fr, value: Fr
) -> List[Fr]:
    """(P(x) - v) / (x - z) by synthetic division
    (same output as reference commitments.rs:315-375)."""
    if len(poly) == 0:
        return []
    if len(poly) == 1:
        return []  # constant: quotient is the empty polynomial
    # Synthetic division of (P - v) by (x - z), highest coefficient first.
    n = len(poly)
    q: List[Fr] = [Fr(0)] * (n - 1)
    carry = Fr(poly[n - 1])
    for i in range(n - 2, -1, -1):
        q[i] = carry
        carry = Fr(poly[i]) + carry * point
        if i == 0:
            # remainder = P(z) - v must be 0; tolerated silently like the
            # reference (it assumes exact division, commitments.rs:337).
            pass
    return q


def polynomial_division(
    dividend: Sequence[Fr], divisor: Sequence[Fr]
) -> List[Fr]:
    """General long division returning the quotient
    (reference commitments.rs:336-375)."""
    if len(divisor) == 0 or all(int(x) == 0 for x in divisor):
        raise PolynomialError("Cannot divide by zero polynomial")
    divisor_degree = len(divisor) - 1
    leading = Fr(divisor[divisor_degree])
    if leading.is_zero():
        raise PolynomialError("Divisor must have non-zero leading coefficient")
    leading_inv = leading.inverse()
    remainder = [Fr(x) for x in dividend]
    if len(remainder) < len(divisor):
        return []
    quotient_degree = len(remainder) - len(divisor)
    quotient = [Fr(0)] * (quotient_degree + 1)
    for i in range(quotient_degree, -1, -1):
        if len(remainder) > i + divisor_degree:
            coeff = remainder[i + divisor_degree] * leading_inv
            quotient[i] = coeff
            for j in range(len(divisor)):
                if i + j < len(remainder):
                    remainder[i + j] = remainder[i + j] - coeff * divisor[j]
    return quotient


# ---------------------------------------------------------------------------
# KZG scheme (reference commitments.rs:156-301)
# ---------------------------------------------------------------------------

class KZGCommitment(CommitmentScheme):
    """KZG over BN254 with the trusted setup from ``setup_params``."""

    @staticmethod
    def commit(
        params: CommitmentParams, polynomial: Sequence[Fr]
    ) -> KZGCommitmentValue:
        if len(polynomial) > len(params.g1_powers):
            raise CommitmentError("Polynomial degree exceeds setup size")
        from ..core.params import NativeSRS

        if isinstance(params.g1_powers, NativeSRS):
            return KZGCommitmentValue(msm(params.g1_powers, polynomial))
        return KZGCommitmentValue(
            msm(params.g1_powers[: len(polynomial)], polynomial)
        )

    @staticmethod
    def open(
        params: CommitmentParams, polynomial: Sequence[Fr], point: Fr
    ) -> Tuple[Fr, KZGProof]:
        value = evaluate_polynomial(polynomial, point)
        quotient = compute_quotient_polynomial(polynomial, point, value)
        proof_commitment = KZGCommitment.commit(params, quotient)
        return value, KZGProof(proof_commitment.commitment)

    # -- evaluation-basis fast path (identical group elements) -------------
    @staticmethod
    def commit_evals(
        params: CommitmentParams, values: Sequence[Fr]
    ) -> KZGCommitmentValue:
        """Commit to the interpolant of ``values`` over {0..n-1} WITHOUT
        interpolating: one MSM against the Lagrange SRS.  Produces the same
        commitment as ``commit(interpolate_on_range(values))``."""
        n = len(values)
        if n == 0:
            return KZGCommitmentValue(G1.zero())
        if n > len(params.g1_powers):
            raise CommitmentError("Polynomial degree exceeds setup size")
        if params.tau is None:
            poly = interpolate_on_range([Fr(v) for v in values])
            return KZGCommitment.commit(params, poly)
        return KZGCommitmentValue(msm(lagrange_srs(params, n), values))

    @staticmethod
    def open_evals(
        params: CommitmentParams, values: Sequence[Fr], point: Fr
    ) -> Tuple[Fr, KZGProof]:
        """Open the interpolant of ``values`` at ``point`` in O(n) field work:
        barycentric evaluation + evaluation-local quotient.  Falls back to
        the coefficient path if ``point`` lies in the domain (negligible
        probability for Fiat-Shamir challenges) or tau is unavailable."""
        from ..field.fr import MODULUS, batch_inverse

        n = len(values)
        zi = int(point)
        if n < 2 or zi < n or params.tau is None:
            poly = interpolate_on_range([Fr(v) for v in values])
            return KZGCommitment.open(params, poly, point)
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                # Barycentric value + quotient vector in one native pass;
                # the quotient bytes feed the MSM without Fr round-trips.
                value, q_bytes = _native.fr_open_evals(values, point)
                proof_pt = msm(lagrange_srs(params, n), q_bytes)
                return value, KZGProof(proof_pt)
        diffs = [Fr((i - zi) % MODULUS) for i in range(n)]
        inv_diffs = batch_inverse(diffs)
        value = barycentric_eval(values, point)
        q = [
            (Fr(values[i]) - value) * inv_diffs[i] for i in range(n)
        ]
        proof_commitment = KZGCommitment.commit_evals(params, q)
        return value, KZGProof(proof_commitment.commitment)

    @staticmethod
    def verify(
        vk: CommitmentVerificationKey,
        commitment: KZGCommitmentValue,
        point: Fr,
        value: Fr,
        proof: KZGProof,
    ) -> bool:
        """Pairing check e(C - [v]_1, [1]_2) == e(pi, [tau]_2 - [z]_2)
        (reference commitments.rs:201-228).  Uses the C++ native pairing
        (single shared final exponentiation) when available."""
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                left_g1 = commitment.commitment - _native.g1_scalar_mul(
                    vk.g1_generator, value
                )
                right_g2 = vk.g2_tau - _native.g2_scalar_mul(
                    vk.g2_generator, point
                )
                return _native.pairing_equal(
                    left_g1, vk.g2_generator, proof.proof, right_g2
                )
        left_g1 = commitment.commitment - vk.g1_generator.scalar_mul(value)
        right_g2 = vk.g2_tau - vk.g2_generator.scalar_mul(point)
        return pairing(left_g1, vk.g2_generator) == pairing(proof.proof, right_g2)

    @staticmethod
    def batch_verify(
        vk: CommitmentVerificationKey,
        commitments: Sequence[KZGCommitmentValue],
        points: Sequence[Fr],
        values: Sequence[Fr],
        proofs: Sequence[KZGProof],
    ) -> bool:
        """RLC batch verification, reference-faithful (commitments.rs:230-301).

        PARITY WARNING: the reference's pairing equation is unbalanced in the
        RLC weights — the left side is linear in gamma while the right side
        (Sum gamma_i pi_i paired with Sum gamma_j (tau - z_j) G2) is
        quadratic — so it rejects HONEST non-empty batches with random
        gammas.  The reference never calls or tests this method; we keep its
        exact behavior (including the fixed [42u8;32]-seeded gammas, NOT the
        transcript) and provide ``batch_verify_sound`` for real batching.
        """
        if not (len(commitments) == len(points) == len(values) == len(proofs)):
            raise CommitmentError("Batch verify input lengths must match")
        if len(commitments) == 0:
            return True
        rng = ChaCha20Rng.from_seed(bytes([42]) * 32)
        gammas = [fr_rand(rng) for _ in commitments]

        batched_commitment = G1.zero()
        for cval, gamma in zip(commitments, gammas):
            batched_commitment = batched_commitment.add(
                cval.commitment.scalar_mul(gamma)
            )
        batched_value = Fr(0)
        for v, gamma in zip(values, gammas):
            batched_value = batched_value + v * gamma
        batched_proof = G1.zero()
        for pi, gamma in zip(proofs, gammas):
            batched_proof = batched_proof.add(pi.proof.scalar_mul(gamma))

        left_g1 = batched_commitment - vk.g1_generator.scalar_mul(batched_value)
        from ..field.g2 import G2

        batched_g2 = G2.zero()
        for z, gamma in zip(points, gammas):
            term = (vk.g2_tau - vk.g2_generator.scalar_mul(z)).scalar_mul(gamma)
            batched_g2 = batched_g2.add(term)

        return pairing(left_g1, vk.g2_generator) == pairing(
            batched_proof, batched_g2
        )

    @staticmethod
    def batch_verify_sound(
        vk: CommitmentVerificationKey,
        commitments: Sequence[KZGCommitmentValue],
        points: Sequence[Fr],
        values: Sequence[Fr],
        proofs: Sequence[KZGProof],
    ) -> bool:
        """Correct RLC batch verification (tnsh extension).

        Uses the standard identity per opening
        ``C_i - v_i G + z_i pi_i  ==  tau * pi_i`` in the exponent, so

            e(Sum gamma_i (C_i - v_i G + z_i pi_i), [1]_2)
              == e(Sum gamma_i pi_i, [tau]_2)

        holds iff every opening is valid (up to RLC soundness error).
        """
        if not (len(commitments) == len(points) == len(values) == len(proofs)):
            raise CommitmentError("Batch verify input lengths must match")
        if len(commitments) == 0:
            return True
        rng = ChaCha20Rng.from_seed(bytes([42]) * 32)
        gammas = [fr_rand(rng) for _ in commitments]
        left = G1.zero()
        right_proof = G1.zero()
        for cval, z, v, pi, gamma in zip(
            commitments, points, values, proofs, gammas
        ):
            term = (
                cval.commitment
                - vk.g1_generator.scalar_mul(v)
                + pi.proof.scalar_mul(z)
            )
            left = left.add(term.scalar_mul(gamma))
            right_proof = right_proof.add(pi.proof.scalar_mul(gamma))
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                return _native.pairing_product_is_one(
                    [(left, vk.g2_generator), (right_proof.neg(), vk.g2_tau)]
                )
        from ..field.pairing import pairing_product_is_one

        return pairing_product_is_one(
            [(left, vk.g2_generator), (right_proof.neg(), vk.g2_tau)]
        )


def verify_openings_batched(
    vk: CommitmentVerificationKey,
    commitments: Sequence[KZGCommitmentValue],
    point: Fr,
    values: Sequence[Fr],
    proofs: Sequence[KZGProof],
) -> bool:
    """Batched verification of several openings AT THE SAME POINT with one
    shared pairing-product check (tnsh extension; used by the protocols'
    fast verify path).

    Each opening satisfies e(C_i - v_i G, [1]_2) == e(pi_i, T) with the
    shared T = [tau]_2 - [z]_2.  With RLC weights gamma^i derived from a
    transcript over the statement, the combined check

        e(Σ gamma^i (C_i - v_i G), [1]_2) * e(-Σ gamma^i pi_i, T) == 1

    costs 2 Miller loops + 1 final exponentiation total (vs 4 + 2 when
    checking sequentially).  Soundness: gamma is unpredictable to the
    prover (depends on all commitments/values/proofs), so a forged opening
    survives with probability ~1/r.
    """
    if not (len(commitments) == len(values) == len(proofs)):
        raise CommitmentError("batched opening inputs must match in length")
    if len(commitments) == 0:
        return True
    from ..core.transcript import Transcript

    t = Transcript(bytes(32))
    t.append_field_element(b"batch_point", point)
    for cval, v in zip(commitments, values):
        t.append_field_element(b"batch_commitment", cval.hash())
        t.append_field_element(b"batch_value", v)
    for pi in proofs:
        t.append_field_element(
            b"batch_proof", KZGCommitmentValue(pi.proof).hash()
        )
    gamma = t.challenge_field_element(b"batch_gamma")

    def _smul(p: G1, s: Fr) -> G1:
        if int(s) == 1:
            return p
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                return _native.g1_scalar_mul(p, s)
        return p.scalar_mul(s)

    acc_c = G1.zero()
    acc_v = Fr(0)
    acc_p = G1.zero()
    weight = Fr(1)
    for cval, v, pi in zip(commitments, values, proofs):
        acc_c = acc_c.add(_smul(cval.commitment, weight))
        acc_v = acc_v + v * weight
        acc_p = acc_p.add(_smul(pi.proof, weight))
        weight = weight * gamma

    left = acc_c - _smul(vk.g1_generator, acc_v)
    right_g2 = vk.g2_tau - vk.g2_generator.scalar_mul(point)
    if not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native

        if _native.available:
            return _native.pairing_equal(left, vk.g2_generator, acc_p, right_g2)
    return pairing(left, vk.g2_generator) == pairing(acc_p, right_g2)


# ---------------------------------------------------------------------------
# Vector commitments (reference commitments.rs:378-483)
# ---------------------------------------------------------------------------

class VectorCommitmentScheme(ABC):
    """Abstract vector commitment scheme (reference commitments.rs:378-405)."""

    @staticmethod
    @abstractmethod
    def commit(params, vector: Sequence[Fr]):
        ...

    @staticmethod
    @abstractmethod
    def open(params, vector: Sequence[Fr], index: int):
        ...

    @staticmethod
    @abstractmethod
    def verify(vk, commitment, index: int, value: Fr, proof) -> bool:
        ...


class KZGVectorCommitment(VectorCommitmentScheme):
    """Vector commitment = KZG over the interpolation of the vector on
    {0..n-1} (reference commitments.rs:407-483)."""

    @staticmethod
    def commit(
        params: CommitmentParams, vector: Sequence[Fr]
    ) -> KZGCommitmentValue:
        poly = interpolate_on_range([Fr(v) for v in vector])
        return KZGCommitment.commit(params, poly)

    @staticmethod
    def open(
        params: CommitmentParams, vector: Sequence[Fr], index: int
    ) -> Tuple[Fr, KZGProof]:
        if index >= len(vector):
            raise CommitmentError("Index out of bounds")
        value = Fr(vector[index])
        poly = interpolate_on_range([Fr(v) for v in vector])
        opened_value, proof = KZGCommitment.open(params, poly, Fr(index))
        if opened_value != value:
            raise CommitmentError("Opened value does not match vector entry")
        return value, proof

    @staticmethod
    def verify(
        vk: CommitmentVerificationKey,
        commitment: KZGCommitmentValue,
        index: int,
        value: Fr,
        proof: KZGProof,
    ) -> bool:
        return KZGCommitment.verify(vk, commitment, Fr(index), value, proof)
