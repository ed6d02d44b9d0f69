"""PST-style multilinear KZG polynomial commitment (tnsh extension).

The reference commits to traces via *univariate* KZG over the domain
{0..n-1} (commitments.rs:162-199), which cannot bind the sum-check's final
multilinear evaluation to the committed data — that gap is why its
consistency closures can be (and are) identically zero (SURVEY caveats 1,
4).  Verifier-enforced sound mode (tnsh.protocols.sound) needs a PCS whose
openings ARE multilinear evaluations; this module provides the standard
Papamanthou–Shi–Tamassia (PST13) multilinear KZG over BN254:

  setup   : taus = (tau_0..tau_{n-1}) drawn from the deterministic ChaCha20
            stream (same transparency stance as the reference, which keeps
            tau in ProverParams — utils.rs:62); SRS = the multilinear
            Lagrange basis at tau, [eq(b, tau)]_1 for b in {0,1}^m over
            every suffix (tau_i..tau_{n-1}), plus [tau_i]_2.
  commit  : C = sum_b v_b [eq(b, tau)]_1 = [~v(tau)]_1 — one MSM over the
            raw evaluation table (native Pippenger via tnsh.commit.kzg.msm).
  open(r) : v = ~v(r) plus n quotient commitments Q_i with
            ~v(X) - v = sum_i (X_i - r_i) q_i(X_{i+1..}); q_i is the
            fold-difference table, so the whole opening is O(2^n) field ops
            + n shrinking MSMs.
  verify  : e(C - [v]_1, [1]_2) == prod_i e(Q_i, [tau_i]_2 - [r_i]_2),
            checked as a single pairing product (native multi-Miller loop).

Variable order matches the sum-check engine: variable 0 is the FASTEST
index bit (little-endian, reference polynomials.rs:108-122), and opening
folds variable 0 first — so a sum-check challenge vector is directly a
valid opening point.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

from ..core.params import SETUP_SEED
from ..core.rng import ChaCha20Rng, fr_rand
from ..errors import CommitmentError
from ..field.fr import MODULUS, Fr
from ..field.g1 import G1
from ..field.g2 import G2
from .kzg import KZGCommitmentValue, msm

_P = MODULUS


@dataclass
class MLCommitmentParams:
    """Prover-side SRS for up to ``num_vars`` variables.

    ``basis[i]`` is the Lagrange basis at ``(tau_i..tau_{n-1})`` — a list of
    ``2^(n-i)`` G1 points; ``basis[0]`` commits full-width polynomials and
    ``basis[i+1]`` commits the i-th opening quotient.
    """

    num_vars: int
    basis: List[List[G1]]
    taus: Optional[List[Fr]]


@dataclass
class MLVerificationKey:
    g1_generator: G1
    g2_generator: G2
    g2_taus: List[G2]


@dataclass
class MLOpeningProof:
    """value + per-variable quotient commitments."""

    quotients: List[G1]

    def serialize_compressed(self) -> bytes:
        from ..core.serialize import g1_to_bytes

        out = [len(self.quotients).to_bytes(8, "little")]
        out += [g1_to_bytes(q) for q in self.quotients]
        return b"".join(out)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "MLOpeningProof":
        from ..core.serialize import g1_from_bytes

        n = int.from_bytes(data[:8], "little")
        qs = []
        off = 8
        for _ in range(n):
            qs.append(g1_from_bytes(data[off : off + 32]))
            off += 32
        return cls(qs)


def _basis_scalars(taus: Sequence[Fr]) -> List[int]:
    """eq(b, taus) for all b, little-endian (variable 0 = bit 0, fastest)."""
    table = [1]
    for t in taus:  # variable m joins as the SLOWEST bit so far -> bit m
        ti = int(t)
        nt = (1 - ti) % _P
        table = [v * nt % _P for v in table] + [v * ti % _P for v in table]
    return table


#: Externally supplied SRS registry: num_vars -> (params, vk).  When set,
#: ``setup_multilinear_params`` returns the installed SRS instead of the
#: deterministic one, so sound-mode proofs can run against a ceremony SRS
#: whose trapdoor nobody holds.
_EXTERNAL_SRS: dict = {}


def install_external_multilinear_srs(
    params: MLCommitmentParams, vk: MLVerificationKey
) -> None:
    """Route ``setup_multilinear_params(params.num_vars)`` to an externally
    supplied SRS (e.g. from :func:`generate_multilinear_srs` run in a
    ceremony, with the taus discarded)."""
    _EXTERNAL_SRS[params.num_vars] = (params, vk)


def clear_external_multilinear_srs(num_vars: Optional[int] = None) -> None:
    if num_vars is None:
        _EXTERNAL_SRS.clear()
    else:
        _EXTERNAL_SRS.pop(num_vars, None)


def has_external_multilinear_srs(num_vars: int) -> bool:
    """True when ``setup_multilinear_params(num_vars)`` serves a ceremony
    SRS whose trapdoor is unknown — factorized (tau-aware) cube paths must
    not be used then."""
    return num_vars in _EXTERNAL_SRS


def generate_multilinear_srs(
    num_vars: int,
    taus: Sequence[Fr],
    keep_taus: bool = False,
) -> Tuple[MLCommitmentParams, MLVerificationKey]:
    """Build a PST SRS from explicit trapdoor scalars.

    With ``keep_taus=False`` (the honest-ceremony mode) the returned params
    do NOT retain the taus: after the caller discards its copy, no one can
    forge openings (see tests/test_sound.py::test_tau_holder_can_forge for
    the attack the default deterministic setup admits).
    """
    import os

    taus = [Fr(t) for t in taus]
    if len(taus) != num_vars:
        raise CommitmentError("need exactly num_vars trapdoor scalars")
    g1_gen = G1.generator()
    g2_gen = G2.generator()

    from .. import _native

    native = _native.available and not os.environ.get("TNSH_NO_NATIVE")
    basis: List = []
    if native:
        # Each basis segment stays native-resident (NativeSRS handle):
        # commits/quotient MSMs run against the handle with zero point
        # marshalling, and setup never materializes Python G1 objects.
        from ..core.params import NativeSRS

        for i in range(num_vars + 1):
            seg_bytes = b"".join(
                s.to_bytes(32, "little") for s in _basis_scalars(taus[i:])
            )
            basis.append(
                NativeSRS(_native.srs_create_fixed_base(g1_gen, seg_bytes))
            )
        g2_taus = [_native.g2_scalar_mul(g2_gen, t) for t in taus]
    else:
        from ..core.params import _fixed_base_powers

        all_scalars: List[Fr] = []
        seg_sizes: List[int] = []
        for i in range(num_vars + 1):
            seg = _basis_scalars(taus[i:])
            seg_sizes.append(len(seg))
            all_scalars.extend(Fr(s) for s in seg)
        pts = _fixed_base_powers(g1_gen, all_scalars)
        off = 0
        for size in seg_sizes:
            basis.append(pts[off : off + size])
            off += size
        g2_taus = [g2_gen.scalar_mul(int(t)) for t in taus]

    params = MLCommitmentParams(
        num_vars=num_vars, basis=basis, taus=taus if keep_taus else None
    )
    vk = MLVerificationKey(
        g1_generator=g1_gen, g2_generator=g2_gen, g2_taus=g2_taus
    )
    return params, vk


@lru_cache(maxsize=32)
def _deterministic_multilinear_params(
    num_vars: int,
) -> Tuple[MLCommitmentParams, MLVerificationKey]:
    rng = ChaCha20Rng.from_seed(SETUP_SEED)
    taus = [fr_rand(rng) for _ in range(num_vars)]
    return generate_multilinear_srs(num_vars, taus, keep_taus=True)


@lru_cache(maxsize=64)
def _deterministic_vk(num_vars: int) -> MLVerificationKey:
    import os

    rng = ChaCha20Rng.from_seed(SETUP_SEED)
    taus = [fr_rand(rng) for _ in range(num_vars)]
    g2_gen = G2.generator()
    from .. import _native

    if _native.available and not os.environ.get("TNSH_NO_NATIVE"):
        g2_taus = [_native.g2_scalar_mul(g2_gen, t) for t in taus]
    else:
        g2_taus = [g2_gen.scalar_mul(int(t)) for t in taus]
    return MLVerificationKey(
        g1_generator=G1.generator(), g2_generator=g2_gen, g2_taus=g2_taus
    )


def multilinear_verification_key(num_vars: int) -> MLVerificationKey:
    """The PST verification key alone — O(num_vars) group work, never
    materializing the 2^num_vars prover SRS.  Sound-mode VERIFIERS use
    this so verifying a big-cube proof stays logarithmic."""
    ext = _EXTERNAL_SRS.get(num_vars)
    if ext is not None:
        return ext[1]
    return _deterministic_vk(num_vars)


def setup_multilinear_params(
    num_vars: int,
) -> Tuple[MLCommitmentParams, MLVerificationKey]:
    """PST setup for ``num_vars`` variables.

    Default: DETERMINISTIC taus from the fixed ``[42u8; 32]`` stream — the
    same transparency stance as the reference, which retains tau in
    ProverParams (utils.rs:62).  **This is reproducibility plumbing, not a
    trusted setup**: anyone can rederive the taus and forge openings
    (demonstrated in tests/test_sound.py), so sound-mode proofs under the
    default SRS bind only against adversaries who do not exploit the public
    trapdoor.  For real deployments, generate an SRS in a ceremony with
    :func:`generate_multilinear_srs(keep_taus=False)` and register it with
    :func:`install_external_multilinear_srs`; this function then serves the
    external SRS instead.
    """
    ext = _EXTERNAL_SRS.get(num_vars)
    if ext is not None:
        return ext
    return _deterministic_multilinear_params(num_vars)


class MultilinearKZG:
    """Commit / open / verify for dense multilinear evaluation tables."""

    @staticmethod
    def commit(
        params: MLCommitmentParams, evaluations: Sequence[Fr]
    ) -> KZGCommitmentValue:
        n_vars = _infer_vars(len(evaluations))
        if n_vars > params.num_vars:
            raise CommitmentError("polynomial exceeds SRS size")
        seg = params.basis[params.num_vars - n_vars]
        return KZGCommitmentValue(msm(seg, list(evaluations)))

    @staticmethod
    def commit_many(
        params: MLCommitmentParams, tables: Sequence[Sequence[Fr]]
    ) -> List[KZGCommitmentValue]:
        """Commit a batch of equal-length columns in ONE burst.

        Native-resident SRS segments route every MSM through
        ``hybrid_srs_msm_many`` (all device parts dispatched before any
        host work — the 2logK+4 column commits of the bit-column provers
        are a natural burst workload).  Identical commitments to
        per-column :meth:`commit` on any path."""
        tables = list(tables)
        if not tables:
            return []
        size = len(tables[0])
        n_vars = _infer_vars(size)
        if n_vars > params.num_vars:
            raise CommitmentError("polynomial exceeds SRS size")
        if any(len(t) != size for t in tables):
            raise CommitmentError("commit_many needs equal-length tables")
        seg = params.basis[params.num_vars - n_vars]
        import os

        from ..core.params import NativeSRS

        if (isinstance(seg, NativeSRS) and size >= 1024
                and not os.environ.get("TNSH_NO_NATIVE")):
            from .. import _native
            from .kzg import hybrid_srs_msm_many

            blobs = [_native._fr_vec_bytes(t) for t in tables]
            res = hybrid_srs_msm_many(seg.srs_id, blobs, size)
            return [KZGCommitmentValue(r) for r in res]
        return [MultilinearKZG.commit(params, t) for t in tables]

    @staticmethod
    def open(
        params: MLCommitmentParams,
        evaluations: Sequence[Fr],
        point: Sequence[Fr],
    ) -> Tuple[Fr, MLOpeningProof]:
        import os

        n_vars = _infer_vars(len(evaluations))
        if len(point) != n_vars:
            raise CommitmentError("opening point has wrong arity")
        offset = params.num_vars - n_vars
        if n_vars > 0 and not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                # Quotient tables computed natively; bytes feed the MSMs
                # without per-element Fr round-trips.
                value, levels = _native.fr_ml_open(evaluations, point)
                quotients = [
                    msm(params.basis[offset + i + 1], levels[i])
                    for i in range(n_vars)
                ]
                return value, MLOpeningProof(quotients)
        table = [int(v) % _P for v in evaluations]
        quotients: List[G1] = []
        for i in range(n_vars):
            half = len(table) // 2
            diff = [(table[2 * j + 1] - table[2 * j]) % _P for j in range(half)]
            quotients.append(msm(params.basis[offset + i + 1], [Fr(d) for d in diff]))
            r = int(point[i])
            table = [
                (table[2 * j] + r * diff[j]) % _P for j in range(half)
            ]
        return Fr(table[0]), MLOpeningProof(quotients)

    @staticmethod
    def verify(
        vk: MLVerificationKey,
        commitment: KZGCommitmentValue,
        point: Sequence[Fr],
        value: Fr,
        proof: MLOpeningProof,
        num_total_vars: Optional[int] = None,
    ) -> bool:
        n_vars = len(point)
        if len(proof.quotients) != n_vars:
            return False
        total = num_total_vars if num_total_vars is not None else n_vars
        offset = total - n_vars
        import os

        left = commitment.commitment - vk.g1_generator.scalar_mul(int(value))
        pairs = [(left.neg(), vk.g2_generator)]
        for i in range(n_vars):
            g2_term = vk.g2_taus[offset + i] - vk.g2_generator.scalar_mul(
                int(point[i])
            )
            pairs.append((proof.quotients[i], g2_term))
        from .. import _native

        if _native.available and not os.environ.get("TNSH_NO_NATIVE"):
            return _native.pairing_product_is_one(pairs)
        from ..field.pairing import pairing_product_is_one

        return pairing_product_is_one(pairs)


def _infer_vars(length: int) -> int:
    if length <= 0 or length & (length - 1):
        raise CommitmentError("evaluation table must be a power of two")
    return length.bit_length() - 1


def batch_verify_openings(items) -> bool:
    """Verify many PST openings with ONE pairing product.

    ``items``: sequence of ``(vk, commitment, point, value, proof)``.
    Standard RLC batching: random weights gamma_i are derived from a
    transcript over the full statement, the commitment-side pairs collapse
    into a single e(-sum gamma_i (C_i - v_i G), [1]_2), and openings AT THE
    SAME POINT (under the same vk) share their G2 terms, so their quotients
    merge into one weighted G1 point per variable.  For sound-Twist's 16
    openings this is ~174 Miller loops + 1 final exponentiation instead of
    ~242 + 16.  Soundness error ~items/r.
    """
    import os

    items = list(items)
    if not items:
        return True
    from ..core.transcript import Transcript

    t = Transcript(bytes(32))
    for vk, comm, point, value, proof in items:
        t.append_field_element(b"mlbatch_commitment", comm.hash())
        t.append_field_elements(b"mlbatch_point", list(point))
        t.append_field_element(b"mlbatch_value", value)
        for q in proof.quotients:
            t.append_field_element(
                b"mlbatch_quotient", KZGCommitmentValue(q).hash()
            )
    gamma = t.challenge_field_element(b"mlbatch_gamma")

    g2_gen = items[0][0].g2_generator
    g1_gen = items[0][0].g1_generator

    def smul(p: G1, s: int) -> G1:
        if s == 1:
            return p
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                return _native.g1_scalar_mul(p, Fr(s))
        return p.scalar_mul(s)

    acc_c = G1.zero()
    acc_v = 0
    groups = {}  # (id(vk), point tuple) -> [vk, point, [weighted Q sums]]
    weight = Fr(1)
    for vk, comm, point, value, proof in items:
        if len(proof.quotients) != len(point):
            return False
        w = int(weight)
        acc_c = acc_c.add(smul(comm.commitment, w))
        acc_v = (acc_v + w * int(value)) % _P
        key = (id(vk), tuple(int(x) for x in point))
        g = groups.get(key)
        if g is None:
            g = [vk, list(point), [G1.zero()] * len(point)]
            groups[key] = g
        for m, q in enumerate(proof.quotients):
            g[2][m] = g[2][m].add(smul(q, w))
        weight = weight * gamma

    # e(Q, [tau_m] - r_m [1]_2) would need a G2 scalar-mul per variable
    # per group (the dominant verify cost at ~2n+k pairs); instead fold
    # the -r_m side into G1 — e(Q, [tau_m]) * e(-r_m Q, [1]_2) — so the
    # [1]_2 terms all merge into ONE pair and pairs sharing the same
    # [tau_m]_2 point (same vk level, any opening point) merge too.
    gen_acc = acc_c.neg().add(smul(g1_gen, acc_v))  # = -(acc_c - [v]G)
    tau_acc = {}  # id(g2_tau point) -> [g2_point, G1 accumulator]
    for vk, point, qsums in groups.values():
        for m, q in enumerate(qsums):
            t2 = vk.g2_taus[m]
            key = id(t2)
            slot = tau_acc.get(key)
            if slot is None:
                slot = [t2, G1.zero()]
                tau_acc[key] = slot
            slot[1] = slot[1].add(q)
            gen_acc = gen_acc.add(smul(q, (-int(point[m])) % _P))
    pairs = [(gen_acc, g2_gen)]
    pairs += [(acc, t2) for t2, acc in tau_acc.values()]
    if not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native

        if _native.available:
            return _native.pairing_product_is_one(pairs)
    from ..field.pairing import pairing_product_is_one

    return pairing_product_is_one(pairs)
