"""Factorized sparse PST commitments for (k, j)-cube witnesses.

Sound-mode Twist/Shout witnesses live on the (memory x time) cube with
index x = j*K + k (variable 0 = k_0, the fastest bit).  Committing them
densely needs a 2^(logK+logT)-point SRS and O(K*T) group work — infeasible
at the 2^20-op north star.  But the PST Lagrange basis FACTORIZES over the
variable split:

    [eq(x, taus)]_1 = eq(k, tau_k-part) * [eq(j, tau_j-part)]_1

so a commitment to any cube table collapses to ONE T-point MSM with
scalars s_j = column_j~(tau_k-part):

  * column-sparse tables (ra/wa one-hots, inc): s_j = sum of the column's
    few entries weighted by an eq-table lookup — O(nnz) field work;
  * column-incremental tables (Val, which changes one cell per cycle):
    s_j evolves by one weighted delta per cycle — O(T log K) total.

Openings fold the j variables FIRST (round-3 backlog item 1): the j-level
quotients live on shrinking (T/2, T/4, ...) column grids — each commits as
one factorized MSM over the matching j-suffix SRS with eq(tau_k)-weighted
column scalars, and those scalars FOLD LINEARLY, so the whole j phase is a
plain dense fold of the T-vector s_j = <column_j, eq(., tau_k)>.  After the
j variables bind, the k-residue g(k) = sum_j eq(j, r_j) col_j(k) is a
K-vector (O(nnz) to build) and the k phase is K-sized dense folds against a
tiny k-suffix SRS.  Total group work: ~(T + K) point-ops per opening versus
(logK + 1) * T for the k-first order — ~11x fewer at K=2^10, T=2^16.
Quotients are emitted in VARIABLE order (k quotients at indices 0..logK-1,
j quotients after), and PST verification checks the decomposition identity
e(C - vG, h) = prod_i e(Q_i, [tau_i - r_i]_2), which any peeling order
satisfies — so the verifier is unchanged; only proof BYTES differ from the
dense suffix-order MultilinearKZG.open.  The dense sound prover uses
:func:`open_dense_cube` (same j-first order) so sparse == dense proof bytes
still holds (tests/test_sound_sparse.py).

Trust model: the factorized scalars require the prover to know tau_k —
available under the repo's default DETERMINISTIC setup (reference-parity
transparency stance, utils.rs:62).  Under an externally-supplied ceremony
SRS (mkzg.install_external_multilinear_srs) the trapdoor is unknown, so
sound proving at cube scale needs the dense SRS; the sparse path raises in
that case.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

from ..core.params import SETUP_SEED
from ..core.rng import ChaCha20Rng, fr_rand
from ..errors import CommitmentError
from ..field.fr import MODULUS, Fr
from ..field.g1 import G1
from ..field.g2 import G2
from .kzg import KZGCommitmentValue, msm
from .mkzg import MLOpeningProof, MLVerificationKey

_P = MODULUS


def eq_table_ints(point: Sequence[int]):
    """eq(b, point) for all b, little-endian (bit 0 = point[0]).

    Large tables come back as a bytes-backed ``FrTable`` (same values,
    list-like) built by the native kernel."""
    if len(point) >= 11:
        import os

        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                from ..field.fr import FrTable

                return FrTable(
                    _native.fr_eq_table([int(p) % _P for p in point])
                )
    table = [1]
    for t in point:
        ti = int(t) % _P
        nt = (1 - ti) % _P
        table = [v * nt % _P for v in table] + [v * ti % _P for v in table]
    return table


@dataclass
class CubeParams:
    """Factorized SRS for (log_k + log_t)-variable cube commitments."""

    log_k: int
    log_t: int
    taus: List[Fr]                       # all log_k + log_t trapdoors
    j_bases: List[object]                # j-suffix SRS levels (NativeSRS or
    #                                      G1 lists), sizes 2^(log_t - l)
    k_bases: List[object]                # k-suffix SRS levels,
    #                                      sizes 2^(log_k - l)
    eqk_tables: List[List[int]]          # eq-tables of tau_k suffixes,
    #                                      eqk_tables[i] = eq(. , taus[i:log_k])
    vk: MLVerificationKey


@lru_cache(maxsize=32)
def cube_params(log_k: int, log_t: int) -> CubeParams:
    """Deterministic factorized setup: SAME taus (ChaCha prefix) as
    ``setup_multilinear_params(log_k + log_t)``, but only O(T + K) points
    are ever materialized."""
    import os

    n = log_k + log_t
    rng = ChaCha20Rng.from_seed(SETUP_SEED)
    taus = [fr_rand(rng) for _ in range(n)]
    tau_j = [int(t) for t in taus[log_k:]]
    g1 = G1.generator()
    g2 = G2.generator()

    from .. import _native

    native = _native.available and not os.environ.get("TNSH_NO_NATIVE")

    def make_base(scalars) -> object:
        if native:
            from ..core.params import NativeSRS

            seg = getattr(scalars, "raw", None)  # FrTable: zero-copy
            if seg is None:
                seg = b"".join(s.to_bytes(32, "little") for s in scalars)
            return NativeSRS(_native.srs_create_fixed_base(g1, seg))
        return [g1.scalar_mul(s) for s in scalars]

    tau_k = [int(t) for t in taus[:log_k]]
    j_bases = [make_base(eq_table_ints(tau_j[lv:])) for lv in range(log_t + 1)]
    k_bases = [make_base(eq_table_ints(tau_k[lv:])) for lv in range(log_k + 1)]
    eqk_tables = [
        list(eq_table_ints([int(t) for t in taus[i:log_k]]))
        for i in range(log_k + 1)
    ]
    if native:
        g2_taus = [_native.g2_scalar_mul(g2, t) for t in taus]
    else:
        g2_taus = [g2.scalar_mul(int(t)) for t in taus]
    vk = MLVerificationKey(g1_generator=g1, g2_generator=g2, g2_taus=g2_taus)
    return CubeParams(
        log_k=log_k, log_t=log_t, taus=taus,
        j_bases=j_bases, k_bases=k_bases, eqk_tables=eqk_tables, vk=vk,
    )


# ---------------------------------------------------------------------------
# Cube table representations
# ---------------------------------------------------------------------------

class SparseCubeTable:
    """Column-sparse (k, j) table: per cycle j a few (position, value)
    entries over the k-cube (ra/wa: one; inc: at most one)."""

    def __init__(self, log_k: int, log_t: int):
        self.log_k = log_k
        self.log_t = log_t
        self.cols: List[List[Tuple[int, int]]] = [
            [] for _ in range(1 << log_t)
        ]
        self._csr = None

    def set(self, j: int, k: int, value: int) -> None:
        self.cols[j].append((k, int(value) % _P))
        self._csr = None

    def csr(self):
        """Native CSR view, marshalled once and cached until mutation."""
        if self._csr is None:
            from .. import _native

            self._csr = _native.wt_csr(self.cols)
        return self._csr

    def to_dense(self) -> List[int]:
        k_size = 1 << self.log_k
        out = [0] * (k_size << self.log_t)
        for j, col in enumerate(self.cols):
            for k, v in col:
                out[j * k_size + k] = (out[j * k_size + k] + v) % _P
        return out


class IncrementalCubeTable:
    """Column-incremental (k, j) table: column j+1 = column j + sparse
    updates applied AT cycle j (Twist's Val: one write per cycle).  Column 0
    is all-zero (memory starts zeroed)."""

    def __init__(self, log_k: int, log_t: int):
        self.log_k = log_k
        self.log_t = log_t
        #: updates[j] applied after column j is read
        self.updates: List[List[Tuple[int, int]]] = [
            [] for _ in range(1 << log_t)
        ]
        self._csr = None

    def add_update(self, j: int, k: int, delta: int) -> None:
        self.updates[j].append((k, int(delta) % _P))
        self._csr = None

    def csr(self):
        """Native CSR view, marshalled once and cached until mutation."""
        if self._csr is None:
            from .. import _native

            self._csr = _native.wt_csr(self.updates)
        return self._csr

    def to_dense(self) -> List[int]:
        k_size = 1 << self.log_k
        cur = [0] * k_size
        out = [0] * (k_size << self.log_t)
        for j in range(1 << self.log_t):
            out[j * k_size: (j + 1) * k_size] = cur
            for k, d in self.updates[j]:
                cur[k] = (cur[k] + d) % _P
        return out


# ---------------------------------------------------------------------------
# Commit
# ---------------------------------------------------------------------------

def _msm_over(base: object, scalars) -> G1:
    import os

    if isinstance(scalars, (bytes, bytearray)):
        data = scalars
    else:
        data = b"".join(s.to_bytes(32, "little") for s in scalars)
    from ..core.params import NativeSRS

    if isinstance(base, NativeSRS) and not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native

        n = len(data) // 32
        from ..core.device import device_msm_enabled
        from .kzg import _DEVICE_MSM_MIN, _hybrid_srs_msm

        if n >= _DEVICE_MSM_MIN and device_msm_enabled():
            # Large commit/open MSMs ride the adaptive host+device hybrid
            # (host-only until the kernel shape is prewarmed — see
            # sound.prewarm_sound(device_msm=...); a cold shape never
            # compiles inline).  Small MSMs pin to the native host MSM,
            # where the per-call digit upload and plan dominate.
            return _hybrid_srs_msm(base.srs_id, data, n)
        return _native.srs_msm(base.srs_id, data)
    return msm(base, data)


def _wt_native():
    """The native module when the witness-table CSR kernels are usable."""
    import os

    if os.environ.get("TNSH_NO_NATIVE"):
        return None
    from .. import _native

    return _native if _native.available else None


def commit_sparse(params: CubeParams, table: SparseCubeTable
                  ) -> KZGCommitmentValue:
    native = _wt_native()
    if native is not None:
        s = native.WtAccumulator(1 << params.log_t).add_col_scalars(
            table.csr(), params.eqk_tables[0], 1 << params.log_k, False
        ).export()
        return KZGCommitmentValue(_msm_over(params.j_bases[0], s))
    eqk = params.eqk_tables[0]
    scalars = [
        sum(v * eqk[k] for k, v in col) % _P for col in table.cols
    ]
    return KZGCommitmentValue(_msm_over(params.j_bases[0], scalars))


def _commit_scalars(params: CubeParams, table) -> object:
    """The T-vector of eq(tau_k)-weighted column scalars for one cube
    witness table (bytes from the native accumulator when available)."""
    native = _wt_native()
    incremental = isinstance(table, IncrementalCubeTable)
    if native is not None:
        return native.WtAccumulator(1 << params.log_t).add_col_scalars(
            table.csr(), params.eqk_tables[0], 1 << params.log_k,
            incremental,
        ).export()
    eqk = params.eqk_tables[0]
    if incremental:
        scalars: List[int] = []
        cur = 0
        for ups in table.updates:
            scalars.append(cur)
            for k, d in ups:
                cur = (cur + d * eqk[k]) % _P
        return scalars
    return [
        sum(v * eqk[k] for k, v in col) % _P for col in table.cols
    ]


def commit_cube_batch(params: CubeParams, tables) -> List[KZGCommitmentValue]:
    """Commit several cube witness tables with ONE burst of hybrid MSMs.

    All device parts dispatch before any host MSM runs, so the device
    works while the host does; identical group elements to committing one
    at a time."""
    import os

    from ..core.params import NativeSRS

    scalars = [_commit_scalars(params, t) for t in tables]
    base = params.j_bases[0]
    if (isinstance(base, NativeSRS)
            and not os.environ.get("TNSH_NO_NATIVE")):
        from ..core.device import device_msm_enabled
        from .kzg import _DEVICE_MSM_MIN, hybrid_srs_msm_many

        blobs = [
            s if isinstance(s, (bytes, bytearray))
            else b"".join(int(v).to_bytes(32, "little") for v in s)
            for s in scalars
        ]
        n = len(blobs[0]) // 32
        if n >= _DEVICE_MSM_MIN and device_msm_enabled():
            return [
                KZGCommitmentValue(g)
                for g in hybrid_srs_msm_many(base.srs_id, blobs, n)
            ]
    return [
        KZGCommitmentValue(_msm_over(base, s)) for s in scalars
    ]


def commit_incremental(params: CubeParams, table: IncrementalCubeTable
                       ) -> KZGCommitmentValue:
    native = _wt_native()
    if native is not None:
        s = native.WtAccumulator(1 << params.log_t).add_col_scalars(
            table.csr(), params.eqk_tables[0], 1 << params.log_k, True
        ).export()
        return KZGCommitmentValue(_msm_over(params.j_bases[0], s))
    eqk = params.eqk_tables[0]
    scalars: List[int] = []
    cur = 0
    for ups in table.updates:
        scalars.append(cur)
        for k, d in ups:
            cur = (cur + d * eqk[k]) % _P
    return KZGCommitmentValue(_msm_over(params.j_bases[0], scalars))


# ---------------------------------------------------------------------------
# Open (fold j variables first — see module docstring for why)
# ---------------------------------------------------------------------------

def _open_j_then_k(params: CubeParams, s: List[int], make_g,
                   point: Sequence[Fr]) -> Tuple[Fr, MLOpeningProof]:
    """Shared j-first opening driver.

    ``s``: the T-vector of eq(tau_k)-weighted column scalars
    s_j = <column_j, eq(., tau_k)> — these fold LINEARLY under j-variable
    binding, so the j-phase quotient scalars are plain odd-even diffs.
    ``make_g(eqw)``: builds the k-residue K-vector
    g(k) = sum_j eqw[j] * column_j(k) from the eq-table of the j-point.
    Quotients are returned in VARIABLE order (k levels first)."""
    import os

    log_k, log_t = params.log_k, params.log_t
    if len(point) != log_k + log_t:
        raise CommitmentError("opening point has wrong arity")
    rk = [int(p) % _P for p in point[:log_k]]
    rj = [int(p) % _P for p in point[log_k:]]

    native = None
    if not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native

        if _native.available:
            native = _native

    if native is not None and log_t > 0:
        # the fold-and-quotient pass IS a multilinear opening over the
        # j variables: one native call yields every level's quotient
        # bytes, which feed the MSMs with zero Python field ops
        _, j_levels = native.fr_ml_open(s, [Fr(x) for x in rj])
        qj = [
            _msm_over(params.j_bases[i + 1], j_levels[i])
            for i in range(log_t)
        ]
    else:
        qj = []
        cur = s
        for i, r in enumerate(rj):
            half = len(cur) // 2
            diff = [(cur[2 * x + 1] - cur[2 * x]) % _P for x in range(half)]
            qj.append(_msm_over(params.j_bases[i + 1], diff))
            cur = [(cur[2 * x] + r * diff[x]) % _P for x in range(half)]

    g = make_g(eq_table_ints(rj))
    if native is not None and log_k > 0:
        gval, k_levels = native.fr_ml_open(g, [Fr(x) for x in rk])
        qk = [
            _msm_over(params.k_bases[i + 1], k_levels[i])
            for i in range(log_k)
        ]
        return Fr(int(gval) % _P), MLOpeningProof(qk + qj)
    qk = []
    for i, r in enumerate(rk):
        half = len(g) // 2
        diff = [(g[2 * x + 1] - g[2 * x]) % _P for x in range(half)]
        qk.append(_msm_over(params.k_bases[i + 1], diff))
        g = [(g[2 * x] + r * diff[x]) % _P for x in range(half)]
    return Fr(g[0] % _P), MLOpeningProof(qk + qj)


def open_sparse(params: CubeParams, table: SparseCubeTable,
                point: Sequence[Fr]) -> Tuple[Fr, MLOpeningProof]:
    return open_combined(params, [(1, table)], [], point)


def open_incremental(params: CubeParams, table: IncrementalCubeTable,
                     point: Sequence[Fr]) -> Tuple[Fr, MLOpeningProof]:
    """Open a column-incremental table: the column scalars are prefix sums
    of weighted deltas (one O(T) scan), and the k-residue weights each delta
    by the STRICT SUFFIX sum of eq(j, r_j) — cell k holds delta d from the
    cycle after it was written onward."""
    return open_combined(params, [], [(1, table)], point)


def sparse_mle_eval(table: SparseCubeTable, point: Sequence[Fr]) -> Fr:
    """~table(point) for a column-sparse cube table, O(nnz + T + K)."""
    native = _wt_native()
    eqk = eq_table_ints([int(p) for p in point[:table.log_k]])
    eqj = eq_table_ints([int(p) for p in point[table.log_k:]])
    if native is not None:
        return native.wt_mle(table.csr(), 1 << table.log_t, eqk,
                             1 << table.log_k, eqj, False)
    eqk, eqj = list(eqk), list(eqj)
    acc = 0
    for j, col in enumerate(table.cols):
        if col:
            acc += eqj[j] * sum(v * eqk[k] for k, v in col)
    return Fr(acc % _P)


def incremental_mle_eval(table: IncrementalCubeTable,
                         point: Sequence[Fr]) -> Fr:
    """~table(point) for a column-incremental cube table, O(T log K)."""
    native = _wt_native()
    eqk = eq_table_ints([int(p) for p in point[:table.log_k]])
    eqj = eq_table_ints([int(p) for p in point[table.log_k:]])
    if native is not None:
        return native.wt_mle(table.csr(), 1 << table.log_t, eqk,
                             1 << table.log_k, eqj, True)
    eqk, eqj = list(eqk), list(eqj)
    cur = 0
    acc = 0
    for j, ups in enumerate(table.updates):
        acc = (acc + eqj[j] * cur) % _P
        for k, d in ups:
            cur = (cur + d * eqk[k]) % _P
    return Fr(acc)


def open_combined(params: CubeParams,
                  sparse_parts: Sequence[Tuple[int, SparseCubeTable]],
                  inc_parts: Sequence[Tuple[int, IncrementalCubeTable]],
                  point: Sequence[Fr]) -> Tuple[Fr, MLOpeningProof]:
    """Open the random linear combination sum_i c_i*S_i + sum_m d_m*V_m
    (S column-sparse, V column-incremental) with ONE j-first quotient set.

    This is the prover side of RLC opening batching: all cube polynomials opened at the same sum-check point fold into
    one polynomial BEFORE the quotients are computed, so the whole batch
    costs one opening's MSM work (~T+K point-ops) instead of one per
    polynomial.  Byte-identical to ``open_dense_cube`` on the pointwise
    RLC of the dense tables (locked by tests/test_sound_sparse.py)."""
    eqk = params.eqk_tables[0]
    t_size = 1 << params.log_t
    k_size = 1 << params.log_k
    native = _wt_native()
    if native is not None:
        acc = native.WtAccumulator(t_size)
        for c, tab in sparse_parts:
            acc.add_col_scalars(tab.csr(), eqk, k_size, False, int(c) % _P)
        for d, tab in inc_parts:
            acc.add_col_scalars(tab.csr(), eqk, k_size, True, int(d) % _P)
        s = acc.export()

        def make_g(eqw):
            ga = native.WtAccumulator(k_size)
            for c, tab in sparse_parts:
                ga.add_residue(tab.csr(), t_size, eqw, False, int(c) % _P)
            for d, tab in inc_parts:
                ga.add_residue(tab.csr(), t_size, eqw, True, int(d) % _P)
            return ga.export()

        return _open_j_then_k(params, s, make_g, point)

    s = [0] * t_size
    for c, tab in sparse_parts:
        c = int(c) % _P
        for j, col in enumerate(tab.cols):
            if col:
                s[j] = (s[j] + c * sum(v * eqk[k] for k, v in col)) % _P
    for d, tab in inc_parts:
        d = int(d) % _P
        cur = 0
        for j, ups in enumerate(tab.updates):
            s[j] = (s[j] + d * cur) % _P
            for k, dv in ups:
                cur = (cur + dv * eqk[k]) % _P

    def make_g(eqw) -> List[int]:
        eqw = list(eqw)
        g = [0] * (1 << params.log_k)
        for c, tab in sparse_parts:
            c = int(c) % _P
            for j, col in enumerate(tab.cols):
                w = eqw[j] * c % _P
                for k, v in col:
                    g[k] = (g[k] + w * v) % _P
        if inc_parts:
            suffix = [0] * (t_size + 1)
            for j in range(t_size - 1, -1, -1):
                suffix[j] = (suffix[j + 1] + eqw[j]) % _P
            for d, tab in inc_parts:
                d = int(d) % _P
                for j, ups in enumerate(tab.updates):
                    w = suffix[j + 1] * d % _P
                    for k, dv in ups:
                        g[k] = (g[k] + w * dv) % _P
        return g

    return _open_j_then_k(params, s, make_g, point)


def open_dense_cube(params: CubeParams, dense: Sequence,
                    point: Sequence[Fr]) -> Tuple[Fr, MLOpeningProof]:
    """j-first opening of a DENSE (k, j) table (index = j*K + k) — the
    dense sound prover's counterpart of :func:`open_sparse`, producing
    byte-identical proofs to it on equal data.  Requires the deterministic
    factorized SRS (the scalars need tau_k)."""
    log_k, log_t = params.log_k, params.log_t
    k_size = 1 << log_k
    if len(dense) != (k_size << log_t):
        raise CommitmentError("dense cube table has wrong size")
    vals = [int(v) % _P for v in dense]
    eqk = params.eqk_tables[0]
    s = [
        sum(vals[j * k_size + k] * eqk[k] for k in range(k_size)) % _P
        for j in range(1 << log_t)
    ]

    def make_g(eqw) -> List[int]:
        eqw = list(eqw)
        return [
            sum(eqw[j] * vals[j * k_size + k] for j in range(1 << log_t)) % _P
            for k in range(k_size)
        ]

    return _open_j_then_k(params, s, make_g, point)
