"""Multi-chip sharding: hypercube-partitioned MLEs + sharded MSM over a mesh.

The scale-out layer (SURVEY §2 "Parallelism strategies", §5 long-context /
communication rows, §7.1 step 9).  The reference's only parallelism is rayon
``par_iter`` over MLE tables (polynomials.rs:92); here that one axis maps
onto a real device mesh:

  * **MLE tables** ``(22, N)`` are block-sharded on the lane axis over a 1-D
    ``Mesh(axis='data')``.  Because lanes are little-endian hypercube
    indices, contiguous blocks correspond to the SLOWEST variables: folding
    variable 0 (the sum-check round variable) touches only adjacent lanes
    inside a shard — zero communication, halving each shard.
  * **Round evaluations** g(0..3) are shard-local partial sums followed by
    one exact limb-wise ``psum`` over the mesh.  Limb sums of < 2p values
    across <= 2^13 devices stay far below int32 range, and a single
    normalize+reduce after the psum restores canonical planes — the
    collective itself needs no bignum semantics.
  * **MSM** partitions points: the 254-step double-and-add is purely lane-
    local; each shard tree-reduces locally to one partial point, and the D
    partials are added on the host (``combine_partials``).

``prover_step`` builds the full jitted multi-chip sum-check+MSM step used by
``__graft_entry__.dryrun_multichip`` — real shardings, one compiled module.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..field.fr_jax import fq_ops, fr_ops
from ..field.limbs import LIMB_BITS, LIMB_MASK, NUM_LIMBS

fr = fr_ops
fq = fq_ops

L = NUM_LIMBS
B = LIMB_BITS
MASK = LIMB_MASK


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    """A 1-D mesh over all (or the given) devices."""
    devices = list(jax.devices() if devices is None else devices)
    return Mesh(np.array(devices), (axis,))


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None) -> None:
    """Initialize jax.distributed for a multi-host run.

    Call once per host before building meshes; afterwards ``jax.devices()``
    spans every host and the shard_map paths below run unchanged, over
    the in-host links (NVLink between GPUs) and the network across hosts.  Arguments default to the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars.
    No-op when already initialized or single-process.
    """
    import jax

    try:
        if coordinator or num_processes:
            jax.distributed.initialize(
                coordinator_address=coordinator,
                num_processes=num_processes,
                process_id=process_id,
            )
        else:
            jax.distributed.initialize()
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process environment


def make_mesh_2d(ici: int, dcn: int, ici_axis: str = "ici",
                 dcn_axis: str = "dcn") -> Mesh:
    """A (dcn, ici) mesh: the fast axis spans the devices of one host, the
    slow axis the hosts.  Shard MLE lanes over the flattened ('dcn', 'ici')
    product axis; psum_field reduces hierarchically (XLA lowers the single
    psum to an in-host reduce + a cross-host exchange)."""
    devices = np.array(jax.devices()[: ici * dcn]).reshape(dcn, ici)
    return Mesh(devices, (dcn_axis, ici_axis))


# ---------------------------------------------------------------------------
# Exact field psum: limb-wise integer psum + renormalization
# ---------------------------------------------------------------------------

def _renorm_mod(t: jnp.ndarray, p_np: np.ndarray, rounds: int = 9) -> jnp.ndarray:
    """Bring limb planes with limbs < 2^31 back to a < 2p normalized value.

    After a psum of D shards of 2p-domain values, the (L,) limb sums encode
    an integer < D * 2p with limbs < D * 2^12.  A carry normalize leaves the
    value in L limbs (D <= 256 keeps it under 2^264, the layout capacity);
    conditional subtracts of p * 2^k for k = rounds..0 then reduce into
    [0, 2p).  Supports mesh axes up to 256 devices.
    """
    # carry-normalize into L limbs + overflow captured in extra limbs
    planes = [t[i] for i in range(t.shape[0])]
    out = []
    carry = None
    for limb in planes:
        v = limb if carry is None else limb + carry
        carry = v >> B
        out.append(v & MASK)
    # overflow carry: value = out + carry * 2^(B*L).  carry < D small.
    # 2^(B*L) mod p is a constant; add carry * that constant (limb planes).
    from ..field.limbs import int_to_limbs

    p_int = 0
    for i in range(p_np.shape[0]):
        p_int += int(p_np[i, 0]) << (B * i)
    r_mod = (1 << (B * L)) % p_int
    r_planes = np.asarray(int_to_limbs(r_mod), dtype=np.int32)[:, None]
    acc = jnp.stack(out) + carry[None] * r_planes
    # acc limbs < 2^12 + D * 2^12; renormalize then subtract shifted moduli
    planes = [acc[i] for i in range(L)]
    out = []
    carry = None
    for limb in planes:
        v = limb if carry is None else limb + carry
        carry = v >> B
        out.append(v & MASK)
    acc = jnp.stack(out)  # value < (D+1) * 2p, fits L limbs for D << 2^8

    for k in range(rounds, -1, -1):
        m = (p_int << k)
        if m >= (1 << (B * L)):
            continue
        m_planes = np.asarray(int_to_limbs(m), dtype=np.int32)[:, None]
        d = acc - m_planes
        rows = [d[i] for i in range(L)]
        outr = []
        carry = None
        for limb in rows:
            v = limb if carry is None else limb + carry
            carry = v >> B
            outr.append(v & MASK)
        ge = carry >= 0
        acc = jnp.where(ge[None], jnp.stack(outr), acc)
    return acc


def psum_field(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Exact field-element psum across a mesh axis (inside shard_map)."""
    s = lax.psum(x, axis_name)
    return _renorm_mod(s, fr.p_planes)


# ---------------------------------------------------------------------------
# Sharded sum-check round (product-of-MLEs oracle)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def sharded_round_step(mesh: Mesh, num_factors: int, axis: str = "data"):
    """Build a jitted sharded round step: tables block-sharded on lanes.

    Returns fn(tables, r) -> (g_evals (22,4) replicated, folded tables).
    Requires shard_size >= 2 lanes (fold halves each shard).

    All the step builders below are lru_cached on their (hashable) build
    arguments: a fresh closure per oracle instance would defeat jax.jit's
    per-function shape cache, re-tracing every shape for every oracle.
    """
    from ..poly import mle_jax

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(tuple([P(None, axis)] * num_factors), P(None, None)),
        out_specs=(P(None, None), tuple([P(None, axis)] * num_factors)),
        check_vma=False,
    )
    def step(tables, r):
        evals_local = mle_jax.product_round_evals(list(tables))
        evals = psum_field(evals_local, axis)
        folded = tuple(mle_jax.fold(t, r) for t in tables)
        return evals, folded

    return jax.jit(step)


@lru_cache(maxsize=32)
def sharded_fold_step(mesh: Mesh, num_factors: int, axis: str = "data"):
    """Jitted shard-local fold of all factor tables (no collectives)."""
    from ..poly import mle_jax

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(tuple([P(None, axis)] * num_factors), P(None, None)),
        out_specs=tuple([P(None, axis)] * num_factors),
        check_vma=False,
    )
    def step(tables, r):
        return tuple(mle_jax.fold(t, r) for t in tables)

    return jax.jit(step)


@lru_cache(maxsize=32)
def sharded_evals_step(mesh: Mesh, num_factors: int, axis: str = "data"):
    """Jitted sharded round evaluations: local partial sums + exact psum."""
    from ..poly import mle_jax

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(tuple([P(None, axis)] * num_factors),),
        out_specs=P(None, None),
        check_vma=False,
    )
    def step(tables):
        return psum_field(mle_jax.product_round_evals(list(tables)), axis)

    return jax.jit(step)


from ..iop.sumcheck import SumcheckOracle


class ShardedProductMLEOracle(SumcheckOracle):
    """Multi-chip sum-check oracle: product of MLEs, hypercube-sharded.

    Drop-in for ``tnsh.iop.sumcheck.SumcheckOracle``: tables live
    block-sharded on the mesh; each round computes g(0..3) with shard-local
    partial sums + one exact psum, and binds the challenge with a
    shard-local fold.  When the folded tables shrink below 2 lanes/device,
    the tail rounds run replicated on a single device.  Produces
    bit-identical proofs to the host ``ProductMLEOracle`` (tested on the
    virtual CPU mesh).
    """

    def __init__(self, factors, mesh: Mesh = None, axis: str = "data"):
        import jax.numpy as jnp

        from ..iop.sumcheck import SumCheckError
        from ..poly import mle_jax

        self._m = mle_jax
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        self.n_devices = int(np.prod([self.mesh.shape[a] for a in self.mesh.axis_names]))
        if not factors:
            raise SumCheckError("ShardedProductMLEOracle needs >= 1 factor")
        self.num_vars = factors[0].num_vars
        for f in factors:
            if f.num_vars != self.num_vars:
                raise SumCheckError("factor num_vars mismatch")
        shard = NamedSharding(self.mesh, P(None, axis))
        self.tables = tuple(
            jax.device_put(jnp.asarray(mle_jax.pack_mle(f.evaluations)), shard)
            for f in factors
        )
        self._evals_fn = sharded_evals_step(self.mesh, len(factors), axis)
        self._fold_fn = sharded_fold_step(self.mesh, len(factors), axis)

    def _sharded_ok(self) -> bool:
        return self.tables[0].shape[1] >= 2 * self.n_devices

    def round_evaluations(self, round_index: int):
        if self._sharded_ok():
            evals = self._evals_fn(self.tables)
        else:
            evals = self._m.product_round_evals_jit(list(self.tables), None)
        return self._m.unpack_fr(evals)

    def bind(self, challenge) -> None:
        import jax.numpy as jnp

        r = jnp.asarray(self._m.pack_fr_scalar(challenge))
        if self._sharded_ok():
            self.tables = self._fold_fn(self.tables, r)
        else:
            self.tables = tuple(self._m.fold_jit(t, r) for t in self.tables)

    def final_evaluation(self, challenges):
        from ..field.fr import Fr

        prod = Fr(1)
        for t in self.tables:
            prod = prod * self._m.unpack_fr(t)[0]
        return prod


@lru_cache(maxsize=32)
def sharded_sop_evals_step(mesh: Mesh, num_tables: int, term_idxs,
                           axis: str = "data"):
    """Jitted sharded sum-of-products round evaluations (sound-mode
    constraints): shard-local partial sums + one exact psum."""
    from ..poly import mle_jax

    num_terms = len(term_idxs)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            tuple([P(None, axis)] * num_tables),
            tuple([P(None, None)] * num_terms),
        ),
        out_specs=P(None, None),
        check_vma=False,
    )
    def step(tables, coeffs):
        local = mle_jax.sum_of_products_round_evals(
            list(tables), list(coeffs), term_idxs
        )
        return psum_field(local, axis)

    return jax.jit(step)


class ShardedSumOfProductsOracle(SumcheckOracle):
    """Multi-chip sum-of-products oracle — the sound-mode constraint
    sum-checks (tnsh.protocols.sound) on a device mesh.

    Same sharding discipline as ``ShardedProductMLEOracle``: tables
    block-sharded on lanes, rounds are shard-local + one psum, folds are
    communication-free.  Once shards would drop below 2 lanes — or after
    ``max_sharded_rounds`` binds (a compile-budget cap: every sharded
    round is a fresh shard_map shape, ~15-35 s of XLA compile on a cold
    virtual-CPU mesh) — the tail delegates to the exact host/native
    ``SumOfProductsOracle`` built from the folded tables: zero further
    compiles, bit-identical arithmetic.  Proofs are bit-identical to the
    host oracle's in all configurations (virtual-mesh tested).
    """

    def __init__(self, num_vars: int, terms, mesh: Mesh = None,
                 axis: str = "data", max_sharded_rounds: int = None):
        import jax.numpy as jnp

        from ..field.fr import MODULUS, Fr
        from ..iop.sumcheck import SumCheckError
        from ..poly import mle_jax

        self._m = mle_jax
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        self.n_devices = int(
            np.prod([self.mesh.shape[a] for a in self.mesh.axis_names])
        )
        self.num_vars = num_vars
        size = 1 << num_vars
        shard = NamedSharding(self.mesh, P(None, axis))
        tables = []
        coeffs = []
        idxs_list = []
        seen = {}
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                key = id(t)
                if key not in seen:
                    if len(t) != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(tables)
                    tables.append(
                        jax.device_put(
                            jnp.asarray(
                                mle_jax.pack_mle(
                                    [Fr(int(v) % MODULUS) for v in t]
                                )
                            ),
                            shard,
                        )
                    )
                idxs.append(seen[key])
            coeffs.append(
                jnp.asarray(
                    mle_jax.pack_fr_scalar(Fr(int(coeff) % MODULUS))
                )
            )
            idxs_list.append(tuple(idxs))
        if not idxs_list:
            raise SumCheckError("ShardedSumOfProductsOracle needs a term")
        self.tables = tuple(tables)
        self._coeffs = tuple(coeffs)
        self._idxs = tuple(idxs_list)
        self._max_sharded = max_sharded_rounds
        self._rounds = 0
        self._host = None
        self._evals_fn = sharded_sop_evals_step(
            self.mesh, len(tables), self._idxs, axis
        )
        self._fold_fn = sharded_fold_step(self.mesh, len(tables), axis)

    def _would_shard(self, rounds_done: int) -> bool:
        if self._max_sharded is not None and rounds_done >= self._max_sharded:
            return False
        return self.tables[0].shape[1] >= 2 * self.n_devices

    def _build_host(self):
        """Exact host/native tail oracle from the current folded tables."""
        from ..iop.sumcheck import SumOfProductsOracle

        lists = [
            [int(v) for v in self._m.unpack_fr(t)] for t in self.tables
        ]
        terms = [
            (int(self._m.unpack_fr(c)[0]), [lists[i] for i in idxs])
            for c, idxs in zip(self._coeffs, self._idxs)
        ]
        self._host = SumOfProductsOracle(
            self.num_vars - self._rounds, terms
        )

    def round_evaluations(self, round_index: int):
        if self._host is not None:
            return self._host.round_evaluations(round_index)
        if self._would_shard(self._rounds):
            evals = self._evals_fn(self.tables, self._coeffs)
            return self._m.unpack_fr(evals)
        self._build_host()
        return self._host.round_evaluations(round_index)

    def bind(self, challenge) -> None:
        import jax.numpy as jnp

        if self._host is None and self._would_shard(self._rounds + 1):
            r = jnp.asarray(self._m.pack_fr_scalar(challenge))
            self.tables = self._fold_fn(self.tables, r)
        else:
            if self._host is None:
                self._build_host()
            self._host.bind(challenge)
        self._rounds += 1

    def final_evaluation(self, challenges):
        if self._host is not None:
            return self._host.final_evaluation(challenges)
        from ..field.fr import MODULUS, Fr

        finals = [int(self._m.unpack_fr(t)[0]) for t in self.tables]
        total = 0
        for coeff, idxs in zip(self._coeffs, self._idxs):
            prod = int(self._m.unpack_fr(coeff)[0])
            for f in idxs:
                prod = prod * finals[f] % MODULUS
            total += prod
        return Fr(total % MODULUS)


def sharded_sopd_evals_step(mesh: Mesh, num_tables: int, term_idxs,
                            npts: int, axis: str = "data"):
    """Jitted sharded GENERIC-DEGREE sum-of-products round evaluations
    (the bit-column protocols' j-phase): shard-local partial sums at
    X = 0..npts-1 + one exact psum."""
    from ..poly import mle_jax

    num_terms = len(term_idxs)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            tuple([P(None, axis)] * num_tables),
            tuple([P(None, None)] * num_terms),
        ),
        out_specs=P(None, None),
        check_vma=False,
    )
    def step(tables, coeffs):
        local = mle_jax.sum_of_products_round_evals_d(
            list(tables), list(coeffs), term_idxs, npts
        )
        return psum_field(local, axis)

    return jax.jit(step)


class ShardedSopOracleD(SumcheckOracle):
    """Multi-chip GENERIC-DEGREE sum-of-products oracle — the bit-column
    sound protocols' j-phase (tnsh.protocols.twist_bits, round degree
    logK+3) on a device mesh.

    Identical discipline to ``ShardedSumOfProductsOracle``: tables
    block-sharded on lanes, rounds shard-local + one exact psum, folds
    communication-free; after ``max_sharded_rounds`` binds (compile
    budget) or once shards would drop below 2 lanes, the tail delegates
    to the host generic-degree oracle (native C++ when available) built
    from the folded tables.  Proofs are bit-identical to the host
    oracle's in every configuration (virtual-mesh tested; exact
    arithmetic end to end)."""

    def __init__(self, num_vars: int, terms, degree: int,
                 mesh: Mesh = None, axis: str = "data",
                 max_sharded_rounds: int = None):
        from ..field.fr import MODULUS, Fr
        from ..iop.sumcheck import SumCheckError
        from ..poly import mle_jax

        self._m = mle_jax
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        self.n_devices = int(
            np.prod([self.mesh.shape[a] for a in self.mesh.axis_names])
        )
        self.num_vars = num_vars
        size = 1 << num_vars
        shard = NamedSharding(self.mesh, P(None, axis))
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
                    tables.append(
                        jax.device_put(
                            jnp.asarray(
                                mle_jax.pack_mle(
                                    [Fr(int(v) % MODULUS) for v in t]
                                )
                            ),
                            shard,
                        )
                    )
                idxs.append(seen[key])
            coeffs.append(
                jnp.asarray(
                    mle_jax.pack_fr_scalar(Fr(int(coeff) % MODULUS))
                )
            )
            idxs_list.append(tuple(idxs))
            max_deg = max(max_deg, len(idxs))
        if not idxs_list:
            raise SumCheckError("ShardedSopOracleD needs a term")
        if degree < max_deg:
            raise SumCheckError("declared degree below term degree")
        self.degree = degree
        self.tables = tuple(tables)
        self._coeffs = tuple(coeffs)
        self._idxs = tuple(idxs_list)
        self._max_sharded = max_sharded_rounds
        self._rounds = 0
        self._host = None
        self._evals_fn = sharded_sopd_evals_step(
            self.mesh, len(tables), self._idxs, degree + 1, axis
        )
        self._fold_fn = sharded_fold_step(self.mesh, len(tables), axis)

    def _would_shard(self, rounds_done: int) -> bool:
        if self._max_sharded is not None and rounds_done >= self._max_sharded:
            return False
        return self.tables[0].shape[1] >= 2 * self.n_devices

    def _build_host(self):
        """Exact host tail oracle (native generic-degree sop when
        available) from the current folded tables."""
        from ..iop.sumcheck_d import make_sopd_oracle

        lists = [
            [int(v) for v in self._m.unpack_fr(t)] for t in self.tables
        ]
        terms = [
            (int(self._m.unpack_fr(c)[0]), [lists[i] for i in idxs])
            for c, idxs in zip(self._coeffs, self._idxs)
        ]
        self._host = make_sopd_oracle(
            self.num_vars - self._rounds, terms, self.degree
        )

    def round_evaluations(self, round_index: int):
        if self._host is not None:
            return self._host.round_evaluations(round_index)
        if self._would_shard(self._rounds):
            evals = self._evals_fn(self.tables, self._coeffs)
            return self._m.unpack_fr(evals)
        self._build_host()
        return self._host.round_evaluations(round_index)

    def bind(self, challenge) -> None:
        if self._host is None and self._would_shard(self._rounds + 1):
            r = jnp.asarray(self._m.pack_fr_scalar(challenge))
            self.tables = self._fold_fn(self.tables, r)
        else:
            if self._host is None:
                self._build_host()
            self._host.bind(challenge)
        self._rounds += 1

    def final_evaluation(self, challenges):
        if self._host is not None:
            return self._host.final_evaluation(challenges)
        from ..field.fr import MODULUS, Fr

        finals = [int(self._m.unpack_fr(t)[0]) for t in self.tables]
        total = 0
        for coeff, idxs in zip(self._coeffs, self._idxs):
            prod = int(self._m.unpack_fr(coeff)[0])
            for f in idxs:
                prod = prod * finals[f] % MODULUS
            total += prod
        return Fr(total % MODULUS)


class ShardedSparseCubeOracle(SumcheckOracle):
    """Column-sharded sparse cube oracle — the sound provers' k-phase
    oracle (tnsh.iop.sparse_oracle) decomposed over the mesh axis.

    Cycles (the j columns) partition into contiguous slices, one per
    device; contiguous slices fix the SLOWEST j bits, so every shard's
    tables stay local through all k rounds and the first log(T/n) j
    rounds.  Per k round:

      * each shard seeds its colinc scan (and class-I running sums) with
        the exclusive prefix of earlier shards' delta totals — on a pod
        this is one log-depth exclusive-scan collective of K_rem-sized
        field vectors per round, O(K) bytes per hop;
      * shard-local scans produce partial round evaluations that combine
        by ONE exact field sum (a psum).

    After the k binds, each shard's slice collapses to T/n-sized dense
    tables; their concatenation feeds one mesh-wide
    ``ShardedSumOfProductsOracle`` (real shard_map + psum), so the j
    phase runs on-device.  Bit-identical round polynomials to the host
    ``SparseCubeOracle`` (asserted by ``__graft_entry__.dryrun_multichip``
    and tests/test_mesh.py).

    The shard scans here run serially in-process (one host, virtual
    devices); on a real multi-host pod each host runs its native scan on
    its own slice — the decomposition and the collectives are what this
    class pins down.
    """

    def __init__(self, log_k: int, log_t: int, terms, mesh: Mesh = None,
                 axis: str = "data", max_sharded_rounds: int = None):
        from ..commit.mkzg_sparse import (
            IncrementalCubeTable,
            SparseCubeTable,
        )
        from ..iop.sparse_oracle import SparseCubeOracle
        from ..iop.sumcheck import SumCheckError

        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        self._max_sharded = max_sharded_rounds
        n_dev = int(
            np.prod([self.mesh.shape[a] for a in self.mesh.axis_names])
        )
        if n_dev & (n_dev - 1):
            raise SumCheckError("mesh device count must be a power of two")
        log_n = n_dev.bit_length() - 1
        if log_t <= log_n:
            raise SumCheckError(
                f"need log_t > log2(devices) ({log_t} <= {log_n})"
            )
        self.log_k = log_k
        self.log_t = log_t
        self.num_vars = log_k + log_t
        self._round = 0
        self._delegate = None
        slice_log_t = log_t - log_n
        s = 1 << slice_log_t

        # slice every payload once (shared payloads stay shared per shard
        # so the per-shard identity dedupe still applies)
        slice_cache: dict = {}

        def sliced(kind, payload, c):
            key = (id(payload), c)
            got = slice_cache.get(key)
            if got is not None:
                return got
            if kind == "eqj":
                out = list(payload[c * s:(c + 1) * s])
            elif kind == "eqk":
                out = payload  # k tables replicate across shards
            elif kind == "colsparse":
                out = SparseCubeTable(log_k, slice_log_t)
                out.cols = [list(col) for col in
                            payload.cols[c * s:(c + 1) * s]]
            elif kind == "colinc":
                out = IncrementalCubeTable(log_k, slice_log_t)
                out.updates = [list(u) for u in
                               payload.updates[c * s:(c + 1) * s]]
            else:
                raise SumCheckError(f"unknown factor kind {kind}")
            slice_cache[key] = out
            return out

        self.shards = []
        for c in range(n_dev):
            shard_terms = [
                (coeff, [(kind, sliced(kind, payload, c))
                         for kind, payload in factors])
                for coeff, factors in terms
            ]
            self.shards.append(
                SparseCubeOracle(log_k, slice_log_t, shard_terms,
                                 use_native=False)
            )

    def _seed_shards(self) -> None:
        """Exclusive prefix of shard-local colinc delta totals at the
        current fold level (the per-round scan collective)."""
        from ..field.fr import MODULUS

        n_inc = len(self.shards[0]._inc)
        k_rem = self.shards[0]._k_rem
        prefix = [[0] * k_rem for _ in range(n_inc)]
        for sh in self.shards:
            sh.set_colinc_start([list(vec) for vec in prefix])
            for ii, ups in enumerate(sh._inc):
                vec = prefix[ii]
                for col in ups:
                    for pos, d in col:
                        vec[pos] = (vec[pos] + d) % MODULUS
        self._final_prefix = prefix

    def round_evaluations(self, round_index: int):
        from ..field.fr import MODULUS, Fr

        if self._round < self.log_k:
            self._seed_shards()
            acc = [0, 0, 0, 0]
            for sh in self.shards:
                ev = sh._k_round_evals()
                for x in range(4):
                    acc[x] = (acc[x] + int(ev[x])) % MODULUS
            return [Fr(v) for v in acc]  # the psum
        if self._delegate is None:
            self._build_delegate()
        return self._delegate.round_evaluations(round_index - self.log_k)

    def bind(self, challenge) -> None:
        if self._round < self.log_k:
            for sh in self.shards:
                sh._k_bind(challenge)
        else:
            if self._delegate is None:
                self._build_delegate()
            self._delegate.bind(challenge)
        self._round += 1

    def _build_delegate(self) -> None:
        """Concatenate the shards' T/n-sized j-phase tables into ONE
        mesh-wide sum-of-products oracle (tables block-shard exactly along
        the slice boundaries)."""
        from ..iop.sumcheck import SumCheckError

        self._seed_shards()  # final (K_rem = 1) colinc start scalars
        per_shard = [sh._delegate_terms() for sh in self.shards]
        cat_cache: dict = {}
        terms = []
        for t_idx, (coeff, tabs0) in enumerate(per_shard[0]):
            cat_tabs = []
            for f_idx in range(len(tabs0)):
                key = tuple(id(p[t_idx][1][f_idx]) for p in per_shard)
                got = cat_cache.get(key)
                if got is None:
                    got = []
                    for p in per_shard:
                        got.extend(p[t_idx][1][f_idx])
                    cat_cache[key] = got
                cat_tabs.append(got)
            for p in per_shard[1:]:
                if p[t_idx][0] != coeff:
                    raise SumCheckError("shard coeff divergence")
            terms.append((coeff, cat_tabs))
        self._delegate = ShardedSumOfProductsOracle(
            self.log_t, terms, self.mesh, self.axis,
            max_sharded_rounds=self._max_sharded,
        )

    def final_evaluation(self, challenges):
        if self._delegate is None:
            self._build_delegate()
        return self._delegate.final_evaluation(challenges)


# ---------------------------------------------------------------------------
# Sharded MSM
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def sharded_msm_fn(mesh: Mesh, axis: str = "data"):
    """Build a jitted sharded MSM: points/scalars block-sharded on lanes.

    Each device runs the 254-bit double-and-add + local tree reduction on
    its block.  Returns (X, Y, Z), each (L, D): column d is device d's
    Jacobian partial sum, which :func:`combine_partials` adds on the host.
    (Adding the D partials on the device would put a second group-law tree
    in the program, and XLA's GPU compile time grows with every group-law
    instance.)
    """
    from ..commit.msm_jax import _msm_kernel

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis,), P(None, axis)),
        out_specs=(P(None, axis), P(None, axis), P(None, axis)),
        check_vma=False,
    )
    def msm(xs, ys, valid, bits):
        return _msm_kernel(xs, ys, valid, bits)  # (L, 1) local partial

    return jax.jit(msm)


def combine_partials(X, Y, Z):
    """Host sum of the (L, D) per-device partials of :func:`sharded_msm_fn`."""
    from ..commit.msm_jax import _jacobian_to_g1
    from ..field.g1 import G1

    X, Y, Z = np.asarray(X), np.asarray(Y), np.asarray(Z)
    acc = G1.zero()
    for d in range(X.shape[1]):
        acc = acc.add(_jacobian_to_g1(X[:, d:d + 1], Y[:, d:d + 1],
                                      Z[:, d:d + 1]))
    return acc


# ---------------------------------------------------------------------------
# Full multi-chip prover step (dryrun + production entry)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def build_sharded_prover_step(mesh: Mesh, num_factors: int = 3, axis: str = "data"):
    """One fused multi-chip Twist prover step:

      1. sum-check round evaluations over the sharded factor tables (local
         partial sums + exact psum),
      2. bind the round challenge (shard-local fold),
      3. a sharded MSM partial over the (sharded) SRS block.

    This is the "training step" analog the multi-chip dryrun compiles: it
    exercises data-sharded compute, a psum collective, an all-gather and
    replicated outputs in a single jitted module.
    """
    from ..commit.msm_jax import _msm_kernel, tree_reduce_points
    from ..poly import mle_jax

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            tuple([P(None, axis)] * num_factors),  # MLE tables
            P(None, None),                         # round challenge r
            P(None, axis),                         # SRS x
            P(None, axis),                         # SRS y
            P(axis,),                              # valid mask
            P(None, axis),                         # scalar bits
        ),
        out_specs=(
            P(None, None),
            tuple([P(None, axis)] * num_factors),
            (P(None, None), P(None, None), P(None, None)),
        ),
        check_vma=False,
    )
    def step(tables, r, xs, ys, valid, bits):
        evals_local = mle_jax.product_round_evals(list(tables))
        evals = psum_field(evals_local, axis)
        folded = tuple(mle_jax.fold(t, r) for t in tables)
        X, Y, Z = _msm_kernel(xs, ys, valid, bits)
        Xg = lax.all_gather(X[:, 0], axis, axis=1)
        Yg = lax.all_gather(Y[:, 0], axis, axis=1)
        Zg = lax.all_gather(Z[:, 0], axis, axis=1)
        Xr, Yr, Zr = tree_reduce_points(Xg, Yg, Zg)
        return evals, folded, (Xr[:, :1], Yr[:, :1], Zr[:, :1])

    return jax.jit(step)
