"""JAX device backend tests: exactness vs the host golden path, single-device
and on the virtual 8-device CPU mesh (conftest forces platform + devices)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tnsh.core.transcript import Transcript
from tnsh.field.fr import MODULUS, Fr
from tnsh.field.g1 import G1
from tnsh.field.limbs import (
    FQ_SPEC,
    FR_SPEC,
    pack_ints,
    pack_scalar_bits,
    unpack_ints,
)
from tnsh.field.fr_jax import fr_add, fr_mont_mul, fr_ops, fr_sub
from tnsh.iop.sumcheck import JaxProductMLEOracle, ProductMLEOracle, SumCheck
from tnsh.poly import mle_jax
from tnsh.poly.mle import MultilinearExtension


class TestFieldKernels:
    def test_mont_mul_exact(self):
        random.seed(11)
        p = FR_SPEC.modulus
        xs = [random.randrange(p) for _ in range(50)] + [0, 1, p - 1, p - 2]
        ys = [random.randrange(p) for _ in range(50)] + [p - 1, 0, p - 1, 1]
        ax = jnp.asarray(pack_ints(xs, FR_SPEC))
        ay = jnp.asarray(pack_ints(ys, FR_SPEC))
        got = unpack_ints(np.asarray(fr_mont_mul(ax, ay)), FR_SPEC)
        assert got == [x * y % p for x, y in zip(xs, ys)]

    def test_add_sub_exact(self):
        random.seed(12)
        p = FR_SPEC.modulus
        xs = [random.randrange(p) for _ in range(32)]
        ys = [random.randrange(p) for _ in range(32)]
        ax = jnp.asarray(pack_ints(xs, FR_SPEC))
        ay = jnp.asarray(pack_ints(ys, FR_SPEC))
        assert unpack_ints(np.asarray(fr_add(ax, ay)), FR_SPEC) == [
            (x + y) % p for x, y in zip(xs, ys)
        ]
        assert unpack_ints(np.asarray(fr_sub(ax, ay)), FR_SPEC) == [
            (x - y) % p for x, y in zip(xs, ys)
        ]

    def test_chained_2p_domain(self):
        # (a*b + a - b) * b stays exact across the lazy-reduction domain.
        random.seed(13)
        p = FR_SPEC.modulus
        xs = [random.randrange(p) for _ in range(16)]
        ys = [random.randrange(p) for _ in range(16)]
        ax = jnp.asarray(pack_ints(xs, FR_SPEC))
        ay = jnp.asarray(pack_ints(ys, FR_SPEC))
        f = jax.jit(
            lambda a, b: fr_ops.mont_mul(
                fr_ops.sub(fr_ops.add(fr_ops.mont_mul(a, b), a), b), b
            )
        )
        got = unpack_ints(np.asarray(f(ax, ay)), FR_SPEC)
        assert got == [(x * y % p + x - y) * y % p for x, y in zip(xs, ys)]

    def test_fq_kernels(self):
        random.seed(14)
        q = FQ_SPEC.modulus
        from tnsh.field.fr_jax import fq_ops

        xs = [random.randrange(q) for _ in range(8)]
        ax = jnp.asarray(pack_ints(xs, FQ_SPEC))
        got = unpack_ints(np.asarray(jax.jit(fq_ops.mont_mul)(ax, ax)), FQ_SPEC)
        assert got == [x * x % q for x in xs]


class TestMLEKernels:
    def _mle(self, n_vars, seed):
        random.seed(seed)
        return MultilinearExtension.from_evaluations(
            [Fr(random.randrange(MODULUS)) for _ in range(1 << n_vars)]
        )

    def test_fold_matches_host(self):
        mle = self._mle(4, 21)
        r = Fr(123456789123456789)
        table = jnp.asarray(mle_jax.pack_mle(mle.evaluations))
        folded = mle_jax.fold_jit(table, jnp.asarray(mle_jax.pack_fr_scalar(r)))
        host = mle.partial_evaluate([r])
        assert mle_jax.unpack_fr(folded) == host.evaluations

    def test_evaluate_matches_host(self):
        mle = self._mle(5, 22)
        random.seed(23)
        point = [Fr(random.randrange(MODULUS)) for _ in range(5)]
        table = jnp.asarray(mle_jax.pack_mle(mle.evaluations))
        out = mle_jax.evaluate(
            table, [jnp.asarray(mle_jax.pack_fr_scalar(r)) for r in point]
        )
        assert mle_jax.unpack_fr(out)[0] == mle.evaluate(point)

    def test_sum_tree_matches_host(self):
        mle = self._mle(6, 24)
        table = jnp.asarray(mle_jax.pack_mle(mle.evaluations))
        assert mle_jax.unpack_fr(mle_jax.sum_tree_jit(table))[0] == (
            mle.sum_evaluations()
        )


class TestJaxSumcheckOracle:
    def test_identical_proofs_to_host_oracle(self):
        random.seed(31)
        n = 4
        evals_a = [Fr(random.randrange(MODULUS)) for _ in range(1 << n)]
        evals_b = [Fr(random.randrange(MODULUS)) for _ in range(1 << n)]
        mle_a = MultilinearExtension.from_evaluations(evals_a)
        mle_b = MultilinearExtension.from_evaluations(evals_b)
        total = Fr(sum(int(a) * int(b) for a, b in zip(evals_a, evals_b)))
        sc = SumCheck(n, total)
        seed = bytes([42]) * 32
        host_proof = sc.prove(ProductMLEOracle([mle_a, mle_b]), Transcript(seed))
        jax_proof = sc.prove(
            JaxProductMLEOracle([mle_a, mle_b]), Transcript(seed)
        )
        assert host_proof.round_polynomials == jax_proof.round_polynomials
        assert host_proof.final_evaluation == jax_proof.final_evaluation
        ok, _ = sc.verify(jax_proof, Transcript(seed))
        assert ok


class TestJaxSumOfProducts:
    def test_identical_proofs_to_host_and_native(self):
        from tnsh.iop.sumcheck import JaxSumOfProductsOracle, SumOfProductsOracle

        random.seed(47)
        n = 4
        size = 1 << n
        t1 = [random.randrange(MODULUS) for _ in range(size)]
        t2 = [random.randrange(MODULUS) for _ in range(size)]
        t3 = [random.randrange(2) for _ in range(size)]
        terms = [(1, [t1, t2, t3]), (MODULUS - 1, [t1, t3]), (7, [t2])]
        total = Fr(
            sum(
                (a * b * c - a * c + 7 * b) % MODULUS
                for a, b, c in zip(t1, t2, t3)
            )
            % MODULUS
        )
        sc = SumCheck(n, total)
        seed = bytes([42]) * 32
        host_proof = sc.prove(SumOfProductsOracle(n, terms), Transcript(seed))
        jax_proof = sc.prove(
            JaxSumOfProductsOracle(n, terms), Transcript(seed)
        )
        assert host_proof.round_polynomials == jax_proof.round_polynomials
        assert host_proof.final_evaluation == jax_proof.final_evaluation
        ok, _ = sc.verify(jax_proof, Transcript(seed))
        assert ok


class TestJaxMSM:
    def test_msm_exact(self):
        from tnsh.commit.kzg import msm as msm_host
        from tnsh.commit.msm_jax import msm_jax

        random.seed(41)
        g = G1.generator()
        points = [g * random.randrange(1, 10**9) for _ in range(8)]
        scalars = [Fr(random.randrange(MODULUS)) for _ in range(8)]
        assert msm_jax(points, scalars) == msm_host(points, scalars)

    def test_msm_edge_cases(self):
        from tnsh.commit.kzg import msm as msm_host
        from tnsh.commit.msm_jax import msm_jax

        g = G1.generator()
        pts = [g * 7, g * 7, G1.zero(), g * 3, g * 11]
        scs = [Fr(5), Fr(5), Fr(3), Fr(0), Fr(MODULUS - 1)]
        assert msm_jax(pts, scs) == msm_host(pts, scs)
        assert msm_jax([], []).is_zero()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
class TestMesh:
    def test_sharded_round_matches_host(self):
        from tnsh.parallel.mesh import make_mesh, sharded_round_step
        from jax.sharding import NamedSharding, PartitionSpec as P

        random.seed(51)
        n = 64
        evals = [
            [Fr(random.randrange(MODULUS)) for _ in range(n)] for _ in range(2)
        ]
        mles = [MultilinearExtension.from_evaluations(e) for e in evals]
        mesh = make_mesh(jax.devices()[:8])
        step = sharded_round_step(mesh, num_factors=2)
        shard = NamedSharding(mesh, P(None, "data"))
        tables = tuple(
            jax.device_put(jnp.asarray(mle_jax.pack_mle(e)), shard)
            for e in evals
        )
        r = Fr(424242)
        g_evals, folded = step(
            tables, jnp.asarray(mle_jax.pack_fr_scalar(r))
        )
        # Host comparison
        host = ProductMLEOracle(mles)
        host_evals = host.round_evaluations(0)
        assert mle_jax.unpack_fr(g_evals) == host_evals
        host.bind(r)
        for f_dev, t_host in zip(folded, host.tables):
            assert [int(v) for v in mle_jax.unpack_fr(f_dev)] == [
                v % MODULUS for v in t_host
            ]

    def test_sharded_msm_matches_host(self):
        from tnsh.commit.kzg import msm as msm_host
        from tnsh.commit.msm_jax import pack_g1_points
        from tnsh.parallel.mesh import (combine_partials, make_mesh,
                                        sharded_msm_fn)
        from jax.sharding import NamedSharding, PartitionSpec as P

        random.seed(52)
        g = G1.generator()
        n = 16
        points = [g * random.randrange(1, 10**9) for _ in range(n)]
        scalars = [Fr(random.randrange(MODULUS)) for _ in range(n)]
        mesh = make_mesh(jax.devices()[:8])
        fn = sharded_msm_fn(mesh)
        xs, ys, valid = pack_g1_points(points)
        bits = pack_scalar_bits([int(s) for s in scalars], num_bits=254)
        shard = NamedSharding(mesh, P(None, "data"))
        shard1 = NamedSharding(mesh, P("data"))
        X, Y, Z = fn(
            jax.device_put(jnp.asarray(xs), shard),
            jax.device_put(jnp.asarray(ys), shard),
            jax.device_put(jnp.asarray(valid), shard1),
            jax.device_put(jnp.asarray(bits), shard),
        )
        assert X.shape == (22, 8)
        assert combine_partials(X, Y, Z) == msm_host(points, scalars)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
class TestShardedOracle:
    def test_sharded_oracle_identical_proofs(self):
        from tnsh.parallel.mesh import ShardedProductMLEOracle, make_mesh

        random.seed(91)
        n = 6
        evals_a = [Fr(random.randrange(MODULUS)) for _ in range(1 << n)]
        evals_b = [Fr(random.randrange(MODULUS)) for _ in range(1 << n)]
        ma = MultilinearExtension.from_evaluations(evals_a)
        mb = MultilinearExtension.from_evaluations(evals_b)
        total = Fr(sum(int(a) * int(b) for a, b in zip(evals_a, evals_b)))
        sc = SumCheck(n, total)
        seed = bytes([42]) * 32
        host_proof = sc.prove(ProductMLEOracle([ma, mb]), Transcript(seed))
        mesh = make_mesh(jax.devices()[:8])
        sharded_proof = sc.prove(
            ShardedProductMLEOracle([ma, mb], mesh), Transcript(seed)
        )
        assert host_proof.round_polynomials == sharded_proof.round_polynomials
        assert host_proof.final_evaluation == sharded_proof.final_evaluation
        ok, _ = sc.verify(sharded_proof, Transcript(seed))
        assert ok

    def test_sharded_sop_oracle_identical_proofs(self):
        from tnsh.iop.sumcheck import SumOfProductsOracle
        from tnsh.parallel.mesh import ShardedSumOfProductsOracle, make_mesh

        random.seed(93)
        n = 6
        size = 1 << n
        t1 = [random.randrange(MODULUS) for _ in range(size)]
        t2 = [random.randrange(MODULUS) for _ in range(size)]
        t3 = [random.randrange(2) for _ in range(size)]
        terms = [(1, [t1, t2, t3]), (MODULUS - 1, [t1, t3]), (7, [t2])]
        total = Fr(
            sum(
                (a * b * c - a * c + 7 * b) % MODULUS
                for a, b, c in zip(t1, t2, t3)
            )
            % MODULUS
        )
        sc = SumCheck(n, total)
        seed = bytes([42]) * 32
        host_proof = sc.prove(SumOfProductsOracle(n, terms), Transcript(seed))
        mesh = make_mesh(jax.devices()[:8])
        sharded_proof = sc.prove(
            ShardedSumOfProductsOracle(n, terms, mesh), Transcript(seed)
        )
        assert host_proof.round_polynomials == sharded_proof.round_polynomials
        assert host_proof.final_evaluation == sharded_proof.final_evaluation
        ok, _ = sc.verify(sharded_proof, Transcript(seed))
        assert ok

    def test_sharded_sparse_cube_oracle_identical_proofs(self):
        """Column-sharded sparse cube oracle (the sound provers' k-phase
        decomposed over the mesh: exclusive-scan colinc seeding + psum
        round evals + mesh j phase) is bit-identical to the host oracle
        across a complete transcript-driven proof."""
        from tnsh.commit.mkzg_sparse import (
            IncrementalCubeTable,
            SparseCubeTable,
        )
        from tnsh.iop.sparse_oracle import SparseCubeOracle
        from tnsh.parallel.mesh import ShardedSparseCubeOracle, make_mesh

        random.seed(97)
        log_k, log_t = 3, 6
        sp = SparseCubeTable(log_k, log_t)
        inc = IncrementalCubeTable(log_k, log_t)
        for j in range(1 << log_t):
            sp.set(j, random.randrange(1 << log_k), 1)
            if j % 3:
                inc.add_update(
                    j, random.randrange(1 << log_k),
                    random.randrange(MODULUS),
                )
        eqj = [random.randrange(MODULUS) for _ in range(1 << log_t)]
        eqk = [random.randrange(MODULUS) for _ in range(1 << log_k)]
        terms = [
            (1, [("eqj", eqj), ("colsparse", sp), ("colinc", inc)]),
            (MODULUS - 2, [("eqk", eqk), ("colsparse", sp),
                           ("colsparse", sp)]),
            (3, [("eqk", eqk), ("colinc", inc)]),   # class I
            (5, [("eqj", eqj), ("eqk", eqk)]),      # class E
        ]
        n = log_k + log_t
        probe = SparseCubeOracle(log_k, log_t, terms)
        ev = probe.round_evaluations(0)
        total = ev[0] + ev[1]
        sc = SumCheck(n, total)
        seed = bytes([43]) * 32
        host_proof = sc.prove(
            SparseCubeOracle(log_k, log_t, terms), Transcript(seed)
        )
        mesh = make_mesh(jax.devices()[:8])
        sharded_proof = sc.prove(
            ShardedSparseCubeOracle(log_k, log_t, terms, mesh),
            Transcript(seed),
        )
        assert host_proof.round_polynomials == sharded_proof.round_polynomials
        assert host_proof.final_evaluation == sharded_proof.final_evaluation
        ok, _ = sc.verify(sharded_proof, Transcript(seed))
        assert ok


def test_sharded_sopd_oracle_identical_proofs():
    """ShardedSopOracleD (multi-chip GENERIC-DEGREE sop — the bit-column
    protocols' j-phase on the mesh) is bit-identical to the host
    generic-degree oracle across a complete transcript-driven proof."""
    import jax

    from tnsh.core.transcript import Transcript
    from tnsh.iop.sumcheck_d import DenseSopOracleD, SumCheckD
    from tnsh.parallel.mesh import ShardedSopOracleD, make_mesh

    random.seed(95)
    n = 6
    size = 1 << n
    t1 = [random.randrange(MODULUS) for _ in range(size)]
    t2 = [random.randrange(2) for _ in range(size)]
    t3 = [random.randrange(MODULUS) for _ in range(size)]
    terms = [
        (3, [t1, t2, t3, t1, t2]),           # degree-5 product
        (MODULUS - 5, [t2, t3]),
        (11, [t3, t3, t3]),
    ]
    degree = 5
    claim = DenseSopOracleD(n, terms, degree=degree).hypercube_sum()
    seed = bytes([43]) * 32
    host_proof, _ = SumCheckD(n, claim, degree).prove_with_challenges(
        DenseSopOracleD(n, terms, degree=degree), Transcript(seed)
    )
    mesh = make_mesh(jax.devices()[:8])
    sharded_proof, _ = SumCheckD(n, claim, degree).prove_with_challenges(
        ShardedSopOracleD(n, terms, degree, mesh), Transcript(seed)
    )
    assert [[int(c) for c in rp] for rp in host_proof.round_polynomials] \
        == [[int(c) for c in rp] for rp in sharded_proof.round_polynomials]
    assert int(host_proof.final_evaluation) == int(
        sharded_proof.final_evaluation
    )
    ok, _ = SumCheckD(n, claim, degree).verify(
        sharded_proof, Transcript(seed)
    )
    assert ok
