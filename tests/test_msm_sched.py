"""Equality tests for the cell-scheduled device Pippenger MSM (msm_sched).

Every case checks bit-identical group elements against the host golden MSM
(tnsh.commit.kzg.msm), per the backend-equality invariant.  XLA compiles the
same programs here for the CPU and in chip_smoke.py for the GPU.
"""

import random

import numpy as np
import pytest

import jax


@pytest.fixture(scope="module", autouse=True)
def _drop_prior_executables():
    """Free the executables compiled by earlier test modules before the
    scheduled-MSM kernels compile: with hundreds of compiled programs
    resident, XLA:CPU in jaxlib 0.9 has crashed loading this suite's
    largest executables.  Clearing the in-memory caches releases that
    code memory; the handful of later re-compiles is noise next to the
    crash."""
    jax.clear_caches()
    yield


from tnsh.field.fr import Fr, MODULUS
from tnsh.field.g1 import G1
from tnsh.commit.kzg import msm as host_msm
from tnsh.commit.msm_sched import (
    MsmPlan,
    ScheduledMsmContext,
    msm_scheduled,
    scalars_to_byte_matrix,
    signed_digits,
)


@pytest.fixture(scope="module")
def points():
    random.seed(101)
    g = G1.generator()
    pts = [g.scalar_mul(Fr(random.randrange(1, MODULUS))) for _ in range(48)]
    pts[5] = G1.zero()  # identity points must contribute nothing
    return pts


def test_signed_digits_reconstruct():
    random.seed(3)
    vals = [0, 1, 127, 128, 255, 256, MODULUS - 1] + [
        random.randrange(MODULUS) for _ in range(20)
    ]
    sb = scalars_to_byte_matrix([Fr(v) for v in vals], len(vals))
    d = signed_digits(sb)
    for j, v in enumerate(vals):
        acc = sum(int(d[w, j]) * (256 ** w) for w in range(d.shape[0]))
        assert acc == v


def test_signed_digits_adaptive_width():
    sb = scalars_to_byte_matrix([Fr(300), Fr(7)], 2)
    d = signed_digits(sb)
    assert d.shape[0] == 4  # 2 bytes used -> W=3 padded to 4


def test_plan_splits_heavy_buckets():
    d = np.zeros((4, 256), dtype=np.int8)
    d[0, :] = 5  # 256 identical digits: one group claims 256 lanes
    plan = MsmPlan(d, 256)
    assert plan.logk_map[0, 5] == 8
    assert plan.r_exact == 1
    d[0, :128] = 3  # two groups of 128 -> 128 lanes each, still 1 step
    plan = MsmPlan(d, 256)
    assert plan.logk_map[0, 3] == 7
    assert plan.logk_map[0, 5] == 7
    assert plan.r_exact == 1


def test_plan_full_width_uniform_keeps_single_lanes():
    rng = np.random.default_rng(0)
    d = rng.integers(-128, 128, (32, 4096), dtype=np.int8)
    plan = MsmPlan(d, 4096)
    # 32 windows x 128 magnitudes exactly fill the 4096-lane budget
    assert plan.r_exact >= 1
    assert int((1 << plan.logk_map[plan.base_map >= 0]).max()) <= 4096


@pytest.mark.parametrize(
    "name,make",
    [
        ("full", lambda n: [Fr(random.randrange(MODULUS)) for _ in range(n)]),
        ("small", lambda n: [Fr(random.randrange(1 << 26)) for _ in range(n)]),
        ("skewed", lambda n: [Fr(424242)] * n),
        ("sparse", lambda n: [Fr(0) if i % 3 else Fr(i) for i in range(n)]),
    ],
)
def test_msm_matches_host(points, name, make):
    random.seed(hash(name) % (1 << 30))
    scalars = make(len(points))
    assert msm_scheduled(points, scalars) == host_msm(points, scalars)


def test_msm_all_zero_scalars(points):
    assert msm_scheduled(points, [Fr(0)] * len(points)) == G1.zero()


def test_context_prefix_msm(points):
    random.seed(17)
    ctx = ScheduledMsmContext(points)
    for n in (len(points), 13, 1):
        scalars = [Fr(random.randrange(MODULUS)) for _ in range(n)]
        assert ctx.msm(scalars) == host_msm(points[:n], scalars)


def test_context_scalar_bytes_input(points):
    random.seed(23)
    ctx = ScheduledMsmContext(points)
    vals = [random.randrange(MODULUS) for _ in range(len(points))]
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    assert ctx.msm(raw) == host_msm(points, [Fr(v) for v in vals])


def test_native_srs_context_matches():
    _native = pytest.importorskip("tnsh._native")
    if not _native.available:
        pytest.skip("native layer unavailable")
    random.seed(31)
    scal = b"".join(
        random.randrange(MODULUS).to_bytes(32, "little") for _ in range(32)
    )
    srs_id = _native.srs_create_fixed_base(G1.generator(), scal)
    try:
        ctx = ScheduledMsmContext.from_native_srs(srs_id)
        scalars = [Fr(random.randrange(MODULUS)) for _ in range(32)]
        assert ctx.msm(scalars) == _native.srs_msm(srs_id, scalars)
    finally:
        _native.srs_free(srs_id)


def test_hybrid_srs_msm_matches_native():
    _native = pytest.importorskip("tnsh._native")
    if not _native.available:
        pytest.skip("native layer unavailable")
    from tnsh.commit import kzg
    from tnsh.field.g1 import G1

    random.seed(47)
    n = 96
    sb = b"".join(
        random.randrange(MODULUS).to_bytes(32, "little") for _ in range(n)
    )
    srs_id = _native.srs_create_fixed_base(G1.generator(), sb)
    try:
        scal = [Fr(random.randrange(MODULUS)) for _ in range(n)]
        want = _native.srs_msm(srs_id, scal)
        # adaptive policy: first call is exact either way — host-only on a
        # cold kernel shape, hybrid when another SRS already compiled it
        assert kzg._hybrid_srs_msm(srs_id, scal, n) == want
        st = kzg._device_msm_stats[kzg._msm_bucket(srs_id, n)]
        assert st["host"] is not None
        # prewarm -> measured split engages; results stay identical
        kzg.prewarm_device_msm(srs_id, n)
        assert st["device"] is not None
        # equal rates -> an even split, so the device takes part here too
        st["device"] = st["host"]
        before = st["device_points"]
        assert kzg._hybrid_srs_msm(srs_id, scal, n) == want
        raw = b"".join(int(s).to_bytes(32, "little") for s in scal)
        assert kzg._hybrid_srs_msm(srs_id, raw, n) == want
        assert st["device_points"] > before
    finally:
        _native.srs_free(srs_id)


def test_compiled_kernel_constructors_are_cached():
    """Every stage constructor keeps its @lru_cache: a lost cache re-traces
    and re-compiles the kernel on every MSM.  Same shape twice => one
    miss, one hit."""
    from tnsh.commit import msm_sched

    for ctor, args in (
        (msm_sched._compiled_schedules, (1, 512, 4, 16)),
        (msm_sched._compiled_insert_xla, (1, 512, 16)),
        (msm_sched._compiled_tail, (4,)),
    ):
        assert hasattr(ctor, "cache_info"), f"{ctor.__name__} lost its cache"
        ctor.cache_clear()
        assert ctor(*args) is ctor(*args)
        info = ctor.cache_info()
        assert info.misses == 1 and info.hits == 1


def test_kernel_shape_reuses_compiled_capacity(monkeypatch):
    """A plan whose exact step count fits an already-compiled schedule
    capacity reuses that kernel shape; otherwise the capacity is the next
    power of two (at least 16)."""
    from tnsh.commit import msm_sched

    monkeypatch.setattr(msm_sched, "_COMPILED_SHAPES", set())
    assert msm_sched._kernel_shape(2, 512, 32, 40) == (2, 512, 32, 64)
    assert msm_sched._kernel_shape(2, 512, 32, 3) == (2, 512, 32, 16)
    msm_sched._COMPILED_SHAPES.add((2, 512, 32, 128))
    assert msm_sched._kernel_shape(2, 512, 32, 40) == (2, 512, 32, 128)
    assert msm_sched._kernel_shape(2, 512, 32, 200) == (2, 512, 32, 256)
    assert msm_sched._kernel_shape(2, 512, 4, 40) == (2, 512, 4, 64)


def test_insert_engine_matches_native():
    """A multi-step MSM at 4096 points (several insertion steps per lane,
    one full chunk) must produce the exact group element of the native
    host MSM."""
    _native = pytest.importorskip("tnsh._native")
    if not _native.available:
        pytest.skip("native layer unavailable")
    from tnsh.commit.msm_sched import ScheduledMsmContext
    from tnsh.field.g1 import G1

    random.seed(71)
    n = 4096
    sb = b"".join(
        random.randrange(MODULUS).to_bytes(32, "little") for _ in range(n)
    )
    srs_id = _native.srs_create_fixed_base(G1.generator(), sb)
    try:
        ctx = ScheduledMsmContext.from_native_srs(srs_id)
        scal = b"".join(
            random.randrange(1 << 20).to_bytes(32, "little")
            for _ in range(n)
        )
        assert ctx.msm(scal) == _native.srs_msm(srs_id, scal)
        assert ctx.hazard_count == 0
    finally:
        _native.srs_free(srs_id)
