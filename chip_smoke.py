"""Smoke test of the Twist/Shout provers on one GPU.

Drives the main path through its public entry points at full size and
checks every device route against the host (native C++ or pure-Python)
golden path by exact equality of field and group elements:

  1. kernels at real widths: the scheduled-Pippenger MSM at 2^18 and 2^20
     points against the native MSM; the fold and
     a degree-13 generic sum-check round at 2^20 lanes against the native
     oracle;
  2. TwistSound (sparse), K=2^10, T=2^18, after ``prewarm_sound``: prove,
     verify, reject a forged read value, and a non-zero device share of
     the MSM points;
  3. TwistBits, K=2^10, T=2^20: prove, verify, reject a tampered proof;
     then at T=2^18 the j phase on the device oracle, whose proof bytes
     must equal the native prove's.

Run on a machine with one GPU:  python chip_smoke.py
Four GPUs, the sharded paths only:  python chip_smoke.py --four
Smaller sizes for a rehearsal:  python chip_smoke.py --log-msm 16 ...

Exits non-zero when JAX finds no GPU, when the native library cannot be
built, or when any phase fails.  The last line of stdout is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import time


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    """The GPU's name and power limit as nvidia-smi reports them."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or out.stderr.strip()


def peak_gb() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _rand_scalar_bytes(n: int, seed: int) -> bytes:
    """n random field scalars below 2^253, as 32-byte LE words."""
    import numpy as np

    raw = np.random.default_rng(seed).integers(0, 256, (n, 32),
                                               dtype=np.uint8)
    raw[:, 31] &= 0x1F
    return raw.tobytes()


# ---------------------------------------------------------------------------
# Phase 1: kernels at real widths
# ---------------------------------------------------------------------------

def phase_msm(log_sizes, seed: int = 7) -> None:
    """Scheduled-Pippenger MSM on the device vs the native host MSM."""
    import jax.numpy as jnp

    from tnsh import _native
    from tnsh.commit import msm_sched
    from tnsh.field.g1 import G1

    n_max = 1 << max(log_sizes)
    t0 = time.perf_counter()
    srs = _native.srs_create_fixed_base(G1.generator(),
                                        _rand_scalar_bytes(n_max, seed))
    ctx = msm_sched.ScheduledMsmContext.from_native_srs(srs)
    say(f"[msm] SRS of 2^{max(log_sizes)} random points on the device "
        f"in {time.perf_counter() - t0:.1f}s")
    try:
        for lg in log_sizes:
            n = 1 << lg
            scalars = _rand_scalar_bytes(n, seed + lg)
            t0 = time.perf_counter()
            got = ctx.msm(scalars)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = ctx.msm(scalars)
            steady = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = _native.srs_msm(srs, scalars)
            host = time.perf_counter() - t0
            _, d, plan, key = ctx.prepare(scalars)
            chunks, m, _, r_c = key
            sched = msm_sched._compiled_schedules(*key)(
                jnp.asarray(d), jnp.asarray(plan.base_map),
                jnp.asarray(plan.logk_map))
            mem = msm_sched._compiled_insert_xla(chunks, m, r_c).lower(
                sched, jnp.asarray(plan.rc_per_chunk),
                ctx.xs[:, :chunks * m], ctx.ys[:, :chunks * m],
            ).compile().memory_analysis()
            say(f"[msm] 2^{lg} points: first call (compile+run) "
                f"{first:.2f}s, steady {steady:.4f}s, native host "
                f"{host:.4f}s, exact match={got == want}, hazards="
                f"{ctx.hazard_count}, kernel shape {key}")
            say(f"[msm] 2^{lg} insertion kernel memory_analysis: {mem}")
            say(f"[msm] peak device memory {peak_gb():.2f} GB")
            if got != want:
                raise AssertionError(f"device MSM mismatch at 2^{lg}")
    finally:
        _native.srs_free(srs)


def _bits_shaped_terms(log_lanes: int, seed: int):
    """A TwistBits j-phase-shaped term system: 24 columns, two degree-13
    products sharing factors, a degree-2 term and booleanity checks."""
    from tnsh.field.fr import MODULUS

    n = 1 << log_lanes
    rng = random.Random(seed)
    cols = [[rng.getrandbits(253) for _ in range(n)] for _ in range(14)]
    cols += [[rng.getrandbits(1) for _ in range(n)] for _ in range(10)]
    terms = [(1, cols[0:13]), (rng.getrandbits(250), cols[11:24]),
             (MODULUS - 5, [cols[0], cols[1]])]
    for b in cols[14:24]:
        w = rng.getrandbits(250)
        terms += [(w, [cols[2], b, b]), (MODULUS - w, [cols[2], b])]
    return terms


def phase_sumcheck(log_lanes: int, seed: int = 11) -> None:
    """Degree-13 generic round and fold on the device oracle vs native."""
    from tnsh.field.fr import Fr
    from tnsh.iop.sumcheck_d import JaxSopOracleD, NativeSopOracleD
    from tnsh.poly import mle_jax

    degree = 13
    terms = _bits_shaped_terms(log_lanes, seed)
    host = NativeSopOracleD(log_lanes, terms, degree=degree)
    t0 = time.perf_counter()
    dev = JaxSopOracleD(log_lanes, terms, degree=degree)
    say(f"[sop-d] 2^{log_lanes} lanes, {dev._stack.shape[0]} tables, "
        f"{len(terms)} terms: packed to the device in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mem = mle_jax.sop_d_round_evals_stacked_jit.lower(
        dev._stack, dev._coeffs, dev._idxs, degree + 1
    ).compile().memory_analysis()
    say(f"[sop-d] round kernel compile {time.perf_counter() - t0:.2f}s, "
        f"memory_analysis: {mem}")
    got, first = _timed(lambda: dev.round_evaluations(0))
    got, steady = _timed(lambda: dev.round_evaluations(0))
    t0 = time.perf_counter()
    want = host.round_evaluations(0)
    t_host = time.perf_counter() - t0
    ok0 = [int(v) for v in got] == [int(v) for v in want]
    r = Fr(0x5EED5EED5EED)
    _, fold_first = _timed(lambda: dev.bind(r) or dev._stack)
    host.bind(r)
    ok1 = [int(v) for v in dev.round_evaluations(1)] == [
        int(v) for v in host.round_evaluations(1)]
    say(f"[sop-d] round 0: first call (compile+run) {first:.2f}s, steady "
        f"{steady:.4f}s, native host {t_host:.4f}s, exact match={ok0}; "
        f"fold of all tables (compile+run) {fold_first:.2f}s, round 1 "
        f"after the fold exact match={ok1}")
    say(f"[sop-d] peak device memory {peak_gb():.2f} GB")
    host.release()
    if not (ok0 and ok1):
        raise AssertionError("device sum-check round mismatch")


# ---------------------------------------------------------------------------
# Phases 2 and 3: the provers through their entry points
# ---------------------------------------------------------------------------

def _trace(log_k: int, log_t: int, seed: int):
    from tnsh.field.fr import Fr
    from tnsh.protocols.twist import MemoryTrace

    rng = random.Random(seed)
    tr = MemoryTrace(1 << log_k)
    for i in range(1 << log_t):
        if i % 3 == 0:
            tr.write(rng.randrange(1 << log_k), Fr(42 * i))
        else:
            tr.read(rng.randrange(1 << log_k))
    return tr


def phase_sound(log_k: int, log_t: int, seed: int = 1) -> None:
    """Sparse TwistSound with the host+device MSM hybrid."""
    from tnsh.commit import kzg
    from tnsh.core.params import setup_params
    from tnsh.field.fr import Fr
    from tnsh.protocols.sound import TwistSound, prewarm_sound

    pp, vp = setup_params(10)
    t0 = time.perf_counter()
    prewarm_sound(log_k, log_t)
    say(f"[sound] prewarm_sound({log_k}, {log_t}) (SRS + device MSM "
        f"compile) {time.perf_counter() - t0:.1f}s")
    tr = _trace(log_k, log_t, seed)
    before = sum(st["device_points"] for st in kzg._device_msm_stats.values())
    t0 = time.perf_counter()
    proof = TwistSound.prove(tr, pp, sparse=True)
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = TwistSound.verify(proof, vp)
    t_verify = time.perf_counter() - t0
    dev_pts = sum(st["device_points"]
                  for st in kzg._device_msm_stats.values()) - before
    proof.col_values[1] = proof.col_values[1] + Fr(1)
    forged = TwistSound.verify(proof, vp)
    hazards = sum(c.hazard_count for c in kzg._device_msm_contexts.values())
    say(f"[sound] K=2^{log_k} T=2^{log_t}: prove {t_prove:.2f}s, verify "
        f"{t_verify * 1e3:.0f} ms, valid={ok}, forged read value "
        f"rejected={not forged}, device MSM points={dev_pts}, "
        f"hazards={hazards}")
    say(f"[sound] peak device memory {peak_gb():.2f} GB")
    if not ok or forged:
        raise AssertionError("TwistSound verification outcome wrong")
    if dev_pts <= 0:
        raise AssertionError("the device computed no MSM points")


def phase_bits(log_k: int, log_t: int, log_t_device: int,
               seed: int = 5) -> None:
    """TwistBits prove/verify/tamper, then a device j-phase prove whose
    bytes must equal the native prove's."""
    import copy

    from tnsh.core.params import setup_params
    from tnsh.core.proof_io import twist_bits_proof_to_bytes
    from tnsh.field.fr import Fr
    from tnsh.protocols.twist_bits import TwistBits

    pp, vp = setup_params(10)
    tr = _trace(log_k, log_t, seed)
    t0 = time.perf_counter()
    proof = TwistBits.prove(tr, pp)
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = TwistBits.verify(proof, vp)
    t_verify = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    bad.values_rj[0] = Fr(int(bad.values_rj[0]) + 1)
    tampered = TwistBits.verify(bad, vp)
    say(f"[bits] K=2^{log_k} T=2^{log_t}: prove {t_prove:.2f}s, verify "
        f"{t_verify * 1e3:.0f} ms, valid={ok}, tampered proof "
        f"rejected={not tampered}")
    if not ok or tampered:
        raise AssertionError("TwistBits verification outcome wrong")
    del tr, proof, bad

    tr = _trace(log_k, log_t_device, seed + 1)
    t0 = time.perf_counter()
    native = twist_bits_proof_to_bytes(TwistBits.prove(tr, pp))
    t_native = time.perf_counter() - t0
    os.environ["TNSH_BITS_FORCE_JAX"] = "1"
    try:
        t0 = time.perf_counter()
        dproof = TwistBits.prove(tr, pp)
        t_dev = time.perf_counter() - t0
    finally:
        del os.environ["TNSH_BITS_FORCE_JAX"]
    same = twist_bits_proof_to_bytes(dproof) == native
    ok = TwistBits.verify(dproof, vp)
    say(f"[bits] K=2^{log_k} T=2^{log_t_device}: native j-phase prove "
        f"{t_native:.2f}s, device j-phase prove (compiles included) "
        f"{t_dev:.2f}s, proof bytes identical={same}, valid={ok}")
    say(f"[bits] peak device memory {peak_gb():.2f} GB")
    if not (same and ok):
        raise AssertionError("device j-phase proof differs from native")


# ---------------------------------------------------------------------------
# --four: the sharded paths on four devices
# ---------------------------------------------------------------------------

def phase_four_sopd(devices, log_lanes: int, sharded_rounds: int,
                    seed: int = 13) -> None:
    """ShardedSopOracleD over a 1-D mesh vs the native oracle, proof bytes."""
    from tnsh.core.proof_io import sumcheck_d_proof_to_bytes
    from tnsh.core.transcript import Transcript
    from tnsh.iop.sumcheck_d import NativeSopOracleD, SumCheckD
    from tnsh.parallel.mesh import ShardedSopOracleD, make_mesh

    degree = 13
    terms = _bits_shaped_terms(log_lanes, seed)
    host = NativeSopOracleD(log_lanes, terms, degree=degree)
    ev = host.round_evaluations(0)
    claim = ev[0] + ev[1]
    host.release()
    seed_b = bytes([7]) * 32
    t0 = time.perf_counter()
    p_host, _ = SumCheckD(log_lanes, claim, degree).prove_with_challenges(
        NativeSopOracleD(log_lanes, terms, degree=degree), Transcript(seed_b))
    t_host = time.perf_counter() - t0
    say(f"[four] sop-d 2^{log_lanes} lanes: native prove {t_host:.2f}s")
    t0 = time.perf_counter()
    oracle = ShardedSopOracleD(log_lanes, terms, degree, make_mesh(devices),
                               max_sharded_rounds=sharded_rounds)
    say(f"[four] sop-d tables packed onto {len(devices)} devices in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    p_mesh, _ = SumCheckD(log_lanes, claim, degree).prove_with_challenges(
        oracle, Transcript(seed_b))
    t_mesh = time.perf_counter() - t0
    same = sumcheck_d_proof_to_bytes(p_mesh) == sumcheck_d_proof_to_bytes(
        p_host)
    say(f"[four] sharded sop-d prove ({sharded_rounds} sharded rounds, "
        f"then the host tail; compiles included) {t_mesh:.2f}s, proof "
        f"bytes identical={same}")
    if not same:
        raise AssertionError("sharded sop-d proof differs from native")


def four_preflight(devices) -> None:
    """One all-reduce across the mesh, before any long compile."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tnsh.parallel.mesh import make_mesh

    mesh = make_mesh(devices)
    n = 8 * len(devices)
    x = jax.device_put(jnp.arange(n, dtype=jnp.int32),
                       NamedSharding(mesh, P("data")))
    total = int(jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(x))
    say(f"[four] all-reduce over {len(devices)} devices: {total} "
        f"(expected {n * (n - 1) // 2})")
    if total != n * (n - 1) // 2:
        raise AssertionError("cross-device all-reduce is wrong")


def start_four_msm(devices, log_per_device: int, seed: int = 17) -> dict:
    """Start the sharded double-and-add MSM's compile in a thread, so that
    it overlaps the sop-d phase, then build its inputs."""
    import threading

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tnsh import _native
    from tnsh.field.fr_jax import fq_ops
    from tnsh.field.g1 import G1
    from tnsh.field.limbs import NUM_LIMBS, bytes_to_limb_planes
    from tnsh.parallel.mesh import make_mesh, sharded_msm_fn

    n = len(devices) << log_per_device
    mesh = make_mesh(devices)
    lanes = NamedSharding(mesh, P(None, "data"))
    flat = NamedSharding(mesh, P("data"))
    specs = (jax.ShapeDtypeStruct((NUM_LIMBS, n), jnp.int32, sharding=lanes),
             jax.ShapeDtypeStruct((NUM_LIMBS, n), jnp.int32, sharding=lanes),
             jax.ShapeDtypeStruct((n,), jnp.bool_, sharding=flat),
             jax.ShapeDtypeStruct((254, n), jnp.int32, sharding=lanes))
    lowered = sharded_msm_fn(mesh).lower(*specs)
    state = {"devices": len(devices), "log_per_device": log_per_device}

    def compile_():
        t0 = time.perf_counter()
        try:
            state["compiled"] = lowered.compile()
        except BaseException as e:  # re-raised by phase_four_msm
            state["error"] = e
        state["compile_s"] = time.perf_counter() - t0
        say(f"[four] sharded MSM compile ended after "
            f"{state['compile_s']:.2f}s")

    state["thread"] = threading.Thread(target=compile_, daemon=True)
    state["thread"].start()

    srs = _native.srs_create_fixed_base(G1.generator(),
                                        _rand_scalar_bytes(n, seed))
    raw = np.frombuffer(_native.srs_export_affine(srs, 0, n),
                        dtype=np.uint8).reshape(n, 64)
    to_mont = jax.jit(fq_ops.to_mont)
    xs = to_mont(jnp.asarray(bytes_to_limb_planes(raw[:, :32])))
    ys = to_mont(jnp.asarray(bytes_to_limb_planes(raw[:, 32:])))
    scalars = _rand_scalar_bytes(n, seed + 1)
    sb = np.frombuffer(scalars, dtype=np.uint8).reshape(n, 32)
    bits = np.unpackbits(sb, axis=1, bitorder="little")[:, :254]
    bits = np.ascontiguousarray(bits.T).astype(np.int32)
    valid = (raw != 0).any(axis=1) & sb.any(axis=1)
    state.update(srs=srs, scalars=scalars, args=(
        jax.device_put(xs, lanes), jax.device_put(ys, lanes),
        jax.device_put(jnp.asarray(valid), flat),
        jax.device_put(jnp.asarray(bits), lanes)))
    return state


def phase_four_msm(state: dict) -> None:
    """Sharded double-and-add MSM vs the native MSM."""
    from tnsh import _native
    from tnsh.parallel.mesh import combine_partials

    try:
        t0 = time.perf_counter()
        state["thread"].join()
        wait = time.perf_counter() - t0
        if "error" in state:
            raise state["error"]
        fn, args = state["compiled"], state["args"]
        _, first = _timed(lambda: fn(*args))
        out, steady = _timed(lambda: fn(*args))
        got = combine_partials(*out)
        t0 = time.perf_counter()
        want = _native.srs_msm(state["srs"], state["scalars"])
        t_host = time.perf_counter() - t0
        say(f"[four] sharded MSM 2^{state['log_per_device']} points per "
            f"device x {state['devices']}: compile {state['compile_s']:.2f}s "
            f"(overlapping the sop-d phase; {wait:.2f}s waited after it), "
            f"first run {first:.4f}s, steady {steady:.4f}s, native "
            f"{t_host:.4f}s, exact match={got == want}")
        if got != want:
            raise AssertionError("sharded MSM mismatch")
    finally:
        _native.srs_free(state["srs"])


# ---------------------------------------------------------------------------

def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    ap.add_argument("--log-msm", default="18,20",
                    help="MSM sizes (log2 points), comma-separated")
    ap.add_argument("--log-lanes", type=int, default=20,
                    help="lanes (log2) of the sum-check kernel phase")
    ap.add_argument("--sound", default="10,18",
                    help="TwistSound log K, log T")
    ap.add_argument("--bits", default="10,20", help="TwistBits log K, log T")
    ap.add_argument("--bits-device-t", type=int, default=18,
                    help="log T of the device j-phase TwistBits prove")
    ap.add_argument("--four-lanes", type=int, default=18,
                    help="lanes (log2) of the sharded sop-d")
    ap.add_argument("--four-msm", type=int, default=16,
                    help="sharded MSM points per device (log2)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    devices = jax.devices()
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
              "not a GPU", file=sys.stderr)
        return 2
    from tnsh import _native
    from tnsh.core.device import setup_compile_cache

    if not _native.available:
        print("chip_smoke: the native library is unavailable",
              file=sys.stderr)
        return 3
    cache = setup_compile_cache()
    say(card_line())
    say(f"jax {jax.__version__}; compile cache {cache}; devices "
        f"{len(devices)} x {devices[0].device_kind}")
    t_all = time.perf_counter()
    if args.four:
        if len(devices) < 4:
            print("chip_smoke --four: needs four GPUs", file=sys.stderr)
            return 4
        devices = devices[:4]
        msm_state = start_four_msm(devices, args.four_msm)
        four_preflight(devices)
        phase_four_sopd(devices, args.four_lanes, sharded_rounds=2)
        phase_four_msm(msm_state)
        count = len(devices)
    else:
        phase_msm([int(x) for x in args.log_msm.split(",")])
        phase_sumcheck(args.log_lanes)
        phase_sound(*[int(x) for x in args.sound.split(",")])
        lk, lt = [int(x) for x in args.bits.split(",")]
        phase_bits(lk, lt, args.bits_device_t)
        count = len(devices)
    say(f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
