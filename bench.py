"""Benchmark entry point for the driver.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Workload: the reference's own headline Twist benchmark at memory size 16 —
write if i % 3 == 0 (value 42*i) else read, 8 operations (the size-tiered
count for size 16; reference benchmarks.rs:57-99).  The baseline number is
the reference's published illustrative throughput for that row: 251 prove
ops/s (BENCHMARK_RESULTS.md:122, BASELINE.md).  vs_baseline > 1 means
faster than the reference's published figure.

Supplementary metrics (device Fr-mul and MSM throughput, larger-size prover
runs) are printed to stderr, each naming the device it ran on, so stdout
stays a single JSON line.  Everything runs in this one process: a second
process could not open a GPU this one already holds.
"""

from __future__ import annotations

import json
import sys
import time


def _device_line() -> str:
    """The JAX device this process runs on, with the card's name and power
    limit from nvidia-smi on a GPU."""
    import shutil
    import subprocess

    import jax

    d = jax.devices()
    line = f"{d[0].platform} {d[0].device_kind} x{len(d)}"
    if d[0].platform == "gpu" and shutil.which("nvidia-smi"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
        line += f" ({card})"
    return line


def main() -> None:
    from tnsh.bench.harness import ProtocolBenchmarks
    from tnsh.core.device import setup_compile_cache

    setup_compile_cache()
    print(f"[bench] device: {_device_line()}", file=sys.stderr)

    # Warm-up run (populates interpolation caches the way a server would);
    # best-of-5 damps co-located load noise on the host.
    ProtocolBenchmarks.benchmark_twist_single(4, 8)
    best = None
    for _ in range(5):
        res = ProtocolBenchmarks.benchmark_twist_single(4, 8)
        if best is None or res.prove_time < best.prove_time:
            best = res
    value = best.prove_ops_per_second()
    baseline = 251.0  # reference BENCHMARK_RESULTS.md:122 (illustrative)
    print(
        f"[bench] twist size=16 ops=8: prove {best.prove_time * 1e3:.2f} ms, "
        f"verify {best.verify_time * 1e3:.2f} ms, setup {best.setup_time * 1e3:.2f} ms",
        file=sys.stderr,
    )

    # Supplementary: the verifier-enforced batched sound prover (protocol
    # v2) at K=2^10 T=2^14 — the capability the reference lacks entirely.
    try:
        import random

        from tnsh.protocols.sound import TwistSound, prewarm_sound
        from tnsh.protocols.twist import MemoryTrace
        from tnsh.core.params import setup_params as _sp
        from tnsh.field.fr import Fr as _F

        s_pp, s_vp = _sp(12)
        prewarm_sound(10, 14)
        random.seed(1)
        tr = MemoryTrace(1 << 10)
        for i in range(1 << 14):
            if i % 3 == 0:
                tr.write(random.randrange(1 << 10), _F(42 * i))
            else:
                tr.read(random.randrange(1 << 10))
        t0 = time.perf_counter()
        sproof = TwistSound.prove(tr, s_pp)
        t1 = time.perf_counter()
        ok = TwistSound.verify(sproof, s_vp)
        t2 = time.perf_counter()
        print(
            f"[bench] twist_sound K=2^10 T=2^14: prove {t1 - t0:.2f} s "
            f"({(1 << 14) / (t1 - t0):.0f} ops/s), verify "
            f"{(t2 - t1) * 1e3:.0f} ms, valid={ok}",
            file=sys.stderr,
        )
    except Exception as exc:  # pragma: no cover - diagnostics only
        print(f"[bench] twist_sound skipped: {exc}", file=sys.stderr)

    # Supplementary: the trapdoor-free bit-column prover (wire v3) at
    # K=2^6 T=2^12 — structured O(T logK) oracle, native k/j phases.
    # Regression line for the adversarial-scale capability.
    try:
        import random

        from tnsh.protocols.twist_bits import TwistBits
        from tnsh.protocols.twist import MemoryTrace
        from tnsh.core.params import setup_params as _sp
        from tnsh.field.fr import Fr as _F

        b_pp, b_vp = _sp(12)
        random.seed(5)
        tr = MemoryTrace(1 << 6)
        for i in range(1 << 12):
            if i % 3 == 0:
                tr.write(random.randrange(1 << 6), _F(42 * i))
            else:
                tr.read(random.randrange(1 << 6))
        TwistBits.prove(tr, b_pp)  # warm (SRS + caches)
        t0 = time.perf_counter()
        bproof = TwistBits.prove(tr, b_pp)
        t1 = time.perf_counter()
        ok = TwistBits.verify(bproof, b_vp)
        t2 = time.perf_counter()
        print(
            f"[bench] twist_bits K=2^6 T=2^12: prove {t1 - t0:.3f} s "
            f"({(1 << 12) / (t1 - t0):.0f} ops/s), verify "
            f"{(t2 - t1) * 1e3:.0f} ms, valid={ok}",
            file=sys.stderr,
        )
    except Exception as exc:  # pragma: no cover - diagnostics only
        print(f"[bench] twist_bits skipped: {exc}", file=sys.stderr)

    from tnsh.core.device import on_gpu

    if not on_gpu():
        print("[bench] fr_mont_mul, msm_sched: not measured (no GPU)",
              file=sys.stderr)
        _emit(value, baseline)
        return

    # Supplementary: Fr Montgomery-mul throughput of the XLA field kernel
    # on the GPU — one jitted fori_loop of 256 chained multiplies over
    # 2^19 lanes, timed to block_until_ready.
    try:
        import jax
        import numpy as np

        from tnsh.field.fr_jax import fr_mont_mul
        from tnsh.field.limbs import FR_SPEC, pack_ints

        rng = np.random.default_rng(0)
        n, iters = 1 << 19, 256
        a = jax.numpy.asarray(pack_ints(
            [int(v) for v in rng.integers(0, 1 << 62, n)], FR_SPEC))
        chain = jax.jit(lambda x, y: jax.lax.fori_loop(
            0, iters, lambda i, r: fr_mont_mul(r, y), x))
        r = jax.block_until_ready(chain(a, a))  # compile + first run
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            r = jax.block_until_ready(chain(r, a))
            best = min(best, time.perf_counter() - t0)
        print(
            f"[bench] fr_mont_mul[{jax.devices()[0].device_kind}] "
            f"{n * iters / best / 1e6:.0f} M muls/s ({iters}x chained muls "
            f"over 2^19 lanes, 1 dispatch)",
            file=sys.stderr,
        )
    except Exception as exc:  # pragma: no cover - diagnostics only
        print(f"[bench] fr_mont_mul skipped: {exc}", file=sys.stderr)

    # Supplementary: the device scheduled-Pippenger MSM at 2^16 points vs
    # the native host MSM on the same SRS.
    try:
        import jax
        import numpy as np

        from tnsh import _native
        from tnsh.commit.msm_sched import ScheduledMsmContext
        from tnsh.field.g1 import G1

        n = 1 << 16

        def rand_scalars(seed):
            raw = np.random.default_rng(seed).integers(
                0, 256, (n, 32), dtype=np.uint8)
            raw[:, 31] &= 0x1F
            return raw.tobytes()

        sid = _native.srs_create_fixed_base(G1.generator(), rand_scalars(7))
        try:
            ctx = ScheduledMsmContext.from_native_srs(sid)
            full = rand_scalars(8)
            got = ctx.msm(full)  # compile + first run
            t0 = time.perf_counter()
            got = ctx.msm(full)
            dev = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = _native.srs_msm(sid, full)
            host = time.perf_counter() - t0
        finally:
            _native.srs_free(sid)
        print(
            f"[bench] msm_sched 2^16 full[{jax.devices()[0].device_kind}] "
            f"{n / dev / 1e3:.0f}k pts/s (host {n / host / 1e3:.0f}k pts/s, "
            f"{'match' if got == want else 'MISMATCH'})",
            file=sys.stderr,
        )
    except Exception as exc:  # pragma: no cover - diagnostics only
        print(f"[bench] msm_sched skipped: {exc}", file=sys.stderr)

    _emit(value, baseline)


def _emit(value: float, baseline: float) -> None:
    print(
        json.dumps(
            {
                "metric": "twist_prove_ops_per_s_size16",
                "value": round(value, 2),
                "unit": "ops/s",
                "vs_baseline": round(value / baseline, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
