"""Mesh-scaling benchmark: sharded sum-check rounds + sharded MSM.

Reports throughput of (a) the sharded product-MLE sum-check round and
(b) the sharded double-and-add MSM, at mesh sizes 1/2/4/8, with derived
scaling efficiency (BASELINE north-star shape: ops/s at 1 chip / 1 host /
N hosts, >=80% target).  Writes a JSON report with --json.

METHODOLOGY CAVEAT (printed into the JSON too): on virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count=N) the mesh shares the
host's cores, so compute-bound stages CANNOT show real speedup — the
numbers validate that the sharded path's collectives and partitioning add
little overhead as the mesh grows.  On N GPUs each shard gets its own
card.  The communication pattern measured is the one the cards run:
per-round psum for sum-check, all-gather tree reduction for MSM.

Usage: python benches/scaling_bench.py [--log-size 14] [--devices 1,2,4,8]
       [--msm-log-size 10] [--json scaling.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-size", type=int, default=14)
    ap.add_argument("--msm-log-size", type=int, default=10)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass

    import random

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tnsh.field.fr import MODULUS, Fr
    from tnsh.field.g1 import G1
    from tnsh.field.limbs import pack_scalar_bits
    from tnsh.commit.msm_jax import pack_g1_points
    from tnsh.parallel.mesh import (
        make_mesh,
        sharded_evals_step,
        sharded_msm_fn,
    )
    from tnsh.poly import mle_jax

    results = {
        "environment": {
            "backend": jax.default_backend(),
            "physical_cores": os.cpu_count(),
            "note": (
                "virtual CPU devices share the host's cores: validates "
                "collective overhead, NOT real multi-device speedup; see "
                "module docstring"
            ),
        },
        "sumcheck_round": [],
        "msm": [],
    }

    n = 1 << args.log_size
    random.seed(5)
    evals = [
        [Fr(random.randrange(MODULUS)) for _ in range(n)] for _ in range(3)
    ]
    packed = [mle_jax.pack_mle(e) for e in evals]

    print(f"[sum-check] round evals over 3 x 2^{args.log_size} tables")
    print(f"{'devices':>8} {'round ms':>10} {'rounds/s':>10} "
          f"{'vs 1-dev':>9}")
    base = None
    for d in (int(x) for x in args.devices.split(",")):
        devs = jax.devices()[:d]
        if len(devs) < d:
            print(f"{d:>8}  (unavailable)")
            continue
        mesh = make_mesh(devs)
        step = sharded_evals_step(mesh, num_factors=3)
        shard = NamedSharding(mesh, P(None, "data"))
        tables = tuple(jax.device_put(jnp.asarray(p), shard) for p in packed)
        out = step(tables)
        jax.block_until_ready(out)
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(tables)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        thr = 1.0 / dt
        base = thr if base is None else base
        rel = thr / base
        results["sumcheck_round"].append(
            {"devices": d, "round_ms": dt * 1e3, "throughput": thr,
             "relative": rel}
        )
        print(f"{d:>8} {dt*1e3:>10.2f} {thr:>10.2f} {rel:>8.0%}")

    # --- sharded MSM (double-and-add kernel, lanes over the mesh) ---------
    nm = 1 << args.msm_log_size
    rng = np.random.default_rng(7)
    g = G1.generator()
    points = [g * int(k) for k in rng.integers(1, 1 << 31, nm)]
    scalars = [int(s) for s in rng.integers(1, 1 << 61, nm)]
    xs, ys, valid = pack_g1_points(points)
    bits = pack_scalar_bits(scalars, num_bits=254)

    print(f"[msm] sharded double-and-add over 2^{args.msm_log_size} points")
    print(f"{'devices':>8} {'msm ms':>10} {'pts/s':>10} {'vs 1-dev':>9}")
    base = None
    for d in (int(x) for x in args.devices.split(",")):
        devs = jax.devices()[:d]
        if len(devs) < d:
            continue
        mesh = make_mesh(devs)
        msm = sharded_msm_fn(mesh)
        shard = NamedSharding(mesh, P(None, "data"))
        shard1 = NamedSharding(mesh, P("data"))
        a = (
            jax.device_put(jnp.asarray(xs), shard),
            jax.device_put(jnp.asarray(ys), shard),
            jax.device_put(jnp.asarray(valid), shard1),
            jax.device_put(jnp.asarray(bits), shard),
        )
        out = msm(*a)
        jax.block_until_ready(out)
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            out = msm(*a)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        thr = nm / dt
        base = thr if base is None else base
        rel = thr / base
        results["msm"].append(
            {"devices": d, "msm_ms": dt * 1e3, "pts_per_s": thr,
             "relative": rel}
        )
        print(f"{d:>8} {dt*1e3:>10.1f} {thr:>10.0f} {rel:>8.0%}")

    if args.json:
        Path(args.json).write_text(json.dumps(results, indent=1))
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
