"""Benchmark CLI.

Port of ``examples/comprehensive_benchmarks.rs`` (reference
comprehensive_benchmarks.rs:31-296): modes quick / full / dev / custom /
twist-only / shout-only / help, flags ``--min-log-size`` / ``--max-log-size``
/ ``--operations``, with the same validation rules (min <= max, logs within
2..=20) and non-zero exit on invalid arguments.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .harness import ProtocolBenchmarks

_HELP = """\
Twist and Shout Comprehensive Benchmarks

USAGE:
    python -m tnsh.bench.cli [MODE] [OPTIONS]

MODES:
    quick       Quick benchmark suite (log sizes 4-6, 64 operations)
    full        Full benchmark suite (log sizes 4-8, 256 operations)
    dev         Development benchmark (log sizes 4-5, 32 operations)
    custom      Custom benchmark with explicit options
    twist-only  Benchmark only the Twist protocol
    shout-only  Benchmark only the Shout protocol
    sound       Verifier-enforced TwistSound/ShoutSound (tnsh extension)
    bits        Trapdoor-free TwistBits/ShoutBits (tnsh extension)
    help        Show this help text

OPTIONS:
    --min-log-size <N>   Minimum log2 size (default 4, range 2..=20)
    --max-log-size <N>   Maximum log2 size (default 6, range 2..=20)
    --operations <N>     Number of operations (default 64)
"""


def _parse_flag(args: List[str], name: str, default: int) -> Optional[int]:
    if name in args:
        idx = args.index(name)
        if idx + 1 >= len(args):
            print(f"error: {name} requires a value")
            return None
        try:
            return int(args[idx + 1])
        except ValueError:
            print(f"error: invalid value for {name}: {args[idx + 1]}")
            return None
    return default


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    mode = args[0] if args and not args[0].startswith("--") else "quick"

    min_log = _parse_flag(args, "--min-log-size", 4)
    max_log = _parse_flag(args, "--max-log-size", 6)
    operations = _parse_flag(args, "--operations", 64)
    if min_log is None or max_log is None or operations is None:
        return 1

    # Validation (reference comprehensive_benchmarks.rs:96-152)
    if min_log > max_log:
        print("error: --min-log-size must be <= --max-log-size")
        return 1
    if not (2 <= min_log <= 20) or not (2 <= max_log <= 20):
        print("error: log sizes must be within 2..=20")
        return 1

    if mode == "help" or "--help" in args or "-h" in args:
        print(_HELP)
        return 0
    if mode == "quick":
        ProtocolBenchmarks.run_quick_benchmark()
    elif mode == "full":
        ProtocolBenchmarks.run_comprehensive_benchmark()
    elif mode == "dev":
        ProtocolBenchmarks.run_dev_benchmark()
    elif mode == "custom":
        ProtocolBenchmarks.run_comprehensive_benchmark_with_params(
            min_log, max_log, operations
        )
    elif mode == "twist-only":
        results = ProtocolBenchmarks.benchmark_twist_scaling_range(min_log, max_log)
        ProtocolBenchmarks.print_scaling_results("Twist", results)
    elif mode == "shout-only":
        results = ProtocolBenchmarks.benchmark_shout_scaling_range(min_log, max_log)
        ProtocolBenchmarks.print_scaling_results("Shout", results)
    elif mode in ("sound", "bits"):
        _run_sound_modes(mode, min_log, max_log, operations)
    else:
        print(f"error: unknown mode '{mode}'\n")
        print(_HELP)
        return 1
    return 0


def _run_sound_modes(mode: str, min_log: int, max_log: int,
                     operations: int) -> None:
    """Time the tnsh sound-protocol tiers (no reference analogue):
    ``sound`` = TwistSound/ShoutSound (PST-bound, sparse-capable),
    ``bits`` = TwistBits/ShoutBits (trapdoor-free bit columns)."""
    import random
    import time

    from ..core.params import setup_params
    from ..field.fr import Fr
    from ..protocols.shout import LookupTable
    from ..protocols.twist import MemoryTrace

    if mode == "bits":
        from ..protocols.twist_bits import ShoutBits as SP, TwistBits as TP
        tier = "trapdoor-free bit-column"
    else:
        from ..protocols.sound import ShoutSound as SP, TwistSound as TP
        tier = "verifier-enforced sound"

    print(f"\n=== {tier} protocols "
          f"(K=2^{min_log}..2^{max_log}, {operations} ops) ===")
    print("Protocol | log K | Prove (ms) | Verify (ms) | Valid")
    print("---------|-------|------------|-------------|------")
    pp, vp = setup_params(max(max_log, 3))
    for log in range(min_log, max_log + 1):
        k = 1 << log
        random.seed(log)
        tr = MemoryTrace(k)
        for i in range(operations):
            if i % 3 == 0:
                tr.write(random.randrange(k), Fr(42 * i + 1))
            else:
                tr.read(random.randrange(k))
        t0 = time.perf_counter()
        proof = TP.prove(tr, pp)
        t1 = time.perf_counter()
        ok = TP.verify(proof, vp)
        t2 = time.perf_counter()
        print(f"Twist    | {log:5d} | {1e3 * (t1 - t0):10.2f} "
              f"| {1e3 * (t2 - t1):11.2f} | {ok}")
        table = LookupTable([Fr(i * i + 1) for i in range(k)])
        for _ in range(operations):
            table.lookup(random.randrange(k))
        t0 = time.perf_counter()
        sproof = SP.prove(table, pp)
        t1 = time.perf_counter()
        ok = SP.verify(sproof, table.entries, vp)
        t2 = time.perf_counter()
        print(f"Shout    | {log:5d} | {1e3 * (t1 - t0):10.2f} "
              f"| {1e3 * (t2 - t1):11.2f} | {ok}")


if __name__ == "__main__":
    from ..core.device import setup_compile_cache

    setup_compile_cache()
    raise SystemExit(main())
