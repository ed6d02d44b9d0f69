"""Profiling and tracing utilities.

Device-aware replacement for the reference's wall-clock-only instrumentation
(SURVEY §5 tracing row; benchmarks.rs:78-111 phase timers):

  * ``PhaseTimer`` — named phase accounting with honest device fencing:
    every phase exit calls ``jax.block_until_ready`` on pending device
    values registered via ``fence()``.
  * ``trace()`` — context manager around ``jax.profiler.trace`` emitting a
    TensorBoard-compatible trace directory for per-kernel device timelines.
  * ``phase_report()`` — JSON-friendly summary consumed by the bench
    harness.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase, device-fenced."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    _pending: List[object] = field(default_factory=list)

    def fence(self, *device_values) -> None:
        """Register device values to synchronize before closing a phase."""
        self._pending.extend(device_values)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield self
        finally:
            if self._pending:
                try:
                    import jax

                    jax.block_until_ready(self._pending)
                except Exception:
                    pass
                self._pending.clear()
            elapsed = time.perf_counter() - start
            self.phases[name] = self.phases.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def phase_report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": total,
                "count": self.counts[name],
                "mean_ms": total / self.counts[name] * 1e3,
            }
            for name, total in self.phases.items()
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """jax.profiler trace context; no-op if profiling is unavailable."""
    if log_dir is None:
        yield
        return
    try:
        import jax

        with jax.profiler.trace(log_dir):
            yield
    except Exception:
        yield
