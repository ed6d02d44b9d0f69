"""Framework configuration.

The reference's config surface is cargo features + ``setup_params(log_size)``
with derived limits + hand-rolled CLI flags (SURVEY §5 config row).  tnsh
centralizes the equivalent knobs in one dataclass consumed by the bench CLI
and the parallel layer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class TnshConfig:
    """Global knobs (mirrors the reference's feature/flag surface)."""

    #: log2 of the memory/table size (reference setup_params arg).
    log_size: int = 4
    #: Override for max operations; None derives 2^(log_size+2) like the
    #: reference (utils.rs:80).
    max_operations: Optional[int] = None
    #: Use the C++ native host kernels when available (cargo feature
    #: ``parallel``/arkworks analog).  Env: TNSH_NO_NATIVE=1 disables.
    use_native: bool = True
    #: Use the JAX device limb kernels for large-size proving paths.
    use_jax: bool = True
    #: Mesh axis sizes for multi-chip runs, e.g. (8,) for 1-D data sharding.
    mesh_shape: Tuple[int, ...] = (1,)
    #: Optional jax.profiler trace output directory.
    profile_dir: Optional[str] = None

    def __post_init__(self) -> None:
        if not (2 <= self.log_size <= 30):
            raise ValueError("log_size must be within 2..=30")
        if os.environ.get("TNSH_NO_NATIVE"):
            self.use_native = False

    @property
    def derived_max_operations(self) -> int:
        if self.max_operations is not None:
            return self.max_operations
        return 1 << (self.log_size + 2)


def from_env() -> TnshConfig:
    """Build a config from TNSH_* environment variables."""
    cfg = TnshConfig(
        log_size=int(os.environ.get("TNSH_LOG_SIZE", "4")),
        use_jax=os.environ.get("TNSH_NO_JAX", "") == "",
        profile_dir=os.environ.get("TNSH_PROFILE_DIR") or None,
    )
    mesh = os.environ.get("TNSH_MESH")
    if mesh:
        cfg.mesh_shape = tuple(int(x) for x in mesh.split(",") if x)
    return cfg
