"""Where the device routes run, and where compiled programs are cached.

One gate decides whether the provers hand work to the accelerator: it is
on when JAX's default backend is a GPU.  On the CPU a device route runs
only when a caller opts in with ``TNSH_DEVICE_MSM=1`` (tests do, to drive
the device code through XLA:CPU); ``TNSH_DEVICE_MSM=0`` turns it off
everywhere.
"""

from __future__ import annotations

import os

#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: fixed inside the checkout (listed in .gitignore), so that every entry
#: point of one checkout finds the programs another one compiled.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    import jax

    return jax.default_backend() == "gpu"


def device_msm_enabled() -> bool:
    """Gate for the device share of large SRS MSMs (``kzg.msm``)."""
    flag = os.environ.get("TNSH_DEVICE_MSM", "")
    if flag in ("0", "1"):
        return flag == "1"
    return on_gpu()


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it
    and nothing else is set; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.  Entry points call this once, before the
    first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
