"""Limb representation of 254-bit field elements for device kernels.

This is the data-layout half of the arkworks-replacement layer (SURVEY §7.0
"Field layer first, as data layout + kernels, not a class").  Design:

  * **12-bit limbs x 22 planes (264 bits)** stored as int32.  12 bits is
    chosen so every intermediate of schoolbook multiplication and interleaved
    Montgomery reduction stays strictly below 2^31:
      - limb product < 2^24,
      - full-product column: <= 22 products  -> < 2^28.5,
      - reduction adds <= 22 more 24-bit terms + carries -> < 2^30.2.
    No uint tricks, no 64-bit emulation — pure int32 arithmetic.
  * **Limb-major layout ``(L, *batch)``**: the batch dimension is the fast,
    contiguous axis; every field op is then a 22-plane elementwise
    computation over the batch.
  * **Montgomery form** with R = 2^264.  Host <-> device conversion helpers
    go through 32-byte little-endian words (exact).

Both BN254 moduli share the layout; ``FR_SPEC`` / ``FQ_SPEC`` carry the
per-field constants.  The compute kernels live in ``tnsh.field.fr_jax``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Sequence

import numpy as np

from .fq import Q
from .fr import MODULUS as R_MOD

#: Limb width in bits and limb count (22 * 12 = 264 >= 254).
LIMB_BITS = 12
NUM_LIMBS = 22
LIMB_MASK = (1 << LIMB_BITS) - 1

#: Montgomery radix for this layout.
R_LIMB = 1 << (LIMB_BITS * NUM_LIMBS)


def int_to_limbs(value: int) -> List[int]:
    """Little-endian 12-bit limb decomposition (length NUM_LIMBS)."""
    return [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NUM_LIMBS)]


def limbs_to_int(limbs: Sequence[int]) -> int:
    acc = 0
    for i, limb in enumerate(limbs):
        acc += int(limb) << (LIMB_BITS * i)
    return acc


@dataclass(frozen=True)
class FieldSpec:
    """Constants for one prime field in the limb layout."""

    name: str
    modulus: int
    #: -modulus^{-1} mod 2^LIMB_BITS (Montgomery n').
    n0: int = field(init=False)
    #: R mod p and R^2 mod p for Montgomery conversion.
    r_mod_p: int = field(init=False)
    r2_mod_p: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(
            self, "n0", (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        )
        object.__setattr__(self, "r_mod_p", R_LIMB % self.modulus)
        object.__setattr__(
            self, "r2_mod_p", (R_LIMB * R_LIMB) % self.modulus
        )

    # numpy constant planes (host side; jax converts on use)
    def modulus_limbs(self) -> np.ndarray:
        return np.array(int_to_limbs(self.modulus), dtype=np.int32)

    def one_mont_limbs(self) -> np.ndarray:
        return np.array(int_to_limbs(self.r_mod_p), dtype=np.int32)

    def r2_limbs(self) -> np.ndarray:
        return np.array(int_to_limbs(self.r2_mod_p), dtype=np.int32)


FR_SPEC = FieldSpec("fr", R_MOD)
FQ_SPEC = FieldSpec("fq", Q)


# ---------------------------------------------------------------------------
# Host packing (exact, Python ints)
# ---------------------------------------------------------------------------

def pack_ints(values: Sequence[int], spec: FieldSpec, montgomery: bool = True
              ) -> np.ndarray:
    """Pack canonical ints into a ``(NUM_LIMBS, N)`` int32 plane array.

    With ``montgomery=True`` (default for compute), stores v * R mod p.
    """
    p = spec.modulus
    r = R_LIMB % p if montgomery else 1
    data = b"".join((int(v) * r % p).to_bytes(32, "little") for v in values)
    return bytes_to_limb_planes(
        np.frombuffer(data, dtype=np.uint8).reshape(-1, 32))


def bytes_to_limb_planes(b: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 little-endian values -> (NUM_LIMBS, n) int32 limb
    planes (no Montgomery conversion)."""
    n = b.shape[0]
    padded = np.zeros((n, 34), dtype=np.uint8)
    padded[:, :32] = b
    u = padded.astype(np.uint32)
    out = np.empty((NUM_LIMBS, n), dtype=np.int32)
    for i in range(NUM_LIMBS):
        b0, off = (LIMB_BITS * i) // 8, (LIMB_BITS * i) % 8
        v = (u[:, b0] | (u[:, b0 + 1] << 8) | (u[:, b0 + 2] << 16)) >> off
        out[i] = (v & LIMB_MASK).astype(np.int32)
    return out


def unpack_ints(planes: np.ndarray, spec: FieldSpec, montgomery: bool = True
                ) -> List[int]:
    """Inverse of :func:`pack_ints`; returns canonical ints in [0, p)."""
    planes = np.asarray(planes)
    p = spec.modulus
    rinv = pow(R_LIMB, -1, p)
    out = []
    for j in range(planes.shape[1]):
        v = limbs_to_int(planes[:, j])
        if montgomery:
            v = v * rinv % p
        out.append(v % p)
    return out


def pack_scalar_bits(values: Sequence[int], num_bits: int = 256) -> np.ndarray:
    """Pack scalars as a ``(num_bits, N)`` int32 bit matrix (LSB first).

    Consumed by the MSM double-and-add kernel, which indexes bit planes
    dynamically inside a ``lax.fori_loop``.
    """
    out = np.zeros((num_bits, len(values)), dtype=np.int32)
    for j, v in enumerate(values):
        v = int(v)
        for i in range(num_bits):
            out[i, j] = (v >> i) & 1
    return out
