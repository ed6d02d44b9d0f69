"""Trusted setup and protocol parameters.

Bit-exact port of ``setup_params`` and the parameter structs (reference
utils.rs:22-131).  The setup is deterministic: ChaCha20 seeded with
``[42u8; 32]`` (utils.rs:81), tau drawn via the ark-ff Fr::rand replica,
powers of tau ``[tau^i]_1`` for ``i = 0..=max_degree`` with
``max_degree = next_pow2(max_operations)`` and
``max_operations = 2^(log_size + 2)`` (utils.rs:80, 89), ``[tau]_2``, and a
32-byte Fiat-Shamir seed drawn from the same RNG stream (utils.rs:100-102).

Device note: the values of ``g1_powers`` are mathematically fixed
(tau^i * G), so the host computes tau-powers in Fr and uses a fixed-base
windowed multiplier; the device MSMs (tnsh.commit.msm_sched,
tnsh.commit.msm_jax) consume these points in limb form for proving-time
commitments.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional

from ..field.fr import Fr
from ..field.g1 import G1
from ..field.g2 import G2
from .rng import ChaCha20Rng, fr_rand

#: Fixed trusted-setup seed (reference utils.rs:81).
SETUP_SEED = bytes([42]) * 32


@dataclass
class CommitmentParams:
    """KZG commitment parameters (reference utils.rs:54-63)."""

    g1_powers: List[G1]
    g2_generator: G2
    #: Kept "for transparency, not used in production" like the reference
    #: (utils.rs:61-62, 107).
    tau: Optional[Fr]


@dataclass
class CommitmentVerificationKey:
    """KZG verification key (reference utils.rs:67-76)."""

    g1_generator: G1
    g2_generator: G2
    g2_tau: G2


@dataclass
class ProverParams:
    """Prover parameters (reference utils.rs:22-34)."""

    log_size: int
    max_operations: int
    commitment_params: CommitmentParams
    fiat_shamir_seed: bytes


@dataclass
class VerifierParams:
    """Verifier parameters (reference utils.rs:38-50)."""

    log_size: int
    max_operations: int
    commitment_vk: CommitmentVerificationKey
    fiat_shamir_seed: bytes


def _next_power_of_two(n: int) -> int:
    """Rust ``usize::next_power_of_two`` (0 -> 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


#: Above this SRS size, points stay resident in native memory (no Python
#: G1 objects): a 2^20-point SRS as Python objects costs GBs; as a native
#: handle it is 96 MB of packed limbs.
LARGE_SRS_THRESHOLD = 1 << 14


class NativeSRS:
    """Lazy sequence view over a native-resident SRS handle.

    Supports ``len`` and point readback by index so the small-scale API
    shape (``g1_powers[i]``) keeps working; MSMs run natively against the
    handle without materializing points (tnsh.commit.kzg routes on this
    type).
    """

    __slots__ = ("srs_id", "_len")

    def __init__(self, srs_id: int):
        from .. import _native

        self.srs_id = srs_id
        self._len = _native.srs_size(srs_id)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx):
        from .. import _native

        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(self._len))]
        if idx < 0:
            idx += self._len
        if not (0 <= idx < self._len):
            raise IndexError(idx)
        return _native.srs_point(self.srs_id, idx)


def _fixed_base_powers(base: G1, scalars: List[Fr]) -> List[G1]:
    """[s * base for s in scalars] with a shared 8-bit window table.

    Mathematically identical to the reference's per-power scalar-muls
    (utils.rs:93-96) but ~6x fewer group ops on the host.
    """
    # table[w][d] = d * (2^(8w) * base), d in 0..255
    max_bits = 256
    n_windows = max_bits // 8
    tables: List[List[G1]] = []
    window_base = base
    for _ in range(n_windows):
        row = [G1.zero(), window_base]
        for d in range(2, 256):
            row.append(row[d - 1].add(window_base))
        tables.append(row)
        for _ in range(8):
            window_base = window_base.double()
    out = []
    for s in scalars:
        k = int(s)
        acc = G1.zero()
        w = 0
        while k:
            d = k & 0xFF
            if d:
                acc = acc.add(tables[w][d])
            k >>= 8
            w += 1
        out.append(acc)
    return out


@lru_cache(maxsize=16)
def setup_params(log_size: int):
    """Deterministic trusted setup (reference utils.rs:79-131).

    Returns ``(ProverParams, VerifierParams)``.  Cached per ``log_size`` —
    the output is a pure function of its argument (fixed seed), so caching
    is observationally identical to the reference's recomputation.
    """
    max_operations = 1 << (log_size + 2)
    rng = ChaCha20Rng.from_seed(SETUP_SEED)

    tau = fr_rand(rng)
    g1_gen = G1.generator()
    g2_gen = G2.generator()

    max_degree = _next_power_of_two(max_operations)
    tau_powers: List[Fr] = []
    current = Fr(1)
    for _ in range(max_degree + 1):
        tau_powers.append(current)
        current = current * tau

    import os

    from .. import _native

    if _native.available and not os.environ.get("TNSH_NO_NATIVE"):
        if max_degree + 1 >= LARGE_SRS_THRESHOLD:
            g1_powers = NativeSRS(
                _native.srs_create_fixed_base(g1_gen, tau_powers)
            )
        else:
            g1_powers = _native.fixed_base_batch(g1_gen, tau_powers)
        g2_tau = _native.g2_scalar_mul(g2_gen, tau)
    else:
        g1_powers = _fixed_base_powers(g1_gen, tau_powers)
        g2_tau = g2_gen.scalar_mul(tau)

    fiat_shamir_seed = rng.fill_bytes(32)

    commitment_params = CommitmentParams(
        g1_powers=g1_powers,
        g2_generator=g2_gen,
        tau=tau,
    )
    commitment_vk = CommitmentVerificationKey(
        g1_generator=g1_gen,
        g2_generator=g2_gen,
        g2_tau=g2_tau,
    )
    prover_params = ProverParams(
        log_size=log_size,
        max_operations=max_operations,
        commitment_params=commitment_params,
        fiat_shamir_seed=fiat_shamir_seed,
    )
    verifier_params = VerifierParams(
        log_size=log_size,
        max_operations=max_operations,
        commitment_vk=commitment_vk,
        fiat_shamir_seed=fiat_shamir_seed,
    )
    return prover_params, verifier_params
