"""tnsh — "Twist 'n' Shout" in JAX.

A zk-SNARK memory-checking framework (JAX/XLA and Pallas on the GPU, a C++
host layer) with the
capabilities of the reference Rust crate ``twist-and-shout``
(vats98754/multilinear-map-cryptography): the Twist (read-write memory
checking) and Shout (read-only lookup) protocols over multilinear
extensions, the sum-check protocol and KZG commitments on BN254, with
bit-exact Fiat-Shamir transcripts.

Public surface mirrors the reference's crate root re-exports
(reference src/lib.rs:49-56).
"""

from .bench.harness import BenchmarkResults, ProtocolBenchmarks, benchmark_setup
from .commit.kzg import (
    CommitmentScheme,
    KZGCommitment,
    KZGCommitmentValue,
    KZGProof,
    KZGVectorCommitment,
    VectorCommitmentScheme,
)
from .core.params import (
    CommitmentParams,
    CommitmentVerificationKey,
    ProverParams,
    VerifierParams,
    setup_params,
)
from .core.transcript import Transcript
from .errors import (
    CommitmentError,
    InvalidParametersError,
    PolynomialError,
    ProofGenerationError,
    ProofVerificationError,
    SumCheckError,
    TwistAndShoutError,
)
from .field.fr import Fr
from .field.fr import Fr as FieldElement
from .field.g1 import G1
from .field.g1 import G1 as G1Element
from .field.g2 import G2
from .field.g2 import G2 as G2Element
from .iop.sumcheck import SumCheck, SumCheckProof, SumCheckVerifier
from .poly.lt import LessThanPolynomial
from .poly.mle import MultilinearExtension
from .commit.mkzg import (
    MLOpeningProof,
    MultilinearKZG,
    setup_multilinear_params,
)
from .protocols.shout import LookupOp, LookupTable, Shout, ShoutProof
from .protocols.sound import (
    ShoutSound,
    ShoutSoundProof,
    TwistSound,
    TwistSoundProof,
)
from .protocols.twist import (
    MemoryOp,
    MemoryOpKind,
    MemoryTrace,
    Twist,
    TwistProof,
)
from .protocols.twist_bits import (
    ShoutBits,
    ShoutBitsCommProof,
    ShoutBitsCommitted,
    ShoutBitsProof,
    TwistBits,
    TwistBitsProof,
)

__version__ = "0.1.0"

__all__ = [
    "BenchmarkResults",
    "CommitmentError",
    "CommitmentParams",
    "CommitmentScheme",
    "CommitmentVerificationKey",
    "FieldElement",
    "Fr",
    "G1",
    "G1Element",
    "G2",
    "G2Element",
    "InvalidParametersError",
    "KZGCommitment",
    "KZGCommitmentValue",
    "KZGProof",
    "KZGVectorCommitment",
    "LessThanPolynomial",
    "LookupOp",
    "LookupTable",
    "MemoryOp",
    "MemoryOpKind",
    "MemoryTrace",
    "MLOpeningProof",
    "MultilinearExtension",
    "MultilinearKZG",
    "PolynomialError",
    "ProofGenerationError",
    "ProofVerificationError",
    "ProtocolBenchmarks",
    "ProverParams",
    "Shout",
    "ShoutProof",
    "ShoutBits",
    "ShoutBitsCommProof",
    "ShoutBitsCommitted",
    "ShoutBitsProof",
    "ShoutSound",
    "ShoutSoundProof",
    "SumCheck",
    "SumCheckError",
    "SumCheckProof",
    "SumCheckVerifier",
    "Transcript",
    "Twist",
    "TwistAndShoutError",
    "TwistProof",
    "TwistBits",
    "TwistBitsProof",
    "TwistSound",
    "TwistSoundProof",
    "VectorCommitmentScheme",
    "VerifierParams",
    "benchmark_setup",
    "setup_multilinear_params",
    "setup_params",
]
