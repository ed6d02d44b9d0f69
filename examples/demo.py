"""Demo walkthrough — port of the reference ``examples/demo.rs`` (demo.rs:6-207).

Four parts:
  1. Twist read-write memory consistency proof,
  2. Shout lookups into a square-number table,
  3. KZG commit/open/verify of 3x^2 + 2x + 1 at x = 5 (value 86),
  4. Multilinear extensions: XOR truth table and a one-hot vector.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tnsh import (  # noqa: E402
    Fr,
    KZGCommitment,
    LookupTable,
    MemoryTrace,
    MultilinearExtension,
    Shout,
    Twist,
    setup_params,
)


def field_to_u64(x: Fr) -> int:
    """Small-value display helper (reference demo.rs field_to_u64)."""
    return int(x) if int(x) < (1 << 64) else -1


def main() -> None:
    print("=== Twist and Shout Demo (tnsh) ===\n")

    print("Part 1: Twist — read-write memory checking")
    prover_params, verifier_params = setup_params(4)
    trace = MemoryTrace(16)
    trace.write(0, Fr(42))
    trace.write(1, Fr(73))
    v = trace.read(0)
    print(f"  wrote 42 @0, 73 @1; read @0 -> {field_to_u64(v)}")
    twist = Twist(prover_params)
    proof = twist.prove(trace)
    print(f"  proof valid: {twist.verify(proof, verifier_params)}\n")

    print("Part 2: Shout — read-only lookups")
    table = LookupTable([Fr(i * i) for i in range(8)])
    for idx in (2, 5, 7):
        print(f"  table[{idx}] = {field_to_u64(table.lookup(idx))}")
    shout = Shout(prover_params)
    sproof = shout.prove(table)
    print(f"  proof valid: {shout.verify(sproof, verifier_params)}\n")

    print("Part 3: KZG commitment to 3x^2 + 2x + 1")
    poly = [Fr(1), Fr(2), Fr(3)]
    commitment = KZGCommitment.commit(prover_params.commitment_params, poly)
    point = Fr(5)
    value, opening = KZGCommitment.open(
        prover_params.commitment_params, poly, point
    )
    print(f"  P(5) = {field_to_u64(value)} (expected 86)")
    ok = KZGCommitment.verify(
        verifier_params.commitment_vk, commitment, point, value, opening
    )
    print(f"  opening valid: {ok}\n")

    print("Part 4: Multilinear extensions")
    xor_mle = MultilinearExtension.from_evaluations(
        [Fr(0), Fr(1), Fr(1), Fr(0)]  # XOR truth table
    )
    for a in (0, 1):
        for b in (0, 1):
            val = xor_mle.evaluate([Fr(a), Fr(b)])
            print(f"  XOR({a},{b}) = {field_to_u64(val)}")
    one_hot = MultilinearExtension.one_hot(3, 5)
    bits = [Fr((5 >> j) & 1) for j in range(3)]
    print(f"  one_hot(3,5) at index-5 bits: {field_to_u64(one_hot.evaluate(bits))}")

    print("\nPart 5: verifier-enforced sound mode (tnsh extension)")
    from tnsh import ShoutSound, TwistSound

    strace = MemoryTrace(8)
    strace.write(1, Fr(42))
    strace.write(1, Fr(100))
    strace.read(1)
    tsp = TwistSound.prove(strace, prover_params)
    print(f"  sound Twist proof valid: {TwistSound.verify(tsp, verifier_params)}")
    stable = LookupTable([Fr(i * i) for i in range(8)])
    stable.lookup(3)
    stable.lookup(6)
    ssp = ShoutSound.prove(stable, prover_params)
    ok = ShoutSound.verify(ssp, stable.entries, verifier_params)
    print(f"  sound Shout proof valid: {ok}")
    # tamper with the claimed read-value evaluation -> cryptographic
    # rejection (col_values = [ot, rv, wv] at the sum-check point)
    tsp.col_values[1] = tsp.col_values[1] + Fr(1)
    print(f"  tampered sound proof rejected: {not TwistSound.verify(tsp, verifier_params)}")

    print("\nPart 6: trapdoor-free bit-column protocols (tnsh extension)")
    # All commitments are T-point columns, so a ceremony SRS with only
    # log T variables covers everything — no cube SRS, no trapdoor
    # anywhere (SOUNDNESS.md).
    from tnsh import ShoutBits, TwistBits

    tbp = TwistBits.prove(strace_fresh(), prover_params)
    print(f"  TwistBits proof valid: {TwistBits.verify(tbp, verifier_params)}")
    sbp = ShoutBits.prove(stable, prover_params)
    ok = ShoutBits.verify(sbp, stable.entries, verifier_params)
    print(f"  ShoutBits proof valid: {ok}")
    tbp.v_val = tbp.v_val + Fr(1)
    print(
        f"  tampered Val claim rejected: "
        f"{not TwistBits.verify(tbp, verifier_params)}"
    )
    # committed-table Shout: the verifier sees a table COMMITMENT, not
    # the entries — O(log K + log T) verification
    from tnsh import ShoutBitsCommitted

    tcomm = ShoutBitsCommitted.preprocess(stable.entries)
    scp = ShoutBitsCommitted.prove(stable, prover_params)
    ok = ShoutBitsCommitted.verify(scp, tcomm, verifier_params)
    print(f"  ShoutBitsCommitted (log-verifier) proof valid: {ok}")
    print("\nDemo complete.")


def strace_fresh() -> "MemoryTrace":
    from tnsh import Fr, MemoryTrace

    tr = MemoryTrace(8)
    tr.write(1, Fr(42))
    tr.write(1, Fr(100))
    tr.read(1)
    return tr


if __name__ == "__main__":
    main()
