"""Univariate interpolation and polynomial utilities.

Port of ``poly_utils`` (reference polynomials.rs:296-371) with the O(n^3)
Lagrange pipeline replaced by algorithms that produce the *same coefficient
vectors* with far less work (exact field arithmetic makes them bit-identical;
SURVEY §7.0 "Interpolation"):

  * ``lagrange_interpolate(points)`` — general (point, value) pairs; Newton
    divided differences + Horner expansion, O(n^2).  Output is a length-n
    coefficient vector (low-degree first) exactly like the reference
    (polynomials.rs:301-352 allocates ``vec![0; n]`` and accumulates).
  * ``interpolate_on_range(values)`` — the dominant prover path
    (``vector_to_polynomial``, reference twist.rs:307-316, shout.rs:277-286)
    specialized to the domain {0, 1, ..., n-1}: divided-difference
    denominators are the small integers (j - i), batch-inverted once.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import List, Sequence, Tuple

from ..field.fr import MODULUS, Fr

_P = MODULUS


def lagrange_interpolate(points: Sequence[Tuple[Fr, Fr]]) -> List[Fr]:
    """Coefficients (low first) of the unique degree<n polynomial through
    ``points``; returns a length-n vector (reference polynomials.rs:301-352).
    """
    n = len(points)
    if n == 0:
        return []
    xs = [int(x) for x, _ in points]
    ys = [int(y) for _, y in points]

    # Newton divided differences: table[k] = f[x_0, ..., x_k]
    coeffs_newton: List[int] = [ys[0]]
    column = list(ys)
    for level in range(1, n):
        new_column = []
        for i in range(n - level):
            num = (column[i + 1] - column[i]) % _P
            den = (xs[i + level] - xs[i]) % _P
            new_column.append(num * pow(den, -1, _P) % _P)
        column = new_column
        coeffs_newton.append(column[0])

    # Expand Newton form to monomial coefficients:
    # p(x) = c_{n-1}; for k = n-2..0: p(x) = p(x) * (x - x_k) + c_k
    poly = [0] * n
    poly[0] = coeffs_newton[n - 1]
    deg = 0
    for k in range(n - 2, -1, -1):
        xk = xs[k]
        # multiply by (x - x_k): shift up, subtract x_k * poly
        for d in range(deg, -1, -1):
            poly[d + 1] = (poly[d + 1] + poly[d]) % _P
            poly[d] = (-poly[d] * xk) % _P
        deg += 1
        poly[0] = (poly[0] + coeffs_newton[k]) % _P
    return [Fr(c) for c in poly]


@lru_cache(maxsize=64)
def _range_inverses(n: int) -> Tuple[int, ...]:
    """Modular inverses of 1..n-1 (batch-inverted)."""
    if n <= 1:
        return ()
    acc = [1]
    for k in range(1, n):
        acc.append(acc[-1] * k % _P)
    inv = pow(acc[-1], -1, _P)
    out = [0] * n
    for k in range(n - 1, 0, -1):
        out[k] = inv * acc[k - 1] % _P
        inv = inv * k % _P
    return tuple(out[1:])  # inverses of 1..n-1


def interpolate_on_range(values: Sequence[Fr]) -> List[Fr]:
    """Interpolate over the domain {0..n-1} — the ``vector_to_polynomial``
    hot path (reference twist.rs:307-316).  O(n^2), denominators are small
    integers batch-inverted once per size.  Dispatches to the C++ native
    kernel (tnsh/_native) when available; both paths are exact and
    bit-identical."""
    n = len(values)
    if n == 0:
        return []
    if n >= 8 and not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native

        if _native.available:
            return _native.interp_range(values)
    inv = _range_inverses(n)  # inv[k-1] = 1/k mod p
    column = [int(v) for v in values]
    coeffs_newton: List[int] = [column[0]]
    for level in range(1, n):
        ilvl = inv[level - 1]
        column = [
            (column[i + 1] - column[i]) * ilvl % _P for i in range(n - level)
        ]
        coeffs_newton.append(column[0])

    poly = [0] * n
    poly[0] = coeffs_newton[n - 1]
    deg = 0
    for k in range(n - 2, -1, -1):
        for d in range(deg, -1, -1):
            poly[d + 1] = (poly[d + 1] + poly[d]) % _P
            poly[d] = (-poly[d] * k) % _P
        deg += 1
        poly[0] = (poly[0] + coeffs_newton[k]) % _P
    return [Fr(c) for c in poly]


def evaluate_polynomial(coeffs: Sequence[Fr], point: Fr) -> Fr:
    """Horner evaluation (reference polynomials.rs:355-357)."""
    acc = 0
    p = int(point)
    for c in reversed(coeffs):
        acc = (acc * p + int(c)) % _P
    return Fr(acc)


def derivative(coeffs: Sequence[Fr]) -> List[Fr]:
    """Formal derivative (reference polynomials.rs:360-370)."""
    if len(coeffs) <= 1:
        return [Fr(0)]
    return [Fr(int(c) * i) for i, c in enumerate(coeffs) if i >= 1]
