"""Structured O(T·logK) sum-check oracles for the bit-column protocols.

The dense generic-degree oracle (tnsh.iop.sumcheck_d.DenseSopOracleD)
materializes every chi cube — O(K·T·logK) per round, impossible at
north-star scale.  These oracles exploit the structure SOUNDNESS.md's
"O(T) prover plan" identifies: every cube factor of the bits protocols
is (a weighted sum of) one-hots eq(k, bits(j)), and binding one k bit at
a time restricts each one-hot to a per-cycle scalar times a shorter
one-hot, so k-round evaluations are O(T) table walks with suffix
lookups, no cube ever built.

``ShoutBitsSparseOracle`` covers the single-one-hot term shapes of
ShoutBits' phase A:

  * (coeff, j_tables, bits, k_table):
      Σ_{k,j} coeff · Π_m j_tables[m](j) · eq(k, bits(j)) · k_table(k)
  * (coeff, j_tables, None, None):  j-lifted column terms (constant
      along k, scaled by 2^{free k vars} during the k rounds).

During the logK k rounds, round evaluations at X = 0..degree are

  g(X) = Σ_j w_j · A_j · chi(X, b_i(j)) · (T_i[2 s_j] + X·ΔT_i[s_j])

with A_j the running product of bound-bit chi scalars, T_i the folded
k_table and s_j the cycle's remaining address-suffix — O(T) per round.
After the k binds the restricted polynomial over j is a product of the
logK chi COLUMNS (each multilinear in j), so the j phase delegates to
the device-backed generic-degree sop oracle (JaxSopOracleD) or its
Python twin, at O(T·logK) per round.

Round polynomials are the SAME polynomials the dense oracle computes,
evaluated at the same points with exact arithmetic — bit-identical
proofs (tests/test_twist_bits.py pins this).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..errors import SumCheckError
from ..field.fr import MODULUS, Fr

_P = MODULUS


def _chi(x: int, b: int) -> int:
    """(1-x)(1-b) + x b mod p for boolean b and arbitrary x."""
    return (x if b else (1 - x)) % _P


class TwistBitsSparseOracle:
    """Structured oracle for the FULL TwistBits phase-A term system,
    including the virtual-Val pair terms, at O(T + K) per k round.

    The Val insight (SOUNDNESS.md plan): V(k, j) = Σ_{j'<j} ic(j') ·
    eq(k, wb(j')) — a prefix sum of write one-hots.  A term like
    READ = eq1(j)·rt(j)·eq(k, rb(j))·V(k, j) therefore sums, per cycle
    j, over earlier writes whose remaining wb-suffix matches the read's
    rb-suffix (the product of the two one-hots over the free k bits is
    the suffix-match indicator).  One ascending-j walk per round
    maintains suffix buckets B[s][b] = Σ ic(j')·A^w_{j'} over earlier
    writes with remaining suffix s and current bit b, giving

      V-part(X, s) = (1-X)·B[s][0] + X·B[s][1]

    in O(1) per cycle.  eq(sigma,(k,j)) factorizes as
    eq(sigma_k, k)·eq(sigma_j, j), so the INC terms are one-hot terms
    with k_table = eq(sigma_k) (folded normally).

    Constructor takes the protocol columns and challenge tables and
    mirrors ``TwistBits.prove``'s dense term list exactly; proofs are
    bit-identical (tests pin this, plus the frozen wire-v3 digests).
    """

    def __init__(self, log_k: int, log_t: int, *, rb, wb, ot, rv, wv, ic,
                 eq1, eqs_k, eqs_j, eqb, alpha_powers, kinv, degree: int):
        import os

        self.log_k = log_k
        self.log_t = log_t
        self.num_vars = log_k + log_t
        self.degree = degree
        self._round = 0
        self._delegate = None
        self._challenges: List[Fr] = []
        t_size = 1 << log_t
        self._tbk = None
        # TNSH_BITS_FORCE_JAX: the j phase runs on the device oracle
        # (JaxSopOracleD); the k phase stays native when available, and
        # the Python state below is kept to build the device delegate.
        self._device_j = bool(os.environ.get("TNSH_BITS_FORCE_JAX"))
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                import numpy as np

                ra = np.zeros(t_size, dtype=np.uint64)
                wa = np.zeros(t_size, dtype=np.uint64)
                for i in range(log_k):
                    ra |= np.asarray(rb[i], dtype=np.uint64) << np.uint64(i)
                    wa |= np.asarray(wb[i], dtype=np.uint64) << np.uint64(i)
                self._tbk = _native.tbk_create(
                    log_k, log_t, ra, wa, ot, ot, rv, wv, ic,
                    eq1, eqs_j, eqb, eqs_k, alpha_powers, kinv, degree + 1,
                )
                if not self._device_j:
                    return
        as_int = lambda tab: [int(v) % _P for v in tab]
        self._ot = as_int(ot)
        self._rv = as_int(rv)
        self._wv = as_int(wv)
        self._ic = as_int(ic)
        self._eq1 = as_int(eq1)
        self._eqsj = as_int(eqs_j)
        self._eqb = as_int(eqb)
        self._eqsk = as_int(eqs_k)  # folded during k rounds
        self._rb = rb
        self._wb = wb
        self._r_addr = [0] * t_size
        self._w_addr = [0] * t_size
        for i in range(log_k):
            for j in range(t_size):
                self._r_addr[j] |= (int(rb[i][j]) & 1) << i
                self._w_addr[j] |= (int(wb[i][j]) & 1) << i
        self._Ar = [1] * t_size
        self._Aw = [1] * t_size
        self._ap = [int(a) % _P for a in alpha_powers]
        self._kinv = int(kinv) % _P

    def _k_round_evals(self) -> List[Fr]:
        npts = self.degree + 1
        i = self._round
        free_after = self.log_k - i - 1
        pow_free = pow(2, free_after, _P)
        t_size = 1 << self.log_t
        E = self._eqsk
        a1 = self._ap[1]
        acc = [0] * npts
        xs = range(npts)

        # --- j-lifted column terms (constant in X), one pass -------------
        s_lift = 0
        kv = self._kinv
        for j in range(t_size):
            e1 = self._eq1[j]
            s_lift -= kv * e1 % _P * self._rv[j]  # rv term (coeff -kinv)
            eb = self._eqb[j]
            cols = [int(self._rb[m][j]) for m in range(self.log_k)] + [
                int(self._wb[m][j]) for m in range(self.log_k)
            ] + [self._ot[j]]
            for m, b in enumerate(cols):
                w = self._ap[2 + m] * kv % _P * eb % _P
                s_lift += w * b % _P * b - w * b
        v_lift = s_lift % _P * pow_free % _P
        for x in xs:
            acc[x] += v_lift

        # --- one ascending-j walk: one-hot + V terms ---------------------
        nb = 1 << (self.log_k - i)  # bucket array size (suffix*2 + bit)
        B = [0] * nb
        for j in range(t_size):
            otj = self._ot[j]
            # READ: eq1 * rt * onehot(rb) * V    (rt = 1 - ot)
            w = self._eq1[j] * ((1 - otj) % _P) % _P * self._Ar[j] % _P
            if w:
                ra = self._r_addr[j]
                b = ra & 1
                s2 = (ra >> 1) << 1
                b0, b1 = B[s2], B[s2 + 1]
                for x in xs:
                    vp = ((1 - x) * b0 + x * b1) % _P
                    if vp:
                        acc[x] += w * _chi(x, b) % _P * vp
            if otj:
                wa = self._w_addr[j]
                b = wa & 1
                s2 = (wa >> 1) << 1
                base = self._eqsj[j] * otj % _P * self._Aw[j] % _P
                if base:
                    # k_table partial: E folded over bound bits, indexed
                    # by the remaining write suffix, current bit at X
                    s = wa >> 1
                    et0 = E[2 * s]
                    edt = (E[2 * s + 1] - et0) % _P
                    b0, b1 = B[s2], B[s2 + 1]
                    ic_wv = (self._ic[j] - self._wv[j]) % _P
                    for x in xs:
                        ek = (et0 + x * edt) % _P
                        cx = _chi(x, b)
                        if not cx:
                            continue
                        head = a1 * base % _P * cx % _P * ek % _P
                        # INC terms a/b: + ic - wv
                        acc[x] += head * ic_wv
                        # INC term c: + V
                        vp = ((1 - x) * b0 + x * b1) % _P
                        if vp:
                            acc[x] += head * vp
                # bucket insert AFTER this cycle's own contributions
                B[(wa >> 1) * 2 + (wa & 1)] = (
                    B[(wa >> 1) * 2 + (wa & 1)]
                    + self._ic[j] * self._Aw[j]
                ) % _P
        return [Fr(v % _P) for v in acc]

    def _k_bind(self, challenge: Fr) -> None:
        r = int(challenge)
        om = (1 - r) % _P
        t_size = 1 << self.log_t
        for j in range(t_size):
            ra, wa = self._r_addr[j], self._w_addr[j]
            self._Ar[j] = self._Ar[j] * (r if ra & 1 else om) % _P
            self._Aw[j] = self._Aw[j] * (r if wa & 1 else om) % _P
            self._r_addr[j] = ra >> 1
            self._w_addr[j] = wa >> 1
        E = self._eqsk
        half = len(E) // 2
        self._eqsk = [
            (E[2 * m] + r * (E[2 * m + 1] - E[2 * m])) % _P
            for m in range(half)
        ]

    def release(self) -> None:
        """Free native state deterministically (idempotent) — called by
        the provers in a ``finally`` so the C++ tables return even while
        the Python GC is paused."""
        if getattr(self, "_tbk", None) is not None:
            from .. import _native

            _native.tbk_free(self._tbk)
            self._tbk = None
        d = getattr(self, "_delegate", None)
        if d is not None and hasattr(d, "release"):
            d.release()

    def __del__(self):  # pragma: no cover - finalizer
        if getattr(self, "_tbk", None) is not None:
            try:
                from .. import _native

                _native.tbk_free(self._tbk)
            except Exception:
                pass

    def phase_b(self, lt_col):
        """Native phase B: ``(v_val, oracle_b)`` — the Val evaluation and
        the single-term Val sum-check delegate, built without any T-sized
        table round-tripping through Python.  Returns None off the native
        path (caller falls back to the Python construction)."""
        if self._tbk is None:
            return None
        from .. import _native
        from .sumcheck_d import NativeSopOracleD

        v_val, handle = _native.tbk_phase_b(self._tbk, lt_col)
        return v_val, NativeSopOracleD._from_handle(
            self.log_t, handle, self.degree
        )

    def _build_delegate(self) -> None:
        r_k = [int(c) for c in self._challenges]
        t_size = 1 << self.log_t
        chi_r_cols = []
        chi_w_cols = []
        for m in range(self.log_k):
            rm = r_k[m]
            om = (1 - rm) % _P
            chi_r_cols.append([
                (rm if int(b) else om) for b in self._rb[m]
            ])
            chi_w_cols.append([
                (rm if int(b) else om) for b in self._wb[m]
            ])
        # V~(r_k, j): prefix sums of ic * A^w (A^w == prod chi_w cols now)
        Vj = [0] * t_size
        cur = 0
        for j in range(t_size):
            Vj[j] = cur
            if self._ot[j]:
                cur = (cur + self._ic[j] * self._Aw[j]) % _P
        rt = [(1 - o) % _P for o in self._ot]
        eqsk_r = self._eqsk[0]  # fully folded: eq(sigma_k)~(r_k)
        a1 = self._ap[1]
        kv = self._kinv
        terms = [
            (1, [self._eq1, rt] + chi_r_cols + [Vj]),
            (_P - kv, [self._eq1, self._rv]),
            (a1 * eqsk_r % _P,
             [self._eqsj, self._ot] + chi_w_cols + [self._ic]),
            ((_P - a1) * eqsk_r % _P,
             [self._eqsj, self._ot] + chi_w_cols + [self._wv]),
            (a1 * eqsk_r % _P,
             [self._eqsj, self._ot] + chi_w_cols + [Vj]),
        ]
        bool_cols = (
            [[int(b) for b in self._rb[m]] for m in range(self.log_k)]
            + [[int(b) for b in self._wb[m]] for m in range(self.log_k)]
            + [self._ot]
        )
        for m, col in enumerate(bool_cols):
            w = self._ap[2 + m] * kv % _P
            terms.append((w, [self._eqb, col, col]))
            terms.append((_P - w, [self._eqb, col]))
        from .sumcheck_d import make_sopd_oracle

        self._delegate = make_sopd_oracle(self.log_t, terms, self.degree)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._round < self.log_k:
            if self._tbk is not None:
                from .. import _native

                return _native.tbk_round_evals(self._tbk, self.degree + 1)
            return self._k_round_evals()
        return self._delegate.round_evaluations(round_index - self.log_k)

    def bind(self, challenge: Fr) -> None:
        if self._round < self.log_k:
            self._challenges.append(challenge)
            if self._tbk is not None:
                from .. import _native

                _native.tbk_bind(self._tbk, challenge)
                if self._round == self.log_k - 1:
                    if self._device_j:
                        # replay the k binds on the Python state, then
                        # build the device delegate from it
                        for c in self._challenges:
                            self._k_bind(c)
                        self._build_delegate()
                    else:
                        from .sumcheck_d import NativeSopOracleD

                        self._delegate = NativeSopOracleD._from_handle(
                            self.log_t, _native.tbk_make_sopd(self._tbk),
                            self.degree,
                        )
            else:
                self._k_bind(challenge)
                if self._round == self.log_k - 1:
                    self._build_delegate()
        else:
            self._delegate.bind(challenge)
        self._round += 1

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        return self._delegate.final_evaluation(challenges[self.log_k:])


class ShoutBitsSparseOracle:
    """Structured oracle for single-one-hot bit-column term systems.

    ``terms``: sequence of ``(coeff, j_tables, bits, k_table)`` where
    ``j_tables`` is a list of T-point int tables, ``bits`` is either
    None or the list of logK T-point BOOLEAN bit columns of the one-hot
    address, and ``k_table`` is either None or a K-point table attached
    to the one-hot (e.g. the public lookup table).  ``k_table`` without
    ``bits`` is unsupported (no such term shape in the protocols).
    """

    def __init__(self, log_k: int, log_t: int, terms, degree: int):
        import os

        self.log_k = log_k
        self.log_t = log_t
        self.num_vars = log_k + log_t
        self.degree = degree
        self._round = 0
        self._delegate = None
        self._challenges: List[Fr] = []
        t_size = 1 << log_t
        k_size = 1 << log_k
        self._sbk = None
        if (not os.environ.get("TNSH_NO_NATIVE")
                and not os.environ.get("TNSH_BITS_FORCE_JAX")):
            from .. import _native

            if _native.available and self._sbk_init(
                    _native, terms, t_size, k_size):
                return
        self._terms = []
        for coeff, j_tables, bits, k_table in terms:
            jt = [[int(v) % _P for v in tab] for tab in j_tables]
            for tab in jt:
                if len(tab) != t_size:
                    raise SumCheckError("j table size mismatch")
            if bits is None:
                if k_table is not None:
                    raise SumCheckError("k_table needs bits")
                self._terms.append(
                    {"coeff": int(coeff) % _P, "jt": jt, "addr": None,
                     "A": None, "T": None}
                )
                continue
            if len(bits) != log_k:
                raise SumCheckError("need log_k bit columns")
            addr = [0] * t_size
            for i, col in enumerate(bits):
                for j, b in enumerate(col):
                    bv = int(b)
                    if bv not in (0, 1):
                        raise SumCheckError(
                            "bit columns must be boolean for the "
                            "structured prover"
                        )
                    addr[j] |= bv << i
            kt = None
            if k_table is not None:
                kt = [int(v) % _P for v in k_table]
                if len(kt) != k_size:
                    raise SumCheckError("k table size mismatch")
            self._terms.append(
                {"coeff": int(coeff) % _P, "jt": jt, "addr": addr,
                 "A": [1] * t_size, "T": kt, "bits": bits}
            )

    def _sbk_init(self, _native, terms, t_size: int, k_size: int) -> bool:
        """Build the native k-phase state (same validations as the Python
        path; bit-identical rounds).  Returns False for term shapes the
        native engine cannot take (falls back to pure Python)."""
        import numpy as np

        jt_tabs: List = []
        jt_seen = {}
        addr_tabs: List = []
        addr_seen = {}
        kt_tabs: List = []
        kt_seen = {}
        spec = []
        for coeff, j_tables, bits, k_table in terms:
            jt_idx = []
            for tab in j_tables:
                if len(tab) != t_size:
                    raise SumCheckError("j table size mismatch")
                key = id(tab)
                if key not in jt_seen:
                    jt_seen[key] = len(jt_tabs)
                    jt_tabs.append(tab)
                jt_idx.append(jt_seen[key])
            if bits is None:
                if k_table is not None:
                    raise SumCheckError("k_table needs bits")
                spec.append((int(coeff) % _P, jt_idx, None, None))
                continue
            if len(bits) != self.log_k:
                raise SumCheckError("need log_k bit columns")
            key = tuple(id(c) for c in bits)
            if key not in addr_seen:
                addr = np.zeros(t_size, dtype=np.uint64)
                for i, col in enumerate(bits):
                    try:
                        arr = np.asarray(col, dtype=np.uint64)
                    except (OverflowError, ValueError, TypeError):
                        raise SumCheckError(
                            "bit columns must be boolean for the "
                            "structured prover"
                        )
                    if arr.size != t_size or np.any(arr > 1):
                        raise SumCheckError(
                            "bit columns must be boolean for the "
                            "structured prover"
                        )
                    addr |= arr << np.uint64(i)
                addr_seen[key] = len(addr_tabs)
                addr_tabs.append((addr, bits))
            a_idx = addr_seen[key]
            k_idx = None
            if k_table is not None:
                if len(k_table) != k_size:
                    raise SumCheckError("k table size mismatch")
                kkey = id(k_table)
                if kkey not in kt_seen:
                    kt_seen[kkey] = len(kt_tabs)
                    kt_tabs.append(k_table)
                k_idx = kt_seen[kkey]
            spec.append((int(coeff) % _P, jt_idx, a_idx, k_idx))
        if not spec:
            raise SumCheckError("ShoutBitsSparseOracle needs terms")
        self._sbk = _native.sbk_create(
            self.log_k, self.log_t, jt_tabs,
            [a for a, _ in addr_tabs], kt_tabs, spec, self.degree + 1,
        )
        return True

    def release(self) -> None:
        """Free native state deterministically (idempotent)."""
        if getattr(self, "_sbk", None) is not None:
            from .. import _native

            _native.sbk_free(self._sbk)
            self._sbk = None
        d = getattr(self, "_delegate", None)
        if d is not None and hasattr(d, "release"):
            d.release()

    def __del__(self):  # pragma: no cover - finalizer
        if getattr(self, "_sbk", None) is not None:
            try:
                from .. import _native

                _native.sbk_free(self._sbk)
            except Exception:
                pass

    # -- k phase -----------------------------------------------------------

    def _k_round_evals(self) -> List[Fr]:
        i = self._round
        npts = self.degree + 1
        free_after = self.log_k - i - 1
        pow_free = pow(2, free_after, _P)
        acc = [0] * npts
        for tm in self._terms:
            if tm["addr"] is None:
                s = 0
                t_size = len(tm["jt"][0]) if tm["jt"] else 1 << self.log_t
                for j in range(t_size):
                    prod = tm["coeff"]
                    for tab in tm["jt"]:
                        prod = prod * tab[j] % _P
                    s += prod
                v = s % _P * pow_free % _P
                for x in range(npts):
                    acc[x] += v
                continue
            addr = tm["addr"]
            A = tm["A"]
            T = tm["T"]
            coeff = tm["coeff"]
            jt = tm["jt"]
            for j in range(len(addr)):
                a = A[j]
                if a == 0:
                    continue
                w = coeff * a % _P
                for tab in jt:
                    w = w * tab[j] % _P
                if w == 0:
                    continue
                b = addr[j] & 1
                s_j = addr[j] >> 1
                if T is not None:
                    t0 = T[2 * s_j]
                    dt = (T[2 * s_j + 1] - t0) % _P
                else:
                    t0, dt = 1, 0
                # g_j(X) = w * chi(X, b) * (t0 + X*dt): evaluate at 0..D
                for x in range(npts):
                    cx = _chi(x, b)
                    if cx == 0:
                        continue
                    acc[x] += w * cx % _P * ((t0 + x * dt) % _P)
        return [Fr(v % _P) for v in acc]

    def _k_bind(self, challenge: Fr) -> None:
        r = int(challenge)
        one_minus = (1 - r) % _P
        for tm in self._terms:
            if tm["addr"] is None:
                continue
            addr = tm["addr"]
            A = tm["A"]
            for j in range(len(addr)):
                A[j] = A[j] * (r if addr[j] & 1 else one_minus) % _P
                addr[j] >>= 1
            if tm["T"] is not None:
                T = tm["T"]
                half = len(T) // 2
                tm["T"] = [
                    (T[2 * m] + r * (T[2 * m + 1] - T[2 * m])) % _P
                    for m in range(half)
                ]

    # -- j phase (delegate) ------------------------------------------------

    def _build_delegate(self, challenges: Sequence[Fr]) -> None:
        """The restricted polynomial over j is a sum of products of
        MULTILINEAR j-columns: the original j_tables plus, per one-hot
        term, the logK chi columns chi(r_i, b_i(j)) (each affine in a
        committed bit column) and the scalar k_table evaluation."""
        r_k = [int(c) for c in challenges[: self.log_k]]
        terms = []
        for tm in self._terms:
            if tm["addr"] is None:
                terms.append((tm["coeff"], list(tm["jt"])))
                continue
            chi_cols = []
            for i, col in enumerate(tm["bits"]):
                ri = r_k[i]
                om = (1 - ri) % _P
                chi_cols.append([
                    (ri if int(b) else om) for b in col
                ])
            coeff = tm["coeff"]
            if tm["T"] is not None:
                coeff = coeff * tm["T"][0] % _P  # T~(r_k)
            terms.append((coeff, list(tm["jt"]) + chi_cols))
        from .sumcheck_d import make_sopd_oracle

        self._delegate = make_sopd_oracle(self.log_t, terms, self.degree)

    # -- SumcheckOracle interface -----------------------------------------

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._round < self.log_k:
            if self._sbk is not None:
                from .. import _native

                return _native.sbk_round_evals(self._sbk, self.degree + 1)
            return self._k_round_evals()
        return self._delegate.round_evaluations(
            round_index - self.log_k
        )

    def bind(self, challenge: Fr) -> None:
        if self._round < self.log_k:
            self._challenges.append(challenge)
            if self._sbk is not None:
                from .. import _native

                _native.sbk_bind(self._sbk, challenge)
                if self._round == self.log_k - 1:
                    from .sumcheck_d import NativeSopOracleD

                    self._delegate = NativeSopOracleD._from_handle(
                        self.log_t, _native.sbk_make_sopd(self._sbk),
                        self.degree,
                    )
            else:
                self._k_bind(challenge)
                if self._round == self.log_k - 1:
                    self._build_delegate(self._challenges)
        else:
            self._delegate.bind(challenge)
        self._round += 1

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        return self._delegate.final_evaluation(challenges[self.log_k:])
