"""Cell-scheduled Pippenger MSM on the device.

Re-designs the reference's commit MSM (reference commitments.rs:162-180)
for a data-parallel device.  Pippenger is restructured around
chunk-local gathers, and every data structure stays device-resident:

  * **Signed 8-bit windows**: scalars split into W windows of signed digits
    in [-128, 127] (host numpy for explicit scalars; W adapts to the scalar
    magnitude, so small commit scalars get W≈4 instead of 32).  Bucket
    lanes = (window, |digit|-1): a flat (22, W*128) plane array of Jacobian
    accumulators that stays device-resident for the whole MSM.
  * **Chunk streaming**: points stream in m-point chunks (contiguous
    dynamic slices, no host round trips).  For each chunk the device builds
    a conflict-free insertion schedule: per-window bucket ranks via an
    int32 cumulative sum of one-hot rows, then the (R_c, TOTAL_LANES) slot
    table by an int32 scatter.
  * **R_c insertion steps per chunk**: step s gathers the s-th member of
    every bucket from the chunk (a gather from an m-wide table) and
    performs one masked mixed-add across all lanes.  R_c is the exact
    maximum bucket occupancy, computed host-side from the digits, so there
    is no overflow path.
  * **Aggregation**: per-window Σ_d d·B_d via an in-block suffix scan plus
    tree sum (Σ_b (b+1)·B_b = Σ_k S_k with S_k the inclusive suffix sums),
    then a W-window Horner combine on the host (native G1).

Group-law hazard: a mixed-add where the incoming point equals the
accumulator needs a doubling.  Inside one bucket lane the accumulator is a
partial sum of *distinct earlier points of the same bucket*, so equality is
cryptographically negligible for SRS bases — but it is *detected* (H == 0,
r == 0) and counted; a nonzero count triggers a host-MSM fallback, so the
result is always exact.  Everything else is exact int32 limb arithmetic
(tnsh.field.fr_jax), bit-identical to the host MSM.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

from ..field.fr import Fr
from ..field.g1 import G1
from ..field.limbs import FQ_SPEC, NUM_LIMBS, bytes_to_limb_planes

_L = NUM_LIMBS  # 22 limb planes


# ---------------------------------------------------------------------------
# Host-side preparation (numpy, vectorized)
# ---------------------------------------------------------------------------

def scalars_to_byte_matrix(scalars, n: int) -> np.ndarray:
    """(n, 32) uint8 little-endian scalar bytes."""
    if isinstance(scalars, (bytes, bytearray)):
        out = np.frombuffer(bytes(scalars), dtype=np.uint8)
        return out.reshape(-1, 32)[:n]
    if isinstance(scalars, np.ndarray) and scalars.dtype.kind in "iu":
        out = np.zeros((n, 32), dtype=np.uint8)
        v = scalars[:n].astype(np.uint64)
        for b in range(8):
            out[:, b] = ((v >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(
                np.uint8
            )
        return out
    try:
        from .. import _native

        if _native.available:
            data = _native._fr_vec_bytes(scalars[:n])
            return np.frombuffer(data, dtype=np.uint8).reshape(-1, 32)
    except Exception:
        pass
    data = b"".join(int(s).to_bytes(32, "little") for s in scalars[:n])
    return np.frombuffer(data, dtype=np.uint8).reshape(-1, 32)


def signed_digits(sb: np.ndarray) -> np.ndarray:
    """(W, n) int8 signed base-256 digits of (n, 32) uint8 scalar bytes.

    Digits lie in [-128, 127]; W adapts to the highest nonzero byte (+1
    carry window, padded to a multiple of 4 to bound kernel-shape count).
    Σ_w d_w 256^w reconstructs each scalar exactly.
    """
    n = sb.shape[0]
    used = np.nonzero(sb.any(axis=0))[0]
    hb = int(used[-1]) if used.size else 0
    w_count = min(hb + 2, 32)
    w_count = (w_count + 3) // 4 * 4
    d = sb[:, :w_count].astype(np.int16).T.copy()  # (W, n)
    carry = np.zeros(n, dtype=np.int16)
    for w in range(w_count):
        v = d[w] + carry
        carry = (v >= 128).astype(np.int16)
        d[w] = v - (carry << 8)
    if carry.any():  # only possible for byte 31 >= 0x7F: not a valid Fr
        raise ValueError("scalar out of field range for signed windows")
    return d.astype(np.int8)


#: Accumulator-lane budget per kernel: the insert step always runs at this
#: width, whether the MSM has 4 or 32 windows.
TOTAL_LANES = 4096
#: Max lanes one (window, digit) group may claim (=> 12 fold levels).
_MAX_GROUP_LANES = 4096


class MsmPlan:
    """Host-computed, data-dependent plan for one MSM call.

    Every (window, |digit|) group is assigned K_g = pow2 accumulator lanes
    out of a fixed TOTAL_LANES budget; insert ``rank`` maps to
    (step = rank >> log2 K_g, lane = base_g + (rank & K_g-1)).  K_g sizes
    come from a binary search equalizing the worst per-chunk step count —
    heavy groups (repeated Twist addresses, the near-constant top windows
    of small or consecutive-valued scalars, even ALL-identical scalars)
    simply claim more lanes, so total work stays ~n*W lane-adds and the
    step count stays ~n*W/TOTAL_LANES regardless of the digit
    distribution.  All plan outputs are runtime tensors — kernel shapes
    depend only on (chunks, m, W, R_c), so compile count stays bounded.
    """

    def __init__(self, d: np.ndarray, m: int):
        w_count, n_pad = d.shape
        self.w_count = w_count
        chunks = n_pad // m
        # (chunk, window, |digit|) occupancy cube: native counting loop when
        # available (this host's np.bincount measured ~4 M keys/s — 2+ s at
        # 2^18x32 windows), numpy fallback otherwise
        ccnt = None
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                ccnt = _native.msm_digit_counts(d, m)
        if ccnt is None:
            mags32 = np.abs(d.astype(np.int16)).astype(np.int32)
            offs32 = (np.arange(w_count, dtype=np.int32) * 129)[:, None]
            keys = mags32.reshape(w_count, chunks, m) + offs32[:, None] + (
                np.arange(chunks, dtype=np.int32) * (w_count * 129)
            )[None, :, None]
            ccnt = np.bincount(
                keys.ravel(), minlength=chunks * w_count * 129
            ).reshape(chunks, w_count, 129)
        ccnt[:, :, 0] = 0
        mc = ccnt.max(axis=0).astype(np.int64)  # (W, 129) worst chunk count
        supported = mc > 0
        self.r_exact = 0
        self.base_map = np.zeros((w_count, 129), dtype=np.int32)
        self.logk_map = np.zeros((w_count, 129), dtype=np.int32)
        lanes = TOTAL_LANES
        self.fold_masks = np.zeros((12, lanes), dtype=bool)
        self.canon_src = np.zeros((w_count * 128,), dtype=np.int32)
        self.canon_mask = np.zeros((w_count * 128,), dtype=bool)
        self.rc_per_chunk = np.zeros((chunks,), dtype=np.int32)
        if not supported.any():
            return

        def lanes_needed(r: int) -> np.ndarray:
            k = -(-mc // r)  # ceil
            k = np.maximum(k, 1)
            # next_pow2, capped
            k = (1 << np.ceil(np.log2(k)).astype(np.int64)).astype(np.int64)
            return np.minimum(np.where(supported, k, 0), _MAX_GROUP_LANES)

        lo, hi = 1, int(mc.max())
        while lo < hi:
            mid = (lo + hi) // 2
            if int(lanes_needed(mid).sum()) <= lanes:
                hi = mid
            else:
                lo = mid + 1
        r = lo
        k_g = lanes_needed(r)
        assert int(k_g.sum()) <= lanes, "lane budget infeasible"
        self.r_exact = int(np.max(np.where(k_g > 0, -(-mc // np.maximum(k_g, 1)), 0)))
        # Per-chunk executed step counts (round-3 backlog item 3): chunks
        # only run the insertion steps THEY need, not the worst chunk's
        # count — recovers the cross-chunk occupancy skew (~10-20% of
        # steps for uniform scalars) without a cleanup pass.
        kq = np.maximum(k_g, 1)[None]  # (1, W, 129)
        self.rc_per_chunk = np.max(
            np.where(k_g[None] > 0, -(-ccnt // kq), 0), axis=(1, 2)
        ).astype(np.int32)
        # pack groups in (window, digit) order
        bases = np.zeros_like(k_g)
        flat_k = k_g.ravel()
        np.cumsum(flat_k[:-1], out=bases.ravel()[1:])
        self.base_map = bases.astype(np.int32)
        self.logk_map = np.where(
            supported,
            np.log2(np.maximum(k_g, 1)).astype(np.int64),
            0,
        ).astype(np.int32)
        # fold masks: tree-fold each group's K_g lanes onto its base lane
        for w in range(w_count):
            for dmag in np.nonzero(supported[w])[0]:
                base = int(bases[w, dmag])
                k = int(k_g[w, dmag])
                for t in range(k.bit_length() - 1):
                    sh = 1 << t
                    sel = base + np.arange(0, k, 2 * sh)
                    self.fold_masks[t, sel] = True
                # canonical magnitude layout: lane w*128+(b) = digit b+1
                dst = w * 128 + (int(dmag) - 1)
                self.canon_src[dst] = base
                self.canon_mask[dst] = True


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------

def _get_jax():
    import jax
    import jax.numpy as jnp
    from jax import lax

    return jax, jnp, lax


def _padd_mixed_flag(fq, X1, Y1, Z1, x2, y2, take):
    """Mixed Jacobian+affine add (no doubling branch) returning also the
    per-lane 'accumulator equals input' hazard flag.  Mirrors
    msm_jax._padd_mixed (11 field muls) with the flag exposed."""
    (Z1Z1,) = fq.mont_mul_many([(Z1, Z1)])
    U2, T2 = fq.mont_mul_many([(x2, Z1Z1), (y2, Z1)])
    (S2,) = fq.mont_mul_many([(T2, Z1Z1)])
    H = fq.sub(U2, X1)
    r0 = fq.sub(S2, Y1)
    r = fq.add(r0, r0)
    H2 = fq.add(H, H)
    I, RR = fq.mont_mul_many([(H2, H2), (r, r)])
    J, V = fq.mont_mul_many([(H, I), (X1, I)])
    X3 = fq.sub(fq.sub(RR, J), fq.add(V, V))
    RVX, SJ, Z1H = fq.mont_mul_many([(r, fq.sub(V, X3)), (Y1, J), (Z1, H)])
    Y3 = fq.sub(RVX, fq.add(SJ, SJ))
    Z3 = fq.add(Z1H, Z1H)

    p_inf = fq.is_zero(Z1)
    one = fq.one(X1.shape[1:])
    X3 = fq.select(p_inf, x2, X3)
    Y3 = fq.select(p_inf, y2, Y3)
    Z3 = fq.select(p_inf, one, Z3)

    X3 = fq.select(take, X3, X1)
    Y3 = fq.select(take, Y3, Y1)
    Z3 = fq.select(take, Z3, Z1)
    same = take & fq.is_zero(H) & fq.is_zero(r0) & ~p_inf
    return X3, Y3, Z3, same


#: (chunks, m, w_count, r_c) shapes whose kernels have been jit-compiled
#: in this process — the warm gate for ``msm_async(only_if_compiled=True)``.
_COMPILED_SHAPES: set = set()


@lru_cache(maxsize=64)
def _compiled_schedules(chunks: int, m: int, w_count: int, r_c: int):
    """jit: (digits (W, chunks*m) int8, base_map, logk_map) -> every
    chunk's insertion schedule stacked, (chunks*R_c, TOTAL_LANES) int32.
    Entry (g*R_c + s, lane) is ±(point index in chunk g + 1) of the s-th
    member of that lane's bucket, sign = digit sign, 0 = no insert."""
    jax, jnp, lax = _get_jax()
    lanes = TOTAL_LANES
    ids_np = np.arange(1, m + 1, dtype=np.int32)

    def build(digits, base_map, logk_map):
        def chunk_body(g, sched_all):
            dch = lax.dynamic_slice(digits, (0, g * m), (w_count, m))
            dch = dch.astype(jnp.int32)

            def win_body(w, flat_sched):
                dw = lax.dynamic_index_in_dim(dch, w, 0, keepdims=False)
                bmap = lax.dynamic_index_in_dim(base_map, w, 0,
                                                keepdims=False)
                kmap = lax.dynamic_index_in_dim(logk_map, w, 0,
                                                keepdims=False)
                mag = jnp.abs(dw)
                bucket = jnp.where(mag > 0, mag - 1, -1)
                oh = (bucket[:, None] == jnp.arange(128, dtype=jnp.int32)
                      ).astype(jnp.int32)
                rank = jnp.take_along_axis(
                    jnp.cumsum(oh, axis=0),
                    jnp.clip(bucket, 0, 127)[:, None], axis=1,
                )[:, 0] - 1
                # group (w, mag) owns K = 1<<lk lanes starting at base
                lk = jnp.take(kmap, mag)
                step_idx = rank >> lk
                lane = jnp.take(bmap, mag) + (rank & ((1 << lk) - 1))
                # masked entries scatter out of bounds -> dropped, so the
                # in-bounds indices are genuinely unique
                flat = jnp.where(mag > 0, step_idx * lanes + lane,
                                 r_c * lanes)
                vals = jnp.where(dw < 0, -ids_np, ids_np)
                return flat_sched.at[flat].set(vals, mode="drop",
                                               unique_indices=True)

            flat_sched = lax.fori_loop(
                0, w_count, win_body, jnp.zeros((r_c * lanes,), jnp.int32)
            )
            return lax.dynamic_update_slice(
                sched_all, flat_sched.reshape(r_c, lanes), (g * r_c, 0))

        return lax.fori_loop(
            0, chunks, chunk_body,
            jnp.zeros((chunks * r_c, lanes), jnp.int32),
        )

    return jax.jit(build)


@lru_cache(maxsize=64)
def _compiled_insert_xla(chunks: int, m: int, r_c: int):
    """Insertion steps, jit: (schedules, rc_per_chunk, xs, ys) -> (accX,
    accY, accZ, hazard flags per lane), with xs/ys the first chunks*m
    points (so contexts of different sizes share one program per shape).
    Each insertion step is one ``fori_loop`` iteration over all
    TOTAL_LANES lanes; only a chunk's needed steps run (a traced bound
    lowers to a while loop)."""
    jax, jnp, lax = _get_jax()
    from ..field.fr_jax import fq_ops_unrolled as fq

    def insert(sched_all, rc_per_chunk, xs, ys):
        def chunk_body(g, state):
            px = lax.dynamic_slice(xs, (0, g * m), (_L, m))
            py = lax.dynamic_slice(ys, (0, g * m), (_L, m))

            def step(s, st):
                accX, accY, accZ, hz = st
                row = lax.dynamic_index_in_dim(
                    sched_all, g * r_c + s, 0, keepdims=False)
                idx = jnp.clip(jnp.abs(row) - 1, 0, m - 1)
                take = row != 0
                gx = jnp.take(px, idx, axis=1)
                gy = jnp.take(py, idx, axis=1)
                gy = fq.select(row < 0, fq.neg(gy), gy)
                accX, accY, accZ, same = _padd_mixed_flag(
                    fq, accX, accY, accZ, gx, gy, take
                )
                return accX, accY, accZ, hz + same.astype(jnp.int32)

            rc_g = jnp.minimum(rc_per_chunk[g], r_c)
            return lax.fori_loop(0, rc_g, step, state)

        one_np = np.asarray(FQ_SPEC.one_mont_limbs(), dtype=np.int32)[:, None]
        zeros = jnp.zeros((_L, TOTAL_LANES), jnp.int32)
        init = (zeros, zeros + one_np, zeros,
                jnp.zeros((TOTAL_LANES,), jnp.int32))
        return lax.fori_loop(0, chunks, chunk_body, init)

    return jax.jit(insert)


@lru_cache(maxsize=64)
def _tail_tables(w_count: int):
    """Static gather/mask tables of the 14 window-sum steps (see
    :func:`_compiled_tail`): a 7-step Hillis-Steele in-block suffix scan,
    then a 7-step in-block tree sum, over lanes w*128 + b."""
    lane = np.arange(TOTAL_LANES)
    in_use = lane < w_count * 128
    b = lane % 128
    src, mask = [], []
    for k in range(7):
        sh = 1 << k
        src.append((lane + sh) % TOTAL_LANES)
        mask.append(in_use & (b + sh < 128))
    for k in range(7):
        sh = 128 >> (k + 1)
        src.append((lane + sh) % TOTAL_LANES)
        mask.append(in_use & (b < sh))
    return np.asarray(src, np.int32), np.asarray(mask, bool)


def _tail_inputs(plan: "MsmPlan"):
    """Per-call tables of the 26-step tail for one plan: (pre_idx,
    pre_mask, src_idx, add_mask), each (26, TOTAL_LANES)."""
    lanes = TOTAL_LANES
    ident = np.arange(lanes, dtype=np.int32)
    w_lanes = plan.w_count * 128
    pre_idx = np.tile(ident, (26, 1))
    pre_mask = np.ones((26, lanes), dtype=bool)
    pre_idx[12, :w_lanes] = plan.canon_src
    pre_idx[12, w_lanes:] = 0
    pre_mask[12, :w_lanes] = plan.canon_mask
    pre_mask[12, w_lanes:] = False
    fold_src = np.asarray(
        [(ident + (1 << t)) % lanes for t in range(12)], dtype=np.int32)
    win_src, win_mask = _tail_tables(plan.w_count)
    src_idx = np.concatenate([fold_src, win_src])
    add_mask = np.concatenate([plan.fold_masks, win_mask])
    return pre_idx, pre_mask, src_idx, add_mask


@lru_cache(maxsize=16)
def _compiled_tail(w_count: int):
    """jit: (accX, accY, accZ, hazard flags, pre_idx, pre_mask, src_idx,
    add_mask) -> packed (L, 3W+1) window sums + hazard count.

    26 steps of ONE loop body (one group-law instance in the program, so
    the compile stays small): step t first gathers the lanes through
    ``pre_idx[t]`` (identity, except at t = 12, which re-canonicalizes
    lane w*128+b to digit magnitude b+1; masked lanes become infinity),
    then adds lane ``src_idx[t]`` into every lane of ``add_mask[t]``.
    Steps 0-11 tree-fold each group's K lanes onto its base lane; steps
    12-25 compute Σ_b (b+1)·B_b = Σ_k S_k per window, with S_k the
    in-block inclusive suffix sums."""
    jax, jnp, lax = _get_jax()
    from .msm_jax import _padd, fq

    one_np = np.asarray(FQ_SPEC.one_mont_limbs(), dtype=np.int32)[:, None]

    def tail(accX, accY, accZ, hz, pre_idx, pre_mask, src_idx, add_mask):
        inf_y = jnp.zeros_like(accY) + one_np

        def body(t, st):
            X, Y, Z = st
            pre = pre_idx[t]
            keep = pre_mask[t]
            X = fq.select(keep, jnp.take(X, pre, axis=1), jnp.zeros_like(X))
            Y = fq.select(keep, jnp.take(Y, pre, axis=1), inf_y)
            Z = fq.select(keep, jnp.take(Z, pre, axis=1), jnp.zeros_like(Z))
            src = src_idx[t]
            Xn, Yn, Zn = _padd(X, Y, Z, jnp.take(X, src, axis=1),
                               jnp.take(Y, src, axis=1),
                               jnp.take(Z, src, axis=1))
            mask = add_mask[t]
            return (fq.select(mask, Xn, X), fq.select(mask, Yn, Y),
                    fq.select(mask, Zn, Z))

        X, Y, Z = lax.fori_loop(0, 26, body, (accX, accY, accZ))
        sel = np.arange(w_count) * 128
        return _pack_result(jnp, X[:, sel], Y[:, sel], Z[:, sel],
                            jnp.sum(hz))

    return jax.jit(tail)


def _pack_result(jnp, Xw, Yw, Zw, hazards):
    """(L, 3W+1) single-array result: window sums side by side, hazard
    count in the last lane of plane 0, so ``finish()`` makes one
    device-to-host copy."""
    hzp = jnp.zeros((_L, 1), jnp.int32).at[0, 0].set(hazards)
    return jnp.concatenate([Xw, Yw, Zw, hzp], axis=1)


@lru_cache(maxsize=8)
def _compiled_to_mont(n_pad: int):
    jax, jnp, _ = _get_jax()
    from ..field.fr_jax import fq_ops

    return jax.jit(lambda a: fq_ops.to_mont(a))


def _kernel_shape(chunks: int, m: int, w_count: int, r_exact: int):
    """Static kernel shape for a plan: the schedule capacity R_c is the
    smallest already-compiled capacity that fits ``r_exact``, else its
    next power of two (at least 16).  Extra capacity rows are zeros that
    the per-chunk dynamic bound skips, so reusing a larger compiled
    capacity keeps one compile per size bucket."""
    fits = [k[3] for k in _COMPILED_SHAPES
            if k[:3] == (chunks, m, w_count) and k[3] >= r_exact]
    r_c = min(fits) if fits else max(1 << (r_exact - 1).bit_length(), 16)
    return (chunks, m, w_count, r_c)


# ---------------------------------------------------------------------------
# Host-facing context
# ---------------------------------------------------------------------------

def _choose_chunk(n: int) -> int:
    """Points per chunk: the next power of two >= n, between 512 and
    32768 (the gather table width of one insertion step)."""
    m = 512
    while m < n and m < 32768:
        m *= 2
    return m


class ScheduledMsmContext:
    """Device-resident base points for repeated scheduled-Pippenger MSMs.

    Build from explicit points (``ScheduledMsmContext(points)``) or from a
    native SRS handle (:meth:`from_native_srs`) — the latter exports affine
    coordinates in one native call and never materializes Python points.
    """

    def __init__(self, points: Optional[Sequence[G1]] = None, *,
                 affine_bytes: Optional[bytes] = None,
                 fallback=None):
        _, jnp, _ = _get_jax()
        if affine_bytes is not None:
            raw = np.frombuffer(affine_bytes, dtype=np.uint8).reshape(-1, 64)
            n = raw.shape[0]
            xb, yb = raw[:, :32], raw[:, 32:]
            valid = (raw != 0).any(axis=1)
        else:
            n = len(points)
            xb = np.zeros((n, 32), dtype=np.uint8)
            yb = np.zeros((n, 32), dtype=np.uint8)
            valid = np.zeros((n,), dtype=bool)
            for i, p in enumerate(points):
                if p.is_zero():
                    continue
                ax, ay = p.to_affine()
                xb[i] = np.frombuffer(ax.to_bytes(32, "little"), np.uint8)
                yb[i] = np.frombuffer(ay.to_bytes(32, "little"), np.uint8)
                valid[i] = True
        self.num_points = n
        m = _choose_chunk(n)
        n_pad = (n + m - 1) // m * m
        self.m = m
        xs = np.zeros((_L, n_pad), dtype=np.int32)
        ys = np.zeros((_L, n_pad), dtype=np.int32)
        xs[:, :n] = bytes_to_limb_planes(xb)
        ys[:, :n] = bytes_to_limb_planes(yb)
        conv = _compiled_to_mont(n_pad)
        self.xs = conv(jnp.asarray(xs))
        self.ys = conv(jnp.asarray(ys))
        self.valid_np = valid  # host-side; invalid points get zero digits
        self.fallback = fallback
        self.hazard_count = 0

    @classmethod
    def from_native_srs(cls, srs_id: int, n: Optional[int] = None
                        ) -> "ScheduledMsmContext":
        from .. import _native

        if n is None:
            n = _native.srs_size(srs_id)
        data = _native.srs_export_affine(srs_id, 0, n)
        return cls(
            affine_bytes=data,
            fallback=lambda scalars: _native.srs_msm(srs_id, scalars),
        )

    def msm(self, scalars) -> G1:
        """Σ scalars[i] · base[i] over the first len(scalars) base points."""
        return self.msm_async(scalars)()

    def prepare(self, scalars):
        """Host side of one MSM: ``(n, digits, plan, kernel shape)``, or
        None when the result is the identity without any device work."""
        if isinstance(scalars, (bytes, bytearray)):
            n = len(scalars) // 32
        else:
            n = len(scalars)
        if n == 0:
            return None
        if n > self.num_points:
            raise ValueError("more scalars than base points")
        sb = scalars_to_byte_matrix(scalars, n)
        d = signed_digits(sb)
        if not self.valid_np[:n].all():
            d[:, np.nonzero(~self.valid_np[:n])[0]] = 0
        # all 32 windows, so one compiled shape serves every scalar width
        # (zero windows claim no lanes and cost no insertion steps)
        w_count = 32
        m = self.m
        chunks = (n + m - 1) // m
        d = np.pad(d, ((0, w_count - d.shape[0]), (0, chunks * m - n)))
        plan = MsmPlan(d, m)
        if plan.r_exact == 0:
            return None
        return n, d, plan, _kernel_shape(chunks, m, w_count, plan.r_exact)

    def msm_async(self, scalars, only_if_compiled: bool = False):
        """Dispatch the MSM and return a zero-arg finisher.

        The device crunches between dispatch and the finisher call, so a
        caller can overlap host work (the hybrid host+device split in
        kzg.msm runs the native MSM on the complementary points while
        this executes).

        ``only_if_compiled=True``: return None instead of compiling a new
        kernel shape inline — kzg's adaptive hybrid checks this so that a
        prove never stalls on a compile; ``kzg.prewarm_device_msm``
        compiles the shapes ahead of time."""
        _, jnp, _ = _get_jax()
        prep = self.prepare(scalars)
        if prep is None:
            return G1.zero
        n, d, plan, key = prep
        chunks, m, w_count, _ = key
        if only_if_compiled and key not in _COMPILED_SHAPES:
            return None
        _COMPILED_SHAPES.add(key)
        sched = _compiled_schedules(*key)(
            jnp.asarray(d), jnp.asarray(plan.base_map),
            jnp.asarray(plan.logk_map))
        accX, accY, accZ, hz = _compiled_insert_xla(chunks, m, key[3])(
            sched, jnp.asarray(plan.rc_per_chunk), self.xs[:, :chunks * m],
            self.ys[:, :chunks * m])
        out = _compiled_tail(w_count)(
            accX, accY, accZ, hz, *map(jnp.asarray, _tail_inputs(plan)))

        def finish() -> G1:
            arr = np.asarray(out)  # one device-to-host copy
            w = (arr.shape[1] - 1) // 3
            hz_v = int(arr[0, -1])
            if hz_v:
                # accumulator==input hazard: result may be wrong — host path
                self.hazard_count += hz_v
                return self._host_fallback(scalars, n)
            return _combine_windows(
                arr[:, :w], arr[:, w:2 * w], arr[:, 2 * w:3 * w]
            )

        return finish

    def _host_fallback(self, scalars, n: int) -> G1:
        if self.fallback is not None:
            return self.fallback(scalars)
        from .kzg import msm as host_msm
        from ..field.limbs import unpack_ints

        xs = unpack_ints(np.asarray(self.xs[:, :n]), FQ_SPEC)
        ys = unpack_ints(np.asarray(self.ys[:, :n]), FQ_SPEC)
        valid = self.valid_np[:n]
        pts = [
            G1(x, y, 1) if v else G1.zero()
            for x, y, v in zip(xs, ys, valid)
        ]
        if isinstance(scalars, (bytes, bytearray)):
            scalars = [
                Fr(int.from_bytes(scalars[32 * i:32 * i + 32], "little"))
                for i in range(n)
            ]
        return host_msm(pts, list(scalars)[:n])


def _combine_windows(Xw: np.ndarray, Yw: np.ndarray, Zw: np.ndarray) -> G1:
    """Host Horner combine of per-window sums: Σ_w 256^w · P_w."""
    from ..field.limbs import unpack_ints

    w_count = Xw.shape[1]
    xs = unpack_ints(Xw, FQ_SPEC)
    ys = unpack_ints(Yw, FQ_SPEC)
    zs = unpack_ints(Zw, FQ_SPEC)
    acc = G1.zero()
    for w in range(w_count - 1, -1, -1):
        for _ in range(8):
            if not acc.is_zero():
                acc = acc.double()
        if zs[w] != 0:
            acc = acc.add(G1(xs[w], ys[w], zs[w]))
    return acc


def msm_scheduled(points: Sequence[G1], scalars: Sequence[Fr]) -> G1:
    """One-shot scheduled-Pippenger MSM (packs points per call; prefer
    ScheduledMsmContext for repeated use of the same bases)."""
    n = min(len(points), len(scalars))
    if n == 0:
        return G1.zero()
    return ScheduledMsmContext(points[:n]).msm(list(scalars)[:n])
