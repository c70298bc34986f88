"""Wavefront XLA reconstruction engine: executes FramePlans in plain XLA.

The independent cross-check engine for the whole-GOP executor
(ops/vmem_engine.py): same semantics, entirely different mechanism.

Reconstruction is phased for parallelism (see models/plan.py for why this is
exactly equivalent to the reference's sequential macroblock loop):

  phase 1 — motion compensation: every MC leaf gathers its (half-pel
            filtered) window from the reference ring; blocks are disjoint,
            so one batched gather + scatter.
  phase 2 — inter residuals: batched integer IDCT + add-saturate scatter.
  phase 3 — intra: ops grouped into dependency levels; each level is one
            batched tap-gather -> formula-select -> residual -> scatter.
            Tap gathers mask "not yet decoded" pixels to the fresh-plane
            value via the plan's sequence map, reproducing the reference's
            read-whatever-is-there semantics bit-for-bit.

Planes live in one (H + H/2, S) int32 buffer per frame: Y on top, packed UV
(U | V halves) below — preserving the reference's flat-plane aliasing.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.idct import idct4, idct8
from ..ops.intra_tables import AVG2, AVG3, COPY, DC, KIND, PASS, TAPS
from .oracle_video import MobiclipVersion
from .plan import FramePlan, PlanningDecoder


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


# Fixed shape buckets: every decode program shape is drawn from this small
# set, so there are only a handful of programs per frame geometry — each
# compiled once per persistent cache.  K (ops per intra level) is capped
# low to bound compile time; oversized levels are split instead, which is
# free.
_MC_BUCKETS = (256, 1024, 4096)
_RES_BUCKETS = (256, 1024, 4096)
_K_BUCKETS = (16, 32)
_L_BUCKETS = (8, 64, 1024)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def prepare_plan(plan: FramePlan) -> dict:
    """Pack a FramePlan into padded device arrays (fixed shape buckets).

    Intra ops are grouped by dependency level; a level with more ops than the
    K bucket is split into consecutive sub-levels (blocks within a level are
    mutually independent, so any split preserves correctness)."""
    mc = _pad_rows(plan.mc.astype(np.int32),
                   _bucket(max(plan.mc.shape[0], 1), _MC_BUCKETS))
    nr = _bucket(max(plan.resid.shape[0], 1), _RES_BUCKETS)
    resid = _pad_rows(plan.resid.astype(np.int32), nr)
    resid_coef = _pad_rows(plan.resid_coef.astype(np.int32), nr)
    intra = plan.intra.astype(np.int64)
    L = max(plan.n_levels, 1)
    buckets: list[list[int]] = [[] for _ in range(L)]
    for i in range(intra.shape[0]):
        buckets[int(intra[i, 9]) - 1].append(i)
    kmax = max((len(b) for b in buckets), default=1) or 1
    K = _bucket(min(kmax, _K_BUCKETS[-1]), _K_BUCKETS)
    rows: list[list[int]] = []
    for b in buckets:
        if not b:
            rows.append([])
        for j in range(0, len(b), K):
            rows.append(b[j:j + K])
    L2 = _bucket(max(len(rows), 1), _L_BUCKETS)
    iops = np.zeros((L2, K, 11), np.int32)
    icoef = np.zeros((L2, K, 64), np.int32)
    for lv, b in enumerate(rows):
        for j, i in enumerate(b):
            iops[lv, j] = intra[i].astype(np.int32)
            icoef[lv, j] = plan.intra_coef[i]
    seqmap = np.concatenate([plan.seq_y, plan.seq_uv], axis=0).astype(np.int32)
    return dict(mc=mc, resid=resid, resid_coef=resid_coef,
                iops=iops, icoef=icoef, seqmap=seqmap,
                n_levels=np.int32(len(rows)))


# --------------------------------------------------------------------- MC
def _mc_kernel(ring, buf, mc, H, S):
    """Phase 1: batched half-pel MC (CopyBlock, MobiclipDecoder.cs:418-456)."""
    HH = H + H // 2
    y, x, w, h, ref, dx, dy = (mc[:, k] for k in range(7))
    valid = w > 0

    ring_flat = ring.reshape(-1)

    def window(ybase, xbase, refi, n):
        # flat 1-D gather (one canonical gather form)
        ii = jnp.arange(n)[None, :, None]
        jj = jnp.arange(n)[None, None, :]
        rows = jnp.clip(ybase[:, None, None] + ii, 0, HH - 1)
        cols = jnp.clip(xbase[:, None, None] + jj, 0, S - 1)
        flat = refi[:, None, None] * (HH * S) + rows * S + cols
        return jnp.take(ring_flat, flat, mode="clip")

    def halfpel(wnd, ddx, ddy, n):
        a = wnd[:, :n, :n]
        b = wnd[:, :n, 1:n + 1]
        cc = wnd[:, 1:n + 1, :n]
        d = wnd[:, 1:n + 1, 1:n + 1]
        c1 = (a >> 1) + (b >> 1)
        c2 = (a >> 1) + (cc >> 1)
        c3 = (((a >> 1) + (b >> 1)) >> 1) + (((cc >> 1) + (d >> 1)) >> 1)
        case = ((ddx & 1) | ((ddy & 1) << 1))[:, None, None]
        return jnp.where(case == 0, a,
                         jnp.where(case == 1, c1,
                                   jnp.where(case == 2, c2, c3)))

    def scatter(buf, px, ybase, xbase, bw, bh, n):
        ii = jnp.arange(n)[None, :, None]
        jj = jnp.arange(n)[None, None, :]
        rows = ybase[:, None, None] + ii
        cols = xbase[:, None, None] + jj
        ok = (valid[:, None, None] & (ii < bh[:, None, None])
              & (jj < bw[:, None, None]))
        flat = jnp.where(ok, rows * S + cols, HH * S)
        return buf.ravel().at[flat.ravel()].set(
            px.ravel(), mode="drop").reshape(HH, S)

    # luma
    wnd = window(y + (dy >> 1), x + (dx >> 1), ref, 17)
    px = halfpel(wnd, dx, dy, 16)
    buf = scatter(buf, px, y, x, w, h, 16)
    # chroma (U and V halves; MVs re-halved like the reference)
    cdx, cdy = dx >> 1, dy >> 1
    cy = H + (y >> 1) + (cdy >> 1)
    for xoff in (0, S // 2):
        cx = (x >> 1) + xoff + (cdx >> 1)
        wndc = window(cy, cx, ref, 9)
        pxc = halfpel(wndc, cdx, cdy, 8)
        buf = scatter(buf, pxc, H + (y >> 1), (x >> 1) + xoff,
                      w >> 1, h >> 1, 8)
    return buf


# ----------------------------------------------------------------- resid
def _resid_block(coef, size):
    """Residual for one 64-coef record: full IDCT at its size, in a 16x16
    tile (top-left corner)."""
    r8 = idct8(coef.reshape(8, 8))
    r4 = idct4(coef[:16].reshape(4, 4))
    out = jnp.zeros((16, 16), jnp.int32)
    out = out.at[:8, :8].set(jnp.where(size == 8, r8,
                                       jnp.pad(r4, ((0, 4), (0, 4)))))
    return out


def _resid_kernel(buf, resid, coef, H, S):
    """Phase 2: add-saturate inter residuals (MinMaxTable semantics)."""
    HH = H + H // 2
    pid, y, x, size = (resid[:, k] for k in range(4))
    row0 = y + pid * H
    res = jax.vmap(_resid_block)(coef, size)
    ii = jnp.arange(16)[None, :, None]
    jj = jnp.arange(16)[None, None, :]
    rows = jnp.clip(row0[:, None, None] + ii, 0, HH - 1)
    cols = jnp.clip(x[:, None, None] + jj, 0, S - 1)
    cur = jnp.take(buf.reshape(-1), rows * S + cols, mode="clip")
    out = jnp.clip(cur + res, 0, 255)
    ok = (size[:, None, None] > 0) & (ii < size[:, None, None]) \
        & (jj < size[:, None, None])
    flat = jnp.where(ok, (row0[:, None, None] + ii) * S
                     + x[:, None, None] + jj, HH * S)
    return buf.ravel().at[flat.ravel()].set(out.ravel(),
                                            mode="drop").reshape(HH, S)


# ----------------------------------------------------------------- intra
_KIND = jnp.asarray(KIND)
_TAPS = jnp.asarray(TAPS)


def _plane_pred_batch(taps, size, grad):
    """Vectorized closed-form plane predictor over a level batch.

    taps: (K, 33) int32; size, grad: (K,).  Returns (K, 16, 16) with the
    reference's u32 word-composition byte aliasing
    (sub_1167BC/sub_116CCC/sub_117E98, MobiclipDecoder.cs:3017-3327).
    """
    t = taps[:, 1:17]
    l = taps[:, 17:33]
    K = taps.shape[0]
    idx = jnp.arange(16)
    n16 = (size == 16)[:, None]
    n4 = (size == 4)[:, None]
    nm1 = jnp.clip(size - 1, 0, 15)
    tr = jnp.take_along_axis(t, nm1[:, None], axis=1)[:, 0]
    bl = jnp.take_along_axis(l, nm1[:, None], axis=1)[:, 0]
    r5 = ((bl + tr + 1) >> 1) + 2 * grad
    r6 = jnp.where(n16[:, 0], r5 - bl + 1, r5 - bl)
    r9 = jnp.where(n16[:, 0], r5 - tr + 1, r5 - tr)
    tscale = jnp.where(n4, 4, 8)
    ascale = jnp.where(n4, 16, 64)
    rshift = jnp.where(size == 4, 5, 7)[:, None, None]
    rnd = jnp.where(n4, 16, 64)[:, :1, None]
    i1 = idx[None, :] + 1
    r4_i = bl[:, None] * tscale + i1 * jnp.where(n16, r6[:, None] >> 1,
                                                 r6[:, None])
    B = jnp.where(n16, r4_i - t * 8 + 1, r4_i - t * tscale)
    r10_r = tr[:, None] * tscale + i1 * jnp.where(n16, r9[:, None] >> 1,
                                                  r9[:, None])
    r7_r = jnp.where(n16, r10_r - l * 8 + 1, r10_r - l * tscale)
    Bt = jnp.where(n16, B >> 1, B)
    r7t = jnp.where(n16, r7_r >> 1, r7_r)
    rr = idx[:, None]
    jj = idx[None, :]
    acc = (ascale[:, :1, None] * t[:, None, :]
           + (rr + 1)[None] * Bt[:, None, :]
           + ascale[:, :1, None] * l[:, :, None]
           + (jj + 1)[None] * r7t[:, :, None] + rnd)
    out = acc >> rshift
    w0, w1, w2, w3 = (out[:, :, k::4] for k in range(4))
    word = (w0 | (w1 << 8) | (w2 << 16) | (w3 << 24))
    res = jnp.zeros((K, 16, 16), jnp.int32)
    res = res.at[:, :, 0::4].set(word & 0xFF)
    res = res.at[:, :, 1::4].set((word >> 8) & 0xFF)
    res = res.at[:, :, 2::4].set((word >> 16) & 0xFF)
    res = res.at[:, :, 3::4].set((word >> 24) & 0xFF)
    return res


def _intra_level_kernel(buf, seqmap, ops, coefs, H, S):
    """One dependency level of intra ops, fully batch-vectorized: bulk flat
    gathers (tap vectors, current content, visibility cells), formula select
    via precomputed LUTs, batched IDCT residuals, one masked flat scatter.
    No per-op control flow — everything is (K, ...) tensor math."""
    HH = H + H // 2
    bflat = buf.reshape(-1)
    sflat = seqmap.reshape(-1)
    Sc = S >> 2
    pid, y, x, size, mode, grad, has_coef = (ops[:, k] for k in range(7))
    av_t, av_l = ops[:, 7], ops[:, 8]
    seq = ops[:, 10]
    row0 = y + pid * H

    # ---- 33-tap neighbor vectors: corner, t[0..15], l[0..15]
    a16 = jnp.arange(16)
    tap_rows = jnp.concatenate([
        jnp.broadcast_to((row0 - 1)[:, None], (row0.shape[0], 17)),
        row0[:, None] + a16[None, :]], axis=1)
    tap_cols = jnp.concatenate([
        (x - 1)[:, None],
        x[:, None] + a16[None, :],
        jnp.broadcast_to((x - 1)[:, None], (x.shape[0], 16))], axis=1)
    cr = jnp.clip(tap_rows, 0, HH - 1)
    cc = jnp.clip(tap_cols, 0, S - 1)
    vals = jnp.take(bflat, cr * S + cc, mode="clip")
    cell = jnp.take(sflat, (cr >> 2) * Sc + (cc >> 2), mode="clip")
    taps = jnp.where((cell >= 0) & (cell < seq[:, None]), vals, 0)

    # ---- current block content (PASS modes / mode-9 residual base)
    ii = jnp.arange(16)[None, :, None]
    jj = jnp.arange(16)[None, None, :]
    rows = jnp.clip(row0[:, None, None] + ii, 0, HH - 1)
    cols = jnp.clip(x[:, None, None] + jj, 0, S - 1)
    cur_cell = jnp.take(sflat, (rows >> 2) * Sc + (cols >> 2), mode="clip")
    cur_v = jnp.take(bflat, rows * S + cols, mode="clip")
    cur = jnp.where((cur_cell >= 0) & (cur_cell < seq[:, None, None]),
                    cur_v, 0)

    # ---- formula modes via LUT select
    kind = jnp.take(_KIND, mode, axis=0, mode="clip")      # (K, 256)
    tsel = jnp.take(_TAPS, mode, axis=0, mode="clip")      # (K, 256, 3)
    a = jnp.take_along_axis(taps, tsel[:, :, 0], axis=1)
    b = jnp.take_along_axis(taps, tsel[:, :, 1], axis=1)
    c = jnp.take_along_axis(taps, tsel[:, :, 2], axis=1)

    # ---- DC values
    npx = jnp.where(size == 4, 4, 8)
    lane = jnp.arange(16)[None, :]
    sum_t = jnp.sum(jnp.where(lane < npx[:, None], taps[:, 1:17], 0), axis=1)
    sum_l = jnp.sum(jnp.where(lane < npx[:, None], taps[:, 17:33], 0), axis=1)
    log_n = jnp.where(size == 4, 2, 3)
    dc_both = (sum_t + sum_l + npx) >> (log_n + 1)
    dc_top = (sum_t + (npx >> 1)) >> log_n
    dc_left = (sum_l + (npx >> 1)) >> log_n
    dc = jnp.where((av_t == 1) & (av_l == 0), dc_top,
                   jnp.where((av_l == 1) & (av_t == 0), dc_left,
                             jnp.where((av_t == 1) & (av_l == 1),
                                       dc_both, 0x80)))
    px = jnp.where(kind == COPY, a,
                   jnp.where(kind == AVG2, (a + b + 1) >> 1,
                             jnp.where(kind == AVG3,
                                       (a + 2 * b + c + 2) >> 2,
                                       jnp.where(kind == DC,
                                                 dc[:, None], 0))))
    pred = px.reshape(-1, 16, 16)
    pred = jnp.where(kind.reshape(-1, 16, 16) == PASS, cur, pred)
    is_plane = ((mode == 2) | (mode == 12))[:, None, None]
    pred = jnp.where(is_plane, _plane_pred_batch(taps, size, grad), pred)

    # ---- residuals (full IDCT at block size)
    res8 = idct8(coefs.reshape(-1, 8, 8))
    res4 = jnp.pad(idct4(coefs[:, :16].reshape(-1, 4, 4)),
                   ((0, 0), (0, 4), (0, 4)))
    res = jnp.zeros((coefs.shape[0], 16, 16), jnp.int32)
    res = res.at[:, :8, :8].set(
        jnp.where((size == 4)[:, None, None], res4, res8))
    out = jnp.where((has_coef == 1)[:, None, None],
                    jnp.clip(pred + res, 0, 255), pred)

    # ---- masked scatter
    ok = ((size > 0)[:, None, None] & (ii < size[:, None, None])
          & (jj < size[:, None, None]))
    flat = jnp.where(ok, (row0[:, None, None] + ii) * S
                     + x[:, None, None] + jj, HH * S)
    return bflat.at[flat.ravel()].set(out.ravel(),
                                      mode="drop").reshape(HH, S)


def decode_frame_core(ring, mc, resid, resid_coef, iops, icoef, seqmap,
                      n_levels, H: int, S: int):
    """Pure single-frame reconstruction (vmappable over a stream batch).
    ``n_levels`` is a traced trip count: level-array padding costs nothing
    at runtime."""
    HH = H + H // 2
    buf = jnp.zeros((HH, S), jnp.int32)
    buf = _mc_kernel(ring, buf, mc, H, S)
    buf = _resid_kernel(buf, resid, resid_coef, H, S)

    def body(lv, buf):
        ops = jax.lax.dynamic_index_in_dim(iops, lv, 0, keepdims=False)
        cfs = jax.lax.dynamic_index_in_dim(icoef, lv, 0, keepdims=False)
        return _intra_level_kernel(buf, seqmap, ops, cfs, H, S)

    return jax.lax.fori_loop(0, jnp.minimum(n_levels, iops.shape[0]),
                             body, buf)


_decode_frame_jit = jax.jit(decode_frame_core, static_argnames=("H", "S"))

# Batched over a leading stream axis on every operand (many independent
# streams at once is what fills a device — BASELINE.md workload constants).
decode_batch_core = jax.vmap(decode_frame_core,
                             in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None, None))
_decode_batch_jit = jax.jit(decode_batch_core, static_argnames=("H", "S"))


class JaxVideoDecoder:
    """Wavefront-engine video decoder: host scanner -> XLA reconstruction.

    Drop-in behavioral equivalent of the oracle (bit-exact YUV): the
    sequential entropy scan runs on the host, reconstruction is a single
    jitted program over the plan arrays.
    """

    def __init__(self, width: int, height: int, version: MobiclipVersion,
                 native: bool | None = None):
        """``native`` selects the C++ scanner (default: use it if a C++
        toolchain is available; plans are bit-identical either way)."""
        self.planner = PlanningDecoder(width, height, version)
        self.native = None
        if native is not False:
            try:
                from ..utils.native import NativePlanner
                self.native = NativePlanner(width, height, int(version))
            except Exception:
                if native is True:
                    raise
        self.width, self.height = width, height
        self.stride = self.planner.stride
        HH = height + height // 2
        self.ring = jnp.zeros((6, HH, self.stride), jnp.int32)

    @property
    def offset(self):
        return (self.native.offset if self.native is not None
                else self.planner.offset)

    def decode_frame(self, packet: bytes) -> tuple[np.ndarray, np.ndarray]:
        """Decode one frame packet; returns (Y, UV) uint8 numpy planes of
        shapes (H, S) and (H/2, S)."""
        if self.native is not None:
            plan = self.native.scan(packet)
        else:
            self.planner.data = packet
            self.planner.offset = 0
            self.planner.decode_frame()
            plan = self.planner.plan()
        arrays = prepare_plan(plan)
        H, S = self.height, self.stride
        ring = jnp.roll(self.ring, 1, axis=0)
        buf = _decode_frame_jit(ring, arrays["mc"], arrays["resid"],
                                arrays["resid_coef"], arrays["iops"],
                                arrays["icoef"], arrays["seqmap"],
                                arrays["n_levels"], H, S)
        self.ring = ring.at[0].set(buf)
        out = np.asarray(buf).astype(np.uint8)
        return out[:H], out[H:]
