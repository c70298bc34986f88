"""Whole-GOP sequential reconstruction engine (Pallas, Triton route).

Motion compensation, inter residuals and intra prediction for a whole GOP
run as ONE Pallas kernel launch: one program per stream (``grid=(B,)``),
each walking its stream's packed op chunks in the reference's exact decode
order.  The reference's "read whatever is in the plane right now"
semantics (fresh-plane zeros for not-yet-decoded taps,
MobiclipDecoder.cs:2368-2471; pass-through residual bases) hold by
construction — no sequence maps, no wavefront levels, no full-plane
scatter passes like the XLA wavefront engine (models/pipeline.py), which
stays as the independent cross-check engine.

Device layout: each stream owns a 6-slot reference ring of uint8 planes in
device memory, ``(HB, SB)`` bytes per slot — Y rows then packed U|V rows,
with MR zero rows above, MCOL zero columns left and a zero apron right and
below, so taps outside the picture read the fresh-plane value 0.  Frame f
decodes straight into slot (5 - f) mod 6; reference r (1-based) of frame f
reads slot (5 - f + r) mod 6.  A DS ring is 432 KiB and a 640x480 ring
about 4.6 MiB per stream, so the working set of a batch sits in L2.

Every op addresses the plane directly with masked 16x16 (luma) or 8x16
(U|V) gathers and scatters at its (row, col).  Ops depend on the pixels
earlier ops stored, and other threads of the program stored them, so the
compiled kernel puts a block barrier after every op.

Integer semantics are bit-exact vs models/oracle_video.py (the executable
spec of MobiclipDecoder.cs): truncating arithmetic shifts for half-pel
averaging (CopyBlock :418-456), u32 word-composition byte aliasing in the
plane predictors (:3017-3327), H.264-style add-clamp (:3551-3558).  There
is no floating point anywhere in the kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intra_tables import AVG2, AVG3, COPY, KIND, TAPS
from ..models.plan import OP_INTRA, OP_MC, OP_RESID

MR = 8       # zero rows above the picture (taps at row -1 read 0)
MCOL = 8     # zero columns left of the picture
RAPRON = 24  # zero columns right of the picture: 16x16 tiles of edge
#              blocks and vertical-left taps reach 15 px past a block
# Op rows per chunk (row 0 is the chunk header); native/scanner.cpp emits
# the same chunking.
CHUNK = 256
# Warps per stream program; a program's work per op is one 16x16 tile.
# Measured on an H100 (PERF.md): 8 warps ran DS GOPs about 8% faster
# than 4 and twice as fast as 1, with identical output.
NUM_WARPS = 8


def _geom(height: int, stride: int) -> tuple[int, int, int]:
    """(HH, HB, SB): decoded rows (Y + U|V), buffer rows, buffer stride."""
    hh = height + height // 2
    return hh, hh + 32, stride + MCOL + RAPRON


def resolve_interpret(interpret: bool | None = None,
                      backend: str | None = None,
                      platforms: str | None = None) -> bool:
    """Whether the executor runs in Pallas interpret mode.

    Compiled on a GPU backend.  Interpreted only where the process asked
    for the CPU platform explicitly (``jax_platforms == "cpu"``, as the
    test suite does).  Any other backend raises: the interpreter is far
    too slow to pass for a decode."""
    if interpret is not None:
        return bool(interpret)
    backend = jax.default_backend() if backend is None else backend
    if platforms is None:
        platforms = jax.config.jax_platforms or ""
    if backend == "gpu":
        return False
    if backend == "cpu" and platforms == "cpu":
        return True
    raise RuntimeError(
        f"the device engine needs a GPU (JAX backend is {backend!r}); "
        "decode with --engine oracle, or set JAX_PLATFORMS=cpu to run the "
        "kernel in Pallas interpret mode for testing")


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


def _btf8_ax0(c):
    """8-point butterfly along axis 0 of (8, ..., N) int32 — same
    shift-add dataflow as ops/idct.py _btf8 (MobiclipDecoder.cs:3450-3505),
    with the batch on the minor axis."""
    r0, r1, r2, r3, r4, r5, r6, r7 = (c[k] for k in range(8))
    a0 = r0 + r4
    a1 = r0 - r4
    b0 = r2 + (r6 >> 1)
    b1 = (r2 >> 1) - r6
    e2 = a1 + b1
    e4 = a1 - b1
    e6 = a0 - b0
    e0 = a0 + b0
    o0 = r1 + r7 - r3 - (r3 >> 1)
    o1 = r7 - r1 + r5 + (r5 >> 1)
    o2 = r5 - r7 - (r7 >> 1) - r3
    o3 = r3 + r5 + r1 + (r1 >> 1)
    f1 = o2 + (o3 >> 2)
    f7 = o3 - (o2 >> 2)
    f3 = o0 + (o1 >> 2)
    f5 = (o0 >> 2) - o1
    return jnp.stack([e0 + f7, e2 + f5, e4 + f3, e6 + f1,
                      e6 - f1, e4 - f3, e2 - f5, e0 - f7], axis=0)


def _btf4_ax0(c):
    """4-point butterfly along axis 0 (IDCT16Px4, :3728-3784)."""
    r0, r1, r2, r3 = (c[k] for k in range(4))
    e0 = r0 + r2
    e1 = r0 - r2
    o1 = (r1 >> 1) - r3
    o0 = r1 + (r3 >> 1)
    return jnp.stack([e0 + o0, e1 + o1, e1 - o1, e0 - o0], axis=0)


def _residuals(flat, sizes_flat):
    """IDCT pre-pass (plain XLA) over every coefficient row.

    Rows flagged size 8 hold one 8x8 coefficient block.  Rows flagged 4
    hold up to FOUR 4x4 blocks in quadrant slots [q0|q1|q2|q3] (the
    scanner's quad-merge: the 4x4 residuals of one inter 8x8 are emitted
    as ONE op whose (8,8) residual is assembled here; intra 4x4 residual
    rows are the degenerate q0-only case, and empty quadrants IDCT to
    zero, so an absent sub-block leaves its pixels untouched through the
    kernel's clip(cur + 0) identity).  Returns (N, 64) rows whose (8,8)
    view is the spatial residual."""
    N = flat.shape[0]
    xT = flat.T                              # (64, N)
    # --- 8x8: coefficient rows (8r, 8c, N); butterfly over coef cols,
    # transpose-free axis swap, second pass, >>6 (idct8's dataflow)
    c8 = xT.reshape(8, 8, N).at[0, 0].add(32)
    t8 = _btf8_ax0(jnp.swapaxes(c8, 0, 1))
    d8 = _btf8_ax0(jnp.swapaxes(t8, 0, 1))
    r8 = jnp.swapaxes(d8, 0, 1) >> 6         # (8r, 8c, N) spatial
    # --- 4x4 quads: [q0|q1|q2|q3] slots -> (4q, 4r, 4c, N); +32 DC
    # rounding applies to EVERY quad's [0,0]
    c4 = xT.reshape(4, 4, 4, N).at[:, 0, 0].add(32)
    tq = _btf4_ax0(jnp.moveaxis(c4, 2, 0))
    dq = _btf4_ax0(jnp.moveaxis(tq, 2, 0))
    # (q, out_c, out_r, N): mirror idct4's output orientation (the full
    # path's output block index is [transformed_coef, transformed_row])
    rq4 = jnp.moveaxis(dq, 2, 0).swapaxes(1, 2) >> 6
    # assemble quads: spatial row = (q>>1)*4 + out_c, col = (q&1)*4 + out_r
    rq = rq4.reshape(2, 2, 4, 4, N).transpose(0, 2, 1, 3, 4) \
        .reshape(8, 8, N)
    resid = jnp.where((sizes_flat == 4)[None, None, :], rq, r8)
    return resid.transpose(2, 0, 1).reshape(N, 64)


# ===================================================================== kernel
def _make_kernel(B: int, H: int, S: int, nct: int, nres: int,
                 interpret: bool):
    """Build the whole-GOP executor for B streams of geometry (H, S) and
    ``nct`` packed op chunks per stream.

    The op stream is a packed chunk sequence per stream: each (CHUNK, 4)
    chunk's header row is [count, frame_idx, first_flag, last_flag], op
    rows follow (models/plan.py pack_unified documents the row format).
    Coefficient rows are partitioned by chunk, so an op's row index w3 is
    chunk-local.  Padding chunks are all zero (count 0) and do nothing.
    """
    HH, HB, SB = _geom(H, S)
    PL = HB * SB                    # bytes per ring slot
    HALF = S // 2                   # V sits at a static +S/2 column offset
    ZT = 4096                       # flat zero-fill tile (power of two)
    NZ = -(-PL // ZT)

    def where(c, x, y):
        # typed constants: the Triton lowering gives a weak Python literal
        # in a select the predicate's i1 type
        return jnp.where(c, np.int32(x) if isinstance(x, int) else x,
                         np.int32(y) if isinstance(y, int) else y)

    def kernel(_ring_in, ops_ref, res_ref, kind_ref, taps_ref,
               ring_ref, frames_ref):
        b = pl.program_id(0)
        ii = jax.lax.broadcasted_iota(jnp.int32, (16, 16), 0)
        jj = jax.lax.broadcasted_iota(jnp.int32, (16, 16), 1)
        # U|V tiles: 8 rows x (8 U columns | 8 V columns)
        ic = jax.lax.broadcasted_iota(jnp.int32, (8, 16), 0)
        jc = jax.lax.broadcasted_iota(jnp.int32, (8, 16), 1)
        vh = jc >> 3                       # 0 = U half, 1 = V half
        jl = jc & 7
        v16 = jax.lax.broadcasted_iota(jnp.int32, (16,), 0)

        def sync():
            # block barrier between dependent ops; the interpreter runs
            # one thread, and the primitive has no interpret rule
            if not interpret:
                plgpu.debug_barrier()

        def load(ref, idx, mask=None):
            if mask is None:
                return ref[idx]
            return plgpu.load(ref.at[idx], mask=mask, other=0)

        def px(base, r, c, mask=None):
            """Ring pixels at (r, c) of the slot at ``base`` as int32;
            coordinates clamp into the slot (only malformed streams reach
            past the zero aprons)."""
            r = jnp.clip(r, 0, HB - 1)
            c = jnp.clip(c, 0, SB - 1)
            return load(ring_ref, base + r * SB + c, mask).astype(jnp.int32)

        def put(base, r, c, val, mask):
            # (r, c) are an op's own in-picture pixels: distinct addresses
            # inside the slot, so masked-off lanes never alias a store
            plgpu.store(ring_ref.at[base + r * SB + c],
                        val.astype(jnp.uint8), mask=mask)

        def res(rowbase, row, i, j, mask):
            """Spatial residual (i, j) of chunk-local coefficient row."""
            g = jnp.minimum(rowbase + row, nres - 1)
            return load(res_ref, g * 64 + (i & 7) * 8 + (j & 7), mask)

        def popc4(m):
            return (m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1) + ((m >> 3) & 1)

        def quad_res(rowbase, first, m4):
            """16x16 residual of up to four 8x8 quads: quad q (rows
            8*(q>>1), cols 8*(q&1)) is present when bit q of m4 is set
            and reads the next of the consecutive rows from ``first``."""
            q = (ii >> 3) * 2 + (jj >> 3)
            row = (first + where(q >= 1, m4 & 1, 0)
                   + where(q >= 2, (m4 >> 1) & 1, 0)
                   + where(q >= 3, (m4 >> 2) & 1, 0))
            return res(rowbase, row, ii, jj, ((m4 >> q) & 1) == 1)

        def halfpel(base, r, c, dx, dy, mask):
            """CopyBlock's 4 filter cases from four shifted loads
            (truncating >>1 per operand, MobiclipDecoder.cs:433-449)."""
            hx = (dx & 1) == 1
            hy = (dy & 1) == 1
            a = px(base, r, c, mask)
            bb = px(base, r, c + 1, mask & hx)
            cv = px(base, r + 1, c, mask & hy)
            d = px(base, r + 1, c + 1, mask & hx & hy)
            h = (a >> 1) + (bb >> 1)
            v = (a >> 1) + (cv >> 1)
            hv = (h >> 1) + (((cv >> 1) + (d >> 1)) >> 1)
            return where(hx, where(hy, hv, h), where(hy, v, a))

        def slot(s):
            return (b * 6 + s) * PL

        # ------------------------------------------------------ MC (1)
        def op_mc(w, rowbase, cur, fm):
            w0, w1, w2, w3 = w
            rr = w1 & 0xFFFF
            cc = w1 >> 16
            bw = (w0 >> 16) & 0x1F
            bh = (w0 >> 21) & 0x1F
            ref = (w0 >> 13) & 7
            # fused residual rows: bits 3..8 of w0 are the cbp mask (4
            # luma quadrant bits + U + V), w3 the first consecutive row
            rmask = (w0 >> 3) & 0x3F
            dx = (w2 << 16) >> 16
            dy = w2 >> 16
            src = slot(jax.lax.rem(5 - fm + ref, 6))
            inb = (ii < bh) & (jj < bw)
            p = halfpel(src, rr + (dy >> 1) + ii, cc + (dx >> 1) + jj,
                        dx, dy, inb)
            p = jnp.clip(p + quad_res(rowbase, w3, rmask & 0xF), 0, 255)
            put(cur, rr + ii, cc + jj, p, inb)
            # chroma: U and V halves in one tile, MVs re-halved
            cdx = dx >> 1
            cdy = dy >> 1
            cy = MR + H + ((rr - MR) >> 1)
            col = MCOL + ((cc - MCOL) >> 1) + vh * HALF + jl
            cin = (ic < (bh >> 1)) & (jl < (bw >> 1))
            pc = halfpel(src, cy + (cdy >> 1) + ic, col + (cdx >> 1),
                         cdx, cdy, cin)
            bu = (rmask >> 4) & 1
            bv = (rmask >> 5) & 1
            crow = w3 + popc4(rmask & 0xF) + vh * bu
            cbit = where(vh == 0, bu, bv)
            pc = jnp.clip(pc + res(rowbase, crow, ic, jl, cin & (cbit == 1)),
                          0, 255)
            put(cur, cy + ic, col, pc, cin)
            sync()

        # -------------------------------------------------- resid (2)
        # three region forms (models/plan.py pack_unified): plain
        # 4x4/8x8, masked 16x16 (a split MB's luma quads in ONE op), and
        # the chroma U+V pair
        def op_res(w, rowbase, cur):
            w0, w1, _w2, w3 = w
            rr = w1 & 0xFFFF
            cc = w1 >> 16
            sl = (w0 >> 2) & 7

            @pl.when(sl < 4)
            def _plain():
                n = 1 << sl
                inb = (ii < n) & (jj < n)
                c = px(cur, rr + ii, cc + jj, inb)
                r = res(rowbase, w3, ii, jj, inb)
                put(cur, rr + ii, cc + jj, jnp.clip(c + r, 0, 255), inb)

            @pl.when(sl == 4)
            def _masked16():
                # uncoded quads add 0: clip(cur + 0) == cur rewrites them
                # unchanged, so one full-region commit is exact
                c = px(cur, rr + ii, cc + jj)
                r = quad_res(rowbase, w3, (w0 >> 5) & 0xF)
                put(cur, rr + ii, cc + jj, jnp.clip(c + r, 0, 255), None)

            @pl.when(sl == 5)
            def _uv():
                bu = (w0 >> 5) & 1
                bv = (w0 >> 6) & 1
                col = cc + vh * HALF + jl
                c = px(cur, rr + ic, col)
                r = res(rowbase, w3 + vh * bu, ic, jl,
                        where(vh == 0, bu, bv) == 1)
                put(cur, rr + ic, col, jnp.clip(c + r, 0, 255), None)

            sync()

        # -------------------------------------------------- intra (3)
        def directional(cur, r0, c0, n, mode, avt, avl):
            """Directional/DC prediction of an n x n block (n = 4, 8) at
            (r0, c0): per-pixel formula kind and tap indices from
            ops/intra_tables.py, taps gathered straight from the plane
            (corner @0, top row t[k] @1+k, left column l[k] @17+k)."""
            inb = (ii < n) & (jj < n)
            e = mode * 256 + ii * 16 + jj
            k = load(kind_ref, e)
            t0 = load(taps_ref, e * 3)
            t1 = load(taps_ref, e * 3 + 1)
            t2 = load(taps_ref, e * 3 + 2)

            def tap(t, m):
                return px(cur, where(t <= 16, r0 - 1, r0 + t - 17),
                          where(t <= 16, c0 + t - 1, c0 - 1), m)

            v0 = tap(t0, inb & (k <= AVG3))
            v1 = tap(t1, inb & ((k == AVG2) | (k == AVG3)))
            v2 = tap(t2, inb & (k == AVG3))
            pdir = where(k == COPY, v0,
                         where(k == AVG2, (v0 + v1 + 1) >> 1,
                               where(k == AVG3, (v0 + 2 * v1 + v2 + 2) >> 2,
                                     0)))
            # DC with edge availability (:1920-2022)
            is_dc = (mode == 3) | (mode == 13)
            on = (v16 < n) & is_dc
            st = jnp.sum(px(cur, r0 - 1 + 0 * v16, c0 + v16, on))
            sl = jnp.sum(px(cur, r0 + v16, c0 - 1 + 0 * v16, on))
            logn = where(n == 4, 2, 3)
            dc = where((avt == 1) & (avl == 1), (st + sl + n) >> (logn + 1),
                       where(avt == 1, (st + (n >> 1)) >> logn,
                             where(avl == 1, (sl + (n >> 1)) >> logn,
                                   0x80)))
            return where(is_dc, dc, pdir)

        def plane(cur, r0, c0, n, grad):
            """Plane modes 2/12 and the 16x16 plane op: closed form of the
            sub_1167BC/sub_116CCC/sub_117E98 recurrences (:3017-3327),
            stored through the reference's u32 word composition so
            out-of-range values alias between byte lanes."""
            n16 = n == 16
            n16i = n16.astype(jnp.int32)
            tsc = where(n == 4, 4, 8)
            asc = where(n == 4, 16, 64)
            rsh = where(n == 4, 5, 7)
            inb = (ii < n) & (jj < n)
            tr = px(cur, r0 - 1, c0 + n - 1)
            bl = px(cur, r0 + n - 1, c0 - 1)
            r5 = ((bl + tr + 1) >> 1) + 2 * grad
            r6 = r5 - bl + n16i
            r9 = r5 - tr + n16i
            r6h = where(n16, r6 >> 1, r6)
            r9h = where(n16, r9 >> 1, r9)
            lft = px(cur, r0 + ii, c0 - 1 + 0 * jj, inb)
            r7 = tr * tsc + (ii + 1) * r9h - lft * tsc + n16i
            r7t = where(n16, r7 >> 1, r7)

            def pout(colx):
                t = px(cur, r0 - 1 + 0 * ii, c0 + colx, inb)
                bi = bl * tsc + (colx + 1) * r6h - t * tsc + n16i
                bt = where(n16, bi >> 1, bi)
                acc = (asc * t + (ii + 1) * bt + asc * lft
                       + (colx + 1) * r7t + asc)
                return acc >> rsh

            g = jj & ~3
            word = (pout(g) | (pout(g + 1) << 8) | (pout(g + 2) << 16)
                    | (pout(g + 3) << 24))
            return jax.lax.shift_right_logical(word, (jj & 3) * 8) & 0xFF

        def op_intra(w, rowbase, cur):
            """All intra forms as a loop over sub-blocks: a single op (one
            block, may be a plane mode), a luma quad batch (up to four
            4x4/8x8 directional sub-blocks, each reading its predecessors'
            pixels) or the chroma U+V pair (models/plan.py pack_unified)."""
            w0, w1, w2, w3 = w
            rr = w1 & 0xFFFF
            cc = w1 >> 16
            isl = (w0 >> 2) & 7
            quad = (isl == 5) | (isl == 6)
            pair = isl == 7
            qsz = where(isl == 5, 4, 8)

            def sub(s, carry):
                nib = (w0 >> (5 + 4 * s)) & 0xF
                qmode = jnp.minimum(nib + where(isl == 5, 10, 0), 19)
                qrow = w3 + popc4((w0 >> 21) & ((1 << s) - 1))
                n = where(quad, qsz, where(pair, 8, 1 << isl))
                r0 = rr + where(quad, qsz * (s >> 1), 0)
                c0 = cc + where(quad, qsz * (s & 1),
                                where(pair, s * HALF, 0))
                mode = where(quad, qmode, (w0 >> 5) & 0x1F)
                has = where(quad, (w0 >> (21 + s)) & 1,
                            where(pair, (w0 >> (10 + s)) & 1,
                                  (w0 >> 10) & 1))
                avt = where(quad, where(s < 2, w2 & 1, 1),
                            where(pair, (rr != MR + H).astype(jnp.int32),
                                  (w0 >> 11) & 1))
                avl = where(quad, where((s & 1) == 0, (w2 >> 1) & 1, 1),
                            where(pair, (cc != MCOL).astype(jnp.int32),
                                  (w0 >> 12) & 1))
                row = where(quad, qrow,
                            w3 + where(pair, s * ((w0 >> 10) & 1), 0))
                present = jnp.logical_not(quad) | (nib != 0xF)
                is_plane = ((isl < 5) & ((mode == 2) | (mode == 12)))
                inb = (ii < n) & (jj < n)

                def commit(pred):
                    r = res(rowbase, row, ii, jj, inb & (has == 1))
                    put(cur, r0 + ii, c0 + jj, jnp.clip(pred + r, 0, 255),
                        inb)

                @pl.when(present & is_plane)
                def _plane():
                    commit(plane(cur, r0, c0, n, w2))

                @pl.when(present & jnp.logical_not(is_plane))
                def _dir():
                    commit(directional(cur, r0, c0, n, mode, avt, avl))

                sync()
                return carry

            nsub = where(quad, 4, where(pair, 2, 1))
            jax.lax.fori_loop(0, nsub, sub, 0)

        # -------------------------------------------------- frame control
        def zero_slot(cur):
            z = jax.lax.broadcasted_iota(jnp.int32, (ZT,), 0)

            def body(t, carry):
                # clamped duplicate lanes all store the same 0
                ring_ref[cur + jnp.minimum(t * ZT + z, PL - 1)] = \
                    jnp.zeros((ZT,), jnp.uint8)
                return carry
            jax.lax.fori_loop(0, NZ, body, 0)

        def commit_frame(cur, fid):
            """Decoded picture (rows MR.., cols MCOL..) -> frames[fid, b]."""
            r8 = jax.lax.broadcasted_iota(jnp.int32, (8, S), 0)
            c8 = jax.lax.broadcasted_iota(jnp.int32, (8, S), 1)
            dst = (fid * B + b) * HH * S

            def body(t, carry):
                r = t * 8 + r8
                frames_ref[dst + r * S + c8] = \
                    ring_ref[cur + (MR + r) * SB + MCOL + c8]
                return carry
            jax.lax.fori_loop(0, HH // 8, body, 0)

        nrow4 = B * nct * CHUNK * 4

        def row_words(o):
            o = jnp.minimum(o, nrow4 - 4)
            return tuple(ops_ref[o + k] for k in range(4))

        def chunk(c, carry):
            hdr = (b * nct + c) * CHUNK * 4
            cnt, fid, first, last = row_words(hdr)
            fm = jax.lax.rem(fid, 6)
            cur = slot(5 - fm)
            rowbase = (b * nct + c) * CHUNK

            @pl.when(first == 1)
            def _fresh():
                zero_slot(cur)
                sync()

            def op(i, w):
                # the next row's words load while this op runs
                nxt = row_words(hdr + 4 * (i + 1))
                typ = w[0] & 3
                pl.when(typ == OP_MC)(lambda: op_mc(w, rowbase, cur, fm))
                pl.when(typ == OP_RESID)(lambda: op_res(w, rowbase, cur))
                pl.when(typ == OP_INTRA)(lambda: op_intra(w, rowbase, cur))
                return nxt

            jax.lax.fori_loop(1, 1 + cnt, op, row_words(hdr + 4))

            @pl.when(last == 1)
            def _commit():
                commit_frame(cur, fid)
            return carry

        jax.lax.fori_loop(0, nct, chunk, 0)

    return kernel


def _intra_tables() -> tuple[np.ndarray, np.ndarray]:
    """Flat (20*256,) formula kinds and (20*256*3,) tap indices."""
    return (np.ascontiguousarray(KIND, np.int32).reshape(-1),
            np.ascontiguousarray(TAPS, np.int32).reshape(-1))


@functools.lru_cache(maxsize=None)
def _build_gop_executor(F: int, B: int, H: int, S: int, nct: int,
                        interpret: bool):
    """Whole-GOP executor: ONE launch, one program per stream.  The ring
    (B streams x 6 slots, flat uint8) is updated in place (input/output
    aliased); returns (ring, frames (F*B*HH*S,) uint8)."""
    HH, HB, SB = _geom(H, S)
    nres = B * nct * CHUNK
    kernel = _make_kernel(B, H, S, nct, nres, interpret)
    # host numpy constants: the builder is lru-cached and may first run
    # inside a trace, where jnp arrays would leak tracers into later ones
    kind, taps = _intra_tables()
    call = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((B * 6 * HB * SB,), jnp.uint8),   # ring
            jax.ShapeDtypeStruct((F * B * HH * S,), jnp.uint8),    # frames
        ),
        grid=(B,),
        input_output_aliases={0: 0},
        backend="triton",
        # one pipeline stage: nothing may move a load across a barrier
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="mobiclip_gop_executor",
    )

    def run(ring, ops, resid):
        return call(ring, ops, resid, kind, taps)

    return run


def _op_nrows(w0: int) -> int:
    """Coefficient rows referenced by one op row: plain resid/intra-with-
    coef reference one; a fused MC references popcount of its residual
    mask (w0 bits 3..8); batched residuals (size_log 4 masked-16x16 /
    size_log 5 U+V pair) popcount of their masks (w0 bits 5..)."""
    typ = w0 & 3
    if typ == OP_RESID:
        sl = (w0 >> 2) & 7
        if sl == 4:
            return bin((w0 >> 5) & 0xF).count("1")
        if sl == 5:
            return bin((w0 >> 5) & 0x3).count("1")
        return 1
    if typ == OP_INTRA:
        sl = (w0 >> 2) & 7
        if sl in (5, 6):                       # luma quad batch
            return bin((w0 >> 21) & 0xF).count("1")
        if sl == 7:                            # chroma U+V pair
            return bin((w0 >> 10) & 0x3).count("1")
        return (w0 >> 10) & 1
    if typ == OP_MC:
        return bin((w0 >> 3) & 0x3F).count("1")
    return 0


def _frame_chunk_spans(rows: np.ndarray) -> list[tuple[int, int]]:
    """Greedy chunk partition of one frame's op rows: a chunk holds at most
    CHUNK-1 op rows AND at most CHUNK coefficient rows (fused MC ops carry
    up to 6 rows each, so the coefficient block can fill first).  This is
    the executable spec of the C++ scanner's chunk-close rule
    (native/scanner.cpp) — both must split identically."""
    n = rows.shape[0]
    spans = []
    i = 0
    cap = CHUNK - 1
    while i < n or not spans:
        j = i
        crow = 0
        while j < n and (j - i) < cap:
            nr = _op_nrows(int(rows[j, 0]))
            if crow + nr > CHUNK:
                break
            crow += nr
            j += 1
        spans.append((i, j))
        i = j
        if i >= n:
            break
    return spans


def _pack_gop_chunks(plans_fb: list[list[dict]], B: int) -> tuple:
    """Pack per-frame scan plans into the packed-chunk-stream GOP layout.

    plans_fb[f][b] = scan_unified dict.  Returns (ops (B, NCT, CHUNK, 4),
    coefs (B, NCT, CHUNK, 64), sizes (B, NCT, CHUNK)).  Chunk headers
    carry [count, frame_idx, first_flag, last_flag]; chunk spans follow
    _frame_chunk_spans.  Coefficient rows are re-partitioned per chunk
    (w3 references become chunk-local)."""
    F = len(plans_fb)
    spans_fb = [[_frame_chunk_spans(
        plans_fb[f][b]["ops"][1:1 + int(plans_fb[f][b]["ops"][0, 0])])
        for f in range(F)] for b in range(B)]
    nct = _bucket(max(sum(len(s) for s in spans_fb[b]) for b in range(B)),
                  NCT_BUCKETS)
    ops = np.zeros((B, nct, CHUNK, 4), np.int32)
    coefs = np.zeros((B, nct, CHUNK, 64), np.int32)
    sizes = np.full((B, nct, CHUNK), 8, np.int32)
    for b in range(B):
        k = 0
        for f in range(F):
            p = plans_fb[f][b]
            n = int(p["ops"][0, 0])
            rows = p["ops"][1:1 + n]
            spans = spans_fb[b][f]
            for c, (i0, i1) in enumerate(spans):
                m = i1 - i0
                dst = ops[b, k, 1:1 + m]
                dst[:] = rows[i0:i1]
                crow = 0
                for r in range(m):
                    nr = _op_nrows(int(dst[r, 0]))
                    if nr:
                        w3 = int(dst[r, 3])
                        coefs[b, k, crow:crow + nr] = \
                            p["coefs"][w3:w3 + nr]
                        sizes[b, k, crow:crow + nr] = \
                            p["sizes"][w3:w3 + nr]
                        dst[r, 3] = crow
                        crow += nr
                    else:
                        dst[r, 3] = 0
                ops[b, k, 0] = (m, f,
                                1 if c == 0 else 0,
                                1 if c == len(spans) - 1 else 0)
                k += 1
    return ops, coefs, sizes


# Whole-GOP packed-chunk-stream buckets: chunks per stream per GOP.  Each
# step is one executor compile per geometry.  A DS 24-frame GOP stream
# packs to about 74 chunks and a 640x480 8-frame stream to about 130 on
# the synthetic workload; padding chunks cost one header read each.
NCT_BUCKETS = (16, 64, 76, 88, 112, 136, 160, 256, 512, 1024)


@functools.partial(jax.jit, static_argnames=("F", "H", "S", "interpret"),
                   donate_argnums=(0,))
def _decode_gop_fused(ring, ops, coefs, sizes, F: int, H: int, S: int,
                      interpret: bool):
    """Whole-GOP decode as ONE kernel launch.

    ops: (B, NCT, CHUNK, 4) packed chunk stream;
    coefs: (B, NCT, CHUNK, 64) chunk-partitioned coefficient rows;
    sizes: (B, NCT, CHUNK); ring: (B, 6, HB, SB) uint8.
    Returns (ring, yuv (F, B, HH, S) uint8).
    """
    B = ops.shape[0]
    nct = ops.shape[1]
    HH, HB, SB = _geom(H, S)
    flat = coefs.reshape(B * nct * CHUNK, 64)
    resid = _residuals(flat, sizes.reshape(-1))
    run = _build_gop_executor(F, B, H, S, nct, interpret)
    ring2, frames = run(ring.reshape(-1), ops.reshape(-1),
                        resid.reshape(-1))
    # renormalize the modular ring back to slot 0 = newest (frame F-1 wrote
    # slot (5 - (F-1)) mod 6)
    w_last = (5 - (F - 1)) % 6
    ring2 = jnp.roll(ring2.reshape(B, 6, HB, SB), -w_last, axis=1)
    return ring2, frames.reshape(F, B, HH, S)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _crop_gop_yuv(yuv, H: int, W: int, S: int):
    """Device-side crop of a fused result (..., H+H/2, S) to (..., H+H/2, W):
    Y columns [0, W); the packed UV rows keep U from [0, W/2) and V from
    [S/2, S/2+W/2), repacked adjacent."""
    y = yuv[..., :H, :W]
    u = yuv[..., H:, :W // 2]
    v = yuv[..., H:, S // 2:S // 2 + W // 2]
    return jnp.concatenate([y, jnp.concatenate([u, v], axis=-1)], axis=-2)


def _gop_part(r: dict) -> dict:
    """Normalize a NativePlanner.scan_gop_packed result into a sliceable
    'part': a frame range over the scan's packed chunk stream.  Parts are
    cheap views into the scan buffers; slicing at frame boundaries (see
    _split_gop_part) re-bases frame ids and coefficient indices at assembly
    time, so oversized GOPs split WITHOUT rescanning."""
    return dict(ops3=r["ops3"], szw=r["szw"],
                idx=r["idx"][:r["nnz"]], val=r["val"][:r["nnz"]],
                fnct=r["frame_nct"], fnnz=r["frame_nnz"],
                c0=0, c1=r["nct"], fbase=0)


def _split_gop_part(q: dict, f0: int, f1: int) -> dict:
    """Sub-part covering the part's local frames [f0, f1)."""
    cn = np.concatenate([[0], np.cumsum(q["fnct"])]).astype(np.int64)
    zn = np.concatenate([[0], np.cumsum(q["fnnz"])]).astype(np.int64)
    return dict(ops3=q["ops3"], szw=q["szw"],
                idx=q["idx"][zn[f0]:zn[f1]], val=q["val"][zn[f0]:zn[f1]],
                fnct=q["fnct"][f0:f1], fnnz=q["fnnz"][f0:f1],
                c0=q["c0"] + int(cn[f0]), c1=q["c0"] + int(cn[f1]),
                fbase=q["fbase"] + f0)


def _part_dense_arrays(parts: list[dict]) -> tuple:
    """Host-side dense reconstruction of per-stream parts: the fallback
    when a SINGLE frame's sparse footprint exceeds the nnz bucket ladder
    (reachable for maximal-density 640x480 frames: 1200 MBs x 384 coefs >
    262144) — mirrors the plan path's dense upload so such frames decode
    instead of raising.  Returns (ops4 (B,nct,CHUNK,4), coefs, sizes)."""
    B = len(parts)
    nct = _bucket(max(q["c1"] - q["c0"] for q in parts), NCT_BUCKETS)
    ops = np.zeros((B, nct, CHUNK, 4), np.int32)
    coefs = np.zeros((B, nct * CHUNK, 64), np.int32)
    sizes = np.full((B, nct * CHUNK), 8, np.int32)
    for b, q in enumerate(parts):
        c0, c1 = q["c0"], q["c1"]
        n = c1 - c0
        p3 = np.ascontiguousarray(q["ops3"][c0:c1]).view(np.uint32)
        a, bw = p3[..., 0], p3[..., 1]
        w0 = a & np.uint32(0x03FFFFFF)
        w3 = (((a >> np.uint32(26)) & np.uint32(0x3F)) << np.uint32(8)) \
            | ((bw >> np.uint32(24)) & np.uint32(0xFF))
        w1 = (bw & np.uint32(0xFFF)) | (((bw >> np.uint32(12))
                                         & np.uint32(0xFFF))
                                        << np.uint32(16))
        o4 = np.stack([w0, w1, p3[..., 2], w3],
                      axis=-1).view(np.int32)
        ops[b, :n] = o4
        if q["fbase"]:
            ops[b, :n, 0, 1] -= q["fbase"]
        idx = q["idx"] - c0 * CHUNK * 64
        coefs[b].reshape(-1)[idx] = q["val"].astype(np.int32)
        spc = CHUNK // 32
        bits = np.unpackbits(
            q["szw"][c0 * spc:c1 * spc].view(np.uint8), bitorder="little")
        sizes[b, :n * CHUNK][bits[:n * CHUNK] == 1] = 4
    return ops, coefs.reshape(B, nct, CHUNK, 64), sizes


def _assemble_gop_parts(parts: list[dict]) -> tuple:
    """Assemble B per-stream parts into the _decode_gop_fused_sblob blob
    (identical layout to _pack_gop_chunks + _pack_gop_blob_sparse, which
    these parts replace on the native hot path).  Caller guarantees every
    part fits the bucket ladders.  Returns (blob, nct, nnzb)."""
    B = len(parts)
    nct = _bucket(max(q["c1"] - q["c0"] for q in parts), NCT_BUCKETS)
    nnzb = _bucket(max(max(q["idx"].size for q in parts), 2),
                   NNZ_PS_BUCKETS)
    rows = nct * CHUNK
    spc = CHUNK // 32                      # size-bit words per chunk
    ops3 = np.zeros((B, nct, CHUNK, 3), np.int32)
    swords = np.zeros((B, nct * spc), np.int32)
    idx = np.full((B, nnzb), rows * 64, np.int32)
    val = np.zeros((B, nnzb), np.int16)
    for b, q in enumerate(parts):
        c0, c1 = q["c0"], q["c1"]
        n = c1 - c0
        ops3[b, :n] = q["ops3"][c0:c1]
        if q["fbase"]:
            # chunk header word B carries the frame id in its low 12 bits
            ops3[b, :n, 0, 1] -= q["fbase"]
        swords[b, :n * spc] = q["szw"][c0 * spc:c1 * spc]
        k = q["idx"].size
        idx[b, :k] = q["idx"]
        if c0:
            idx[b, :k] -= c0 * CHUNK * 64
        val[b, :k] = q["val"]
    val_words = val.reshape(-1).astype('<i2').view('<i4').astype(np.int32)
    blob = np.concatenate([ops3.reshape(-1), swords.reshape(-1),
                           idx.reshape(-1), val_words])
    return blob, nct, nnzb


def _pack_gop_blob_sparse(ops, coefs, sizes):
    """Host-side sparse pack for the fused whole-GOP path, or None when
    the GOP must take the dense fallback.

    Coefficient indices are PER STREAM (local to stream b's (nct*CHUNK,
    64) rows, padded to a common per-stream bucket), so the device-side
    reconstruction is B independent scatters.

    Blob (int32): [ops3 | size_bits | idx (B, nnzb) | val16 (B, nnzb/2)].
    """
    B = sizes.shape[0]
    rows = coefs.reshape(B, -1, 64).shape[1]
    if rows * 64 > (1 << 31) - 1:
        return None
    per = []
    for b in range(B):
        fb = coefs[b].reshape(-1)
        idx = np.flatnonzero(fb)
        val = fb[idx]
        if val.size and (int(val.min()) < -32768 or int(val.max()) > 32767):
            return None
        per.append((idx, val))
    nnz_max = max(max((int(i.size) for i, _ in per), default=0), 2)
    if nnz_max > NNZ_PS_BUCKETS[-1]:
        return None
    ops3 = _pack_ops3(ops)
    if ops3 is None:
        return None
    nnzb = _bucket(nnz_max, NNZ_PS_BUCKETS)
    idx_a = np.full((B, nnzb), rows * 64, np.int32)
    val_a = np.zeros((B, nnzb), np.int16)
    for b, (idx, val) in enumerate(per):
        idx_a[b, :idx.size] = idx
        val_a[b, :idx.size] = val.astype(np.int16)
    nsb = (B * rows + 31) // 32
    sbits = np.zeros(nsb * 32, np.uint32)
    sbits[:B * rows] = (sizes.reshape(-1) == 4)
    swords = (sbits.reshape(-1, 32)
              << np.arange(32, dtype=np.uint32)).sum(
                  axis=1, dtype=np.uint32).view(np.int32)
    val_words = val_a.reshape(-1).astype('<i2').view('<i4').astype(np.int32)
    blob = np.concatenate([ops3.ravel(), swords, idx_a.ravel(), val_words])
    return blob, nnzb


@functools.partial(jax.jit,
                   static_argnames=("F", "nct", "nnzb", "H", "S",
                                    "interpret"),
                   donate_argnums=(0,))
def _decode_gop_fused_sblob(ring, blob, F: int, nct: int,
                            nnzb: int, H: int, S: int, interpret: bool):
    """Sparse-upload whole-GOP decode: ONE host->device blob, ONE kernel
    launch (see _pack_gop_blob_sparse)."""
    B = ring.shape[0]
    nrows = B * nct * CHUNK
    rows = nct * CHUNK
    a = nrows * 3
    nsb = (nrows + 31) // 32
    b = a + nsb
    c = b + B * nnzb
    ops = _unpack_ops3(blob[:a].reshape(B, nct, CHUNK, 3))
    sbits = blob[a:b]
    idx = blob[b:c].reshape(B, nnzb)
    v32 = blob[c:c + B * nnzb // 2].reshape(B, nnzb // 2)
    lo = jax.lax.shift_right_arithmetic(v32 << 16, 16)
    hi = jax.lax.shift_right_arithmetic(v32, 16)
    val = jnp.stack([lo, hi], axis=2).reshape(B, nnzb)
    # one scatter per stream; indices are unique by construction (one
    # entry per nonzero of the dense coefs) and pads sit out of range, so
    # scatter-SET applies
    denses = [
        jnp.zeros(rows * 64, jnp.int32).at[idx[bb]].set(
            val[bb], mode="drop", indices_are_sorted=True,
            unique_indices=True)
        for bb in range(B)
    ]
    coefs = jnp.stack(denses).reshape(B, nct, CHUNK, 64)
    word = sbits[jnp.arange(nrows) // 32]
    bit = (word >> (jnp.arange(nrows) % 32)) & 1
    sizes = jnp.where(bit == 1, 4, 8).astype(jnp.int32).reshape(B, nct,
                                                                CHUNK)
    return _decode_gop_fused(ring, ops, coefs, sizes, F, H, S, interpret)


@functools.lru_cache(maxsize=None)
def _sharded_gop_fused(mesh, F: int, H: int, S: int, interpret: bool):
    """shard_map'd fused whole-GOP decode split over the mesh's 'data'
    axis.  Every argument and result carries the stream batch as a
    leading/inner axis, so the specs are plain data-parallel splits and no
    collectives run (streams are independent)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def fn(ring, ops, coefs, sizes):
        return _decode_gop_fused(ring, ops, coefs, sizes, F, H, S, interpret)

    # check_vma=False: pallas_call's ShapeDtypeStruct outputs carry no vma
    # annotation, which newer JAX rejects under the default check; every
    # in/out spec here is a plain P('data') split
    sm = shard_map(fn, mesh=mesh,
                   in_specs=(P("data"), P("data"), P("data"), P("data")),
                   out_specs=(P("data"), P(None, "data")), check_vma=False)
    return jax.jit(sm, donate_argnums=(0,))


def decode_gop_fused_sharded(mesh, ring, ops, coefs, sizes, F: int, H: int,
                             S: int, interpret: bool):
    """Multi-device fused GOP (B divisible by the data-axis size).
    Returns (ring, yuv (F, B, HH, S)) like _decode_gop_fused."""
    return _sharded_gop_fused(mesh, F, H, S, interpret)(ring, ops, coefs,
                                                        sizes)


# Per-STREAM nnz buckets for the fused whole-GOP path (see
# _pack_gop_blob_sparse).
NNZ_PS_BUCKETS = (16384, 65536, 131072, 262144)


def _pack_ops3(ops: np.ndarray):
    """Pack (..., 4) int32 op rows into (..., 3) for upload, or None when a
    field exceeds its packed width (caller falls back to the 4-word form).

    Op rows (models/plan.py pack_unified) are [w0, w1=rr|cc<<16, w2, w3]
    with w0 using bits 0..25, rr/cc < 4096 (row/col inside the padded
    plane; stride 1024 + margins < 1216), and w3 a chunk-local coefficient
    row index < 2^14.
    Packed: A = w0 | (w3>>8)<<26;  B = rr | cc<<12 | (w3&0xFF)<<24;  C = w2.
    Chunk header rows [count, frame, first, last] satisfy the same bounds
    (count < 2^26, frame < 4096, last < 2^14) so they round-trip too.
    w2 (MV pair / plane gradient) keeps its full 32 bits.
    """
    u = np.ascontiguousarray(ops).view(np.uint32)
    w0, w1, w3 = u[..., 0], u[..., 1], u[..., 3]
    rr = w1 & np.uint32(0xFFFF)
    cc = w1 >> np.uint32(16)
    # negative fields view as huge unsigned values, so the max-checks also
    # reject them
    if int(w0.max(initial=0)) >= 1 << 26:
        return None
    if int(rr.max(initial=0)) >= 1 << 12 or int(cc.max(initial=0)) >= 1 << 12:
        return None
    if int(w3.max(initial=0)) >= 1 << 14:
        return None
    packed = np.empty(ops.shape[:-1] + (3,), np.uint32)
    packed[..., 0] = w0 | (w3 >> np.uint32(8)) << np.uint32(26)
    packed[..., 1] = (rr | cc << np.uint32(12)
                      | (w3 & np.uint32(0xFF)) << np.uint32(24))
    packed[..., 2] = u[..., 2]
    return packed.view(np.int32)


def _unpack_ops3(p3):
    """Device-side inverse of _pack_ops3: (..., 3) -> (..., 4) int32."""
    a = p3[..., 0]
    b = p3[..., 1]
    w0 = a & 0x03FFFFFF
    w3 = ((jax.lax.shift_right_logical(a, 26) & 0x3F) << 8) \
        | (jax.lax.shift_right_logical(b, 24) & 0xFF)
    rr = b & 0xFFF
    cc = jax.lax.shift_right_logical(b, 12) & 0xFFF
    w1 = rr | (cc << 16)
    return jnp.stack([w0, w1, p3[..., 2], w3], axis=-1)


# ==================================================================== driver
class VmemBatchDecoder:
    """Decodes B independent streams in lockstep through the whole-GOP
    executor: one kernel launch per GOP (a frame-at-a-time decode is a GOP
    of one frame)."""

    def __init__(self, width: int, height: int, version, batch: int = 1,
                 interpret: bool | None = None, native: bool | None = None,
                 crop: bool = False):
        # crop=True slices results to frame width ON DEVICE before
        # download — (F, B, HH, W) with the UV halves repacked as U|V in
        # [0,W) — instead of the full stride.  Default off: the
        # full-stride layout is the bit-exactness contract surface the
        # tests compare against.
        from ..models.plan import PlanningDecoder
        self.B = batch
        self.crop = bool(crop)
        self.width, self.height = width, height
        self.planners = [PlanningDecoder(width, height, version)
                         for _ in range(batch)]
        self.natives = None
        if native is not False:
            try:
                from ..utils.native import NativePlanner
                self.natives = [NativePlanner(width, height, int(version))
                                for _ in range(batch)]
            except Exception:
                if native is True:
                    raise
        self.stride = self.planners[0].stride
        import concurrent.futures as _cf
        self._pool = _cf.ThreadPoolExecutor(max_workers=min(batch, 16))
        self.interpret = resolve_interpret(interpret)
        _hh, HB, SB = _geom(height, self.stride)
        self.ring = jnp.zeros((batch, 6, HB, SB), jnp.uint8)
        from ..runtime.metrics import DecodeMetrics
        self.metrics = DecodeMetrics()

    @property
    def offset(self):
        if self.natives is not None:
            return self.natives[0].offset
        return self.planners[0].offset

    def ring_frame_np(self, b: int = 0, slot: int = 0) -> np.ndarray:
        """Host copy of one ring frame as uint8 rows (HB, SB), margins
        included — the accessor for the containment path."""
        return np.asarray(self.ring[b, slot])

    def _scan_one(self, b: int, packet: bytes) -> dict:
        if self.natives is not None:
            return self.natives[b].scan_unified(packet)
        p = self.planners[b]
        p.data = packet
        p.offset = 0
        p.decode_frame()
        return p.unified_plan()

    def _scan_all(self, packets: list[bytes]) -> list[dict]:
        if self.natives is not None and self.B > 1:
            # the C++ scanner releases the GIL (plain ctypes call) and each
            # stream has its own context -> streams scan in parallel on
            # host cores
            return list(self._pool.map(
                lambda a: self._scan_one(*a), enumerate(packets)))
        return [self._scan_one(b, pkt) for b, pkt in enumerate(packets)]

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """One frame per stream (a one-frame GOP); returns (B, HH, S)
        uint8 planes."""
        return self.decode_gop([packets])[0]

    def _dispatch_gop_fused(self, frames: list[list[bytes]]):
        """Scan + pack + dispatch one GOP through the single-launch path;
        returns (scan_end_time, device yuv array) WITHOUT blocking on the
        result (dispatch is async).

        Hot path: the C++ scanner emits the packed upload blob directly
        (scanner_scan_gop) — one native call per stream covering the whole
        GOP, no Python pack loops.  Falls back to the per-frame plan path
        when native scanning is unavailable or the GOP doesn't fit the
        native format (the C++ state is rewound first, so the re-scan is
        bit-identical)."""
        if self.natives is not None:
            out = self._dispatch_gop_native(frames)
            if out is not None:
                return out[0], self._maybe_crop(out[1])
        with jax.profiler.TraceAnnotation("mobiclip.scan"):
            plans_fb = [self._scan_all(fp) for fp in frames]
        t1, yuv = self._dispatch_plans(plans_fb)
        return t1, self._maybe_crop(yuv)

    def _maybe_crop(self, yuv):
        """Apply the device-side width crop when enabled (see __init__)."""
        if not self.crop or self.width == self.stride:
            return yuv
        return _crop_gop_yuv(yuv, self.height, self.width, self.stride)

    def _dispatch_gop_native(self, frames: list[list[bytes]]):
        """Whole-GOP native scan+pack+dispatch, or None to fall back (with
        all stream states rewound to the GOP start)."""
        F = len(frames)
        if F == 0 or F >= 4096:
            return None
        per = [[frames[f][b] for f in range(F)] for b in range(self.B)]
        with jax.profiler.TraceAnnotation("mobiclip.scan"):
            for nv in self.natives:
                nv.checkpoint()
            if self.B > 1:
                res = list(self._pool.map(
                    lambda b: self.natives[b].scan_gop_packed(per[b]),
                    range(self.B)))
            else:
                res = [self.natives[0].scan_gop_packed(per[0])]
        if any(r["err"] or r["val_overflow"] or r["done"] != F
               for r in res):
            # malformed frame, >int16 coefficient, or a stream outgrew the
            # scan buffers: rewind every stream and let the plan path (which
            # has no such limits and raises at the right frame) redo the GOP
            for nv in self.natives:
                nv.rollback()
            return None
        return self._dispatch_parts([_gop_part(r) for r in res])

    def _dispatch_parts(self, parts: list[dict]):
        """Dispatch per-stream GOP parts, splitting at frame boundaries
        while any stream exceeds the chunk/nnz bucket ladders (mirrors
        _dispatch_plans' split; the ring carries across dispatches)."""
        import time
        F = len(parts[0]["fnct"])
        if (max(q["c1"] - q["c0"] for q in parts) > NCT_BUCKETS[-1]
                or max(q["idx"].size for q in parts) > NNZ_PS_BUCKETS[-1]):
            if F <= 1:
                if max(q["c1"] - q["c0"] for q in parts) > NCT_BUCKETS[-1]:
                    raise ValueError(
                        "single frame exceeds fused-GOP chunk buckets")
                # a lone frame too dense for the sparse format: dense
                # upload, like the plan path's _pack_gop_blob_sparse=None
                # fallback
                ops, coefs, sizes = _part_dense_arrays(parts)
                t1 = time.perf_counter()
                self.ring, yuv = _decode_gop_fused(
                    self.ring, jnp.asarray(ops), jnp.asarray(coefs),
                    jnp.asarray(sizes), F, self.height, self.stride,
                    self.interpret)
                return t1, yuv
            mid = F // 2
            _ta, ya = self._dispatch_parts(
                [_split_gop_part(q, 0, mid) for q in parts])
            tb, yb = self._dispatch_parts(
                [_split_gop_part(q, mid, F) for q in parts])
            return tb, jnp.concatenate([ya, yb], axis=0)
        with jax.profiler.TraceAnnotation("mobiclip.pack"):
            blob, nct, nnzb = _assemble_gop_parts(parts)
        t1 = time.perf_counter()
        self.ring, yuv = _decode_gop_fused_sblob(
            self.ring, blob, F, nct, nnzb,
            self.height, self.stride, self.interpret)
        return t1, yuv

    def _dispatch_plans(self, plans_fb: list[list[dict]]):
        """Pack pre-scanned per-frame plans and dispatch the fused GOP.
        A GOP whose packed chunk stream would overflow the largest bucket
        is split into consecutive dispatches (the ring carries across them
        — each dispatch leaves it renormalized), results concatenated on
        device so there is still only one fetch."""
        cap = NCT_BUCKETS[-1]
        totals = [0] * self.B
        for row in plans_fb:
            for b, p in enumerate(row):
                n = int(p["ops"][0, 0])
                totals[b] += len(_frame_chunk_spans(p["ops"][1:1 + n]))
        if max(totals) > cap and len(plans_fb) > 1:
            mid = len(plans_fb) // 2
            _t1a, ya = self._dispatch_plans(plans_fb[:mid])
            t1b, yb = self._dispatch_plans(plans_fb[mid:])
            return t1b, jnp.concatenate([ya, yb], axis=0)
        return self._dispatch_plans_one(plans_fb)

    def _dispatch_plans_one(self, plans_fb: list[list[dict]]):
        import time
        F = len(plans_fb)
        with jax.profiler.TraceAnnotation("mobiclip.pack"):
            ops, coefs, sizes = _pack_gop_chunks(plans_fb, self.B)
        t1 = time.perf_counter()
        nct = ops.shape[1]
        sp = _pack_gop_blob_sparse(ops, coefs,
                                   sizes.reshape(self.B, nct * CHUNK))
        if sp is not None:
            blob, nnzb = sp
            self.ring, yuv = _decode_gop_fused_sblob(
                self.ring, blob, F, nct, nnzb,
                self.height, self.stride, self.interpret)
        else:
            self.ring, yuv = _decode_gop_fused(
                self.ring, jnp.asarray(ops), jnp.asarray(coefs),
                jnp.asarray(sizes), F, self.height, self.stride,
                self.interpret)
        return t1, yuv

    def decode_gops(self, gops) -> "Iterator[np.ndarray]":
        """Streaming multi-GOP decode: GOP n's device->host copy runs
        while GOP n+1 is scanned on the host and decoded on the device.
        Yields (F, B, HH, S) uint8 per GOP, in order."""
        import time
        pending = None
        for frames in gops:
            t0 = time.perf_counter()
            _t1, yuv = self._dispatch_gop_fused(frames)
            yuv.copy_to_host_async()
            if pending is not None:
                out, pf, pt0 = pending
                arr = np.asarray(out)
                self._account_gop(pf, time.perf_counter() - pt0)
                yield arr
            pending = (yuv, len(frames) * self.B, t0)
        if pending is not None:
            out, pf, pt0 = pending
            arr = np.asarray(out)
            self._account_gop(pf, time.perf_counter() - pt0)
            yield arr

    def _account_gop(self, n_frames: int, wall: float) -> None:
        m = self.metrics
        m.frames += n_frames
        m.wall_seconds += wall

    def decode_gop(self, frames: list[list[bytes]]) -> np.ndarray:
        """frames[f][b] = packet of frame f of stream b; returns
        (F, B, HH, S) uint8 — one upload, one launch, one download."""
        import time
        t0 = time.perf_counter()
        t1, yuv = self._dispatch_gop_fused(frames)
        with jax.profiler.TraceAnnotation("mobiclip.device_decode"):
            out = np.asarray(yuv)
        t2 = time.perf_counter()
        m = self.metrics
        m.frames += len(frames) * self.B
        m.bytes_in += sum(len(p) for fp in frames for p in fp)
        m.scan_seconds += t1 - t0
        m.device_seconds += t2 - t1
        m.wall_seconds += t2 - t0
        return out


class VmemVideoDecoder(VmemBatchDecoder):
    """Single-stream convenience wrapper (JaxVideoDecoder-compatible)."""

    def decode_stream_chunk(self, packets: list[bytes]
                            ) -> tuple[np.ndarray, list[int], int | None]:
        """Decode consecutive frames of ONE stream as a single fused
        dispatch (one upload + one fetch instead of one per frame — the
        transcoder's throughput path).  Scans run per packet so each
        frame's bitstream end offset is captured (MODS audio packets start
        where the video reader stopped, Program.cs:250-252).

        Returns (yuv (K, HH, S) uint8, K end offsets, err_index): the K
        successfully scanned prefix frames are decoded and committed to
        the ring; ``err_index`` is the index of the packet whose scan
        failed (its frame is NOT decoded — per-frame containment is the
        caller's job, matching the reference player's swallow policy), or
        None when the whole chunk scanned.

        Hot path: ONE native scanner_scan_gop call covers the whole chunk
        (per-frame consumed offsets come back from C++); malformed frames
        keep the prefix and report err at the C++ frame boundary.
        """
        import time
        t0 = time.perf_counter()
        yuvs: list[np.ndarray] = []
        offsets: list[int] = []
        err = None
        t_scan = 0.0
        rem = list(packets)
        ndone = 0
        nv = self.natives[0] if self.natives is not None else None
        while rem and nv is not None:
            ts = time.perf_counter()
            nv.checkpoint()
            r = nv.scan_gop_packed(rem)
            t_scan += time.perf_counter() - ts
            if r["val_overflow"]:
                # >int16 coefficient somewhere: rewind and take the dense
                # per-packet path for the remainder
                nv.rollback()
                break
            done = r["done"]
            offsets.extend(int(c) for c in r["consumed"])
            if done:
                _t1, yuv = self._dispatch_parts([_gop_part(r)])
                yuvs.append(np.asarray(self._maybe_crop(yuv))[:, 0])
                ndone += done
                rem = rem[done:]
            if r["err"]:
                err = ndone
                rem = []
                break
            if done == 0:
                # a frame bigger than the native scan caps: the per-packet
                # plan path below has no such limits — decode the rest there
                break
        if rem and err is None:
            # native scanner unavailable (or val_overflow): per-packet
            # scan + plan dispatch, dense coefficient rows
            plans_fb: list[list[dict]] = []
            ts = time.perf_counter()
            for i, pkt in enumerate(rem):
                try:
                    plans_fb.append([self._scan_one(0, pkt)])
                    offsets.append(self.offset)
                except Exception:
                    err = ndone + i
                    break
            t_scan += time.perf_counter() - ts
            if plans_fb:
                _t1, yuv = self._dispatch_plans(plans_fb)
                yuvs.append(np.asarray(self._maybe_crop(yuv))[:, 0])
                ndone += len(plans_fb)
        out_w = (self.width if self.crop else self.stride)
        out = (np.concatenate(yuvs, axis=0) if yuvs else
               np.zeros((0, self.height + self.height // 2, out_w),
                        np.uint8))
        t2 = time.perf_counter()
        m = self.metrics
        m.frames += ndone
        m.bytes_in += sum(len(p) for p in packets[:ndone])
        m.scan_seconds += t_scan
        m.device_seconds += (t2 - t0) - t_scan
        m.wall_seconds += t2 - t0
        return out, offsets, err

    def __init__(self, width: int, height: int, version,
                 interpret: bool | None = None, native: bool | None = None,
                 crop: bool = False):
        super().__init__(width, height, version, batch=1,
                         interpret=interpret, native=native, crop=crop)

    def decode_frame(self, packet: bytes) -> tuple[np.ndarray, np.ndarray]:
        out = self.decode_frames([packet])[0]
        H = self.height
        return out[:H], out[H:]
