"""Device-side full-search SAD volume for the encoder's motion search.

The reference analyzer runs a log/diamond descent per block per reference
frame on the CPU (Analyzer.cs:608-679).  The device formulation inverts
the loop: ONE jitted program computes the SAD of EVERY 8x8 tile of the
frame against EVERY full-pel offset in a +-`range_` window of EVERY
reference frame — a (cands, refs, H/8, W/8) volume.  Any 8-aligned leaf of
the partition lattice (16x16 .. 8x8 with the default min_part=8) then gets
its full-search SAD surface as a sum of tile entries, so the host's
rate-distortion pass reduces to an argmin plus a 3x3 half-pel refinement
around the winner — a few dozen host SADs per macroblock instead of
hundreds, and full search strictly dominates the reference's descent
(which can stall in local minima).

The volume is exact integer SAD; out-of-frame candidates are garbage
(zero-padded reference) and must be masked by the caller's legality
window (encoder._mv_range does).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("range_",))
def _sad8_volume(cur, refs, range_: int = 16):
    """cur: (H, W) int32; refs: (R, H, W) int32.  Returns
    ((2*range_+1)**2, R, H//8, W//8) int32: entry [k, r, by, bx] is the SAD
    of cur's 8x8 tile (by, bx) against ref r shifted by full-pel
    (dy, dx) = (k // (2*range_+1) - range_, k % (2*range_+1) - range_)."""
    H, W = cur.shape
    R = refs.shape[0]
    side = 2 * range_ + 1
    pad = jnp.pad(refs, ((0, 0), (range_, range_), (range_, range_)))

    def one(_, k):
        dy = k // side
        dx = k % side
        win = jax.lax.dynamic_slice(pad, (0, dy, dx), (R, H, W))
        d = jnp.abs(cur[None] - win)
        s8 = d.reshape(R, H // 8, 8, W // 8, 8).sum(axis=(2, 4))
        return 0, s8

    _, vol = jax.lax.scan(one, 0, jnp.arange(side * side))
    return vol


class SadVolume:
    """Per-frame full-search helper: device volume + host reductions."""

    def __init__(self, cur: np.ndarray, refs: list[np.ndarray],
                 range_: int = 16):
        """cur: (H, W) uint8 target; refs: list of (H, W) uint8 planes
        (reference 1..R in MC order)."""
        self.range_ = range_
        self.side = 2 * range_ + 1
        self.R = len(refs)
        if self.R == 0:
            self.vol = None
            return
        c = jnp.asarray(cur, jnp.int32)
        r = jnp.asarray(np.stack(refs), jnp.int32)
        self.vol = np.asarray(_sad8_volume(c, r, range_))
        k = np.arange(self.side * self.side)
        self.cand_dy = k // self.side - range_
        self.cand_dx = k % self.side - range_

    def leaf_best(self, bx: int, by: int, w: int, h: int,
                  lo_x: int, hi_x: int, lo_y: int, hi_y: int,
                  nrefs: int):
        """Best full-pel (SAD, ref, mv_halfpel) per reference for the
        8-aligned leaf at (bx, by) size (w, h), restricted to the half-pel
        legality box [lo_x, hi_x] x [lo_y, hi_y].  Returns a list of
        (sad, ref, (mvx, mvy)) sorted best-first, one entry per ref."""
        sums = self.vol[:, :nrefs,
                        by // 8:(by + h) // 8,
                        bx // 8:(bx + w) // 8].sum(axis=(2, 3))
        mvx = 2 * self.cand_dx
        mvy = 2 * self.cand_dy
        ok = ((mvx >= lo_x) & (mvx <= hi_x)
              & (mvy >= lo_y) & (mvy <= hi_y))
        masked = np.where(ok[:, None], sums, 1 << 30)
        best_k = np.argmin(masked, axis=0)            # (nrefs,)
        out = []
        for r in range(nrefs):
            k = int(best_k[r])
            out.append((int(masked[k, r]), r + 1,
                        (int(mvx[k]), int(mvy[k]))))
        out.sort()
        return out
