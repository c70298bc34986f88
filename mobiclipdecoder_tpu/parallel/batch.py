"""Multi-stream batched decoding through the XLA wavefront engine.

One DS/3DS frame is tiny (a 256x192 ring is ~432 KiB); a device is filled
by decoding *many independent streams/GOPs at once* (BASELINE.md workload
constants).  This module stacks per-stream FramePlans into (B, ...) arrays
(padded to shared static shapes) and reconstructs the whole batch in one
jitted call; a whole GOP can be decoded in one device program via
`lax.scan` over frames.  It is the cross-check engine for the whole-GOP
executor (ops/vmem_engine.py), which is the hot path.

With a `jax.sharding.Mesh` the batch axis maps onto the mesh's "data" axis
(corpus/GOP data-parallelism).  There is deliberately no spatial axis:
GSPMD answers width-sharding of the ring with a full-plane all-gather,
because decode-order plane updates scatter across the whole plane, so
streams/GOPs are the scaling axis.  Multi-host GOP assignment lives in
parallel/gop.py.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.oracle_video import MobiclipVersion
from ..models.pipeline import (decode_frame_core, prepare_plan,
                               PlanningDecoder)

_decode_batch = jax.jit(
    jax.vmap(decode_frame_core,
             in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None, None)),
    static_argnames=("H", "S"))


def _decode_gop_core(ring0, mc, resid, resid_coef, iops, icoef, seqmap,
                     n_levels, H: int, S: int):
    """(F, B, ...) stacked plans -> scan over frames with the reference ring
    as carry; one device program per GOP batch."""

    def step(ring, frame):
        fmc, fresid, frc, fio, fic, fsq, fnl = frame
        ring = jnp.roll(ring, 1, axis=1)
        buf = jax.vmap(decode_frame_core,
                       in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None, None))(
            ring, fmc, fresid, frc, fio, fic, fsq, fnl, H, S)
        ring = ring.at[:, 0].set(buf)
        return ring, buf

    return jax.lax.scan(step, ring0, (mc, resid, resid_coef, iops, icoef,
                                      seqmap, n_levels))


decode_gop_jit = jax.jit(_decode_gop_core, static_argnames=("H", "S"))


def _pad_to(a: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    if a.ndim == 0 or a.shape == tuple(shape):
        return a
    pads = [(0, t - s) for s, t in zip(a.shape, shape)]
    return np.pad(a, pads)


def stack_plans(prepared: list[dict]) -> dict:
    """Pad a list of prepare_plan() outputs to common shapes and stack."""
    out = {}
    for key in ("mc", "resid", "resid_coef", "iops", "icoef", "seqmap",
                "n_levels"):
        arrs = [np.asarray(p[key]) for p in prepared]
        tgt = tuple(max(a.shape[d] for a in arrs)
                    for d in range(arrs[0].ndim))
        out[key] = np.stack([_pad_to(a, tgt) for a in arrs])
    return out


class BatchVideoDecoder:
    """Decodes B independent streams in lockstep, one jitted call per frame
    round (or one per GOP with decode_gop)."""

    def __init__(self, width: int, height: int, version: MobiclipVersion,
                 batch: int, mesh: Mesh | None = None,
                 native: bool | None = None):
        self.B = batch
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
        self.width, self.height = width, height
        self.stride = self.planners[0].stride
        self.mesh = mesh
        HH = height + height // 2
        self.ring = jnp.zeros((batch, 6, HH, self.stride), jnp.int32)
        if mesh is not None:
            self.data_sharding = NamedSharding(mesh, P("data"))
            # batch axis only (see the module docstring)
            self.ring_sharding = NamedSharding(mesh, P("data"))
            self.ring = jax.device_put(self.ring, self.ring_sharding)

    def scan_packets(self, packets: list[bytes]) -> dict:
        assert len(packets) == self.B
        prepared = []
        if self.natives is not None:
            for nat, pkt in zip(self.natives, packets):
                prepared.append(prepare_plan(nat.scan(pkt)))
        else:
            for planner, pkt in zip(self.planners, packets):
                planner.data = pkt
                planner.offset = 0
                planner.decode_frame()
                prepared.append(prepare_plan(planner.plan()))
        return stack_plans(prepared)

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """One frame per stream; returns (B, HH, S) uint8 planes."""
        arrays = self.scan_packets(packets)
        if self.mesh is not None:
            arrays = {k: jax.device_put(v, self.data_sharding)
                      for k, v in arrays.items()}
        ring = jnp.roll(self.ring, 1, axis=1)
        buf = _decode_batch(ring, arrays["mc"], arrays["resid"],
                            arrays["resid_coef"], arrays["iops"],
                            arrays["icoef"], arrays["seqmap"],
                            arrays["n_levels"], self.height, self.stride)
        self.ring = ring.at[:, 0].set(buf)
        return np.asarray(buf).astype(np.uint8)

    def decode_gop(self, frames: list[list[bytes]]) -> np.ndarray:
        """frames[f][b] = packet of frame f of stream b.  One device program
        for the whole GOP; returns (F, B, HH, S) uint8."""
        per_frame = [self.scan_packets(fp) for fp in frames]
        stacked = {}
        for k in per_frame[0]:
            arrs = [np.asarray(pf[k]) for pf in per_frame]
            tgt = tuple(max(a.shape[d] for a in arrs)
                        for d in range(arrs[0].ndim))
            stacked[k] = np.stack([_pad_to(a, tgt) for a in arrs])
        if self.mesh is not None:
            spec = NamedSharding(self.mesh, P(None, "data"))
            stacked = {k: jax.device_put(v, spec) for k, v in stacked.items()}
        ring, bufs = decode_gop_jit(
            self.ring, stacked["mc"], stacked["resid"],
            stacked["resid_coef"], stacked["iops"], stacked["icoef"],
            stacked["seqmap"], stacked["n_levels"], self.height, self.stride)
        self.ring = ring
        return np.asarray(bufs).astype(np.uint8)
