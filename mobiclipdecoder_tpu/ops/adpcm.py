"""IMA ADPCM as two associative scans (the device formulation).

The sample-sequential IMA recurrence (models/audio_ima.py) looks inherently
serial, but both state variables evolve by clamped adds, and clamped-add maps
``x -> clamp(x + a, lo, hi)`` are closed under composition:

    g(f(x)) = clamp(x + af + ag, clamp(lo_f + ag, lo_g, hi_g),
                                 clamp(hi_f + ag, lo_g, hi_g))

so `jax.lax.associative_scan` computes all intermediate states in
O(log n) depth:

  pass 1 — the step-index chain (delta from the nibble's index table entry,
           clamped to [0, 88]); an exclusive scan yields each nibble's
           *pre-update* index, from which its diff follows directly;
  pass 2 — the sample chain (clamped add of the signed diff to [-32768,
           32767]); an inclusive scan yields the output samples.

This is BASELINE.json's audio target: bit-exact vs the sequential oracle
(tests/test_audio.py) with log-depth parallelism over the whole packet.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.audio_ima import INDEX_TABLE, STEP_TABLE

_IDX = jnp.asarray(INDEX_TABLE)
_STEP = jnp.asarray(STEP_TABLE)
_BIG = jnp.int32(1 << 29)


def _compose(f, g):
    """Compose clamped-add maps elementwise: g after f."""
    af, lof, hif = f
    ag, log_, hig = g
    a = af + ag
    lo = jnp.clip(lof + ag, log_, hig)
    hi = jnp.clip(hif + ag, log_, hig)
    return a, lo, hi


@functools.partial(jax.jit, static_argnames=())
def decode_nibbles(nibbles, index0, last0):
    """Decode a (..., N) int32 nibble array given initial (index, last).

    Returns int32 samples of the same shape.  Vectorizes over any leading
    batch axes (channels, packets, streams).
    """
    # pass 1: pre-update step index per nibble
    a = _IDX[nibbles & 7]
    lo = jnp.full_like(a, 0)
    hi = jnp.full_like(a, 88)
    pa, plo, phi = jax.lax.associative_scan(_compose, (a, lo, hi), axis=-1)
    # exclusive: index BEFORE nibble k = prefix of k-1 applied to index0
    idx_incl = jnp.clip(index0[..., None] + pa, plo, phi)
    idx_pre = jnp.concatenate(
        [jnp.broadcast_to(index0[..., None], idx_incl[..., :1].shape),
         idx_incl[..., :-1]], axis=-1)
    # diff from pre-update index (IMAADPCMDecoder.cs:37-42)
    step = _STEP[idx_pre]
    diff = (step >> 3) + (step >> 2) * (nibbles & 1) \
        + (step >> 1) * ((nibbles >> 1) & 1) + step * ((nibbles >> 2) & 1)
    d = jnp.where(nibbles & 8, -diff, diff)
    # pass 2: clamped-add sample chain
    lo2 = jnp.full_like(d, -32768)
    hi2 = jnp.full_like(d, 32767)
    sa, slo, shi = jax.lax.associative_scan(_compose, (d, lo2, hi2), axis=-1)
    return jnp.clip(last0[..., None] + sa, slo, shi)


def decode_packets(packets: np.ndarray, index0: np.ndarray,
                   last0: np.ndarray) -> np.ndarray:
    """Decode (..., L) uint8 packet bytes -> (..., 2L) int16 samples."""
    b = jnp.asarray(packets, jnp.int32)
    nibbles = jnp.stack([b & 0xF, b >> 4], axis=-1).reshape(
        *b.shape[:-1], b.shape[-1] * 2)
    out = decode_nibbles(nibbles, jnp.asarray(index0, jnp.int32),
                         jnp.asarray(last0, jnp.int32))
    return np.asarray(out).astype(np.int16)
