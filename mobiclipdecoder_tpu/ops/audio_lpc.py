"""Device-side batched LPC audio synthesis (FastAudio lattice).

The FastAudio codec (models/audio_fastaudio.py, mirror of
LibMobiclip/Codec/FastAudio/FastAudioDecoder.cs:41-72) splits naturally at
the same seam as video: packet unpacking (bitstream work, host) vs the
8-tap lattice synthesis filter (sample-sequential arithmetic, device).
One channel's filter is a scalar recurrence — worthless on a device alone —
but a transcode job carries CHANNELS x STREAMS independent recurrences, so
the device formulation is a `lax.scan` over the 256 samples of a packet
with every channel in the batch advancing one sample per step (the same
batching argument as the video engine's lockstep streams; the IMA ADPCM
kernel in ops/adpcm.py uses an associative scan instead because its
recurrence composes).

Bit-exactness: the reference computes `(coef * hist + 0x4000) >> 15` in
unbounded intermediate precision (the oracle uses Python ints).  The device
program stays in int32 (JAX disables int64 by default), so the product is
split exactly in int32:

    b = bh * 2^15 + bl   (bl = b & 0x7FFF in [0, 2^15), bh = b >> 15)
    (a*b + 0x4000) >> 15 == a*bh + ((a*bl + 0x4000) >> 15)

which holds for ALL int32 b when |a| < 2^15 (true for every FastAudio
quantization table entry: max |coef| = 32665) because a*bl < 2^30 and
|a*bh| < 2^31 never overflow.  The identity is floor-shift exact, matching
the arithmetic >> of both C# and numpy.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_DEEMPH = 0x6E14  # fixed de-emphasis coefficient (FastAudioDecoder.cs:66)


def _mulshift15(a, b):
    """Exact (a * b + 0x4000) >> 15 for int32 b, |a| < 2**15."""
    bl = b & 0x7FFF
    bh = b >> 15
    return a * bh + ((a * bl + 0x4000) >> 15)


def fastaudio_synth(excit, coef, hist0, r9_0):
    """Batched FastAudio synthesis filter (FastAudioDecoder.cs:54-71).

    excit: (B, N) int32 pulse excitation; coef: (B, 8) int32 LPC
    coefficients; hist0: (B, 8) filter history (hist[j] = Internal[107-j]);
    r9_0: (B,) de-emphasis state.  Returns (pcm (B, N) int16, hist, r9).
    """
    def step(carry, e):
        hist, r9 = carry
        r5 = e
        cols = []
        for j in range(8):
            r5 = r5 - _mulshift15(coef[:, j], hist[:, j])
            cols.append(hist[:, j] + _mulshift15(coef[:, j], r5))
        hist2 = jnp.stack(cols[1:] + [r5], axis=1)
        r9n = r5 + _mulshift15(jnp.int32(_DEEMPH), r9)
        r8 = jnp.clip(r9n, -(1 << 28), 1 << 28) * 2
        out = jnp.clip(r8, -32768, 32767).astype(jnp.int16)
        return (hist2, r9n), out

    (hist, r9), pcm = jax.lax.scan(step, (hist0, r9_0),
                                   jnp.swapaxes(excit, 0, 1))
    return jnp.swapaxes(pcm, 0, 1), hist, r9


_synth_jit = jax.jit(fastaudio_synth)


class FastAudioBatchDecoder:
    """Many-channel FastAudio decoding with the synthesis filter on device.

    Host side unpacks each channel's packet (FastAudioDecoder.excitation);
    the lattice runs as one jitted scan over all channels.  Bit-exact vs
    the per-channel oracle decoders (tests/test_audio_device.py).
    """

    def __init__(self, channels: int):
        from ..models.audio_fastaudio import FastAudioDecoder
        self.channels = channels
        self.decs = [FastAudioDecoder() for _ in range(channels)]
        self.hist = jnp.zeros((channels, 8), jnp.int32)
        self.r9 = jnp.zeros((channels,), jnp.int32)

    def decode(self, packets: list[bytes | None]) -> np.ndarray:
        """packets[ch] = one 40-byte packet per channel (None = silence for
        that channel this round).  Returns (channels, 256) int16."""
        ex = np.zeros((self.channels, 256), np.int32)
        cf = np.zeros((self.channels, 8), np.int32)
        for ch, pkt in enumerate(packets):
            if pkt is None:
                continue
            d = self.decs[ch]
            d.data = pkt
            d.offset = 0
            out, coef = d.excitation()
            ex[ch] = out.astype(np.int32)
            cf[ch] = coef
        pcm, self.hist, self.r9 = _synth_jit(jnp.asarray(ex),
                                             jnp.asarray(cf),
                                             self.hist, self.r9)
        return np.asarray(pcm)
