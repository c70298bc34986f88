"""Synthetic container files with audio, for end-to-end checks.

``mods_file`` writes a DS .mods stream with per-frame IMA ADPCM packets;
``moflex_file`` writes a 3DS .moflex stream with an IMA audio track.  Both
carry random legal video from :class:`StreamSynthesizer`, seeded.
"""
from __future__ import annotations

import numpy as np

from ..containers.mods import ModsMuxer
from ..containers.moflex import AudioStream, MoflexMuxer, VideoStream
from ..models.audio_ima import encode_ima
from ..models.oracle_video import MobiclipVersion
from .synth import StreamSynthesizer


def mods_file(nframes: int = 6, W: int = 64, H: int = 48, channels: int = 2,
              seed: int = 11, key_at: tuple[int, ...] = (0, 3)) -> bytes:
    """A MODS file whose keyframes sit at ``key_at``."""
    synth = StreamSynthesizer(W, H, MobiclipVersion.MODS_DS, seed=seed)
    mux = ModsMuxer(W, H, fps=24.0, audio_codec=3, nb_channel=channels,
                    frequency=16384)
    # Per-channel IMA streams restart at every keyframe (the decoder resets
    # its audio state there, Program.cs:255-265); first packet of each
    # segment carries the 4-byte state header (Program.cs:268-270).
    segments = sorted(key_at) + [nframes]
    per_frame_pkts: list[list[bytes]] = [[] for _ in range(nframes)]
    for s in range(len(segments) - 1):
        f0, f1 = segments[s], segments[s + 1]
        nfr = f1 - f0
        for c in range(channels):
            t = np.arange(nfr * 256) + f0 * 256
            wave = (4000 * np.sin(t / (5 + c))).astype(np.int16)
            blob = encode_ima(wave, index0=8)
            hdr, body = blob[:4], blob[4:]
            for i in range(nfr):
                chunk = body[i * 128:(i + 1) * 128]
                chunk = chunk + bytes(128 - len(chunk))
                per_frame_pkts[f0 + i].append(
                    (hdr + chunk) if i == 0 else chunk)
    for i in range(nframes):
        video = synth.iframe(0x18, pad=False) if i in key_at \
            else synth.pframe(pad=False)
        if i in key_at:
            synth.frame_idx = 1  # ring restart semantics for P-frames after
        mux.add_frame(video, per_frame_pkts[i], keyframe=(i in key_at))
    return mux.to_bytes()


def moflex_file(nframes: int = 4, W: int = 64, H: int = 48,
                with_audio: bool = True, seed: int = 21) -> bytes:
    """A Moflex file: one video stream, optionally stereo IMA audio."""
    synth = StreamSynthesizer(W, H, MobiclipVersion.MOFLEX_3DS, seed=seed)
    chunks = [VideoStream(stream_index=0, codec_id=0, fps_rate=24,
                          fps_scale=1, width=W, height=H)]
    channels = 2
    if with_audio:
        chunks.append(AudioStream(stream_index=1, codec_id=1,
                                  frequency=16384, channels=channels))
    mux = MoflexMuxer(chunks)
    for i in range(nframes):
        video = synth.iframe(0x12, pad=False) if i == 0 \
            else synth.pframe(pad=False)
        mux.add_frame(0, video)
        if with_audio:
            # Moflex IMA audio frame: 4-byte header per channel, then
            # 128-byte packets round-robin (Form1.cs:601-630)
            frame = bytearray()
            bodies = []
            for c in range(channels):
                t = np.arange(512) + i * 512
                wave = (3000 * np.sin(t / (6 + c))).astype(np.int16)
                blob = encode_ima(wave, index0=4)
                frame += blob[:4]
                bodies.append(blob[4:4 + 256])
            for k in range(0, 256, 128):
                for c in range(channels):
                    frame += bodies[c][k:k + 128]
            mux.add_frame(1, bytes(frame))
    return mux.to_bytes()
