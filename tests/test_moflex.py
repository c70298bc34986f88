"""Moflex container: mux/demux round-trip + A/V end-to-end decode."""
import numpy as np

from mobiclipdecoder_tpu.containers.moflex import (MoflexDemuxer,
                                                   VideoStream, read_varint7,
                                                   read_synchro_header,
                                                   write_varint7,
                                                   _synchro_checksum)
from mobiclipdecoder_tpu.runtime.transcode import decode_moflex
from mobiclipdecoder_tpu.testing.containers import moflex_file


def test_varint7_roundtrip():
    for v in [0, 1, 0x7F, 0x80, 0x1FFF, 0x2000, 0x1FFFFF, 0x200000,
              0xFFFFFFF]:
        b = write_varint7(v)
        got, pos = read_varint7(b, 0, len(b))
        assert got == v and pos == len(b)


def test_synchro_header_roundtrip():
    for ts in [1, 12345, (1 << 62), (1 << 63) | 5]:
        hdr = bytearray(14)
        hdr[0], hdr[1] = 0x4C, 0x32
        import struct
        struct.pack_into(">Q", hdr, 4, ts)
        struct.pack_into(">H", hdr, 12, 0xFFF)
        struct.pack_into(">H", hdr, 2, _synchro_checksum(ts))
        got = read_synchro_header(bytes(hdr), 0)
        assert got is not None
        assert got[0] == ts and got[1] == 0x1000


_build_moflex = moflex_file


def test_moflex_demux_video_frames():
    blob = _build_moflex(with_audio=False)
    frames = []
    dm = MoflexDemuxer(blob, on_frame=lambda ch, d: frames.append((ch, d)))
    dm.demux_all()
    vid = [d for ch, d in frames if isinstance(ch, VideoStream)]
    assert len(vid) == 4
    assert all(d[-2:] == b"\x00\x00" for d in vid)


def test_moflex_e2e_oracle_vs_tpu():
    blob = _build_moflex()
    a = list(decode_moflex(blob, engine="oracle"))
    b = list(decode_moflex(blob, engine="device"))
    assert len(a) == 4 and len(b) == 4
    total_pcm = 0
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa.y, fb.y)
        np.testing.assert_array_equal(fa.u, fb.u)
        np.testing.assert_array_equal(fa.v, fb.v)
        if fa.pcm is not None:
            np.testing.assert_array_equal(fa.pcm, fb.pcm)
            total_pcm += len(fa.pcm)
    assert total_pcm > 0


def test_moflex_resync_after_garbage():
    """Desynchronize/rescan recovery (MoLiveDemux.cs:57-96): garbage before
    the stream is skipped via pattern scan."""
    blob = _build_moflex(with_audio=False)
    corrupted = b"\xDE\xAD\xBE\xEF" * 8 + blob
    frames = []
    dm = MoflexDemuxer(corrupted,
                       on_frame=lambda ch, d: frames.append((ch, d)))
    dm.demux_all()
    vid = [d for ch, d in frames if isinstance(ch, VideoStream)]
    assert len(vid) == 4


def test_moflex_e2e_tpu_chunk_boundaries():
    """Chunk boundaries in the buffered moflex device path must be
    seamless, including PCM attachment order."""
    from mobiclipdecoder_tpu.runtime import transcode as tc
    old = tc.CHUNK_FRAMES
    tc.CHUNK_FRAMES = 2
    try:
        blob = _build_moflex()
        a = list(decode_moflex(blob, engine="oracle"))
        b = list(decode_moflex(blob, engine="device"))
        assert len(a) == len(b) == 4
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa.y, fb.y)
            if fa.pcm is None:
                assert fb.pcm is None
            else:
                np.testing.assert_array_equal(fa.pcm, fb.pcm)
    finally:
        tc.CHUNK_FRAMES = old
