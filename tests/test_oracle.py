"""Oracle decoder tests: structural correctness on synthesized bitstreams.

The reference has no test suite or fixtures (SURVEY.md §4); bitstreams are
synthesized (mobiclipdecoder_tpu.testing.synth) and the oracle defines the
golden YUV output for the device engines to match.
"""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer
from mobiclipdecoder_tpu.utils.bitio import BitWriter


def _flat_gray_iframe(width: int, height: int) -> bytes:
    """Minimal I-frame: all MBs full-block DC mode, no residual.

    Every macroblock: sub-bit 0, CBP varint 0 (cbp_intra[0] == 0), luma mode
    3 (DC), chroma mode 3.  With no neighbors the DC predictor emits 0x80
    (MobiclipDecoder.cs:1927-1940), and with all-0x80 neighbors it stays 0x80.
    """
    bw = BitWriter()
    bw.write_bits(1, 1)   # I-frame
    bw.write_bits(1, 1)   # yuv format
    bw.write_bits(0, 1)   # coefficient table 0
    bw.write_bits(0x18, 6)
    for _ in range((height // 16) * (width // 16)):
        bw.write_bits(0, 1)   # full-block mode
        bw.write_bits(1, 1)   # varint(0) -> CBP 0
        bw.write_bits(3, 3)   # luma DC
        bw.write_bits(3, 3)   # chroma DC
    return bw.to_bytes() + b"\x00\x00"


def test_flat_gray_iframe():
    dec = OracleDecoder(64, 48, MobiclipVersion.MODS_DS)
    dec.data = _flat_gray_iframe(64, 48)
    y, uv = dec.decode_frame()
    ycrop, u, v = dec.cropped_yuv()
    assert (ycrop == 0x80).all()
    assert (u == 0x80).all()
    assert (v == 0x80).all()
    assert dec.quantizer == 0x18


def test_bitio_varint_roundtrip():
    # The refill cadence guarantees only 16 valid register bits at a read, so
    # varints are format-limited to 15 bits (values <= 254 / |v| <= 127) —
    # the reference decoder has the identical constraint.
    values_u = [0, 1, 2, 3, 5, 10, 63, 64, 127, 254]
    values_s = [0, 1, -1, 2, -2, 17, -31, 101, -127]
    bw = BitWriter()
    for v in values_u:
        bw.write_varint_u(v)
    for v in values_s:
        bw.write_varint_s(v)
    data = bw.to_bytes() + b"\x00\x00\x00\x00"
    dec = OracleDecoder(16, 16, MobiclipVersion.MODS_DS)
    dec.data = data
    dec.offset = 2
    dec._r3 = (data[0] | (data[1] << 8)) << 16
    dec._nb = 0
    for v in values_u:
        assert dec._varint_u() == v
    for v in values_s:
        assert dec._varint_s() == v


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synth_iframe_decodes(version, seed):
    W, H = 64, 48
    synth = StreamSynthesizer(W, H, version, seed=seed)
    pkt = synth.iframe(quantizer=0x18)
    dec = OracleDecoder(W, H, version)
    dec.data = pkt
    dec.decode_frame()
    y, u, v = dec.cropped_yuv()
    # decode again: must be deterministic
    dec2 = OracleDecoder(W, H, version)
    dec2.data = pkt
    dec2.decode_frame()
    y2, u2, v2 = dec2.cropped_yuv()
    assert (y == y2).all() and (u == u2).all() and (v == v2).all()
    # the video offset must land exactly at the end of the payload
    assert dec.offset <= len(pkt)


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_synth_gop_decodes(version):
    W, H = 64, 48
    synth = StreamSynthesizer(W, H, version, seed=7)
    dec = OracleDecoder(W, H, version)
    frames = []
    for i in range(5):
        pkt = synth.iframe(0x1A) if i == 0 else synth.pframe()
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        frames.append(tuple(a.copy() for a in dec.cropped_yuv()))
    # all six ring slots populated after 5 frames? (slot 5 after 6)
    assert dec.y_planes[4] is not None
    # re-decoding the same GOP reproduces every frame exactly
    dec2 = OracleDecoder(W, H, version)
    synth2 = StreamSynthesizer(W, H, version, seed=7)
    for i in range(5):
        pkt = synth2.iframe(0x1A) if i == 0 else synth2.pframe()
        dec2.data = pkt
        dec2.offset = 0
        dec2.decode_frame()
        for a, b in zip(frames[i], dec2.cropped_yuv()):
            assert (a == b).all()


def test_rgb_output_shapes():
    W, H = 64, 48
    synth = StreamSynthesizer(W, H, MobiclipVersion.MOFLEX_3DS, seed=3)
    dec = OracleDecoder(W, H, MobiclipVersion.MOFLEX_3DS)
    dec.data = synth.iframe(0x18)
    rgb = dec.decode_frame(rgb=True)
    assert rgb.shape == (H, W, 3)
    assert rgb.dtype == np.uint8
