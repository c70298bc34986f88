"""Encoder round-trip: encoder output decodes bit-exactly to the encoder's
own reconstruction (the decoder-twin construction makes this structural),
and the decoded video approximates the source (quality sanity)."""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.encoder import MobiclipEncoder
from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)


def _test_video(W, H, n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(n):
        y = (128 + 60 * np.sin(xx / 17 + t / 3) * np.cos(yy / 13)
             + rng.normal(0, 3, (H, W))).clip(0, 255).astype(np.uint8)
        # slowly moving gradient for chroma
        u = (128 + 40 * np.sin((xx[:H // 2 * 2:2, :W // 2 * 2:2] / 23) + t / 5)) \
            .clip(0, 255).astype(np.uint8)
        v = (128 + 40 * np.cos((yy[:H // 2 * 2:2, :W // 2 * 2:2] / 19) - t / 4)) \
            .clip(0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


@pytest.mark.parametrize("version", [MobiclipVersion.MOFLEX_3DS,
                                     MobiclipVersion.MODS_DS])
def test_roundtrip_bit_exact_recon(version):
    W, H, N = 64, 48, 4
    frames = _test_video(W, H, N)
    enc = MobiclipEncoder(W, H, version, quantizer=0x14, gop=3)
    dec = OracleDecoder(W, H, version)
    for i, (y, u, v) in enumerate(frames):
        pkt = enc.encode_frame(y, u, v)
        dec.data = pkt + b"\x00\x00"
        dec.offset = 0
        dec.decode_frame()
        np.testing.assert_array_equal(dec.y_planes[0], enc.twin.y_planes[0],
                                      err_msg=f"frame {i} luma")
        np.testing.assert_array_equal(dec.uv_planes[0], enc.twin.uv_planes[0],
                                      err_msg=f"frame {i} chroma")


def test_quality_reasonable():
    W, H = 64, 48
    frames = _test_video(W, H, 3, seed=1)
    enc = MobiclipEncoder(W, H, MobiclipVersion.MOFLEX_3DS,
                          quantizer=0x10, gop=3)
    dec = OracleDecoder(W, H, MobiclipVersion.MOFLEX_3DS)
    for y, u, v in frames:
        pkt = enc.encode_frame(y, u, v)
        dec.data = pkt + b"\x00\x00"
        dec.offset = 0
        dec.decode_frame()
    got = dec.y_planes[0].reshape(-1, dec.stride)[:H, :W].astype(np.float64)
    src = frames[-1][0].astype(np.float64)
    mse = ((got - src) ** 2).mean()
    psnr = 10 * np.log10(255 * 255 / max(mse, 1e-9))
    assert psnr > 25, f"luma PSNR too low: {psnr:.1f} dB"


def test_tpu_pipeline_decodes_encoder_output():
    pytest.importorskip("jax")
    from mobiclipdecoder_tpu.models.pipeline import JaxVideoDecoder
    W, H = 64, 48
    frames = _test_video(W, H, 3, seed=2)
    enc = MobiclipEncoder(W, H, MobiclipVersion.MOFLEX_3DS,
                          quantizer=0x14, gop=3)
    dec = JaxVideoDecoder(W, H, MobiclipVersion.MOFLEX_3DS)
    for y, u, v in frames:
        pkt = enc.encode_frame(y, u, v)
        yt, uvt = dec.decode_frame(pkt + b"\x00\x00")
        np.testing.assert_array_equal(yt.ravel(), enc.twin.y_planes[0])
        np.testing.assert_array_equal(uvt.ravel(), enc.twin.uv_planes[0])
