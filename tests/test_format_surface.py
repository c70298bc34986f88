"""Format-surface exactness gates: every decoder branch the synthesizer can
reach must execute on the PRODUCTION path (C++ scanner + executor engine), not
just the oracle.

Round-3 review finding: the synthesizer emitted coefficients exclusively as
escape-3 explicit codes, never exercised the 12-bit table-hit VLC path or
escapes 1/2 (MobiclipDecoder.cs:3330-3432) on either table, never emitted
odd (half-pel) luma MVs (CopyBlock :418-456), 4x4 intra mode 18 (:2734),
P-frame dQP (:119-143), the I-frame VLC table-select bit (:226-227), or the
Moflex QP clamp edges (:3886-3890).  These tests pin all of that, asserting
both *that* the branches are exercised (synthesizer stats) and that the
native scanner + executor kernel agree with the oracle bit-exactly on them.
"""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

pytest.importorskip("jax")
from mobiclipdecoder_tpu.ops.vmem_engine import VmemVideoDecoder  # noqa: E402


def _assert_engine_matches_oracle(pkts, W, H, version, native):
    """Every packet through oracle and executor engine (native C++ scan when
    native=True); planes must agree bit-exactly."""
    oracle = OracleDecoder(W, H, version)
    eng = VmemVideoDecoder(W, H, version, interpret=True, native=native)
    S = oracle.stride
    for i, pkt in enumerate(pkts):
        oracle.data = pkt
        oracle.offset = 0
        oracle.decode_frame()
        y_t, uv_t = eng.decode_frame(pkt)
        np.testing.assert_array_equal(
            oracle.y_planes[0].reshape(-1, S), y_t, err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(
            oracle.uv_planes[0].reshape(-1, S), uv_t, err_msg=f"frame {i} UV")


def _gop(synth, n, table=0, dqs=None):
    pkts = [synth.iframe(0x18, table=table)]
    for f in range(1, n):
        pkts.append(synth.pframe(dq=(dqs[f % len(dqs)] if dqs else 0)))
    return pkts


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_synth_covers_format_surface(version):
    """The synthesizer must exercise every coefficient-VLC branch, half-pel
    MVs and the above-right intra modes; guards against the coverage
    regressing silently."""
    s = StreamSynthesizer(96, 64, version, seed=0)
    for i in range(8):
        s.iframe(0x18, table=(i // 4) & 1) if i % 4 == 0 else s.pframe()
    for key in ("coef_plain_t0", "coef_esc1_t0", "coef_esc2_t0",
                "coef_esc3_t0", "coef_plain_t1", "coef_esc1_t1",
                "coef_esc2_t1", "coef_esc3_t1"):
        assert s.stats[key] > 0, (key, dict(s.stats))
    assert s.stats["mv_halfpel"] > 0
    assert s.stats["mode8_8"] > 0   # 8x8 vertical-left (:2368)
    assert s.stats["mode4_8"] > 0   # 4x4 mode 18 (:2734)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
def test_table1_and_dqp_through_vmem(version, native, W=64, H=48):
    """I-frame VLC table 1 + non-zero P-frame dQP through the Python and
    C++ scan paths into the executor kernel, bit-exact vs the oracle."""
    s = StreamSynthesizer(W, H, version, seed=3)
    pkts = _gop(s, 6, table=1, dqs=[0, 2, -1, 3])
    _assert_engine_matches_oracle(pkts, W, H, version, native)


@pytest.mark.parametrize("native", [False, True])
def test_moflex_qp_clamp_edges_through_vmem(native, W=64, H=48):
    """Moflex QP clamp (MobiclipDecoder.cs:3886-3890): header quantizers
    below 0x0C and above 0x34, and dQPs that push across the clamp edges,
    must decode identically everywhere."""
    v = MobiclipVersion.MOFLEX_3DS
    s = StreamSynthesizer(W, H, v, seed=5)
    pkts = [s.iframe(2)]            # clamps up to 0x0C
    pkts.append(s.pframe(dq=-3))    # stays clamped at 0x0C
    pkts.append(s.pframe(dq=5))
    pkts.append(s.iframe(0x3F, table=1))  # clamps down to 0x34
    pkts.append(s.pframe(dq=7))     # stays clamped at 0x34
    _assert_engine_matches_oracle(pkts, W, H, v, native)


def test_big_levels_dense_fallback_e2e(W=64, H=48):
    """Large escape-3 levels whose dequantized coefficients overflow int16
    must push the engine to its dense fallback and still match the oracle."""
    v = MobiclipVersion.MODS_DS
    s = StreamSynthesizer(W, H, v, seed=7, big_levels=0.3)
    pkts = _gop(s, 4)
    oracle = OracleDecoder(W, H, v)
    eng = VmemVideoDecoder(W, H, v, interpret=True)
    yuv, offs, err = eng.decode_stream_chunk(pkts)
    assert err is None and yuv.shape[0] == len(pkts)
    S = oracle.stride
    for i, pkt in enumerate(pkts):
        oracle.data = pkt
        oracle.offset = 0
        oracle.decode_frame()
        np.testing.assert_array_equal(
            yuv[i][:H], oracle.y_planes[0].reshape(-1, S)[:H],
            err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(
            yuv[i][H:], oracle.uv_planes[0].reshape(-1, S)[:H // 2],
            err_msg=f"frame {i} UV")


@pytest.mark.parametrize("native", [False, True])
def test_encoder_streams_through_native_and_vmem(native):
    """Encoder-generated streams (full plain/esc1/esc2/esc3 cascade +
    half-pel ME) must decode bit-exactly through the C++ scanner and the
    executor kernel — the production path, not just the oracle (round-3 gap:
    encoder round-trips only ever ran through oracle + pipeline engine)."""
    from mobiclipdecoder_tpu.models.encoder import MobiclipEncoder
    W, H = 48, 32
    rng = np.random.default_rng(11)
    enc = MobiclipEncoder(W, H, MobiclipVersion.MOFLEX_3DS, quantizer=0x14,
                          gop=3, refs=2, me_range=6)
    yy, xx = np.mgrid[0:H, 0:W]
    pkts = []
    for f in range(4):
        y = (128 + 60 * np.sin(xx / 11 + f / 2) * np.cos(yy / 7)
             + rng.normal(0, 4, (H, W))).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin(xx[::2, ::2] / 13 + f / 3)) \
            .clip(0, 255).astype(np.uint8)
        v = (128 + 40 * np.cos(yy[::2, ::2] / 9 - f / 4)) \
            .clip(0, 255).astype(np.uint8)
        pkts.append(enc.encode_frame(y, u, v) + b"\x00\x00")
    _assert_engine_matches_oracle(pkts, W, H, MobiclipVersion.MOFLEX_3DS,
                                  native)
