"""XLA wavefront pipeline vs oracle: bit-exact YUV equivalence on synth streams.

This is the project's core correctness gate: the planner + JAX reconstruction
engine must reproduce the sequential oracle exactly — including decode-order
semantics (intra taps into not-yet-decoded regions) and half-pel rounding.
"""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

pytest.importorskip("jax")
from mobiclipdecoder_tpu.models.pipeline import JaxVideoDecoder  # noqa: E402


def _compare_gop(version, seed, W=64, H=48, nframes=4):
    synth = StreamSynthesizer(W, H, version, seed=seed)
    oracle = OracleDecoder(W, H, version)
    dec = JaxVideoDecoder(W, H, version)
    for i in range(nframes):
        pkt = synth.iframe(0x18) if i == 0 else synth.pframe()
        oracle.data = pkt
        oracle.offset = 0
        oracle.decode_frame()
        y_t, uv_t = dec.decode_frame(pkt)
        S = oracle.stride
        y_o = oracle.y_planes[0].reshape(-1, S)
        uv_o = oracle.uv_planes[0].reshape(-1, S)
        if not (y_o == y_t).all() or not (uv_o == uv_t).all():
            dy = np.argwhere(y_o.astype(int) != y_t.astype(int))
            duv = np.argwhere(uv_o.astype(int) != uv_t.astype(int))
            raise AssertionError(
                f"frame {i}: Y mismatches {len(dy)} (first {dy[:5].tolist()}),"
                f" UV mismatches {len(duv)} (first {duv[:5].tolist()})")
        # scanners must consume identical byte counts
        assert oracle.offset == dec.offset


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_matches_oracle_gop(version, seed):
    _compare_gop(version, seed)


def test_pipeline_matches_oracle_larger_frame():
    _compare_gop(MobiclipVersion.MODS_DS, seed=5, W=128, H=96, nframes=3)
