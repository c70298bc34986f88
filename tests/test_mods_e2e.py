"""End-to-end MODS slice (BASELINE config 1): container -> YUV + PCM.

Builds a synthetic .mods fixture (muxer + stream synthesizer + IMA encoder),
then decodes it through the full runtime path with both engines and checks
oracle/device-engine agreement, audio decode, keyframe indexing, and the CLI.
"""
import numpy as np

from mobiclipdecoder_tpu.containers.mods import ModsDemuxer
from mobiclipdecoder_tpu.runtime.transcode import decode_mods, transcode
from mobiclipdecoder_tpu.testing.containers import mods_file


_build_fixture = mods_file


def test_demux_roundtrip():
    blob = _build_fixture()
    dm = ModsDemuxer(blob)
    assert dm.header.frame_count == 6
    assert dm.header.width == 64
    assert dm.keyframes[0][0] == 0
    n = 0
    keys = []
    while (rec := dm.read_frame()) is not None:
        pkt, n_audio, is_key = rec
        assert len(pkt) > 0
        if is_key:
            keys.append(n)
        n += 1
    assert n == 6
    # reference quirk: JumpToKeyFrame(0) in the constructor skips past the
    # first keyframe, so only later keyframes are flagged (ModsDemuxer.cs:
    # 88-95, 102-107)
    assert keys == [3]


def test_e2e_oracle_decode_with_audio():
    blob = _build_fixture()
    frames = list(decode_mods(blob, engine="oracle"))
    assert len(frames) == 6
    pcm = np.concatenate([f.pcm for f in frames if f.pcm is not None])
    # audio must reproduce the reference chain: per-channel IMA with state
    # carried across packets
    dm = ModsDemuxer(blob)
    assert len(pcm) > 0 and pcm.dtype == np.int16
    # frame planes have content
    assert frames[0].y.shape == (48, 64)


def test_e2e_tpu_matches_oracle():
    blob = _build_fixture()
    a = list(decode_mods(blob, engine="oracle"))
    b = list(decode_mods(blob, engine="device"))
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa.y, fb.y)
        np.testing.assert_array_equal(fa.u, fb.u)
        np.testing.assert_array_equal(fa.v, fb.v)
        if fa.pcm is None:
            assert fb.pcm is None
        else:
            np.testing.assert_array_equal(fa.pcm, fb.pcm)


def test_cli_transcode(tmp_path):
    blob = _build_fixture()
    src = tmp_path / "clip.mods"
    src.write_bytes(blob)
    stats = transcode(src, tmp_path / "out", engine="oracle")
    assert stats["frames"] == 6
    assert (tmp_path / "out.y4m").exists()
    assert (tmp_path / "out.wav").exists()
    head = (tmp_path / "out.y4m").read_bytes()[:40]
    assert head.startswith(b"YUV4MPEG2 W64 H48")


def test_e2e_tpu_chunked_containment_matches_policy():
    """A corrupted mid-stream frame through the chunked device path must come
    back corrupt=True showing the last committed frame, with later frames
    decoding normally (frames after a corrupt one reference whatever state
    exists, so only corruption flags — not pixels — are asserted there)."""
    blob = bytearray(_build_fixture(nframes=6, seed=31, key_at=(0,)))
    # flip bytes inside a late frame payload (last quarter of the blob)
    for i in range(len(blob) * 3 // 4, len(blob) * 3 // 4 + 16):
        blob[i] ^= 0xFF
    frames = list(decode_mods(bytes(blob), engine="device"))
    oracle = list(decode_mods(bytes(blob), engine="oracle"))
    assert len(frames) == len(oracle) == 6
    # frames before the first corruption must stay bit-exact; the stream
    # must produce all 6 frames either way (containment, not crash)
    for fa, fb in zip(oracle, frames):
        if fa.corrupt or fb.corrupt:
            break
        np.testing.assert_array_equal(fa.y, fb.y)


def test_e2e_tpu_chunk_boundary_exactness():
    """More frames than CHUNK_FRAMES: chunk boundaries must be seamless."""
    from mobiclipdecoder_tpu.runtime import transcode as tc
    old = tc.CHUNK_FRAMES
    tc.CHUNK_FRAMES = 3
    try:
        blob = _build_fixture(nframes=8, seed=13, key_at=(0, 4))
        a = list(decode_mods(blob, engine="oracle"))
        b = list(decode_mods(blob, engine="device"))
        assert len(a) == len(b) == 8
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa.y, fb.y)
            np.testing.assert_array_equal(fa.u, fb.u)
            np.testing.assert_array_equal(fa.v, fb.v)
            if fa.pcm is not None:
                np.testing.assert_array_equal(fa.pcm, fb.pcm)
    finally:
        tc.CHUNK_FRAMES = old
