"""Batched multi-stream decode: per-stream bit-exactness + mesh sharding."""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

jax = pytest.importorskip("jax")
from jax.sharding import Mesh, PartitionSpec  # noqa: E402

from mobiclipdecoder_tpu.parallel.batch import BatchVideoDecoder  # noqa: E402


def _oracle_gop(version, seed, W, H, nframes):
    synth = StreamSynthesizer(W, H, version, seed=seed)
    dec = OracleDecoder(W, H, version)
    pkts, planes = [], []
    for i in range(nframes):
        pkt = synth.iframe(0x18) if i == 0 else synth.pframe()
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        pkts.append(pkt)
        planes.append((dec.y_planes[0].copy(), dec.uv_planes[0].copy()))
    return pkts, planes


@pytest.mark.parametrize("use_gop_scan", [False, True])
def test_batch_matches_oracle(use_gop_scan):
    W, H, B, F = 64, 48, 4, 3
    version = MobiclipVersion.MODS_DS
    data = [_oracle_gop(version, 100 + b, W, H, F) for b in range(B)]
    bd = BatchVideoDecoder(W, H, version, batch=B)
    S = bd.stride
    if use_gop_scan:
        frames = [[data[b][0][f] for b in range(B)] for f in range(F)]
        out = bd.decode_gop(frames)  # (F, B, HH, S)
        for f in range(F):
            for b in range(B):
                y_o, uv_o = data[b][1][f]
                got = out[f, b]
                np.testing.assert_array_equal(got[:H].ravel(), y_o)
                np.testing.assert_array_equal(got[H:].ravel(), uv_o)
    else:
        for f in range(F):
            out = bd.decode_frames([data[b][0][f] for b in range(B)])
            for b in range(B):
                y_o, uv_o = data[b][1][f]
                np.testing.assert_array_equal(out[b, :H].ravel(), y_o)
                np.testing.assert_array_equal(out[b, H:].ravel(), uv_o)


def test_batch_sharded_over_mesh():
    """Same decode under a 2-axis mesh on the 8 virtual CPU devices (the
    second axis is deliberately unused — see test_no_collectives)."""
    devs = np.array(jax.devices()).reshape(4, 2)
    mesh = Mesh(devs, ("data", "tile"))
    W, H, B, F = 64, 48, 4, 2
    version = MobiclipVersion.MODS_DS
    data = [_oracle_gop(version, 200 + b, W, H, F) for b in range(B)]
    bd = BatchVideoDecoder(W, H, version, batch=B, mesh=mesh)
    for f in range(F):
        out = bd.decode_frames([data[b][0][f] for b in range(B)])
        for b in range(B):
            y_o, uv_o = data[b][1][f]
            np.testing.assert_array_equal(out[b, :H].ravel(), y_o)
            np.testing.assert_array_equal(out[b, H:].ravel(), uv_o)


def test_no_collectives_in_batch_decode():
    """Streams are independent, so the data-parallel batch program must
    contain ZERO collectives.  This is the regression gate for the round-2
    'decorative tile axis' finding: width-sharding the ring made GSPMD
    all-gather the whole plane on every device (measured on an 8-device
    CPU mesh), so the tile spec was removed — if a plane
    sharding ever sneaks back in, the gather reappears here."""
    from mobiclipdecoder_tpu.parallel.batch import _decode_batch
    import jax.numpy as jnp

    devs = np.array(jax.devices()).reshape(4, 2)
    mesh = Mesh(devs, ("data", "tile"))
    W, H, B = 64, 48, 4
    version = MobiclipVersion.MODS_DS
    from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer
    synths = [StreamSynthesizer(W, H, version, seed=s) for s in range(B)]
    bd = BatchVideoDecoder(W, H, version, batch=B, mesh=mesh)
    arrays = bd.scan_packets([s.iframe(0x18) for s in synths])
    arrays = {k: jax.device_put(v, bd.data_sharding)
              for k, v in arrays.items()}
    ring = jnp.roll(bd.ring, 1, axis=1)
    txt = _decode_batch.lower(
        ring, arrays["mc"], arrays["resid"], arrays["resid_coef"],
        arrays["iops"], arrays["icoef"], arrays["seqmap"],
        arrays["n_levels"], H, bd.stride).compile().as_text()
    for coll in ("all-gather", "collective-permute", "all-to-all"):
        assert coll not in txt, f"unexpected {coll} in batch decode HLO"
    # scalar pred[]/s32[] all-reduces are loop-condition agreement across
    # the replicated axis (bytes, not planes) — anything bigger is a leak
    import re
    for m in re.findall(r"all-reduce[^=]*= (\w+\[[^\]]*\])", txt):
        assert m in ("pred[]", "s32[]", "u32[]"), \
            f"non-scalar all-reduce {m} in batch decode HLO"
