"""Whole-GOP executor engine vs oracle: bit-exact YUV equivalence.

The engine executes the unified decode-order op stream in one Pallas kernel
(interpret mode on the CPU here; compiled for the GPU by chip_smoke.py).
Must reproduce the sequential oracle exactly — including decode-order
semantics and half-pel truncation.
"""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

pytest.importorskip("jax")
from mobiclipdecoder_tpu.ops.vmem_engine import (VmemBatchDecoder,  # noqa: E402
                                                 VmemVideoDecoder)


def _compare_gop(version, seed, W=64, H=48, nframes=4, qp=0x18):
    synth = StreamSynthesizer(W, H, version, seed=seed)
    oracle = OracleDecoder(W, H, version)
    eng = VmemVideoDecoder(W, H, version, interpret=True, native=False)
    for i in range(nframes):
        pkt = synth.iframe(qp) if i == 0 else synth.pframe()
        oracle.data = pkt
        oracle.offset = 0
        oracle.decode_frame()
        y_t, uv_t = eng.decode_frame(pkt)
        S = oracle.stride
        y_o = oracle.y_planes[0].reshape(-1, S)
        uv_o = oracle.uv_planes[0].reshape(-1, S)
        if not (y_o == y_t).all() or not (uv_o == uv_t).all():
            dy = np.argwhere(y_o.astype(int) != y_t.astype(int))
            duv = np.argwhere(uv_o.astype(int) != uv_t.astype(int))
            raise AssertionError(
                f"frame {i}: Y mismatches {len(dy)} (first {dy[:5].tolist()}),"
                f" UV mismatches {len(duv)} (first {duv[:5].tolist()})")


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
@pytest.mark.parametrize("seed", [0, 1])
def test_vmem_matches_oracle_gop(version, seed):
    _compare_gop(version, seed)


def test_vmem_matches_oracle_other_qp():
    _compare_gop(MobiclipVersion.MODS_DS, seed=3, qp=0x24)


def test_vmem_batch_matches_single():
    W, H = 64, 48
    v = MobiclipVersion.MODS_DS
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (5, 6, 7)]
    oracles = [OracleDecoder(W, H, v) for _ in range(3)]
    bd = VmemBatchDecoder(W, H, v, batch=3, interpret=True, native=False)
    for i in range(3):
        pkts = [s.iframe(0x18) if i == 0 else s.pframe() for s in synths]
        out = bd.decode_frames(pkts)
        for b, (o, pkt) in enumerate(zip(oracles, pkts)):
            o.data = pkt
            o.offset = 0
            o.decode_frame()
            S = o.stride
            exp = np.concatenate([o.y_planes[0].reshape(-1, S),
                                  o.uv_planes[0].reshape(-1, S)], axis=0)
            assert (out[b] == exp).all(), f"frame {i} stream {b}"


def test_vmem_decode_gop_matches_per_frame():
    W, H = 64, 48
    v = MobiclipVersion.MODS_DS
    F, B = 4, 2
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (11, 12)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(F)]
    a = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    b = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    gop = a.decode_gop(frames)
    for f in range(F):
        per = b.decode_frames(frames[f])
        np.testing.assert_array_equal(gop[f], per)


def test_ops3_pack_roundtrip_and_bounds():
    """The 3-word packed op upload must round-trip exactly and reject rows
    whose fields exceed the packed widths (w0 26 bits, rr/cc 12, w3 14)."""
    import jax.numpy as jnp
    from mobiclipdecoder_tpu.ops.vmem_engine import _pack_ops3, _unpack_ops3

    rng = np.random.default_rng(0)
    n = 512
    ops = np.zeros((n, 4), np.int32)
    ops[:, 0] = rng.integers(0, 1 << 26, n)
    rr = rng.integers(0, 1 << 12, n)
    cc = rng.integers(0, 1 << 12, n)
    ops[:, 1] = rr | (cc << 16)
    ops[:, 2] = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    ops[:, 3] = rng.integers(0, 1 << 14, n)
    p3 = _pack_ops3(ops)
    assert p3 is not None and p3.shape == (n, 3)
    back = np.asarray(_unpack_ops3(jnp.asarray(p3)))
    np.testing.assert_array_equal(back, ops)

    for col, bad in ((0, 1 << 26), (1, 4096), (1, 4096 << 16), (3, 1 << 14),
                     (3, -1)):
        o2 = ops.copy()
        o2[5, col] = bad
        assert _pack_ops3(o2) is None, (col, bad)


def test_gop_blob_sparse_dense_fallback():
    """w3 overflow or >int16 coefficient levels must push the fused GOP
    pack to the dense fallback (return None) rather than corrupt."""
    from mobiclipdecoder_tpu.ops.vmem_engine import (CHUNK,
                                                     _pack_gop_blob_sparse,
                                                     _pack_gop_chunks)

    W, H, B = 64, 48, 2
    v = MobiclipVersion.MODS_DS
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (31, 32)]
    bd = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(3)]
    plans_fb = [bd._scan_all(fp) for fp in frames]
    ops, coefs, sizes = _pack_gop_chunks(plans_fb, B)
    nct = ops.shape[1]
    sp = _pack_gop_blob_sparse(ops, coefs, sizes.reshape(B, nct * CHUNK))
    assert sp is not None
    big = coefs.copy()
    big[0, 0, 0, 0] = 0x10000
    assert _pack_gop_blob_sparse(ops, big,
                                 sizes.reshape(B, nct * CHUNK)) is None
    badops = ops.copy()
    badops[0, 0, 1, 3] = 1 << 14
    assert _pack_gop_blob_sparse(badops, coefs,
                                 sizes.reshape(B, nct * CHUNK)) is None


def test_vmem_decode_gop_fused_matches_per_frame():
    """The whole-GOP single-launch path (HBM ring, modular slots) must equal
    per-frame decoding exactly, across more frames than ring slots so the
    modular slot reuse wraps."""
    W, H = 64, 48
    v = MobiclipVersion.MODS_DS
    F, B = 8, 2
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (31, 32)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(F)]
    a = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    b = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    gop = a.decode_gop(frames)
    for f in range(F):
        per = b.decode_frames(frames[f])
        np.testing.assert_array_equal(gop[f], per, err_msg=f"frame {f}")


def test_vmem_fused_gop_ring_carries_across_gops():
    """Ring renormalization after a fused GOP must leave slot 0 = newest so
    a following GOP (fused or per-frame) continues bit-exactly."""
    W, H = 64, 48
    v = MobiclipVersion.MODS_DS
    B = 2
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (41, 42)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(7)]
    a = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    b = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    ga1 = a.decode_gop(frames[:4])
    ga2 = a.decode_gop(frames[4:])
    for f in range(7):
        per = b.decode_frames(frames[f])
        got = ga1[f] if f < 4 else ga2[f - 4]
        np.testing.assert_array_equal(got, per, err_msg=f"frame {f}")


def test_vmem_decode_gops_streaming_matches():
    """The overlapped multi-GOP streaming API must yield the same planes
    as per-GOP fused decoding, in order."""
    W, H = 64, 48
    v = MobiclipVersion.MODS_DS
    B = 2
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (51, 52)]
    gops = []
    for _ in range(3):
        gops.append([[s.iframe(0x18) if f == 0 else s.pframe()
                      for s in synths] for f in range(3)])
    a = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    b = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    got = list(a.decode_gops(iter(gops)))
    assert len(got) == 3
    for g, arr in enumerate(got):
        exp = b.decode_gop(gops[g])
        np.testing.assert_array_equal(arr, exp, err_msg=f"gop {g}")


def _geometry_vs_oracle(W, H, seed, nframes):
    """Decode a Moflex stream of a wide geometry frame by frame; every
    plane must match the oracle, and the ring accessor must return the
    last frame in the (HB, SB) buffer layout (margins MR=MCOL=8)."""
    from mobiclipdecoder_tpu.ops import vmem_engine as ve
    v = MobiclipVersion.MOFLEX_3DS
    synth = StreamSynthesizer(W, H, v, seed=seed)
    oracle = OracleDecoder(W, H, v)
    eng = ve.VmemVideoDecoder(W, H, v, interpret=True, native=False)
    S = oracle.stride
    _hh, HB, SB = ve._geom(H, S)
    assert eng.ring.shape == (1, 6, HB, SB) and SB == S + 32
    for i in range(nframes):
        pkt = synth.iframe(0x18) if i == 0 else synth.pframe()
        oracle.data = pkt
        oracle.offset = 0
        oracle.decode_frame()
        y_t, uv_t = eng.decode_frame(pkt)
        np.testing.assert_array_equal(
            oracle.y_planes[0].reshape(-1, S), y_t, err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(
            oracle.uv_planes[0].reshape(-1, S), uv_t,
            err_msg=f"frame {i} UV")
    prev = eng.ring_frame_np()
    assert prev.shape == (HB, SB)
    np.testing.assert_array_equal(
        prev[8:8 + H, 8:8 + S], oracle.y_planes[0].reshape(-1, S))
    np.testing.assert_array_equal(
        prev[8 + H:8 + H + H // 2, 8:8 + S],
        oracle.uv_planes[0].reshape(-1, S))
    # the zero aprons stay zero (taps outside the picture read 0)
    assert not prev[:8].any() and not prev[:, :8].any()
    assert not prev[:, 8 + S:].any() and not prev[8 + H + H // 2:].any()


def test_vmem_wii_size_hbm_ring_matches_oracle():
    """Stride-1024 geometry (640-wide, the 640x480 profile's stride) at a
    short height: bit-exact vs the oracle in the uint8 ring layout."""
    _geometry_vs_oracle(640, 48, seed=9, nframes=3)


def test_vmem_packed_ring_matches_oracle():
    """Stride-512 geometry (400-wide, the 3DS stride): bit-exact vs the
    oracle, ring accessor in the buffer layout."""
    _geometry_vs_oracle(400, 64, seed=13, nframes=4)


def test_vmem_fused_gop_split_on_chunk_overflow(monkeypatch):
    """A GOP exceeding the largest chunk bucket must transparently split
    into multiple dispatches with identical results."""
    from mobiclipdecoder_tpu.ops import vmem_engine as ve
    W, H = 64, 48
    v = MobiclipVersion.MODS_DS
    B, F = 2, 6
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (61, 62)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(F)]
    a = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    b = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    ref = b.decode_gop(frames)
    monkeypatch.setattr(ve, "NCT_BUCKETS", (4,))  # force a split
    got = a.decode_gop(frames)
    np.testing.assert_array_equal(got, ref)


def test_device_crop_matches_host_crop():
    """crop=True fused results must equal the host-side crop of the
    full-stride result: Y columns [0,W), then U|V repacked adjacent."""
    W, H = 64, 48
    v = MobiclipVersion.MODS_DS
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (71, 72)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(3)]
    a = VmemBatchDecoder(W, H, v, batch=2, interpret=True, native=False)
    b = VmemBatchDecoder(W, H, v, batch=2, interpret=True, native=False,
                         crop=True)
    full = a.decode_gop(frames)          # (F, B, HH, S)
    cropped = b.decode_gop(frames)       # (F, B, HH, W)
    S = a.stride
    assert cropped.shape[-1] == W
    np.testing.assert_array_equal(cropped[:, :, :H], full[:, :, :H, :W])
    np.testing.assert_array_equal(cropped[:, :, H:, :W // 2],
                                  full[:, :, H:, :W // 2])
    np.testing.assert_array_equal(cropped[:, :, H:, W // 2:],
                                  full[:, :, H:, S // 2:S // 2 + W // 2])


def test_fused_gop_sharded_matches_unsharded():
    """The shard_map'd FUSED whole-GOP path (the production dispatch shape)
    over an 8-device CPU mesh must equal the single-device fused result."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from mobiclipdecoder_tpu.ops.vmem_engine import (
        _decode_gop_fused, _pack_gop_chunks, decode_gop_fused_sharded)

    W, H = 64, 48
    v = MobiclipVersion.MODS_DS
    B, F = 8, 3
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    synths = [StreamSynthesizer(W, H, v, seed=100 + s) for s in range(B)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(F)]
    bd = VmemBatchDecoder(W, H, v, batch=B, interpret=True, native=False)
    plans_fb = [bd._scan_all(fp) for fp in frames]
    ops, coefs, sizes = _pack_gop_chunks(plans_fb, B)
    args = (jnp.asarray(ops), jnp.asarray(coefs), jnp.asarray(sizes))
    ring_a = jnp.zeros_like(bd.ring)
    ring_b = jnp.zeros_like(bd.ring)
    ring_a, ya = _decode_gop_fused(ring_a, *args, F, H, bd.stride, True)
    ring_b, yb = decode_gop_fused_sharded(mesh, ring_b, *args, F, H,
                                          bd.stride, True)
    np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
    np.testing.assert_array_equal(np.asarray(ring_a), np.asarray(ring_b))


def test_mc_residual_fusion_active_and_exact():
    """The scanner-level MC+residual fusion must actually engage (a
    regression that silently stops fusing would only show up as a perf
    cliff) and the fused stream must stay bit-exact — the oracle
    comparison is covered by the suite-wide gates; here we pin the
    structural facts: fused MC ops carry mask bits + consecutive rows,
    and the op count drops materially vs the residual count."""
    v = MobiclipVersion.MODS_DS
    W, H = 96, 64
    s = StreamSynthesizer(W, H, v, seed=5)
    from mobiclipdecoder_tpu.models.plan import PlanningDecoder
    py = PlanningDecoder(W, H, v)
    fused_rows = 0
    n_ops = 0
    for f in range(4):
        pkt = s.iframe(0x18) if f == 0 else s.pframe()
        py.data = pkt
        py.offset = 0
        py.decode_frame()
        up = py.unified_plan()
        n = int(up["ops"][0, 0])
        rows = up["ops"][1:1 + n]
        n_ops += n
        mc = rows[(rows[:, 0] & 3) == 1]
        for w0, w1, w2, w3 in mc:
            mask = (int(w0) >> 3) & 0x3F
            nr = bin(mask).count("1")
            fused_rows += nr
            if nr:
                bw = (int(w0) >> 16) & 0x1F
                bh = (int(w0) >> 21) & 0x1F
                if (bw, bh) == (16, 16):
                    pass            # unsplit-MB fusion: any of the 6 bits
                else:
                    # split-leaf attachment (round 5): only >=8x8 leaves
                    # absorb quads, luma bits only, quads inside the leaf
                    assert bw >= 8 and bh >= 8, (bw, bh)
                    assert mask & 0x30 == 0, mask   # no chroma on leaves
                    if bw == 8:
                        assert mask & 0b0010 == 0 and mask & 0b1000 == 0
                    if bh == 8:
                        assert mask & 0b1100 == 0
                assert 0 <= int(w3) < up["coefs"].shape[0]
    assert fused_rows > 50, (fused_rows, n_ops)


@pytest.mark.parametrize("mode", ["pad", "split"])
def test_gop_wrapper_bucket_padding_and_frame_split(monkeypatch, mode):
    """The native GOP wrapper pads each stream's chunk stream to a ladder
    step with all-zero (count 0) chunks, and splits a GOP at frame
    boundaries into several launches when a stream outgrows the ladder;
    both decode bit-exactly like the default ladder."""
    from mobiclipdecoder_tpu.ops import vmem_engine as ve
    W, H, B, F = 64, 48, 2, 5
    v = MobiclipVersion.MODS_DS
    synths = [StreamSynthesizer(W, H, v, seed=s) for s in (81, 82)]
    frames = [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
              for f in range(F)]
    ref = VmemBatchDecoder(W, H, v, batch=B, native=True).decode_gop(frames)
    bd = VmemBatchDecoder(W, H, v, batch=B, native=True)
    res = [nv.scan_gop_packed([frames[f][b] for f in range(F)])
           for b, nv in enumerate(bd.natives)]
    real = max(r["nct"] for r in res)
    launches = []
    orig = ve._decode_gop_fused_sblob

    def counting(ring, blob, F, nct, *a, **k):
        launches.append((F, nct))
        return orig(ring, blob, F, nct, *a, **k)
    monkeypatch.setattr(ve, "_decode_gop_fused_sblob", counting)
    if mode == "pad":
        monkeypatch.setattr(ve, "NCT_BUCKETS", (64,))
        blob, nct, _nnzb = ve._assemble_gop_parts([ve._gop_part(r)
                                                   for r in res])
        assert nct == 64 > real
        ops3 = blob[:B * nct * ve.CHUNK * 3].reshape(B, nct, ve.CHUNK, 3)
        assert not ops3[:, real:].any()
    else:
        assert real > 3           # one chunk per frame or more
        monkeypatch.setattr(ve, "NCT_BUCKETS", (2, 3))
    bd2 = VmemBatchDecoder(W, H, v, batch=B, native=True)
    got = bd2.decode_gop(frames)
    np.testing.assert_array_equal(got, ref)
    if mode == "pad":
        assert launches == [(F, 64)]
    else:
        assert len(launches) > 1 and sum(f for f, _ in launches) == F
        assert all(n <= 3 for _f, n in launches)
