"""Native whole-GOP packed scan (scanner_scan_gop): the C++ scanner emits
the fused-GOP sparse upload blob directly.  Gates:

* bit-identical blobs vs the Python _pack_gop_chunks + _pack_gop_blob_sparse
  pipeline (the executable spec of the layout),
* frame-boundary splitting without rescanning (oversized-GOP dispatch),
* checkpoint/rollback exactness (the fallback path's correctness argument),
* malformed-frame prefix semantics through decode_stream_chunk.
"""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu.ops.vmem_engine import (
    CHUNK, VmemBatchDecoder, VmemVideoDecoder, _assemble_gop_parts,
    _gop_part, _pack_gop_blob_sparse, _pack_gop_chunks, _split_gop_part)
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer
from mobiclipdecoder_tpu.utils.native import NativePlanner


def _gop(B=3, F=8, W=256, H=192, version=MobiclipVersion.MODS_DS):
    synths = [StreamSynthesizer(W, H, version, seed=b) for b in range(B)]
    return [[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
            for f in range(F)]


def test_gop_blob_bit_identical_to_python_pack():
    B, F = 3, 8
    frames = _gop(B, F)
    bd = VmemBatchDecoder(256, 192, MobiclipVersion.MODS_DS, batch=B)
    plans_fb = [bd._scan_all(fp) for fp in frames]
    ops, coefs, sizes = _pack_gop_chunks(plans_fb, B)
    nct = ops.shape[1]
    blob_ref, nnzb_ref = _pack_gop_blob_sparse(
        ops, coefs, sizes.reshape(B, nct * CHUNK))

    nvs = [NativePlanner(256, 192, int(MobiclipVersion.MODS_DS))
           for _ in range(B)]
    res = [nv.scan_gop_packed([frames[f][b] for f in range(F)])
           for b, nv in enumerate(nvs)]
    for r in res:
        assert r["done"] == F and not r["err"] and not r["val_overflow"]
    blob_nat, nct_nat, nnzb_nat = _assemble_gop_parts(
        [_gop_part(r) for r in res])
    assert nct_nat == nct and nnzb_nat == nnzb_ref
    assert np.array_equal(blob_ref, blob_nat)


def test_gop_split_matches_separate_scans():
    """Splitting one scan's parts at a frame boundary must equal scanning
    the two halves as separate GOP calls (re-based frame ids + indices)."""
    F = 8
    frames = _gop(1, F)
    pkts = [frames[f][0] for f in range(F)]

    nv = NativePlanner(256, 192, int(MobiclipVersion.MODS_DS))
    r = nv.scan_gop_packed(pkts)
    assert r["done"] == F
    part = _gop_part(r)
    mid = 3
    a, b = _split_gop_part(part, 0, mid), _split_gop_part(part, mid, F)
    blob_a, nct_a, nnzb_a = _assemble_gop_parts([a])
    blob_b, nct_b, nnzb_b = _assemble_gop_parts([b])

    nv2 = NativePlanner(256, 192, int(MobiclipVersion.MODS_DS))
    ra = nv2.scan_gop_packed(pkts[:mid])
    rb = nv2.scan_gop_packed(pkts[mid:])
    blob_a2, _, _ = _assemble_gop_parts([_gop_part(ra)])
    blob_b2, _, _ = _assemble_gop_parts([_gop_part(rb)])
    assert np.array_equal(blob_a, blob_a2)
    assert np.array_equal(blob_b, blob_b2)


def test_checkpoint_rollback_rescan_identical():
    F = 6
    frames = _gop(1, F)
    pkts = [frames[f][0] for f in range(F)]
    nv = NativePlanner(256, 192, int(MobiclipVersion.MODS_DS))
    nv.checkpoint()
    r1 = nv.scan_gop_packed(pkts)
    nv.rollback()
    r2 = nv.scan_gop_packed(pkts)
    assert r1["nct"] == r2["nct"] and r1["nnz"] == r2["nnz"]
    assert np.array_equal(r1["ops3"][:r1["nct"]], r2["ops3"][:r2["nct"]])
    assert np.array_equal(r1["idx"][:r1["nnz"]], r2["idx"][:r2["nnz"]])
    assert np.array_equal(r1["val"][:r1["nnz"]], r2["val"][:r2["nnz"]])


def test_gop_scan_malformed_frame_prefix():
    """A malformed packet mid-GOP: C++ keeps the good prefix and reports
    err at the frame boundary; decode_stream_chunk mirrors the reference
    player's containment."""
    F = 6
    frames = _gop(1, F)
    pkts = [frames[f][0] for f in range(F)]
    bad = 3
    pkts[bad] = b"\x00"  # < 2 bytes: scan() rejects outright

    nv = NativePlanner(256, 192, int(MobiclipVersion.MODS_DS))
    r = nv.scan_gop_packed(pkts)
    assert r["err"] and r["done"] == bad
    assert len(r["consumed"]) == bad

    dec = VmemVideoDecoder(256, 192, MobiclipVersion.MODS_DS)
    yuv, offs, err = dec.decode_stream_chunk(pkts)
    assert err == bad
    assert yuv.shape[0] == bad and len(offs) == bad

    # the oracle decodes the same prefix identically
    from mobiclipdecoder_tpu.models.oracle_video import OracleDecoder
    odec = OracleDecoder(256, 192, MobiclipVersion.MODS_DS)
    S = odec.stride
    for k in range(bad):
        odec.data = pkts[k]
        odec.offset = 0
        odec.decode_frame()
        assert np.array_equal(yuv[k][:192],
                              odec.y_planes[0].reshape(-1, S)[:192])
        assert np.array_equal(yuv[k][192:],
                              odec.uv_planes[0].reshape(-1, S)[:96])


def test_gop_val_overflow_flag():
    """Coefficients beyond int16 set val_overflow (the driver then rewinds
    and takes the dense path).  QP 51 MODS + max escape levels produce
    scales large enough to overflow."""
    s = StreamSynthesizer(256, 192, MobiclipVersion.MODS_DS, seed=0)
    pkt = s.iframe(51)  # QP 51: 8x8 scale = qscale << 14, levels up to 39
    nv = NativePlanner(256, 192, int(MobiclipVersion.MODS_DS))
    r = nv.scan_gop_packed([pkt])
    if not r["val_overflow"]:
        pytest.skip("synthesizer produced no >int16 coefficient")
    assert r["done"] == 1  # val overflow alone doesn't abort the scan

    # the driver rewinds and takes the dense plan path: decode still
    # matches the oracle
    from mobiclipdecoder_tpu.models.oracle_video import OracleDecoder
    dec = VmemVideoDecoder(256, 192, MobiclipVersion.MODS_DS)
    yuv, offs, err = dec.decode_stream_chunk([pkt])
    assert err is None and yuv.shape[0] == 1
    odec = OracleDecoder(256, 192, MobiclipVersion.MODS_DS)
    odec.data = pkt
    odec.offset = 0
    odec.decode_frame()
    S = odec.stride
    assert np.array_equal(yuv[0][:192],
                          odec.y_planes[0].reshape(-1, S)[:192])
    assert np.array_equal(yuv[0][192:],
                          odec.uv_planes[0].reshape(-1, S)[:96])


def test_decode_gop_native_path_bit_exact_vs_oracle():
    """decode_gop (now the native scan path) stays bit-exact vs the
    oracle across a multi-frame GOP."""
    from mobiclipdecoder_tpu.models.oracle_video import OracleDecoder
    B, F = 2, 6
    frames = _gop(B, F)
    bd = VmemBatchDecoder(256, 192, MobiclipVersion.MODS_DS, batch=B)
    out = bd.decode_gop(frames)
    for b in range(B):
        odec = OracleDecoder(256, 192, MobiclipVersion.MODS_DS)
        S = odec.stride
        for f in range(F):
            odec.data = frames[f][b]
            odec.offset = 0
            odec.decode_frame()
            assert np.array_equal(out[f, b, :192],
                                  odec.y_planes[0].reshape(-1, S)[:192])
            assert np.array_equal(out[f, b, 192:],
                                  odec.uv_planes[0].reshape(-1, S)[:96])


def test_single_frame_dense_fallback(monkeypatch):
    """A lone frame whose sparse nnz exceeds the bucket ladder must take
    the dense-upload fallback (reachable for maximal-density Wii frames),
    not raise.  Forced here by shrinking the ladder; output must stay
    bit-exact vs the normal sparse path."""
    from mobiclipdecoder_tpu.ops import vmem_engine as ve

    frames = _gop(1, 3)
    pkts = [frames[f][0] for f in range(3)]

    ref_dec = VmemVideoDecoder(256, 192, MobiclipVersion.MODS_DS)
    ref_yuv, _, err = ref_dec.decode_stream_chunk(pkts)
    assert err is None

    monkeypatch.setattr(ve, "NNZ_PS_BUCKETS", (2,))
    dec = VmemVideoDecoder(256, 192, MobiclipVersion.MODS_DS)
    yuv, offs, err = dec.decode_stream_chunk(pkts)
    assert err is None and yuv.shape[0] == 3
    np.testing.assert_array_equal(yuv, ref_yuv)


def test_fusion_coef_capacity_chunk_close():
    """With MC+residual fusion a chunk's COEFFICIENT capacity (CHUNK rows)
    can fill before its op capacity (CHUNK-1 ops): a stream of unsplit
    full-cbp inter MBs carries 6 rows per MC op, closing chunks at ~42
    ops.  The Python span rule and the C++ scanner must split identically
    and the decode must stay bit-exact."""
    from mobiclipdecoder_tpu.models.oracle_video import OracleDecoder
    from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer, _inv_lut, _pb_code
    from mobiclipdecoder_tpu.tables import TABLES
    from mobiclipdecoder_tpu.utils.bitio import BitWriter

    W, H = 256, 96
    v = MobiclipVersion.MODS_DS
    s = StreamSynthesizer(W, H, v, seed=77)
    pkts = [s.iframe(0x18)]

    # hand-built P-frame: every MB is an unsplit mode-1 MC with a FULL
    # residual cbp (0x3F) of whole-8x8 blocks -> 6 fused rows per MC
    bw = BitWriter()
    bw.write_bits(0, 1)
    bw.write_varint_s(0)
    s.table = 0
    for mby in range(H // 16):
        for mbx in range(W // 16):
            code, nbits = _pb_code(16, 16, "mods", 1)
            bw.write_bits(code, nbits)
            bw.write_varint_s(0)    # dx = pred
            bw.write_varint_s(0)    # dy = pred
            bw.write_varint_u(_inv_lut(TABLES["cbp_inter"], 0x3F))
            for _ in range(6):
                bw.write_bits(1, 1)          # whole 8x8 DCT
                s._emit_block_coefs(bw, 8)
    s.frame_idx += 1
    pkts.append(bw.to_bytes() + b"\x00\x00")

    # every MC op in the dense frame must be fused with 6 rows, and the
    # frame must span multiple chunks closed early by coef capacity
    from mobiclipdecoder_tpu.models.plan import PlanningDecoder
    from mobiclipdecoder_tpu.ops.vmem_engine import (_frame_chunk_spans,
                                                     _op_nrows)
    py = PlanningDecoder(W, H, v)
    for pkt in pkts:
        py.data = pkt
        py.offset = 0
        py.decode_frame()
        up = py.unified_plan()
    n = int(up["ops"][0, 0])
    rows = up["ops"][1:1 + n]
    mc = rows[(rows[:, 0] & 3) == 1]
    assert ((mc[:, 0] >> 3) & 0x3F == 0x3F).all()
    spans = _frame_chunk_spans(rows)
    assert len(spans) > 1
    i0, i1 = spans[0]
    assert sum(_op_nrows(int(w)) for w in rows[i0:i1, 0]) <= 256
    assert (i1 - i0) < 255  # closed by coef capacity, not op capacity

    # C++ GOP scan must produce the bit-identical blob and exact decode
    nv = NativePlanner(W, H, int(v))
    r = nv.scan_gop_packed(pkts)
    assert r["done"] == 2 and not r["err"]
    py2 = PlanningDecoder(W, H, v)
    plans = []
    for pkt in pkts:
        py2.data = pkt
        py2.offset = 0
        py2.decode_frame()
        plans.append([py2.unified_plan()])
    from mobiclipdecoder_tpu.ops.vmem_engine import (CHUNK,
                                                     _assemble_gop_parts,
                                                     _gop_part,
                                                     _pack_gop_blob_sparse,
                                                     _pack_gop_chunks)
    ops, coefs, sizes = _pack_gop_chunks(plans, 1)
    nct = ops.shape[1]
    sp = _pack_gop_blob_sparse(ops, coefs, sizes.reshape(1, nct * CHUNK))
    assert sp is not None
    blob_ref, nnzb_ref = sp
    blob_nat, nct_nat, nnzb_nat = _assemble_gop_parts([_gop_part(r)])
    assert nct_nat == nct and nnzb_nat == nnzb_ref
    np.testing.assert_array_equal(blob_ref, blob_nat)

    # and the engine decodes the dense stream bit-exactly
    dec = VmemVideoDecoder(W, H, v, interpret=True)
    yuv, _offs, err = dec.decode_stream_chunk(pkts)
    assert err is None
    odec = OracleDecoder(W, H, v)
    S = odec.stride
    for k, pkt in enumerate(pkts):
        odec.data = pkt
        odec.offset = 0
        odec.decode_frame()
        np.testing.assert_array_equal(
            yuv[k][:H], odec.y_planes[0].reshape(-1, S)[:H])
        np.testing.assert_array_equal(
            yuv[k][H:], odec.uv_planes[0].reshape(-1, S)[:H // 2])
