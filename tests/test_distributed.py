"""Multi-worker corpus decoding: assignment completeness, resume, gather."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))

from test_mods_e2e import _build_fixture  # noqa
from mobiclipdecoder_tpu.parallel.distributed import (gather_corpus,  # noqa
                                                      run_worker,
                                                      shard_corpus)


def _corpus(tmp_path, n_files=3):
    files = []
    for i in range(n_files):
        p = tmp_path / f"c{i}.mods"
        p.write_bytes(_build_fixture(nframes=6, seed=20 + i, key_at=(0, 3)))
        files.append(p)
    return files


def test_workers_cover_corpus_exactly_once(tmp_path):
    files = _corpus(tmp_path)
    out = tmp_path / "out"
    stats = [run_worker(files, out, worker_id=w, n_workers=2,
                        engine="oracle") for w in range(2)]
    shards = shard_corpus(files)
    assert sum(s["shards_decoded"] for s in stats) == len(shards)
    totals = gather_corpus(files, out)
    assert totals == {0: 6, 1: 6, 2: 6}


def test_worker_resume_skips_done_shards(tmp_path):
    files = _corpus(tmp_path, n_files=2)
    out = tmp_path / "out"
    s1 = run_worker(files, out, worker_id=0, n_workers=1, engine="oracle")
    assert s1["shards_decoded"] > 0 and s1["shards_skipped"] == 0
    s2 = run_worker(files, out, worker_id=0, n_workers=1, engine="oracle")
    assert s2["shards_decoded"] == 0
    assert s2["shards_skipped"] == s1["shards_decoded"]


def test_sharded_results_match_straight_decode(tmp_path):
    from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                         OracleDecoder)
    from mobiclipdecoder_tpu.containers.mods import ModsDemuxer
    files = _corpus(tmp_path, n_files=1)
    out = tmp_path / "out"
    run_worker(files, out, worker_id=0, n_workers=1, engine="oracle")
    # straight-through decode of the same file
    data = files[0].read_bytes()
    dm = ModsDemuxer(data)
    h = dm.header
    dec = OracleDecoder(h.width, h.height, MobiclipVersion.MODS_DS)
    S = dec.stride
    ref = []
    while (rec := dm.read_frame()) is not None:
        pkt, _n, _k = rec
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        ref.append(np.concatenate([dec.y_planes[0].reshape(-1, S),
                                   dec.uv_planes[0].reshape(-1, S)], axis=0))
    got = np.concatenate([np.load(out / "f0_g0.npy"),
                          np.load(out / "f0_g1.npy")], axis=0)
    np.testing.assert_array_equal(got, np.stack(ref))

def test_tpu_worker_lockstep_batching_matches_oracle(tmp_path):
    """engine="device" groups same-shape shards into one fused-GOP program;
    outputs must equal the oracle worker's shard files exactly."""
    files = _corpus(tmp_path, n_files=3)
    out_t = tmp_path / "out_device"
    out_o = tmp_path / "out_oracle"
    st = run_worker(files, out_t, worker_id=0, n_workers=1, engine="device",
                    batch=4)
    so = run_worker(files, out_o, worker_id=0, n_workers=1, engine="oracle")
    assert st["frames"] == so["frames"] > 0
    npys = sorted(p.name for p in out_o.glob("*.npy"))
    assert npys and npys == sorted(p.name for p in out_t.glob("*.npy"))
    for name in npys:
        a = np.load(out_t / name)
        b = np.load(out_o / name)
        np.testing.assert_array_equal(a, b, err_msg=name)
