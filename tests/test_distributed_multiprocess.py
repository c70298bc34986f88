"""True multi-process jax.distributed execution (BASELINE config 5 shape).

tests/test_distributed.py exercises worker assignment/resume/gather by
calling run_worker serially in one process; this module actually SPAWNS two
OS processes that rendezvous through init_distributed's coordinator path
(parallel/distributed.py) — the closest honest approximation of an N-host
DCN job this single-host environment allows.  The gathered YUV must equal a
single-process decode bit-for-bit.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))

from test_mods_e2e import _build_fixture  # noqa

_WORKER = r"""
import json, sys
import jax
# the CPU platform, set in-process before any backend use
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from mobiclipdecoder_tpu.parallel.distributed import (init_distributed,
                                                      run_worker)
coord, pid, nproc, out_dir = (sys.argv[2], int(sys.argv[3]),
                              int(sys.argv[4]), sys.argv[5])
files = sys.argv[6:]
got_pid, got_n = init_distributed(coord, num_processes=nproc,
                                  process_id=pid)
assert (got_pid, got_n) == (pid, nproc), (got_pid, got_n)
stats = run_worker(files, out_dir, worker_id=got_pid, n_workers=got_n,
                   engine="oracle")
stats["process_count"] = got_n
print(json.dumps(stats))
"""


def test_two_process_coordinator_rendezvous(tmp_path):
    repo = str(Path(__file__).resolve().parent.parent)
    files = []
    for i in range(2):
        p = tmp_path / f"c{i}.mods"
        p.write_bytes(_build_fixture(nframes=6, seed=40 + i, key_at=(0, 3)))
        files.append(str(p))
    out_mp = tmp_path / "out_mp"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), repo, coord, str(pid), "2",
         str(out_mp)] + files,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    # both processes saw the 2-process runtime and split the corpus
    assert all(o["process_count"] == 2 for o in outs)
    assert sum(o["shards_decoded"] for o in outs) > 0
    from mobiclipdecoder_tpu.parallel.distributed import (gather_corpus,
                                                          run_worker)
    totals = gather_corpus(files, out_mp)
    assert totals == {0: 6, 1: 6}
    # bit-exact vs a single-process decode of the same corpus
    out_sp = tmp_path / "out_sp"
    run_worker(files, out_sp, worker_id=0, n_workers=1, engine="oracle")
    names = sorted(p.name for p in out_sp.glob("*.npy"))
    assert names == sorted(p.name for p in out_mp.glob("*.npy"))
    for name in names:
        np.testing.assert_array_equal(np.load(out_mp / name),
                                      np.load(out_sp / name), err_msg=name)
