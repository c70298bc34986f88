"""Multi-host corpus decoding: `jax.distributed` runtime + worker loop.

The codec's scaling story (SURVEY.md §5): GOPs are fully independent
(keyframes reset every piece of decoder state), so corpus-level scaling is
data parallelism over GOP shards — workers take shards by deterministic
assignment, each decodes its shards through the whole-GOP executor on its
own card, and results land in per-shard files that a driver gathers.
Nothing crosses between cards; scaling efficiency is bounded only by host
scan throughput and shard balance (assign_shards is size-balanced).

Launch form: ONE worker process per card.  A JAX process reserves most of
the memory of every card it can see, so a worker pins itself to one card
(``pin_worker_card``) before it first touches the device.

The worker is restartable: a JSONL ledger records finished (file, gop) pairs
(ShardProgress), mirroring the reference's JumpToKeyFrame seek design
(ModsDemuxer.cs:88-95) — decoder state is never checkpointed because
keyframes rebuild all of it (MobiclipDecoder.cs:231-236).
"""
from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

import numpy as np

from ..models.oracle_video import MobiclipVersion
from .gop import (GopShard, ShardProgress, assign_shards, shard_mods,
                  shard_moflex)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize the jax.distributed runtime (DCN rendezvous).  Returns
    (process_id, num_processes).  With no arguments, runs standalone."""
    import jax
    if coordinator is None:
        return 0, 1
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index(), jax.process_count()


def _count_cards() -> int:
    """Cards on this machine per nvidia-smi, 0 where there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=index",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return len([ln for ln in out.splitlines() if ln.strip()])


def pin_worker_card(worker_id: int, env=None, n_cards=None) -> str | None:
    """Restrict this process to one card: worker k takes card k modulo the
    cards it may use (``CUDA_VISIBLE_DEVICES`` when set, else every card
    nvidia-smi lists).  A process already restricted to one card keeps it.
    Returns the card id, or None when there is no card to pin (CPU runs).
    Takes effect only before JAX first initializes its GPU backend."""
    env = os.environ if env is None else env
    vis = env.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        cards = [c.strip() for c in vis.split(",") if c.strip()]
    else:
        n = _count_cards() if n_cards is None else n_cards
        cards = [str(i) for i in range(n)]
    if not cards:
        return None
    card = cards[worker_id % len(cards)]
    env["CUDA_VISIBLE_DEVICES"] = card
    return card


def shard_corpus(files: list[str | Path]) -> list[GopShard]:
    """Cut every container file of a corpus into GOP shards."""
    shards: list[GopShard] = []
    for fid, f in enumerate(files):
        data = Path(f).read_bytes()
        if data[:4] == b"MODS":
            shards.extend(shard_mods(data, file_id=fid))
        elif data[:2] == b"\x4c\x32":
            shards.extend(shard_moflex(data, file_id=fid))
        else:
            raise ValueError(f"{f}: not a GOP-shardable container")
    return shards


def _load_ledger(path: Path) -> ShardProgress:
    prog = ShardProgress()
    if path.exists():
        for line in path.read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                prog.done.add((rec["file_id"], rec["gop_index"]))
    return prog


def run_worker(files: list[str | Path], out_dir: str | Path,
               worker_id: int = 0, n_workers: int = 1,
               width: int | None = None, height: int | None = None,
               engine: str = "device", batch: int = 8) -> dict:
    """Decode this worker's GOP shards to per-shard .yuv files.

    Idempotent: a ledger at <out_dir>/worker<k>.ledger.jsonl records finished
    shards; rerunning (e.g. after a preemption) resumes from partial
    progress.  With the device engine the process first pins itself to one
    card (``pin_worker_card``), unless JAX was told to run on the CPU.
    Returns summary stats."""
    import jax
    from ..runtime.transcode import probe_info
    if engine == "device" and (jax.config.jax_platforms or "") != "cpu":
        pin_worker_card(worker_id)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ledger_path = out_dir / f"worker{worker_id}.ledger.jsonl"
    prog = _load_ledger(ledger_path)

    all_shards = shard_corpus(files)
    mine = assign_shards(all_shards, n_workers, worker_id)
    pending = prog.pending(mine)

    # geometry + codec profile per file
    geos = {}
    for fid, f in enumerate(files):
        info = probe_info(f)
        if info["container"] == "moflex":
            vs = [s for s in info["streams"] if s["type"] == "video"][0]
            geos[fid] = (vs["width"], vs["height"],
                         MobiclipVersion.MOFLEX_3DS)
        else:
            geos[fid] = (info["width"], info["height"],
                         MobiclipVersion.MODS_DS)

    frames = 0

    def _finish(shard, out, ledger):
        nonlocal frames
        np.save(out_dir / f"f{shard.file_id}_g{shard.gop_index}.npy", out)
        ledger.write(json.dumps({"file_id": shard.file_id,
                                 "gop_index": shard.gop_index,
                                 "frames": shard.frame_count}) + "\n")
        ledger.flush()
        prog.mark(shard)
        frames += shard.frame_count

    with open(ledger_path, "a") as ledger:
        if engine == "device":
            # lockstep batching: group same-(geometry, length) shards and
            # decode up to `batch` of them per whole-GOP launch (one
            # program per stream: many streams at once fill the card)
            groups: dict[tuple, list] = {}
            for shard in pending:
                key = geos[shard.file_id] + (shard.frame_count,)
                groups.setdefault(key, []).append(shard)
            from ..ops.vmem_engine import VmemBatchDecoder
            for (W, H, ver, F), shards in groups.items():
                for i in range(0, len(shards), batch):
                    grp = shards[i:i + batch]
                    bd = VmemBatchDecoder(W, H, ver, batch=len(grp))
                    gop = [[grp[b].packets[f] for b in range(len(grp))]
                           for f in range(F)]
                    out = bd.decode_gop(gop)  # (F, B, HH, S)
                    for b, shard in enumerate(grp):
                        _finish(shard, out[:, b], ledger)
        else:
            for shard in pending:
                W, H, ver = geos[shard.file_id]
                dec = _make_decoder(W, H, engine, ver)
                planes = []
                for pkt in shard.packets:
                    y, uv = _decode_one(dec, pkt)
                    planes.append(np.concatenate([y, uv], axis=0))
                _finish(shard, np.stack(planes), ledger)
    return {"worker": worker_id, "n_workers": n_workers,
            "shards_total": len(mine), "shards_decoded": len(pending),
            "shards_skipped": len(mine) - len(pending), "frames": frames}


def _make_decoder(W: int, H: int, engine: str,
                  version=MobiclipVersion.MODS_DS):
    if engine == "oracle":
        from ..models.oracle_video import OracleDecoder
        return OracleDecoder(W, H, version)
    from ..ops.vmem_engine import VmemVideoDecoder
    return VmemVideoDecoder(W, H, version)


def _decode_one(dec, pkt: bytes):
    from ..models.oracle_video import OracleDecoder
    if isinstance(dec, OracleDecoder):
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        S = dec.stride
        return (dec.y_planes[0].reshape(-1, S),
                dec.uv_planes[0].reshape(-1, S))
    return dec.decode_frame(pkt)


def gather_corpus(files: list[str | Path], out_dir: str | Path) -> dict:
    """Host-0 gather: verify every (file, gop) shard result is present and
    stitch per-file frame counts.  Returns {file_id: total_frames}."""
    out_dir = Path(out_dir)
    shards = shard_corpus(files)
    totals: dict[int, int] = {}
    for s in shards:
        p = out_dir / f"f{s.file_id}_g{s.gop_index}.npy"
        if not p.exists():
            raise FileNotFoundError(f"missing shard result {p}")
        arr = np.load(p)
        assert arr.shape[0] == s.frame_count
        totals[s.file_id] = totals.get(s.file_id, 0) + s.frame_count
    return totals
