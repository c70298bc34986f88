"""Smoke check of the decode path on an NVIDIA GPU, compiled, bit-exact.

Run from the root of a checkout on a machine with one card:

    python chip_smoke.py               # every correctness phase
    python chip_smoke.py --time        # ... then the kernel-vs-XLA timing
    python chip_smoke.py --four        # only the four-card corpus path

Phases: card identity; compile of the whole-GOP executor at 256x192,
400x240 and 640x480; ``VmemBatchDecoder.decode_gops`` on 8 DS streams x 2
GOPs of 24 frames; the format surface (VLC table 1 with a dQP ladder,
Moflex QP clamps, big levels through the dense upload, encoder-made
streams) at the three geometries; the CLI on a MODS and a Moflex file with
IMA audio against ``--engine oracle``, plus the device audio ops.  Every
decoded frame is compared with models/oracle_video.py bit for bit.

Exits non-zero, without a result line, when JAX finds no GPU or any phase
fails.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Only this process uses the card; helper processes (the oracle pool, the
``--four`` workers) either stay off the card or each own one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GEOMS = {  # name: (W, H, profile, streams, frames, chunk bucket)
    "256x192": (256, 192, "MODS_DS", 8, 24, 76),
    "400x240": (400, 240, "MOFLEX_3DS", 4, 12, 112),
    "640x480": (640, 480, "MOFLEX_3DS", 2, 8, 136),
}


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card(s)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        _fail(f"nvidia-smi failed: {e!r}")
    return out


def _version(name: str):
    from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion
    return getattr(MobiclipVersion, name)


def oracle_frames(W: int, H: int, profile: str, pkts: list[bytes]):
    """Oracle planes (F, H + H/2, S) uint8 of one stream's packets."""
    import numpy as np
    from mobiclipdecoder_tpu.models.oracle_video import OracleDecoder
    dec = OracleDecoder(W, H, _version(profile))
    S = dec.stride
    out = []
    for p in pkts:
        dec.data = p
        dec.offset = 0
        dec.decode_frame()
        out.append(np.concatenate([dec.y_planes[0].reshape(-1, S),
                                   dec.uv_planes[0].reshape(-1, S)]))
    return np.stack(out)


def _pool():
    # spawned workers import numpy and the oracle only: they never touch
    # the card this process holds
    import concurrent.futures as cf
    import multiprocessing as mp
    return cf.ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                  mp_context=mp.get_context("spawn"))


def _assert_same(got, want, tag: str) -> None:
    import numpy as np
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.argwhere(got != want)[:5].tolist()
               if got.shape == want.shape else "shape")
        raise AssertionError(f"{tag}: differs from the oracle at {bad} "
                             f"(got {got.shape}, want {want.shape})")


# ------------------------------------------------------------------ phases
def phase_identity():
    import jax
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        _fail(f"no GPU: JAX's first device is {d.platform!r}")
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}: platform={d.platform} "
          f"kind={d.device_kind} count={len(devs)}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}",
          flush=True)
    return d, len(devs)


def phase_compile() -> None:
    """Compile the executor (with its IDCT pre-pass) once per geometry."""
    import jax
    import jax.numpy as jnp
    from mobiclipdecoder_tpu.ops import vmem_engine as ve
    for name, (W, H, prof, B, F, nct) in GEOMS.items():
        S = 256 if W <= 256 else (512 if W <= 512 else 1024)
        _hh, HB, SB = ve._geom(H, S)
        sds = jax.ShapeDtypeStruct
        args = (sds((B, 6, HB, SB), jnp.uint8),
                sds((B, nct, ve.CHUNK, 4), jnp.int32),
                sds((B, nct, ve.CHUNK, 64), jnp.int32),
                sds((B, nct, ve.CHUNK), jnp.int32))
        t0 = time.perf_counter()
        lowered = ve._decode_gop_fused.trace(*args, F, H, S, False).lower()
        compiled = lowered.compile()
        dt = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        print(f"compile {name} B={B} F={F} nct={nct}: {dt:.2f} s; memory "
              f"args {ma.argument_size_in_bytes} out "
              f"{ma.output_size_in_bytes} temp {ma.temp_size_in_bytes} "
              f"alias {ma.alias_size_in_bytes} bytes", flush=True)


def _ds_gops(seed: int, B: int, F: int, n_gops: int):
    from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer
    synths = [StreamSynthesizer(256, 192, _version("MODS_DS"),
                                seed=seed * 1000 + b) for b in range(B)]
    return [[[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
             for f in range(F)] for _ in range(n_gops)]


def phase_batch(seed: int, pool) -> None:
    """The production batch path: decode_gops, 8 DS streams x 2 GOPs."""
    import numpy as np
    from mobiclipdecoder_tpu.ops.vmem_engine import VmemBatchDecoder
    B, F = 8, 24
    gops = _ds_gops(seed, B, F, 2)
    per_stream = [[gops[g][f][b] for g in range(2) for f in range(F)]
                  for b in range(B)]
    want = [pool.submit(oracle_frames, 256, 192, "MODS_DS", p)
            for p in per_stream]
    bd = VmemBatchDecoder(256, 192, _version("MODS_DS"), batch=B,
                          native=True)
    assert not bd.interpret
    t0 = time.perf_counter()
    got = list(bd.decode_gops(iter(gops)))
    dt = time.perf_counter() - t0
    full = np.concatenate(got, axis=0)            # (2F, B, HH, S)
    for b in range(B):
        _assert_same(full[:, b], want[b].result(), f"decode_gops stream {b}")
    print(f"decode_gops 256x192 MODS B={B} 2x{F} frames (seeds "
          f"{seed * 1000}..{seed * 1000 + B - 1}): {B * 2 * F} frames "
          f"bit-exact vs oracle ({dt:.2f} s incl. compile)", flush=True)


def _encoder_pkts(w: int, h: int, n: int = 3) -> list[bytes]:
    import numpy as np
    from mobiclipdecoder_tpu.models.encoder import MobiclipEncoder
    rng = np.random.default_rng(5)
    enc = MobiclipEncoder(w, h, _version("MOFLEX_3DS"), quantizer=0x14,
                          gop=4, refs=2, me_range=6)
    yy, xx = np.mgrid[0:h, 0:w]
    pkts = []
    for f in range(n):
        y = (128 + 60 * np.sin(xx / 11 + f / 2) * np.cos(yy / 7)
             + rng.normal(0, 4, (h, w))).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin(xx[::2, ::2] / 13)).clip(0, 255) \
            .astype(np.uint8)
        v = (128 + 40 * np.cos(yy[::2, ::2] / 9)).clip(0, 255) \
            .astype(np.uint8)
        pkts.append(enc.encode_frame(y, u, v) + b"\x00\x00")
    return pkts


def _surface_cases(name: str, seed: int):
    """(tag, profile, packets) of the format surface at one geometry."""
    from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer
    W, H, prof, _B, _F, _n = GEOMS[name]
    ver = _version(prof)
    n = 8 if prof == "MODS_DS" else 6
    s1 = StreamSynthesizer(W, H, ver, seed=seed + 1)
    cases = [("default", prof, [s1.iframe(0x18) if i == 0 else s1.pframe()
                                for i in range(n)])]
    s2 = StreamSynthesizer(W, H, ver, seed=seed + 2)
    cases.append(("table1+dqp", prof, [s2.iframe(0x18, table=1),
                                       s2.pframe(dq=2), s2.pframe(dq=-1),
                                       s2.pframe(dq=3)]))
    if prof == "MOFLEX_3DS":
        # QP clamp edges (MobiclipDecoder.cs:3886-3890)
        s3 = StreamSynthesizer(W, H, ver, seed=seed + 3)
        cases.append(("qp-clamp", prof, [s3.iframe(2), s3.pframe(dq=-3),
                                         s3.iframe(0x3F, table=1),
                                         s3.pframe(dq=7)]))
    # big escape-3 levels: the dense-upload fallback path
    s4 = StreamSynthesizer(W, H, ver, seed=seed + 4, big_levels=0.3)
    cases.append(("big-levels", prof, [s4.iframe(0x18), s4.pframe()]))
    # encoder-made stream (full VLC cascade + half-pel ME), Moflex profile
    cases.append(("encoder", "MOFLEX_3DS", _encoder_pkts(W, H)))
    return cases


def phase_surface(seed: int, pool) -> None:
    """The format surface through decode_stream_chunk at 3 geometries."""
    from mobiclipdecoder_tpu.ops.vmem_engine import VmemVideoDecoder
    for name in GEOMS:
        W, H = GEOMS[name][:2]
        cases = _surface_cases(name, seed)
        want = [pool.submit(oracle_frames, W, H, prof, pk)
                for _t, prof, pk in cases]
        decs = {}
        total = 0
        for (tag, prof, pkts), fut in zip(cases, want):
            dec = decs.setdefault(prof, VmemVideoDecoder(
                W, H, _version(prof), native=True))
            yuv, offs, err = dec.decode_stream_chunk(pkts)
            assert err is None and yuv.shape[0] == len(pkts), (tag, err)
            assert offs == [len(p) for p in pkts], tag
            _assert_same(yuv, fut.result(), f"{name} {tag}")
            total += len(pkts)
        print(f"format surface {name}: {total} frames bit-exact vs oracle "
              f"({'/'.join(t for t, _p, _k in cases)})", flush=True)


def phase_cli(seed: int) -> None:
    """`python -m mobiclipdecoder_tpu decode` with the device engine and
    with --engine oracle must write identical .y4m and .wav bytes.  Run in
    this process (a second process could not open the card it holds)."""
    import contextlib
    import io
    import tempfile
    from mobiclipdecoder_tpu.__main__ import main
    from mobiclipdecoder_tpu.testing.containers import mods_file, moflex_file
    files = {
        "clip.mods": mods_file(nframes=10, W=256, H=192, seed=seed,
                               key_at=(0, 5)),
        "clip.moflex": moflex_file(nframes=8, W=400, H=240, seed=seed + 1),
    }
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        for fname, blob in files.items():
            src = td / fname
            src.write_bytes(blob)
            stats = {}
            for eng in ("device", "oracle"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert main(["decode", str(src), str(td / eng),
                                 "--engine", eng]) == 0
                stats[eng] = json.loads(buf.getvalue().strip()
                                        .splitlines()[-1])
            for ext in (".y4m", ".wav"):
                a = (td / f"device{ext}").read_bytes()
                b = (td / f"oracle{ext}").read_bytes()
                assert len(b) > 0 and a == b, f"{fname}{ext} differs"
            print(f"CLI decode {fname}: .y4m and .wav byte-identical to "
                  f"--engine oracle ({stats['device']['frames']} frames, "
                  f"{stats['device']['seconds']} s device engine)",
                  flush=True)
    _device_audio(seed)


def _device_audio(seed: int) -> None:
    """ops/adpcm.py and ops/audio_lpc.py on the card vs the host decoders
    (the CLI decodes audio on the host)."""
    import numpy as np
    from mobiclipdecoder_tpu.models.audio_fastaudio import FastAudioDecoder
    from mobiclipdecoder_tpu.models.audio_ima import (ImaAdpcmDecoder,
                                                      encode_ima)
    from mobiclipdecoder_tpu.ops.adpcm import decode_packets
    from mobiclipdecoder_tpu.ops.audio_lpc import FastAudioBatchDecoder
    rng = np.random.default_rng(seed)
    for _ in range(4):
        t = np.arange(500)
        wave = (3000 * np.sin(t / 7) + rng.integers(-500, 500, 500)) \
            .astype(np.int16)
        pkt = encode_ima(wave, index0=int(rng.integers(0, 40)))
        want = ImaAdpcmDecoder().decode(pkt, 0, len(pkt))
        index0 = int.from_bytes(pkt[0:2], "little", signed=True) & 0x7F
        last0 = int.from_bytes(pkt[2:4], "little", signed=True)
        got = decode_packets(np.frombuffer(pkt[4:], np.uint8),
                             np.int32(index0), np.int32(last0))
        _assert_same(np.asarray(got), want, "IMA ADPCM scan")
    nch = 5
    oracles = [FastAudioDecoder() for _ in range(nch)]
    batch = FastAudioBatchDecoder(nch)
    for _ in range(4):
        pkts = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
                for _ in range(nch)]
        got = batch.decode(pkts)
        for ch, o in enumerate(oracles):
            o.data = pkts[ch]
            o.offset = 0
            _assert_same(np.asarray(got[ch]), o.decode(), "FastAudio")
    print("device audio: IMA ADPCM scan and FastAudio batch bit-exact vs "
          "the host decoders", flush=True)


def phase_time(seed: int, batches=(8, 64), F: int = 24) -> None:
    """The executor against what XLA makes of the wavefront engine
    (models/pipeline.py via parallel/batch.py), DS 256x192 MODS, F=24, at
    B=8 and B=64: host scan apart from device time, and end to end with
    results on the host."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mobiclipdecoder_tpu.ops import vmem_engine as ve
    from mobiclipdecoder_tpu.parallel.batch import (BatchVideoDecoder,
                                                    decode_gop_jit)
    print(f"timing on: {card_line()}", flush=True)
    for B in batches:
        gops = _ds_gops(seed + 7, B, F, 2)
        n = B * F
        # ---- executor: scan+pack, device, end to end
        bd = ve.VmemBatchDecoder(256, 192, _version("MODS_DS"), batch=B,
                                 native=True)
        per = [[gops[0][f][b] for f in range(F)] for b in range(B)]

        def scan_pack():
            for nv in bd.natives:
                nv.checkpoint()
            res = list(bd._pool.map(
                lambda b: bd.natives[b].scan_gop_packed(per[b]), range(B)))
            for nv in bd.natives:
                nv.rollback()
            return ve._assemble_gop_parts([ve._gop_part(r) for r in res])
        blob, nct, nnzb = scan_pack()
        t_scan = min(_timed(scan_pack) for _ in range(3))
        dblob = jax.device_put(blob)
        ring = jnp.zeros_like(bd.ring)           # donated by every step

        def k_step():
            nonlocal ring
            ring, y = ve._decode_gop_fused_sblob(ring, dblob, F, nct, nnzb,
                                                 192, bd.stride,
                                                 bd.interpret)
            return y
        jax.block_until_ready(k_step())                  # compile
        t_dev = min(_timed(lambda: jax.block_until_ready(k_step()))
                    for _ in range(5))
        list(bd.decode_gops(iter(gops[:1])))             # warm
        t0 = time.perf_counter()
        got = sum(a.shape[0] * a.shape[1]
                  for a in bd.decode_gops(iter(gops)))
        k_e2e = got / (time.perf_counter() - t0)
        print(f"executor DS B={B} F={F}: host scan+pack {t_scan * 1e3:.2f}"
              f" ms/GOP; device {t_dev * 1e3:.3f} ms/GOP "
              f"({n / t_dev:.1f} frames/s); end to end decode_gops "
              f"{k_e2e:.1f} frames/s (nct={nct})", flush=True)
        # ---- XLA wavefront engine
        xd = BatchVideoDecoder(256, 192, _version("MODS_DS"), batch=B,
                               native=True)

        def x_scan():
            for nv in xd.natives:
                nv.checkpoint()
            per_frame = [xd.scan_packets(fp) for fp in gops[0]]
            for nv in xd.natives:
                nv.rollback()
            return per_frame
        x_scan()
        t_xscan = min(_timed(x_scan) for _ in range(2))
        per_frame = x_scan()
        stacked = {}
        for k in per_frame[0]:
            arrs = [np.asarray(pf[k]) for pf in per_frame]
            tgt = tuple(max(a.shape[d] for a in arrs)
                        for d in range(arrs[0].ndim))
            stacked[k] = jnp.asarray(np.stack(
                [np.pad(a, [(0, t - s) for s, t in zip(a.shape, tgt)])
                 for a in arrs]))
        keys = ("mc", "resid", "resid_coef", "iops", "icoef", "seqmap",
                "n_levels")

        def x_step():
            return decode_gop_jit(xd.ring, *(stacked[k] for k in keys),
                                  192, xd.stride)
        t0 = time.perf_counter()
        jax.block_until_ready(x_step())
        t_xc = time.perf_counter() - t0
        t_xdev = min(_timed(lambda: jax.block_until_ready(x_step()))
                     for _ in range(3))
        t0 = time.perf_counter()
        for g in gops:
            xd.decode_gop(g)
        x_e2e = 2 * n / (time.perf_counter() - t0)
        print(f"xla wavefront DS B={B} F={F}: host scan+plan "
              f"{t_xscan * 1e3:.2f} ms/GOP; device {t_xdev * 1e3:.3f} "
              f"ms/GOP ({n / t_xdev:.1f} frames/s, first call "
              f"{t_xc:.1f} s); end to end decode_gop {x_e2e:.1f} frames/s",
              flush=True)
        print(f"B={B}: executor/xla end-to-end speedup "
              f"{k_e2e / x_e2e:.2f}x, device speedup {t_xdev / t_dev:.2f}x",
              flush=True)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# ------------------------------------------------------------- four cards
def _four_corpus(td: Path, seed: int) -> list[Path]:
    from mobiclipdecoder_tpu.testing.containers import mods_file
    files = []
    for i in range(4):
        p = td / f"clip{i}.mods"
        p.write_bytes(mods_file(nframes=16, W=256, H=192, seed=seed + i,
                                key_at=(0, 8)))
        files.append(p)
    return files


def four_worker(argv: list[str]) -> None:
    """One --four worker: decode this worker's shards on its one card."""
    import jax
    from mobiclipdecoder_tpu.parallel.distributed import run_worker
    out_dir, k = Path(argv[0]), int(argv[1])
    files = [Path(a) for a in argv[2:]]
    d = jax.devices()
    assert d[0].platform == "gpu" and len(d) == 1, d
    st = run_worker(files, out_dir, worker_id=k, n_workers=4)
    print(json.dumps({"worker": k, "kind": d[0].device_kind, **st}))


def phase_four(seed: int) -> dict:
    """4 worker processes, one per card (CUDA_VISIBLE_DEVICES=k), each
    running run_worker over its share of a synthesized corpus; then
    gather_corpus and every shard against the oracle.  This process stays
    off the cards until the workers have exited."""
    import tempfile
    import numpy as np
    from mobiclipdecoder_tpu.parallel.distributed import (gather_corpus,
                                                          shard_corpus)
    print(f"cards: {card_line()}", flush=True)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        files = _four_corpus(td, seed)
        out = td / "out"
        procs = []
        t0 = time.perf_counter()
        for k in range(4):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(k))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--four-worker", str(out), str(k), *map(str, files)],
                env=env, stdout=subprocess.PIPE, text=True))
        outs = []
        try:
            for p in procs:
                so, _ = p.communicate(timeout=900)
                outs.append(so)
                if p.returncode:
                    _fail(f"four-card worker exited {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        dt = time.perf_counter() - t0
        stats = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        totals = gather_corpus(files, out)
        nshard = 0
        for s in shard_corpus(files):
            got = np.load(out / f"f{s.file_id}_g{s.gop_index}.npy")
            _assert_same(got, oracle_frames(256, 192, "MODS_DS", s.packets),
                         f"shard f{s.file_id} g{s.gop_index}")
            nshard += 1
        who = ", ".join(f"{s['worker']}:{s['kind']}" for s in stats)
        print(f"four cards: {len(stats)} workers ({who}), "
              f"{sum(s['shards_decoded'] for s in stats)} shards, "
              f"{sum(totals.values())} frames; all {nshard} shards bit-exact "
              f"vs oracle ({dt:.1f} s wall incl. worker start and compile)",
              flush=True)
    return stats[0]


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time", action="store_true",
                    help="also time the executor against the XLA engine")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card corpus phase")
    ap.add_argument("--four-worker", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.four_worker:
        four_worker(args.four_worker)
        return 0
    if args.four:
        phase_four(args.seed)
        import jax
        devs = jax.devices()
        if devs[0].platform != "gpu":
            _fail(f"no GPU: JAX's first device is {devs[0].platform!r}")
        print(json.dumps({"ok": True, "device": {
            "platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}}))
        return 0
    dev, count = phase_identity()
    with _pool() as pool:
        for name, run in (("compile", phase_compile),
                          ("batch", lambda: phase_batch(args.seed, pool)),
                          ("surface", lambda: phase_surface(args.seed, pool)),
                          ("cli", lambda: phase_cli(args.seed))):
            t0 = time.perf_counter()
            run()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    if args.time:
        phase_time(args.seed)
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
