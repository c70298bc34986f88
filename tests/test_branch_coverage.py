"""Measured branch-coverage gate over the executable spec.

Replaces the hand-maintained synth.stats counters as the coverage guard
(earlier rounds each shipped a silent format gap — plane modes,
escape-3-only coefficients — that counters did not catch because nothing
*measured* whether every decode branch of models/oracle_video.py and
models/plan.py executes under the suite's corpus).

Mechanism: CPython 3.12 ``sys.monitoring`` BRANCH events record the actual
(instruction, destination) edges taken while a format-surface corpus decodes;
``dis`` enumerates every conditional branch (POP_JUMP_IF_*) statically with
its two possible destinations (jump target + fall-through — verified exact
for these opcodes on this interpreter).  The gate fails when any branch
direction is never taken, unless that direction appears in the justified
exclusion table below.  No third-party coverage package exists in this image;
this is the same arc measurement coverage.py performs, scoped to the two
spec files.

The corpus is the synthesizer's full surface (both profiles, both VLC
tables, dQP ladder, QP clamp edges, big-level escapes, encoder streams,
malformed/truncated packets for the error branches) plus both planner
outputs (unified decode-order stream and the wavefront FramePlan).
"""
from __future__ import annotations

import dis
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import mobiclipdecoder_tpu.models.oracle_video as _oracle_mod
import mobiclipdecoder_tpu.models.plan as _plan_mod
from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.models.plan import PlanningDecoder
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

_TARGETS = {Path(m.__file__).resolve(): m for m in (_oracle_mod, _plan_mod)}
_BRANCH_OPS = frozenset({"POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE",
                         "POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE"})

# Justified never-taken branch directions, keyed by (qualname, stripped
# source line, direction) where direction is "taken" (the jump) or "fall"
# (fall-through).  Every entry must say WHY the direction is unreachable
# on legal + fuzzed input; anything not listed fails the gate.  Compound
# conditions (`a and b`) compile to one instruction per operand sharing a
# source line; an entry excuses only the never-fired instruction(s) on
# that line — fired ones pass on their own.
_EXCLUSIONS: dict[tuple[str, str, str], str] = {
    ("OracleDecoder.decode_frame", "if self._nb < 0:", "taken"):
        "after the 2-byte register preload _nb is exactly 0, so the "
        "P-frame's 1-bit consume always drives it negative (refill always "
        "runs; mirror of MobiclipDecoder.cs:115)",
    ("OracleDecoder._decode_iframe", "if self._nb < 0:", "taken"):
        "the I-frame header consumes 3 bits from _nb == 0, so the refill "
        "check is always true (MobiclipDecoder.cs:226-229)",
    ("OracleDecoder._switch_pblock", "elif 1 <= mode <= 5:", "taken"):
        "the `1 <= mode` operand: mode 0 is handled by the branch above "
        "and the extracted LUTs are total over 0..9, so mode < 1 cannot "
        "reach this elif (tools/extract_tables.py builds complete "
        "partition Huffman tables — every peek pattern maps to a legal "
        "mode, verified in this file's test_partition_luts_are_total)",
    ("OracleDecoder._switch_pblock",
     "elif mode == 6 and (w, h) == (16, 16):", "taken"):
        "the size operand: mode 6 only exists in the 16x16 LUTs "
        "(MobiclipDecoder.cs:469-581 vs the sub-size tables), so "
        "`mode == 6 and size != 16x16` cannot occur",
    ("OracleDecoder._switch_pblock",
     "elif mode == 7 and (w, h) == (16, 16):", "taken"):
        "same as mode 6: 7 only appears in the 16x16 LUTs",
    ("OracleDecoder._switch_pblock", "elif mode in (8, 9):", "taken"):
        "modes reaching this point are exactly {8, 9} (0..7 handled "
        "above; LUTs are total over 0..9), so the else-raise is the "
        "defensive mirror of the reference's unreachable default throw "
        "(MobiclipDecoder.cs:625)",
    ("OracleDecoder._switch_pblock", "except KeyError:", "taken"):
        "every (size, mode 8/9) the LUTs can produce has a _PB_SPLIT "
        "entry (verified in test_partition_luts_are_total); the handler "
        "mirrors the reference's defensive throw",
    ("OracleDecoder._switch_pblock", "except KeyError:", "fall"):
        "same: the KeyError handler is defensive dead code",
    ("OracleDecoder._predict_intra",
     "elif left_avail and not top_avail:", "taken"):
        "the left_avail operand: both no-edge cases (neither avail; top "
        "without left) are handled by the branches above, so left_avail "
        "is true in every state reaching this elif",
    ("OracleDecoder._predict_intra",
     "elif m == 8:  # vertical-left, reads past the block's top-right",
     "taken"):
        "m ranges over 0..8 (3-bit full-MB modes are 0..7; the MPM "
        "scheme maps its 4-bit value to 0..9 and 9/19 exit at the top), "
        "and 0..7 are handled above — the trailing raise is defensive",
    ("pack_unified.<locals>.try_fuse",
     "if ry not in (fy, fy + 8) or rx not in (fx, fx + 8):", "taken"):
        "defensive guard: in decode order a luma residual always belongs "
        "to the immediately preceding MC's macroblock, so its quad "
        "coords always match the fusing 16x16's base",
    ("pack_unified.<locals>.try_fuse",
     "if ry not in (fy, fy + 8) or rx not in (fx, fx + 8):", "fall"):
        "second operand of the same defensive guard (see above)",
    ("pack_unified.<locals>.try_fuse", "if ry != fy >> 1:", "fall"):
        "defensive guard: a chroma residual row always equals the "
        "fusing MB's chroma row in decode order",
    ("pack_unified.<locals>.try_fuse",
     "elif rx == (fx >> 1) + S // 2:", "taken"):
        "a chroma residual column is always the fusing MB's U or V "
        "column; the else (total mismatch) is defensive",
    ("pack_unified.<locals>.try_fuse", 'if bit <= fuse["last"]:', "fall"):
        "defensive: cbp residual emissions are strictly bit-ordered "
        "(luma quads 0..3 then U then V) by the decode loop",
    ("pack_unified.<locals>.try_fuse",
     'elif k != w3 + fuse["n"]:', "fall"):
        "defensive: coefficient rows of one MB's residuals are allocated "
        "consecutively (quad-merged 4x4s reuse their existing row and "
        "return before try_fuse)",
    ("pack_unified.<locals>.pend_add",
     'if (pend["on"] and pend["pid"] == pid and pend["my"] == my', "taken"):
        "the my operand: a pend is only still open while the SAME MB's "
        "residual section streams (every MB begins with MC or intra ops, "
        "which flush), so a same-pid my mismatch cannot occur; the on and "
        "pid operands' false directions both fire",
    ("pack_unified.<locals>.pend_add",
     'and pend["mx"] == mx and bit > pend["last"]', "taken"):
        "same-MB structure: mx always matches when pid and my do, and "
        "cbp residual emissions are strictly bit-ordered (quads 0..3 "
        "luma, U before V)",
    ("pack_unified.<locals>.pend_add",
     'and k == pend["first"] + pend["n"]):', "taken"):
        "coefficient rows of one MB's residuals are allocated "
        "consecutively (quad-merged 4x4s reuse their row and return "
        "before pend_add), so the consecutiveness guard never fails — "
        "it pins the invariant the C++ scanner's deferred-buffer design "
        "relies on",
    ("pack_unified.<locals>.try_attach",
     'if (my, mx) != (leaf_mb["my"], leaf_mb["mx"]):', "fall"):
        "defensive guard: a luma pend always belongs to the same MB as "
        "the buffered leaves — the pend flushes (at the next MC/intra) "
        "before a different MB can buffer leaves, and intra MBs flush "
        "the leaf buffer before their pass-through residuals pend (the "
        "empty-leaves check above fires instead)",
    ("pack_unified.<locals>.try_attach",
     'if hit == li_last and bit <= bit_last:', "fall"):
        "defensive guard: pend mask bits ascend in MB row-major order "
        "and map monotonically to leaf-relative bits within one leaf, "
        "so a same-leaf bit can never arrive out of order",
    ("pack_unified.<locals>.emit_intra",
     'and q > ibat["lastq"]):', "fall"):
        "within a contiguous intra run of one parent block, decode order "
        "visits sub-blocks in ascending q; a same-parent revisit is only "
        "reachable after another op flushed the batch, which the on/base "
        "operands catch first (their false directions fire)",
    ("pack_unified.<locals>.emit_intra",
     'if (ivb["on"] and y == ivb["y"] and x == ivb["x"] + S // 2',
     "taken"):
        "the y/x operands: when a U-half candidate is held, the next "
        "chroma intra op is always its V partner (any intervening op "
        "flushes the hold, making the on operand false — that direction "
        "fires); a same-MB chroma pair always has y_v == y_u and "
        "x_v == x_u + S/2",
    ("pack_unified.<locals>.emit_intra",
     'and mode == ivb["mode"]):', "taken"):
        "U and V of one MB share the single 3-bit chroma mode "
        "(MobiclipDecoder.cs loc_116290), so the pair's modes are always "
        "equal; the guard pins the invariant the one-mode pair op "
        "encoding relies on",
    ("pack_unified.<locals>.emit_resid",
     'if quad["key"] == key and b > quad["b"]:', "taken"):
        "the `b > quad[\"b\"]` operand: sub-4x4 emissions arrive in "
        "ascending quadrant order from the decode loop, so a same-key "
        "out-of-order b never occurs (the new-key direction does fire)",
}


def _static_branches():
    """{(qualname, offset): (set(possible dests), lineno, srcline)} for every
    conditional branch in the target files (module-level code excluded —
    it runs at import, before monitoring starts)."""
    out = {}
    for path in _TARGETS:
        src = path.read_text()
        lines = src.splitlines()
        root = compile(src, str(path), "exec")

        def walk(co):
            yield co
            for c in co.co_consts:
                if isinstance(c, types.CodeType):
                    yield from walk(c)

        for co in walk(root):
            if co.co_qualname == "<module>":
                continue
            insns = list(dis.get_instructions(co))
            for i, ins in enumerate(insns):
                if ins.opname in _BRANCH_OPS:
                    fall = insns[i + 1].offset
                    line = ins.positions.lineno
                    out[(str(path), co.co_qualname, ins.offset)] = (
                        {ins.argval: "taken", fall: "fall"}, line,
                        lines[line - 1].strip() if line else "?")
    return out


class _BranchMonitor:
    TOOL = 4

    def __init__(self):
        self.observed: dict[tuple, set] = {}
        self._files = {str(p) for p in _TARGETS}

    def __enter__(self):
        mon = sys.monitoring
        mon.use_tool_id(self.TOOL, "mobiclip-branchcov")
        mon.register_callback(self.TOOL, mon.events.BRANCH, self._on_branch)
        mon.set_events(self.TOOL, mon.events.BRANCH)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        mon.set_events(self.TOOL, 0)
        mon.register_callback(self.TOOL, mon.events.BRANCH, None)
        mon.free_tool_id(self.TOOL)

    def _on_branch(self, code, ioff, dest):
        if code.co_filename in self._files:
            self.observed.setdefault(
                (code.co_filename, code.co_qualname, ioff), set()).add(dest)


# ---------------------------------------------------------------- corpus
def _decode_all(version, W, H, pkts):
    """Every packet through the oracle AND both planner outputs."""
    dec = OracleDecoder(W, H, version)
    pl = PlanningDecoder(W, H, version)
    for pkt in pkts:
        dec.data = pkt
        dec.offset = 0
        dec.decode_frame()
        pl.data = pkt
        pl.offset = 0
        pl.decode_frame()
        pl.unified_plan()
        pl.plan()


def _legal_corpus():
    # stride policy branches (MobiclipDecoder.cs:50-52): 256 / 512 / 1024
    for W, H in ((288, 32), (544, 32)):
        s = StreamSynthesizer(W, H, MobiclipVersion.MOFLEX_3DS, seed=4)
        _decode_all(MobiclipVersion.MOFLEX_3DS, W, H,
                    [s.iframe(0x18), s.pframe()])
    # Vx stub parity (MobiclipDecoder.cs:63-95): skip blocks, first-frame
    # fresh planes, then the copy-from-previous branch, then the
    # NotImplementedError for any non-skip mode
    from mobiclipdecoder_tpu.utils.bitio import BitWriter
    vx = OracleDecoder(32, 32, MobiclipVersion.VX_DS)
    bw = BitWriter()
    for _ in range(4):
        bw.write_varint_u(1)
    pkt = bw.to_bytes() + b"\x00\x00"
    for _ in range(2):              # None-planes then copy branch
        vx.data = pkt
        vx.offset = 0
        vx.decode_frame()
    bw2 = BitWriter()
    bw2.write_varint_u(2)
    vx.data = bw2.to_bytes() + b"\x00\x00"
    vx.offset = 0
    try:
        vx.decode_frame()
    except NotImplementedError:
        pass
    # rgb epilogue, both color models (MobiclipDecoder.cs:298-312)
    for version in (MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS):
        s = StreamSynthesizer(64, 48, version, seed=6)
        d = OracleDecoder(64, 48, version)
        d.data = s.iframe(0x18)
        d.offset = 0
        d.decode_frame(rgb=True)
    # P-frame as the very first frame: the Moflex quantizer==0 guard
    # (MobiclipDecoder.cs:121-127 builds QP-0 tables); MC against empty
    # ring raises — the parse branch is what we exercise
    s = StreamSynthesizer(64, 48, MobiclipVersion.MOFLEX_3DS, seed=8)
    s.frame_idx = 1                 # let the synthesizer emit a P first
    d = OracleDecoder(64, 48, MobiclipVersion.MOFLEX_3DS)
    try:
        d.data = s.pframe()
        d.offset = 0
        d.decode_frame()
    except Exception:
        pass
    # an op-less frame packs to the empty stream (plan.py:216-219)
    from mobiclipdecoder_tpu.models.plan import pack_unified
    pack_unified([], 256, 48)
    for version in (MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS):
        for W, H, seed in ((64, 48, 0), (96, 64, 1), (32, 32, 2)):
            s = StreamSynthesizer(W, H, version, seed=seed)
            pkts = []
            for i in range(10):
                if i % 5 == 0:
                    pkts.append(s.iframe(0x18, table=(i // 5) & 1))
                else:
                    pkts.append(s.pframe(dq=(0, 2, -1, 3)[i & 3]))
            _decode_all(version, W, H, pkts)
        # big escape-3 levels (dense fallback branch class)
        s = StreamSynthesizer(64, 48, version, seed=7, big_levels=0.3)
        _decode_all(version, 64, 48,
                    [s.iframe(0x18), s.pframe(), s.pframe(dq=1)])
    # Moflex QP clamp edges (MobiclipDecoder.cs:3886-3890)
    v = MobiclipVersion.MOFLEX_3DS
    s = StreamSynthesizer(64, 48, v, seed=5)
    _decode_all(v, 64, 48, [s.iframe(2), s.pframe(dq=-3), s.pframe(dq=5),
                            s.iframe(0x3F, table=1), s.pframe(dq=7)])
    # encoder-generated streams (plain/esc1/esc2/esc3 cascade, half-pel ME)
    from mobiclipdecoder_tpu.models.encoder import MobiclipEncoder
    W, H = 48, 32
    rng = np.random.default_rng(11)
    enc = MobiclipEncoder(W, H, v, quantizer=0x14, gop=3, refs=2, me_range=6)
    yy, xx = np.mgrid[0:H, 0:W]
    pkts = []
    for f in range(4):
        y = (128 + 60 * np.sin(xx / 11 + f / 2) * np.cos(yy / 7)
             + rng.normal(0, 4, (H, W))).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin(xx[::2, ::2] / 13)).clip(0,
                                                        255).astype(np.uint8)
        vv = (128 + 40 * np.cos(yy[::2, ::2] / 9)).clip(0,
                                                        255).astype(np.uint8)
        pkts.append(enc.encode_frame(y, u, vv) + b"\x00\x00")
    _decode_all(v, W, H, pkts)


def _fuzz_corpus():
    """Malformed input: the oracle's reject/raise branches must fire too."""
    for version in (MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS):
        s = StreamSynthesizer(64, 48, version, seed=13)
        base = [s.iframe(0x18), s.pframe(), s.pframe()]
        rng = np.random.default_rng(17)
        cases = []
        for pkt in base:
            arr = np.frombuffer(pkt, np.uint8).copy()
            for _ in range(40):
                a = arr.copy()
                n = int(rng.integers(1, 4))
                pos = rng.integers(0, len(a) * 8, n)
                for p in pos:
                    a[p // 8] ^= 1 << (p % 8)
                cases.append(a.tobytes())
            for cut in (1, 5, len(pkt) // 2, len(pkt) - 3):
                cases.append(pkt[:cut])
        cases.append(b"")
        cases.append(b"\x00\x00")
        dec = OracleDecoder(64, 48, version)
        pl = PlanningDecoder(64, 48, version)
        for c in cases:
            for d in (dec, pl):
                try:
                    d.data = c
                    d.offset = 0
                    d.decode_frame()
                    if d is pl:
                        pl.unified_plan()
                        pl.plan()
                except Exception:
                    pass


def test_every_decode_branch_executes():
    static = _static_branches()
    assert static, "no branches found (dis enumeration broken?)"
    with _BranchMonitor() as bm:
        _legal_corpus()
        _fuzz_corpus()
    missing = []
    for key, (dests, line, src) in sorted(static.items(),
                                          key=lambda t: (t[0][0], t[1][1])):
        seen = bm.observed.get(key, set())
        for dest, direction in dests.items():
            if dest in seen:
                continue
            qual = key[1]
            exkey = (qual, src, direction)
            if exkey in _EXCLUSIONS:
                continue
            fname = Path(key[0]).name
            missing.append(f"{fname}:{line} {qual} [{direction}"
                           f"{' never fired' if not seen else ''}] {src!r}")
    assert not missing, (
        f"{len(missing)} branch direction(s) never executed under the "
        "format-surface corpus — extend the corpus or add a justified "
        "exclusion:\n" + "\n".join(missing))


def test_partition_luts_are_total():
    """The structural fact several exclusions rest on: every peek pattern
    of every partition Huffman LUT maps to a legal mode with a nonzero
    bit count, and every (size, split mode) a LUT can produce has a
    _PB_SPLIT entry — so the oracle's illegal-partition raises are
    defensive mirrors of the reference's unreachable default throws
    (MobiclipDecoder.cs:625)."""
    from mobiclipdecoder_tpu.models.oracle_video import _PB_SPLIT
    from mobiclipdecoder_tpu.tables import TABLES
    for (w, h) in _PB_SPLIT:
        for prof in ("mods", "moflex"):
            mode_lut = TABLES[f"pb{w}x{h}_mode_{prof}"]
            bits_lut = TABLES[f"pb{w}x{h}_bits_{prof}"]
            peek = int(TABLES[f"pb{w}x{h}_peek_{prof}"])
            assert len(mode_lut) == 1 << peek
            modes = {int(m) for m in mode_lut}
            assert modes <= set(range(10)), (w, h, prof, modes)
            assert all(int(bits_lut[m]) > 0 for m in modes), (w, h, prof)
            for m in modes & {8, 9}:
                assert m in _PB_SPLIT[(w, h)], (w, h, prof, m)
            if (w, h) != (16, 16):
                assert not (modes & {6, 7}), (w, h, prof)


# Justified never-executed scanner.cpp lines, matched by stripped source
# text.  Same contract as _EXCLUSIONS: every entry says why the line is
# unreachable on legal + fuzzed input.
_CPP_EXCLUSIONS: dict[str, str] = {
    "return -1;":
        "size_index is only called with sizes from the recursive split "
        "table, all of which are in kSizes (defensive)",
    "fz_flush();":
        "fz_try's mismatch guards: in decode order a residual always "
        "belongs to the fusing MB (same justification as the Python "
        "try_fuse exclusions — the two scanners mirror each other)",
    "return false;":
        "second half of the fz_try mismatch guards above",
    "else { fz_flush(); return false; }":
        "chroma-column mismatch guard of fz_try (same class)",
    "sink->bad = true;  // illegal mode (reference throws)":
        "the partition LUTs are total over legal modes "
        "(test_partition_luts_are_total), so the else-raise mirror of "
        "MobiclipDecoder.cs:625 is unreachable — like the oracle's",
    "return;":
        "the return after the unreachable illegal-mode marker above",
}


def _cpp_corpus(native_mod):
    """The Python corpus's surface through the C++ scanner: legal streams
    (both profiles/tables/geometries, dQP, clamp edges, big levels),
    whole-GOP packed scans, checkpoint/rollback, FramePlan scans, and
    malformed/truncated packets for the reject paths."""
    NativePlanner = native_mod.NativePlanner
    for version in (MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS):
        for W, H, seed in ((64, 48, 0), (96, 64, 1), (288, 32, 4)):
            s = StreamSynthesizer(W, H, version, seed=seed)
            pkts = []
            for i in range(10):
                if i % 5 == 0:
                    pkts.append(s.iframe(0x18, table=(i // 5) & 1))
                else:
                    pkts.append(s.pframe(dq=(0, 2, -1, 3)[i & 3]))
            nv = NativePlanner(W, H, int(version))
            for pkt in pkts[:4]:
                nv.scan_unified(pkt)
                nv.offset = 0
            # whole-GOP packed path + rollback + re-scan
            nv2 = NativePlanner(W, H, int(version))
            nv2.checkpoint()
            nv2.scan_gop_packed(pkts)
            nv2.rollback()
            nv2.scan_gop_packed(pkts)
            # FramePlan scan path
            nv3 = NativePlanner(W, H, int(version))
            nv3.scan(pkts[0])
            nv3.scan(pkts[1])
        # big escape-3 levels: the int16 clip + val_overflow flag
        s = StreamSynthesizer(64, 48, version, seed=7, big_levels=0.5)
        nv = NativePlanner(64, 48, int(version))
        nv.scan_gop_packed([s.iframe(0x18), s.pframe()])
        # malformed packets: reject/err paths (agreement with the oracle is
        # fuzz-tested elsewhere; here they only need to EXECUTE)
        s2 = StreamSynthesizer(64, 48, version, seed=13)
        base = [s2.iframe(0x18), s2.pframe(), s2.pframe()]
        rng = np.random.default_rng(17)
        nv = NativePlanner(64, 48, int(version))
        for pkt in base:
            arr = np.frombuffer(pkt, np.uint8).copy()
            for _ in range(40):
                a = arr.copy()
                for p in rng.integers(0, len(a) * 8, int(rng.integers(1,
                                                                      4))):
                    a[p // 8] ^= 1 << (p % 8)
                try:
                    nv.scan_unified(a.tobytes())
                except Exception:
                    pass
                nv.checkpoint()
                nv.scan_gop_packed([a.tobytes()])
                nv.rollback()
            for cut in (1, 5, len(pkt) // 2):
                try:
                    nv.scan_unified(pkt[:cut])
                except Exception:
                    pass
    # QP clamp edges
    v = MobiclipVersion.MOFLEX_3DS
    s = StreamSynthesizer(64, 48, v, seed=5)
    nv = NativePlanner(64, 48, int(v))
    nv.scan_gop_packed([s.iframe(2), s.pframe(dq=-3), s.pframe(dq=5),
                       s.iframe(0x3F, table=1), s.pframe(dq=7)])
    # headline-size frames: >255 ops/frame force multi-chunk frames, with
    # chunk closes landing on every emission form (fused-MC flushes,
    # batched-residual/intra flushes, row-less MC leaves) across enough
    # frames that each boundary class occurs
    for seed in (21, 23):
        s = StreamSynthesizer(256, 192, MobiclipVersion.MODS_DS, seed=seed)
        nv = NativePlanner(256, 192, int(MobiclipVersion.MODS_DS))
        nv.scan_gop_packed([s.iframe(0x18)]
                           + [s.pframe() for _ in range(10)])
    # output-capacity overflow paths: per-array caps (scan/scan_unified)
    # and the whole-GOP chunk/nnz caps with their frame-edge rewinds
    s = StreamSynthesizer(64, 48, MobiclipVersion.MODS_DS, seed=22)
    pkts = [s.iframe(0x18), s.pframe(), s.pframe()]
    nv = NativePlanner(64, 48, int(MobiclipVersion.MODS_DS))
    nv.UOPS_CAP = 4
    nv.UCOEF_CAP = 4
    for fn, kwargs in ((nv.scan_unified, {}), (nv.scan, {})):
        try:
            fn(pkts[0], **kwargs)
        except Exception:
            pass
    nv2 = NativePlanner(64, 48, int(MobiclipVersion.MODS_DS))
    nv2.MC_CAP = nv2.RES_CAP = nv2.INTRA_CAP = 2
    for pkt in pkts[:2]:
        try:
            nv2.scan(pkt)
        except Exception:
            pass
    full = NativePlanner(64, 48, int(MobiclipVersion.MODS_DS))
    full.checkpoint()
    r = full.scan_gop_packed(pkts)
    full.rollback()
    assert r["done"] == len(pkts)
    f0_nct = int(r["frame_nct"][0])
    f0_nnz = int(r["frame_nnz"][0])
    # chunk-cap exactly one frame: frame 1's open overflows at frame start
    full.checkpoint()
    full.GOP_NCT_CAP = f0_nct
    r2 = full.scan_gop_packed(pkts)
    assert r2["done"] in (0, 1)
    full.rollback()
    # nnz cap mid-frame: the frame is rewound via restore(snap)
    full.GOP_NCT_CAP = NativePlanner.GOP_NCT_CAP
    full.GOP_NNZ_CAP = max(f0_nnz - 1, 1)
    full.checkpoint()
    full.scan_gop_packed(pkts)
    full.rollback()
    # debug/introspection API (used by parity tools)
    import ctypes
    lib = native_mod._load()
    q = ctypes.c_uint32(0)
    lib.scanner_get_state(ctypes.c_void_p(full._ctx), ctypes.byref(q))
    buf = np.zeros(392, np.int32)
    lib.scanner_debug_internal(
        ctypes.c_void_p(full._ctx),
        buf.ctypes.data_as(ctypes.c_void_p))


def test_scanner_cpp_line_coverage(tmp_path):
    """gcov gate over native/scanner.cpp: every executable line of the C++
    scanner runs under the same format-surface corpus, with justified
    exclusions (the native leg of the measured gate)."""
    import shutil
    import subprocess
    pytest.importorskip("jax")  # native module pulls in the engine deps
    if shutil.which("gcov") is None or shutil.which("g++") is None:
        pytest.skip("gcov/g++ unavailable")
    import mobiclipdecoder_tpu.utils.native as native_mod
    src = Path(native_mod._SRC)
    obj = tmp_path / "scanner.o"
    so = tmp_path / "libmobiscan_cov.so"
    subprocess.run(["g++", "-O0", "-std=c++17", "-fPIC", "--coverage",
                    "-c", str(src), "-o", str(obj)], check=True,
                   capture_output=True)
    dump_src = tmp_path / "covdump.cpp"
    dump_src.write_text('extern "C" void __gcov_dump(void);\n'
                        'extern "C" void mobiscan_cov_dump(void)'
                        '{ __gcov_dump(); }\n')
    subprocess.run(["g++", "-shared", "-fPIC", "--coverage", str(obj),
                    str(dump_src), "-o", str(so)], check=True,
                   capture_output=True)
    old_so, old_lib = native_mod._SO, native_mod._lib
    native_mod._SO, native_mod._lib = so, None
    # the instrumented lib must look newer than the source or _load
    # rebuilds over it without instrumentation
    import os
    os.utime(so)
    try:
        _cpp_corpus(native_mod)
        lib = native_mod._load()
        lib.mobiscan_cov_dump()
    finally:
        native_mod._SO, native_mod._lib = old_so, old_lib
    r = subprocess.run(["gcov", "-b", "-o", str(tmp_path), str(src)],
                       check=True, capture_output=True, text=True,
                       cwd=tmp_path)
    gcov_file = tmp_path / (src.name + ".gcov")
    assert gcov_file.exists(), r.stdout + r.stderr
    missing = []
    total = hit = 0
    for raw in gcov_file.read_text().splitlines():
        parts = raw.split(":", 2)
        if len(parts) < 3:
            continue
        count, lineno, text = parts[0].strip(), parts[1].strip(), parts[2]
        if count == "-" or not lineno.isdigit() or int(lineno) == 0:
            continue
        total += 1
        if count != "#####":
            hit += 1
            continue
        stripped = text.strip()
        if stripped in _CPP_EXCLUSIONS:
            continue
        missing.append(f"scanner.cpp:{lineno} {stripped!r}")
    assert total > 500, "gcov produced implausibly few executable lines"
    assert not missing, (
        f"{len(missing)} scanner.cpp line(s) never executed "
        f"({hit}/{total} hit) — extend the corpus or justify:\n"
        + "\n".join(missing))


def test_exclusions_still_exist():
    """Every exclusion must still point at a real (qualname, source line) —
    stale entries fail so the table can't rot."""
    if not _EXCLUSIONS:
        return
    static = _static_branches()
    live = {(q, src) for (_p, q, _o), (_d, _l, src) in static.items()}
    stale = [k for k in _EXCLUSIONS if (k[0], k[1]) not in live]
    assert not stale, f"stale exclusions: {stale}"
