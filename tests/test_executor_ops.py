"""The whole-GOP executor kernel, one op class at a time, vs the oracle.

Each case builds a decode-order op list by hand, runs it through the
oracle's reconstruction hooks on random reference planes, and through
pack_unified + the executor kernel (Pallas interpret mode here) on the same
ring; the decoded frames must be identical.  The ops land on a frame whose
macroblocks were first motion-compensated from random references, so every
tap, residual base and half-pel neighbour reads non-trivial pixels.
"""
import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import (MobiclipVersion,
                                                     OracleDecoder)
from mobiclipdecoder_tpu.models.plan import OP_INTRA, OP_MC, OP_RESID, \
    pack_unified

pytest.importorskip("jax")
from mobiclipdecoder_tpu.ops import vmem_engine as ve  # noqa: E402

W, H = 64, 48          # 4 x 3 macroblocks, stride 256
S = 256


def _coef(rng, n):
    """Dense dequantized coefficients and the 'last' cursor that selects
    the full IDCT in the oracle (the kernel's pre-pass is the full IDCT)."""
    c = np.zeros((n, n), np.int32)
    k = rng.integers(1, 6)
    c.flat[rng.integers(0, n * n, k)] = rng.integers(-300, 300, k)
    return c, (63 if n == 8 else 90)


def _mc(rng, y, x, w=16, h=16, hp=None, ref=None):
    """An in-plane MC op; hp=(dx&1, dy&1) forces the half-pel case."""
    ymin, ymax = -2 * y, 2 * (H - h - 2 - y)
    xmin, xmax = -2 * x, 2 * (W - w - 2 - x)
    if hp is None:
        dy = int(rng.integers(ymin, ymax + 1))
        dx = int(rng.integers(xmin, xmax + 1))
    else:
        # bounds are even: an even draw below the top plus the parity
        # bit stays inside them
        dy = int(rng.integers(ymin, ymax)) // 2 * 2 + hp[1]
        dx = int(rng.integers(xmin, xmax)) // 2 * 2 + hp[0]
    ref = int(rng.integers(1, 6)) if ref is None else ref
    return ("mc", w, h, ref, dx, dy, y * S + x)


def _background(rng, skip=()):
    """MC-fill every macroblock except those in ``skip``."""
    return [_mc(rng, y, x) for y in range(0, H, 16) for x in range(0, W, 16)
            if (y, x) not in skip]


def _res(pid, y, x, n, rng):
    return ("resid", pid, y, x, n, _coef(rng, n))


def _intra(pid, y, x, n, mode, rng, grad=0, coefs=True):
    return ("intra", pid, y, x, n, mode, grad,
            _coef(rng, n) if coefs else None)


def _case(name, rng):
    """Op list of one case, plus the op classes it must produce."""
    bg = _background(rng)
    if name.startswith("mc_hp"):
        hp = (int(name[5]), int(name[6]))
        ops = bg + [_mc(rng, 16, 16, hp=hp)] + [
            _res(0, 16 + dy, 16 + dx, 8, rng) for dy in (0, 8)
            for dx in (0, 8)] + [_res(1, 8, 8, 8, rng),
                                 _res(1, 8, 8 + S // 2, 8, rng)]
        return ops, {(OP_MC, None)}
    if name == "mc_res_v_only":
        # fused chroma residual with U absent: V reads the first chroma row
        ops = bg + [_mc(rng, 16, 32, hp=(1, 0)), _res(0, 24, 40, 8, rng),
                    _res(1, 8, 16 + S // 2, 8, rng)]
        return ops, {(OP_MC, None)}
    if name == "mc_leaves":
        # split MB: four 8x8 leaves with residual quads attached
        ops = bg + [_mc(rng, 16 + dy, 32 + dx, 8, 8) for dy in (0, 8)
                    for dx in (0, 8)] + [_res(0, 16, 32, 8, rng),
                                         _res(0, 24, 40, 8, rng)]
        return ops, {(OP_MC, None)}
    if name == "res_8x8":
        return bg + [_intra(0, 16, 16, 8, 9, rng)], {(OP_RESID, 3)}
    if name == "res_quad4x4":
        return bg + [_intra(0, 16 + dy, 16 + dx, 4, 19, rng)
                     for dy, dx in ((0, 0), (0, 4), (4, 4))], \
            {(OP_RESID, 3)}
    if name == "res_masked16":
        return bg + [_intra(0, 16 + dy, 32 + dx, 8, 9, rng)
                     for dy, dx in ((0, 0), (8, 0), (8, 8))], \
            {(OP_RESID, 4)}
    if name == "res_uv":
        return bg + [_intra(1, 8, 16, 8, 9, rng),
                     _intra(1, 8, 16 + S // 2, 8, 9, rng)], {(OP_RESID, 5)}
    if name.startswith("intra8_m"):
        mode = int(name[8:])
        return bg + [_intra(0, 16, 16, 8, mode, rng)], {(OP_INTRA, 3)}
    if name == "intra_quad4x4":
        modes = (10, 14, 17, 18)
        return bg + [_intra(0, 16 + 4 * (q >> 1), 24 + 4 * (q & 1), 4,
                            modes[q], rng, coefs=q != 1)
                     for q in range(4)], {(OP_INTRA, 5)}
    if name == "intra_quad8x8":
        modes = (0, 6, 8, 1)
        return bg + [_intra(0, 16 + 8 * (q >> 1), 16 + 8 * (q & 1), 8,
                            modes[q], rng, coefs=q != 2)
                     for q in range(4)], {(OP_INTRA, 6)}
    if name == "intra_uv_pair":
        return bg + [_intra(1, 8, 8, 8, 5, rng),
                     _intra(1, 8, 8 + S // 2, 8, 5, rng, coefs=False)], \
            {(OP_INTRA, 7)}
    if name.startswith("dc_"):
        y, x, n = {"dc_interior": (16, 16, 8), "dc_top": (0, 16, 8),
                   "dc_left": (16, 0, 8), "dc_corner": (0, 0, 8),
                   "dc_4x4": (20, 36, 4)}[name]
        mode = 3 if n == 8 else 13
        return bg + [_intra(0, y, x, n, mode, rng)], {(OP_INTRA, None)}
    if name == "plane8":
        return bg + [_intra(0, 16, 16, 8, 2, rng, grad=120)], \
            {(OP_INTRA, 3)}
    if name == "plane4":
        return bg + [_intra(0, 20, 36, 4, 12, rng, grad=-110)], \
            {(OP_INTRA, 2)}
    if name == "plane16":
        return bg + [("intra", 0, 16, 16, 16, 2, 127, None)], \
            {(OP_INTRA, 4)}
    if name == "plane8_chroma":
        return bg + [_intra(1, 8, 8 + S // 2, 8, 2, rng, grad=-100)], \
            {(OP_INTRA, 3)}
    raise KeyError(name)


CASES = (["mc_hp00", "mc_hp10", "mc_hp01", "mc_hp11", "mc_res_v_only",
          "mc_leaves",
          "res_8x8", "res_quad4x4", "res_masked16", "res_uv"]
         + [f"intra8_m{m}" for m in (0, 1, 4, 5, 6, 7, 8)]
         + ["intra_quad4x4", "intra_quad8x8", "intra_uv_pair",
            "dc_interior", "dc_top", "dc_left", "dc_corner", "dc_4x4",
            "plane8", "plane4", "plane16", "plane8_chroma"])


def _oracle_run(ops, refs_y, refs_uv):
    o = OracleDecoder(W, H, MobiclipVersion.MODS_DS)
    for r in range(1, 6):
        o.y_planes[r] = refs_y[r - 1].reshape(-1).copy()
        o.uv_planes[r] = refs_uv[r - 1].reshape(-1).copy()
    o.y_planes[0] = np.zeros(S * H, np.uint8)
    o.uv_planes[0] = np.zeros(S * H // 2, np.uint8)
    for op in ops:
        if op[0] == "mc":
            o._exec_mc(*op[1:])
        elif op[0] == "resid":
            _, pid, y, x, n, cf = op
            plane = o.y_planes[0] if pid == 0 else o.uv_planes[0]
            o._exec_resid(plane, y * S + x, n, cf)
        elif op[4] == 16:
            o._plane16(o.y_planes[0], op[2] * S + op[3], op[6])
        else:
            _, pid, y, x, n, mode, grad, cf = op
            plane = o.y_planes[0] if pid == 0 else o.uv_planes[0]
            o._exec_intra(plane, y * S + x, n, mode, grad, cf)
    return np.concatenate([o.y_planes[0].reshape(H, S),
                           o.uv_planes[0].reshape(H // 2, S)])


@pytest.mark.parametrize("name", CASES)
def test_executor_op_class_matches_oracle(name):
    rng = np.random.default_rng(CASES.index(name))
    refs_y = rng.integers(0, 256, (5, H, S), dtype=np.uint8)
    refs_uv = rng.integers(0, 256, (5, H // 2, S), dtype=np.uint8)
    ops, want_classes = _case(name, rng)
    plan = pack_unified(ops, S, H)
    rows = plan["ops"][1:1 + int(plan["ops"][0, 0])]
    got_classes = {(int(w) & 3, (int(w) >> 2) & 7) for w in rows[:, 0]}
    for typ, sl in want_classes:
        assert any(t == typ and (sl is None or s == sl)
                   for t, s in got_classes), (name, got_classes)
    want = _oracle_run(ops, refs_y, refs_uv)

    ops4, coefs, sizes = ve._pack_gop_chunks([[plan]], 1)
    _hh, HB, SB = ve._geom(H, S)
    ring = np.zeros((1, 6, HB, SB), np.uint8)
    for r in range(1, 6):
        # frame 0 writes slot 5; its reference r reads slot r - 1
        ring[0, r - 1, 8:8 + H, 8:8 + S] = refs_y[r - 1]
        ring[0, r - 1, 8 + H:8 + H + H // 2, 8:8 + S] = refs_uv[r - 1]
    ring2, yuv = ve._decode_gop_fused(ring, ops4, coefs, sizes, 1, H, S,
                                      True)
    got = np.asarray(yuv)[0, 0]
    bad = np.argwhere(got != want)
    assert bad.size == 0, f"{name}: {len(bad)} pixels differ, first " \
                          f"{bad[:5].tolist()}"
    # the decoded frame is the ring's new slot 0, references shift down
    np.testing.assert_array_equal(np.asarray(ring2)[0, 0, 8:8 + H + H // 2,
                                                    8:8 + S], want)
    np.testing.assert_array_equal(np.asarray(ring2)[0, 1], ring[0, 0])
