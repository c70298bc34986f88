"""Native C++ scanner: plan equality with the Python planner, and speed."""
import shutil
import time

import numpy as np
import pytest

from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu.models.plan import PlanningDecoder
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

if shutil.which("g++") is None:
    pytest.skip("no C++ toolchain", allow_module_level=True)

from mobiclipdecoder_tpu.utils.native import NativePlanner  # noqa: E402


def _plans_equal(a, b, ctx=""):
    np.testing.assert_array_equal(a.mc, b.mc, err_msg=f"{ctx} mc")
    np.testing.assert_array_equal(a.resid, b.resid, err_msg=f"{ctx} resid")
    np.testing.assert_array_equal(a.resid_coef, b.resid_coef,
                                  err_msg=f"{ctx} resid_coef")
    np.testing.assert_array_equal(a.intra, b.intra, err_msg=f"{ctx} intra")
    np.testing.assert_array_equal(a.intra_coef, b.intra_coef,
                                  err_msg=f"{ctx} intra_coef")
    np.testing.assert_array_equal(a.seq_y, b.seq_y, err_msg=f"{ctx} seq_y")
    np.testing.assert_array_equal(a.seq_uv, b.seq_uv, err_msg=f"{ctx} seq_uv")
    assert a.n_levels == b.n_levels, ctx


@pytest.mark.parametrize("version", [MobiclipVersion.MODS_DS,
                                     MobiclipVersion.MOFLEX_3DS])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_plans_match_python(version, seed):
    W, H, F = 64, 48, 4
    synth = StreamSynthesizer(W, H, version, seed=seed)
    py = PlanningDecoder(W, H, version)
    nat = NativePlanner(W, H, int(version))
    for f in range(F):
        pkt = synth.iframe(0x18) if f == 0 else synth.pframe()
        py.data = pkt
        py.offset = 0
        py.decode_frame()
        plan_py = py.plan()
        plan_nat = nat.scan(pkt)
        _plans_equal(plan_py, plan_nat, ctx=f"v{version} s{seed} f{f}")
        assert py.offset == nat.offset


def test_native_speedup():
    W, H, F = 256, 192, 8
    synth = StreamSynthesizer(W, H, MobiclipVersion.MODS_DS, seed=7)
    pkts = [synth.iframe(0x18) if f == 0 else synth.pframe()
            for f in range(F)]
    py = PlanningDecoder(W, H, MobiclipVersion.MODS_DS)
    t0 = time.perf_counter()
    for pkt in pkts:
        py.data = pkt
        py.offset = 0
        py.decode_frame()
        py.plan()
    t_py = time.perf_counter() - t0
    nat = NativePlanner(W, H, int(MobiclipVersion.MODS_DS))
    t0 = time.perf_counter()
    for pkt in pkts:
        nat.scan(pkt)
    t_nat = time.perf_counter() - t0
    assert t_nat < t_py / 4, (t_py, t_nat)


def test_native_unified_stream_matches_python():
    """scanner_scan_unified must be bit-identical to
    PlanningDecoder.unified_plan() (ops to the executor engine)."""
    import numpy as np
    from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion
    from mobiclipdecoder_tpu.models.plan import PlanningDecoder
    from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer
    from mobiclipdecoder_tpu.utils.native import NativePlanner

    for ver in (MobiclipVersion.MODS_DS, MobiclipVersion.MOFLEX_3DS):
        W, H = 64, 48
        s = StreamSynthesizer(W, H, ver, seed=2)
        py = PlanningDecoder(W, H, ver)
        nat = NativePlanner(W, H, int(ver))
        for i in range(4):
            pkt = s.iframe(0x18) if i == 0 else s.pframe()
            py.data = pkt
            py.offset = 0
            py.decode_frame()
            up = py.unified_plan()
            un = nat.scan_unified(pkt)
            assert (up["ops"] == un["ops"]).all()
            assert (up["coefs"] == un["coefs"]).all()
            assert (up["sizes"] == un["sizes"]).all()
            assert py.offset == nat.offset
