"""Each kernel's count of work reproduces the bound column of PERF.md's
kernel table at S = 8, 1920x1088, R = 16: K1 0.166 ms of bytes and
0.272 ms of operations, K2a 0.332 ms, K2b 0.025 ms, K4 0.420 ms."""

from types import SimpleNamespace

import pytest

from portbench import catalog, peaks, roofline
from portbench.kernels import sad8x8, sad16, windows

H100 = peaks.of("NVIDIA H100 80GB HBM3")
S, W, H, R = 8, 1920, 1088, 16


def ms(nbytes, ops=0):
    return (nbytes / H100["hbm_bytes_s"] * 1e3,
            ops / H100["int32_ops_s"] * 1e3)


@pytest.mark.parametrize("name,work,want", [
    ("K1", lambda: sad16.k1(S, W, H, R), (0.166, 0.272)),
    ("K4", lambda: sad8x8.k4(S, W, H, R), (0.420, 0.272)),
    ("K2a", lambda: (windows.k2a(S, W, H), 0), (0.332, 0.0)),
    ("K2b", lambda: (windows.k2b(S, W, H), 0), (0.025, 0.0)),
])
def test_bounds_at_s8(name, work, want):
    t_b, t_o = ms(*work())
    assert (round(t_b, 3), round(t_o, 3)) == want


def cell_readings(inter, kernels, slots=1):
    cfg = {"param": {"analyse.inter": inter,
                     "analyse.i_me_method": "ME_DIA"}}
    return SimpleNamespace(config=cfg, S=S, W=W, H=H, me_range=R,
                           device_name="NVIDIA H100 80GB HBM3",
                           trace={"slots": slots, "kernels": kernels})


def test_sad_roofline_takes_the_cells_surface():
    k1_s = 0.552e-3
    r = cell_readings(0, {"_Z20sad_surface16_kernel4Args": 2 * k1_s}, 2)
    pct, term = roofline.share(r, "sad")
    assert term == "operations"
    assert abs(pct - 100 * 0.2720 / 0.552) < 0.1
    r = cell_readings("ANALYSE_PSUB16x16",
                      {"sad_surfaces_8x8_kernel": 0.996e-3})
    pct, term = roofline.share(r, "sad")
    assert term == "bytes" and abs(pct - 100 * 0.420 / 0.996) < 0.1
    # no launch of the family traced: nothing to read
    assert roofline.share(cell_readings(0, {"other": 1.0}), "sad") is None
    assert catalog.metric("sad_roofline").read(
        SimpleNamespace(trace=None)) is None


def test_every_kernel_file_names_its_family():
    fams = {k.ROOFLINE for k in catalog.kernels()}
    assert {"sad", "windows"} <= fams
    for k in catalog.kernels():
        assert k.DEVICE_KERNELS and callable(k.work)
