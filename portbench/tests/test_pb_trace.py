"""The reduction of a profiler trace on a synthetic event list: busy
time as the union of device activity, the operation count, the idle
share, the longest gaps with the host operation over them."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench import catalog, trace


def ev(name, start, end, device):
    tr = SimpleNamespace(start=start, end=end,
                         elapsed_us=lambda s=start, e=end: e - s)
    return SimpleNamespace(name=name, time_range=tr,
                           device_type=DeviceType.CUDA if device
                           else DeviceType.CPU)


def test_union_gaps_and_counts():
    events = [ev("k1", 0, 100, True), ev("k2", 50, 150, True),
              ev("k1", 400, 500, True), ev("k3", 520, 540, True),
              ev("aten::where", 160, 390, False),
              ev("aten::add", 200, 300, False)]
    rec = trace.reduce(events, window_s=1e-3, slots=2)
    assert rec["busy_s"] == (150 + 100 + 20) / 1e6
    assert rec["device_ops"] == 4
    assert abs(rec["kernels"]["k1"] - 200 / 1e6) < 1e-12
    gaps = rec["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::add", 250 / 1e6]    # innermost over 275
    assert gaps[1][1] == 20 / 1e6
    r = SimpleNamespace(trace=rec)
    idle = catalog.metric("device_idle_pct").read(r)
    assert abs(idle - 100 * (1 - 270e-6 / 1e-3)) < 1e-9
    assert catalog.metric("device_ops_per_slot").read(r) == 2


def test_no_device_activity_reads_nothing():
    rec = trace.reduce([ev("aten::add", 0, 10, False)], 1e-3, 1)
    r = SimpleNamespace(trace=rec)
    assert catalog.metric("device_idle_pct").read(r) is None
    assert catalog.metric("device_ops_per_slot").read(r) is None
