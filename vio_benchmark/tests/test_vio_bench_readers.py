"""The per-layer readers on a synthetic trace, and the trace's reduction."""

import json

import numpy as np
import pytest

from vio_benchmark import registry
from vio_benchmark.yardstick import peaks, trace, work

NAMES = ["sweep_wall_frames_per_s", "fleet_step_ms_p95", "host_syncs_per_step", "frontend_host_ms_per_step",
         "backend_host_ms_per_step", "k2_roofline", "k11_roofline", "device_idle_share",
         "cuda_launches_per_step"]
K2 = "void (anonymous namespace)::pyramid_kernel<4>(Args)"
K11 = "void (anonymous namespace)::update_kernel<float, 8>(UpdateArgs)"


def synthetic(device=True):
    dev = [(K2, 0.0, 100.0), ("Memcpy DtoH (Device -> Pinned)", 150.0, 160.0),
           (K11, 300.0, 700.0), ("void at::native::elementwise_kernel<128>(int)", 650.0, 800.0)]
    host = [("backend_step_fleet", 90.0, 1000.0), ("aten::item", 160.0, 300.0),
            ("frontend_step_fleet", 0.0, 90.0), ("aten::copy_", 100.0, 150.0)]
    k2 = work.k2_work(63, 480, 752, 4, 17)
    k11 = work.k11_work(141, 4, 20, 1680, [26, 77])
    return {"steps": 40, "instance_frames": 2520, "window_s": 2.0, "step_s": [0.05] * 36 + [0.1, 0.2, 0.3, 0.4], "host_syncs": 180,
            "span_s": {"frontend_step_fleet": 0.8, "backend_step_fleet": 1.6},
            "profile": {"window_s": 0.001, "steps": 2, "launches": 3600,
                        "device": dev if device else [], "host": host,
                        "k2_calls": [k2], "k11_calls": [k11]}}


def read(name, t):
    return registry.load_reader(name)(t)


def test_every_metric_has_a_reader_and_a_layer():
    bench = json.loads((registry.ROOT.parent / "BENCHMARK.json").read_text())
    assert sorted(m["name"] for m in bench["per_layer"]) == sorted(NAMES)
    for m in bench["per_layer"]:
        assert callable(registry.load_reader(m["name"]))
        assert m["moves"] == "device_frames_per_s"


def test_readers_on_a_synthetic_trace():
    t = synthetic()
    assert read("sweep_wall_frames_per_s", t) == 1260.0
    assert read("fleet_step_ms_p95", t) == pytest.approx(200.0)
    assert read("host_syncs_per_step", t) == 4.5
    assert read("frontend_host_ms_per_step", t) == pytest.approx(20.0)
    assert read("backend_host_ms_per_step", t) == pytest.approx(40.0)
    assert read("cuda_launches_per_step", t) == 1800
    # busy: [0, 100] + [150, 160] + [300, 800] = 610 us of a 1000 us window
    assert read("device_idle_share", t) == pytest.approx(39.0)
    b, o = t["profile"]["k2_calls"][0]
    assert read("k2_roofline", t) == pytest.approx(100 * peaks.bound(b, o)[0] / 100e-6)
    b, o = t["profile"]["k11_calls"][0]
    assert read("k11_roofline", t) == pytest.approx(100 * peaks.bound(b, o)[0] / 400e-6)


def test_missing_device_events_report_nothing():
    t = synthetic(device=False)
    for name in ("k2_roofline", "k11_roofline", "device_idle_share"):
        assert read(name, t) is None, name
    t = synthetic()
    t["profile"]["device"] = [d for d in t["profile"]["device"] if "update_kernel" not in d[0]]
    assert read("k11_roofline", t) is None
    assert read("k2_roofline", t) is not None
    t["profile"] = None
    assert read("cuda_launches_per_step", t) is None


def test_kernel_names_and_breakdown():
    assert trace.kernel_name(K11) == "update_kernel"
    assert trace.kernel_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    p = synthetic()["profile"]
    assert trace.busy_seconds(p["device"]) == pytest.approx(610e-6)
    ops = trace.device_ops(p["device"])
    assert ops[0][0] == "update_kernel" and ops[0][1] == pytest.approx(400e-6)
    gaps = trace.idle_gaps(p["device"], p["host"], ("frontend_step_fleet", "backend_step_fleet"))
    assert gaps == [["backend_step_fleet: aten::item", pytest.approx(140e-6)],
                    ["backend_step_fleet: aten::copy_", pytest.approx(50e-6)]]


def test_union_of_device_intervals():
    s = np.array([300, 0, 150, 650, 50], np.int64)
    e = np.array([700, 100, 160, 800, 90], np.int64)
    assert trace.union_ns(s, e) == 610.0
    assert trace.union_ns(s[:0], e[:0]) == 0.0


def test_device_busy_over_segments():
    """The segmented profile on the CPU's own activity: every segment's
    events are read, none twice, and the union is no longer than the wall."""
    import time

    import torch

    busy = trace.DeviceBusy(torch.profiler.ProfilerActivity.CPU, torch.autograd.DeviceType.CPU,
                            skip=("aten::ones",))
    x = torch.ones(256, 256)
    t0 = time.perf_counter()
    busy.start()
    for _ in range(3):
        for _ in range(4):
            x = torch.mm(x, x).clamp_(-1, 1)
        busy.cut()
    busy.stop()
    wall = time.perf_counter() - t0
    seconds, counts = busy.read()
    assert len(counts) == 4 and counts[-1] == 0
    assert counts[0] == counts[1] == counts[2] > 0
    assert 0 < seconds <= wall
    assert busy.read() == (0.0, [])
