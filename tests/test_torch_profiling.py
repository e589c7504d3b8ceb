"""The port's recorder (``utils/profiling.py``) on the CPU: spans and
counters off by default and free of torch calls, their nesting, and the
stage spans, host reads by site and work counters of the fleet step and of
the single stream, at the 94x60 size of tests/test_torch_fleet.py.

The fleet stretch: B = 3 instances over 10 frames, instance 1 inactive on
the first 3 (the back-end gathers the active ones), instance 0's tracks cut
after frame 6 (its lost pass alone, with an overflow pass and K11's QR
tier), and the 8-camera window full from frame 7 (the prune, K12).  It runs
twice, the recorder off and on.
"""

import types

import pytest
import torch

from tests.test_torch_fleet import B, STRIDE, T, fleet_frames, render, starve, tiny_config
from uav_airvision_tpu_torch import device
from uav_airvision_tpu_torch.models import vio
from uav_airvision_tpu_torch.parallel import fleet
from uav_airvision_tpu_torch.profile_main import count_under
from uav_airvision_tpu_torch.utils import profiling, tree
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
CUT = 6  # instance 0's tracks are cut after this many frames
BACKEND_SPANS = sorted(n for n in profiling.SPANS
                       if n == "backend" or n.startswith("be.")
                       or (n.startswith("sync.be.") and n != "sync.be.reset"))


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _raise(*args, **kwargs):
    raise AssertionError("the recorder called into torch while off")


def test_recorder_off_records_nothing_and_calls_no_torch(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", _raise)
    for _ in range(3):
        with profiling.span("fleet.step"):
            with profiling.span("backend"):
                profiling.count("k11.rows", 7)
    assert profiling.records() == []
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert profiling.span("frontend") is profiling.span("backend")  # one shared no-op


def test_recorder_nests_steps_and_counts():
    with profiling.recording():
        for _ in range(2):
            with profiling.span("fleet.step"):
                with profiling.span("backend"):
                    with profiling.span("be.lost"):
                        profiling.count("k11.updates.T1")
                        profiling.count("k11.rows", 26)
                with profiling.span("frontend"):
                    pass
    assert not profiling.enabled()
    recs = profiling.records()
    assert [(s, n, p) for s, n, p, _, _ in recs[:4]] == [
        (1, "be.lost", "backend"), (1, "backend", "fleet.step"), (1, "frontend", "fleet.step"),
        (1, "fleet.step", None)]
    assert [r[0] for r in recs[4:]] == [2] * 4
    assert all(t0 <= t1 for *_, t0, t1 in recs)
    snap = profiling.snapshot()
    assert {n: c for n, (_, c) in snap["spans"].items()} == {
        "fleet.step": 2, "backend": 2, "be.lost": 2, "frontend": 2}
    outer = snap["spans"]["fleet.step"][0]
    assert 0 < snap["spans"]["be.lost"][0] <= snap["spans"]["backend"][0] <= outer
    assert snap["counters"] == {"k11.updates.T1": 2, "k11.rows": 52}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_recorder_takes_declared_names_and_host_ints():
    with profiling.recording():
        with pytest.raises(KeyError):
            profiling.span("be.unknown")
        with pytest.raises(KeyError):
            profiling.count("k13.updates")
        with pytest.raises(TypeError):  # a device value would make the count a host read
            profiling.count("k11.rows", torch.tensor(3))
    assert set(profiling.COUNTERS) >= {f"sync.{s}" for s in profiling.SYNC_SITES}
    assert set(profiling.SPANS) >= {f"sync.{s}" for s in profiling.SYNC_SITES}


@pytest.fixture(scope="module")
def stretch():
    """The fleet stretch, the recorder off and then on: {mode: (state,
    outputs, host reads, snapshot)}."""
    cfg = tiny_config()
    pb, cam0, cam1 = render(cfg, T + STRIDE * (B - 1))
    frames = fleet_frames(vio.frames_from_prebatch(pb, cam0, cam1, CPU))
    active = frames.active.clone()
    active[:3, 1] = False
    frames = frames._replace(active=active)

    def run():
        n0 = device.host_syncs["sync"]
        state, out1 = fleet.run_fleet(cfg, vio.VioFrame(*(x[:CUT] for x in frames)),
                                      pb.gyro_bias, pb.acc_mean)
        state = state._replace(frontend=starve(state.frontend, 0))
        state, out2 = fleet.run_fleet(cfg, vio.VioFrame(*(x[CUT:] for x in frames)),
                                      pb.gyro_bias, pb.acc_mean, state=state)
        out = type(out1)(*(torch.cat(xs) for xs in zip(out1, out2)))
        return state, out, device.host_syncs["sync"] - n0

    runs = {"off": (*run(), profiling.snapshot())}
    with profiling.recording():
        runs["on"] = (*run(), profiling.snapshot())
    return runs


def test_fleet_stretch_records_every_backend_stage(stretch):
    *_, off = stretch["off"]
    *_, snap = stretch["on"]
    assert off == {"spans": {}, "counters": {}}
    assert [n for n in BACKEND_SPANS if n not in snap["spans"]] == []
    for name in ("fleet.init", "fleet.step", "frontend", "fe.pyramid", "fe.first_frame",
                 "fe.predict", "fe.track", "fe.detect", "fe.stereo", "fe.select", "fe.publish"):
        assert name in snap["spans"], name
    spans = snap["spans"]
    assert spans["fleet.step"][1] == T and spans["backend"][1] == T
    assert spans["fleet.init"][1] == 1
    c = snap["counters"]
    assert c["be.lost.instances"] == 1 and c["be.lost.second_pass"] == 1
    assert c["be.subset.gathers"] >= 3  # the inactive frames, the lost pass on one instance
    assert c["be.prune.instances"] >= B and c["k12.updates"] >= 1


def test_fleet_host_reads_by_site_sum_to_the_total(stretch):
    _, _, syncs_off, _ = stretch["off"]
    _, _, syncs_on, snap = stretch["on"]
    sites = {k: v for k, v in snap["counters"].items() if k.startswith("sync.")}
    assert sum(sites.values()) == syncs_on == syncs_off
    assert {k: snap["spans"][k][1] for k in sites} == sites
    assert sites["sync.be.candidates"] == T and sites["sync.fleet.active"] == 2


def test_fleet_bits_equal_with_the_recorder_on_and_off(stretch):
    s_off, o_off, _, _ = stretch["off"]
    s_on, o_on, _, _ = stretch["on"]
    assert _differences(o_off, o_on) == []
    assert _differences(s_off, s_on) == []


def _differences(a, b, path="state"):
    """The paths of the leaves (tensors, pyramids' storage) where two trees
    differ in a bit."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return [d for name, x, y in zip(a._fields, a, b)
                for d in _differences(x, y, f"{path}.{name}")]
    if type(a).__name__ == "Pyramid":
        return _differences(a.flat, b.flat, f"{path}.flat")
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


def test_k11_counters_count_the_lost_passes_rows(stretch):
    """K11 updates here come from the lost passes alone (the prune takes
    K12): the first pass's rows are the published ``n_update_rows``, and
    the overflow pass adds its own on one more update."""
    _, out, _, snap = stretch["on"]
    c = snap["counters"]
    tiers = {t: c.get(f"k11.updates.{t}", 0) for t in ("T1", "T2", "QR", "all")}
    first = [int(n) for n in out.n_update_rows.flatten() if int(n) > 0]
    assert sum(tiers.values()) == len(first) + c["be.lost.second_pass"]
    assert c["k11.rows"] > sum(first) > 0


def test_single_stream_records_the_backend_stages():
    cfg = tiny_config()
    pb, cam0, cam1 = render(cfg, 8)
    frames = vio.frames_from_prebatch(pb, cam0, cam1, CPU)
    n0 = device.host_syncs["sync"]
    with profiling.recording():
        vio.run_sequence(cfg, frames, pb.gyro_bias, pb.acc_mean)
    snap = profiling.snapshot()
    for name in ("frontend", "backend", "be.propagate", "be.augment", "be.observe", "be.lost",
                 "be.prune", "be.reset", "fe.track", "sync.run.active", "sync.be.reset"):
        assert name in snap["spans"], name
    sites = sum(v for k, v in snap["counters"].items() if k.startswith("sync."))
    assert sites == device.host_syncs["sync"] - n0


def test_spans_under_a_profiler_only_when_on():
    """Off, a profile holds no program span, so the benchmark's reductions of
    a profile see the parent's events; on, every span is a host event with
    the operations it ran below it."""
    cfg = tiny_config()
    pb, cam0, cam1 = render(cfg, 1)
    frames = fleet_frames(vio.frames_from_prebatch(pb, cam0, cam1, CPU), n=1, n_inst=1)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fleet.run_fleet(cfg, frames, pb.gyro_bias, pb.acc_mean)
    assert not {e.name for e in prof.events()} & set(profiling.SPANS)
    with profiling.recording(), torch.profiler.profile(activities=acts) as prof:
        fleet.run_fleet(cfg, frames, pb.gyro_bias, pb.acc_mean)
    names = {e.name for e in prof.events()}
    assert {"fleet.step", "frontend", "fe.pyramid", "backend", "sync.fleet.active"} <= names
    under = count_under(prof.events(), profiling.SPANS, names=("aten::cat",))
    assert under["fleet.step"][1] == 1 and under["fleet.step"][0] >= under["frontend"][0] > 0
    assert profiling.device_by_span(prof.events()) == {}  # no device on the CPU


def _event(id, name, start, end, device="cpu", annotation=False):
    kind = torch.autograd.DeviceType.CPU if device == "cpu" else torch.autograd.DeviceType.CUDA
    return types.SimpleNamespace(id=id, name=name, device_type=kind, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_device_by_span_follows_the_launching_call():
    """A device operation goes to the spans whose host interval holds the
    runtime call with its correlation id; overlapping intervals count once;
    a span's device-side copy is left out; an operation without a launching
    call is unattributed."""
    events = [_event(1, "fleet.step", 0, 100), _event(2, "be.lost", 10, 50),
              _event(3, "aten::mm", 12, 20), _event(900, "cudaLaunchKernel", 30, 31),
              _event(901, "cudaLaunchKernel", 14, 15), _event(902, "cuLaunchKernel", 16, 17),
              _event(904, "cudaMemcpyAsync", 70, 71),
              _event(900, "update_kernel", 200, 260, device="cuda"),
              _event(901, "gemm", 150, 180, device="cuda"),
              _event(902, "gemm", 170, 190, device="cuda"),
              _event(903, "elementwise", 300, 310, device="cuda"),
              _event(904, "Memcpy HtoD", 320, 330, device="cuda"),
              _event(2, "be.lost", 150, 260, device="cuda", annotation=True)]
    got = profiling.device_by_span(events)
    assert got["be.lost"] == [pytest.approx(100e-6), 3]
    assert got["fleet.step"] == [pytest.approx(110e-6), 4]
    assert got["(unattributed)"] == [pytest.approx(10e-6), 1]
    assert set(got) == {"be.lost", "fleet.step", "(unattributed)"}
