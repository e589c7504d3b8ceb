"""The stage table (``stages.py``) on a stand-in for the harness: the
recorder on over the window and the profiled steps, every program span's
name passed to the profile's reduction, the harness put back after."""

import types

import pytest

from uav_airvision_tpu_torch.utils import profiling
from vio_benchmark import stages
from vio_benchmark.yardstick import trace


class _Profile:
    def events(self):
        return []


def _harness():
    """A stand-in for ``fleet_sweep`` whose ``run_cell`` records two stages
    in its window and one step in its profiled sub-window."""
    seen = {}

    def reduce_profile(prof, span_labels=()):
        seen["labels"] = set(span_labels)
        return {"device": [], "host": [], "launches": 0}

    def _profile():
        with profiling.span("fleet.step"):
            pass
        return fake.trace.reduce_profile(_Profile(), fake.LAYER_SPANS)

    def run_cell(workload, seed, fault=None):
        seen["off_before"] = not profiling.enabled()
        fault(None)
        for _ in range(2):
            with profiling.span("fleet.step"), profiling.span("backend"):
                profiling.count("k11.updates.T1")
                profiling.count("k11.rows", 26)
        return {"trace": {"profile": fake._profile()}}

    fake = types.SimpleNamespace(
        run_cell=run_cell, _profile=_profile, LAYER_SPANS=("frontend_step_fleet", "backend_step_fleet"),
        trace=types.SimpleNamespace(reduce_profile=reduce_profile, idle_gaps=trace.idle_gaps))
    return fake, seen


def test_recorded_run_records_window_and_profile_and_restores():
    fake, seen = _harness()
    originals = (fake.run_cell, fake._profile, fake.trace.reduce_profile)
    res, st = stages.recorded_run(fake, "tiny.cell", 7)
    assert res["trace"]["profile"]["launches"] == 0
    assert seen["off_before"] and not profiling.enabled()
    # the spans' device-side copies are kept out of the device's events
    assert seen["labels"] >= set(profiling.SPANS) | set(fake.LAYER_SPANS)
    assert {n: c for n, (_, c) in st["window"]["spans"].items()} == {"fleet.step": 2, "backend": 2}
    assert st["window"]["counters"] == {"k11.updates.T1": 2, "k11.rows": 52}
    assert {n: c for n, (_, c) in st["profiled"]["spans"].items()} == {"fleet.step": 1}
    assert st["device"] == {} and st["launches"] == {} and st["idle_by_span"] == []
    assert (fake.run_cell, fake._profile, fake.trace.reduce_profile) == originals
    profiling.reset()


def test_table_per_step():
    st = {"window": {"spans": {"backend": [0.2, 10], "be.augment": [0.1, 9]},
                     "counters": {"k11.rows": 400, "sync.be.candidates": 9}},
          "device": {"backend": [0.004, 300], "be.augment": [0.001, 200]},
          "launches": {"backend": [500, 2], "be.augment": [220, 2]}}
    tab = stages.table(st, steps=10, profile_steps=2)
    assert tab["spans"]["backend"] == pytest.approx([20.0, 1.0, 2.0, 250.0])
    assert tab["spans"]["be.augment"] == pytest.approx([10.0, 0.9, 0.5, 110.0])
    assert tab["counters"] == {"k11.rows": 40.0, "sync.be.candidates": 0.9}


def test_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stages.main(["--workload", "sweep63.default", "--seed", "1", "--seconds", "1"]) == 2
