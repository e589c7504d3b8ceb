"""The output check on the CPU, a small cell registered from a temporary
directory: a sound run is correct; its control (the reference in TF32, its
LK in bfloat16) and a timed path broken underneath are not.  The harness's look for a card is
skipped (``run_cell`` on the CPU, where the port runs its plain versions)."""

import time

import pytest
import torch

from vio_benchmark import fleet_sweep
from vio_bench_common import register

SEED = 2 ** 31 + 101
WINDOW_S = 15.0  # long enough to reach the checked steps on a slow CPU


def run(tmp_path, fault=None, control=False):
    bench, search = register(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    try:
        res = fleet_sweep.run_cell("tiny.cell", SEED, WINDOW_S, False, time.perf_counter(),
                                   device="cpu", search=search, bench_path=bench, fault=fault,
                                   control=control)
    finally:
        torch.set_num_threads(threads)
    # the window reached the checked stretches, so what fails is the comparison
    assert res["info"]["steps"] >= 60, res["info"]
    return res


def failed_numbers(res):
    return [k for k, v in res["checked"].items() if not v["value"] <= v["limit"]]


def test_sound_run_is_correct_and_its_control_is_not(tmp_path):
    res = run(tmp_path, control=True)
    assert res["correct"], res["checked"]
    assert res["failed"] == 0 and res["attempted"] >= 60
    limits = {k: v["limit"] for k, v in res["checked"].items()}
    over = [k for k, v in res["control"].items() if k in limits and v > limits[k]]
    assert {"cov_gap_mid", "feature_gap_p90_px"} <= set(over), res["control"]


def _wrap(monkeypatch, port, make):
    fleet = port["fleet"]
    monkeypatch.setattr(fleet, "vio_step_fleet", make(fleet.vio_step_fleet, port))


def test_state_left_unchanged_fails(tmp_path, monkeypatch):
    def make(orig, port):
        def step(bstate, bframe, *args):
            _, out, fe = orig(bstate, bframe, *args)
            return bstate, out, fe
        return step

    res = run(tmp_path, fault=lambda port: _wrap(monkeypatch, port, make))
    assert not res["correct"] and failed_numbers(res)


def test_half_the_batch_left_out_fails(tmp_path, monkeypatch):
    def make(orig, port):
        take, VioFrame = port["tree"].take, port["vio"].VioFrame

        def step(bstate, bframe, fparams, mparams, config, active):
            B = len(active)
            half = list(range(B // 2 or 1))
            st, out, fe = orig(take(bstate, half), VioFrame(*(x[:len(half)] for x in bframe)),
                               fparams, mparams, config, active[:len(half)])
            tile = [half[b % len(half)] for b in range(B)]  # the rest copies the computed half
            return take(st, tile), take(out, tile), take(fe, tile)
        return step

    res = run(tmp_path, fault=lambda port: _wrap(monkeypatch, port, make))
    assert not res["correct"] and failed_numbers(res)


def test_altered_pose_fails(tmp_path, monkeypatch):
    def make(orig, port):
        def step(*args):
            st, out, fe = orig(*args)
            p = out.p.clone()
            p[0] += 0.05  # instance 0's published position, 5 cm off
            return st, out._replace(p=p), fe
        return step

    res = run(tmp_path, fault=lambda port: _wrap(monkeypatch, port, make))
    assert not res["correct"] and "pose_gap_start_m" in failed_numbers(res)


def test_shifted_features_fail(tmp_path, monkeypatch):
    def fault(port):
        vio = port["vio"]
        orig = vio.frontend_step_fleet

        def frontend(*args):
            st, fe = orig(*args)
            uv = fe.uv.clone()
            uv[0] += 0.5 / 229.0  # instance 0's features, half a pixel of cam0's focal length off
            return st, fe._replace(uv=uv)
        monkeypatch.setattr(vio, "frontend_step_fleet", frontend)

    res = run(tmp_path, fault=fault)
    assert not res["correct"] and "feature_gap_p90_px" in failed_numbers(res)


def test_altered_covariance_fails(tmp_path, monkeypatch):
    def fault(port):
        vio = port["vio"]
        orig = vio.backend_step_fleet

        def backend(*args):
            st, out = orig(*args)
            return st._replace(cov=st.cov * 1.001), out  # the step's covariance 0.1% off
        monkeypatch.setattr(vio, "backend_step_fleet", backend)

    res = run(tmp_path, fault=fault)
    assert not res["correct"] and "cov_gap_mid" in failed_numbers(res)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's timed path on the card")


@pytest.mark.cuda
def test_small_cell_on_the_card_is_correct(tmp_path, card):
    bench, search = register(tmp_path)
    res = fleet_sweep.run_cell("tiny.cell", SEED, WINDOW_S, True, time.perf_counter(),
                               device="cuda", search=search, bench_path=bench)
    assert res["correct"], res["checked"]
    assert res["trace"]["profile"]["launches"] > 0
