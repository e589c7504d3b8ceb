"""A later change adds a configuration, a traffic mix and a per-layer metric
as files: the harness finds them by name, its own files unchanged."""

import json

from vio_benchmark import registry
from vio_bench_common import register


def test_registered_from_a_temporary_directory(tmp_path):
    bench_path, search = register(tmp_path)
    (tmp_path / "metrics" / "dummy_share.py").write_text(
        "def read(t):\n    return 100.0 * t['host_syncs'] / max(t['steps'], 1)\n")
    bench = registry.load_benchmark(bench_path)
    cell, conf = registry.cell(bench, "tiny.cell")
    assert conf["name"] == "tiny_cfg"
    assert registry.load_config("tiny_cfg", search)["config"]["calib"]["cam0_resolution"] == [376, 240]
    assert registry.load_traffic("tiny_mix", search)["steps"] == 70
    assert registry.load_reader("dummy_share", search)({"host_syncs": 3, "steps": 6}) == 50.0
    assert set(registry.load_limits("tiny.cell", search)) >= {"pose_gap_start_m", "cov_gap_start"}
    # the benchmark's own files are still found beside them
    assert registry.load_traffic("sweep63", search)["steps"] == 300
    assert registry.load_limits("no.such.cell", search) == {}


def test_metrics_of_a_cell():
    bench = json.loads((registry.ROOT.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        e2e = [m["name"] for m in registry.metrics_of(bench, w["name"], "end_to_end")]
        assert e2e == ["setup_s", "device_frames_per_s"]
        assert len(registry.metrics_of(bench, w["name"], "per_layer")) == 9
        registry.load_config(w["config"])
        registry.load_traffic(w["traffic"])
        assert registry.load_limits(w["name"])
