"""Small cells for the benchmark's CPU tests, registered from a temporary
directory as a later change would register its own."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def small_config(name="tiny_cfg"):
    """euroc_default at half resolution (376x240, intrinsics halved)."""
    conf = json.loads((ROOT / "configs" / "euroc_default.json").read_text())
    conf = copy.deepcopy(conf)
    conf["name"] = name
    calib = conf["config"]["calib"]
    for cam in ("cam0", "cam1"):
        calib[f"{cam}_resolution"] = [376, 240]
        calib[f"{cam}_intrinsics"] = [x / 2 for x in calib[f"{cam}_intrinsics"]]
    return conf


def small_mix(name="tiny_mix", steps=70):
    mix = json.loads((ROOT / "traffic" / "sweep63.json").read_text())
    mix.update(name=name, sequences=["difficult"], offsets_s=[1, 40], steps=steps,
               warmup_steps=10, profile_steps=2, render_batch=20,
               check={"start_steps": 30, "start_instances": 2, "mid_first": 40,
                      "mid_last": 40, "mid_steps": 20, "mid_instances": 2})
    return mix


def register(tmp: Path, limits=None, cell="tiny.cell"):
    """A BENCHMARK.json naming one small cell, with its configuration, mix
    and limits, under ``tmp``; returns (bench path, search dirs)."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    (tmp / "configs" / "tiny_cfg.json").write_text(json.dumps(small_config()))
    (tmp / "traffic" / "tiny_mix.json").write_text(json.dumps(small_mix()))
    lim = limits or json.loads((ROOT / "limits" / "sweep63.default.json").read_text())["limits"]
    (tmp / "limits" / f"{cell}.json").write_text(json.dumps({"limits": lim}))
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_cfg", "source": "test", "file": "tiny_cfg.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": cell, "config": "tiny_cfg", "traffic": "tiny_mix",
                           "chips": 1, "why": "test"}]
    for m in bench["per_layer"]:
        m["workloads"] = [cell]
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path, [str(tmp)]
