"""The benchmark's one traffic generator: a mix's parameters -> a fleet's inputs.

A traffic mix (``vio_benchmark/traffic/<name>.json``) names the sequences
(motion presets), the start offsets each sequence is flown from, the steps
of a sweep, the sensor rates, the scenes' seed and the noise's seed.  Each
(sequence, offset) pair is one instance; sequence ``s`` is flown over the
scene drawn from ``(scene_seed, s)``, and instance ``k`` of the mix's list
takes its IMU noise and its image noise (a ``torch.Generator`` on the
device) from ``(noise_seed, k)``.  From ``seed`` comes the order of the
instances in the batch.  So every seed gives the same instances, the same
inputs and the same work, in another order: the noise decides what the
filter does (features kept, updates made), and a seed that drew it would
change the work of a sweep.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .prebatch import prebatch_imu
from .render import DeviceScene, render_batch
from .world import OffsetTrajectory, Rig, imu_stream, make_texture

FRAME_FIELDS = ("timestamp", "cam0", "cam1", "imu_t", "imu_w", "imu_a", "imu_mask",
                "fe_mean_w", "fe_dt", "active")

# streams of the seed (SeedSequence spawn keys)
_TEXTURE, _IMU, _IMAGE, _ORDER = 1, 2, 3, 4


def sub_seed(seed: int, *key: int) -> int:
    """A 63-bit seed of the stream ``key`` under ``seed`` (any integer)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class FleetInputs:
    """A sweep's inputs: ``frames`` {field: (T, B, ...) tensor on the
    device} in the order of the port's ``VioFrame``, each instance's gravity
    and gyro-bias means, its ground-truth positions and its labels."""

    frames: dict
    gyro_bias: np.ndarray  # (B, 3)
    acc_mean: np.ndarray  # (B, 3)
    groundtruth: np.ndarray  # (T, B, 3)
    labels: list  # (preset, offset) of each instance
    phases: dict = field(default_factory=dict)  # set-up seconds by phase

    @property
    def steps(self) -> int:
        return int(self.frames["timestamp"].shape[0])

    @property
    def batch(self) -> int:
        return int(self.frames["timestamp"].shape[1])


def instance_order(mix: dict, seed: int):
    """The mix's instances' indices in the batch's order, which the seed
    draws."""
    n = len(mix["sequences"]) * len(mix["offsets_s"])
    return [int(i) for i in np.random.default_rng(sub_seed(seed, _ORDER)).permutation(n)]


def instances(mix: dict, seed: int):
    """[(sequence index, preset, offset s)] in the batch's order."""
    pairs = [(s, preset, float(o)) for s, preset in enumerate(mix["sequences"])
             for o in mix["offsets_s"]]
    return [pairs[i] for i in instance_order(mix, seed)]


def generate(mix: dict, config: dict, seed: int, device, sync=lambda: None) -> FleetInputs:
    """The fleet's inputs for ``mix`` under ``config`` (the configuration's
    dict as ``Config.to_json`` writes it) from ``seed``, frames rendered on
    ``device``; ``sync`` waits for the device before a phase's clock stops."""
    device = torch.device(device)
    phases = {}
    t0 = time.perf_counter()
    T, fps, rate = int(mix["steps"]), float(mix["fps"]), float(mix["imu_hz"])
    cap = config["capacity"]
    insts = instances(mix, seed)
    ids, noise_seed = instance_order(mix, seed), int(mix["noise_seed"])
    B = len(insts)
    fts = np.arange(T) / fps
    rig = Rig(config["calib"])
    trajs = [OffsetTrajectory(preset, off, t0=mix["lead_in_s"], ramp=mix["ramp_s"])
             for _, preset, off in insts]
    pbs, gts = [], []
    for b, traj in enumerate(trajs):
        rng = np.random.default_rng(sub_seed(noise_seed, _IMU, ids[b]))
        imu_t, imu_w, imu_a = imu_stream(traj, T / fps, rng, rate)
        pbs.append(prebatch_imu(fts, imu_t, imu_w, imu_a, cap["max_imu_per_frame"],
                                cap["imu_init_msgs"]))
        gts.append(traj.pos(fts))

    def f32(name):
        return torch.as_tensor(np.stack([getattr(p, name) for p in pbs], 1), dtype=torch.float32,
                               device=device)

    frames = {"timestamp": f32("timestamps"), "imu_t": f32("imu_t"), "imu_w": f32("imu_w"),
              "imu_a": f32("imu_a"),
              "imu_mask": torch.as_tensor(np.stack([p.imu_mask for p in pbs], 1), device=device),
              "fe_mean_w": f32("fe_mean_w"), "fe_dt": f32("fe_dt"),
              "active": torch.as_tensor(np.stack([p.active for p in pbs], 1), device=device)}
    sync()
    phases["worlds_imu"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    scene = DeviceScene(rig, device)
    cams = {c: torch.empty((T, B, rig.H, rig.W), dtype=torch.uint8, device=device)
            for c in ("cam0", "cam1")}
    noise = torch.Generator(device=device)
    per = int(mix["render_batch"])
    for s in range(len(mix["sequences"])):
        tex_gen = torch.Generator(device=device)
        tex_gen.manual_seed(sub_seed(int(mix["scene_seed"]), _TEXTURE, s))
        tex = make_texture(tex_gen, device)
        for b in (b for b, inst in enumerate(insts) if inst[0] == s):
            noise.manual_seed(sub_seed(noise_seed, _IMAGE, ids[b]))
            poses = rig.camera_poses(trajs[b], fts)
            for k0 in range(0, T, per):
                k1 = min(k0 + per, T)
                for cam in ("cam0", "cam1"):
                    R, t = poses[cam]
                    render_batch(scene, tex, cam, R[k0:k1], t[k0:k1], fts[k0:k1], noise,
                                 cams[cam][k0:k1, b])
    frames.update(cams)
    sync()
    phases["render"] = time.perf_counter() - t0
    frames = {k: frames[k] for k in FRAME_FIELDS}
    return FleetInputs(frames=frames, gyro_bias=np.stack([p.gyro_bias for p in pbs]),
                       acc_mean=np.stack([p.acc_mean for p in pbs]),
                       groundtruth=np.stack(gts, 1), labels=[(p, o) for _, p, o in insts],
                       phases=phases)
