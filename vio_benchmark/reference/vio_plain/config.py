# Frozen copy of uav_airvision_tpu_torch/config.py at commit efd1109, unchanged: part of the
# benchmark's plain reference, which runs on CPU tensors only (every wrapper takes its
# plain PyTorch version there; kernels.py is a stub).
"""The PyTorch port's own copy of uav_airvision_tpu/config.py: same names, same
behaviour (tests/test_torch_standalone.py holds the two equal).

Configuration tree for the stereo VIO framework.

Mirrors every parameter of the reference configuration
(reference: src/config.py:7-123) as frozen dataclasses, and adds the static
capacity constants that the fixed-shape XLA design needs (the reference grows
Python lists/dicts dynamically; we pre-allocate and mask instead).

Everything here is host-side, serializable, and hashable so a config can be a
``static_argnum`` of a jitted step function.  The calibration block is exposed
both as tuples (hashable, static) and via ``numpy`` helpers.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

Mat4 = Tuple[Tuple[float, ...], ...]


def _t4(a) -> Mat4:
    return tuple(tuple(float(x) for x in row) for row in np.asarray(a, dtype=np.float64))


# EuRoC / Kalibr calibration (reference src/config.py:93-123).
_T_IMU_CAM0 = (
    (0.014865542981794, 0.999557249008346, -0.025774436697440, 0.065222909535531),
    (-0.999880929698575, 0.014967213324719, 0.003756188357967, -0.020706385492719),
    (0.004140296794224, 0.025715529947966, 0.999660727177902, -0.008054602460030),
    (0.0, 0.0, 0.0, 1.0),
)
_T_IMU_CAM1 = (
    (0.012555267089103, 0.999598781151433, -0.025389800891747, -0.044901980682509),
    (-0.999755099723116, 0.013011905181504, 0.017900583825251, -0.020569771258915),
    (0.018223771455443, 0.025158836311552, 0.999517347077547, -0.008638135126028),
    (0.0, 0.0, 0.0, 1.0),
)
_T_CN_CNM1 = (
    (0.999997256477881, 0.002312067192424, 0.000376008102415, -0.110073808127187),
    (-0.002317135723281, 0.999898048506644, 0.014089835846648, 0.000399121547014),
    (-0.000343393120525, -0.014090668452714, 0.999900662637729, -0.000853702503357),
    (0.0, 0.0, 0.0, 1.0),
)
_EYE4 = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))


@dataclass(frozen=True)
class TriangulationConfig:
    """Feature-position LM optimization (reference src/config.py:7-17)."""

    translation_threshold: float = -1.0  # <0 disables the motion check
    huber_epsilon: float = 0.01
    estimation_precision: float = 5e-7
    initial_damping: float = 1e-3
    outer_loop_max_iteration: int = 5
    inner_loop_max_iteration: int = 5
    # Run the LM solve as ``inner_loop_max_iteration`` straight-line gated
    # steps instead of the reference's nested while loops.  Result-identical
    # (the flat recurrence reproduces the shared-inner-counter semantics,
    # tested in tests/test_triangulation.py), but on TPU the nested whiles
    # serialize at a cond-sync per iteration AND — vmapped over a feature
    # batch — run to the max trip count of the batch anyway; the static form
    # pipelines freely (measured ~3x cheaper in the prune path).
    static_solve: bool = True


@dataclass(frozen=True)
class FrontendConfig:
    """Image-processing front-end parameters (reference src/config.py:23-44)."""

    grid_row: int = 4
    grid_col: int = 5
    grid_min_feature_num: int = 3
    grid_max_feature_num: int = 5
    fast_threshold: int = 15
    ransac_threshold: float = 3.0  # dead in the reference (all-ones RANSAC)
    stereo_threshold: float = 5.0
    # Reference cap is 30 (src/config.py:30); 10 is the measured fast
    # default — LK iterations terminate on eps long before the cap for
    # converged features, the cap only bounds stragglers, and the 200-frame
    # bench measured max10 at BETTER ATE than max30 (0.00530 vs 0.00624 m,
    # scripts/exp_lk_budget.py) at +46% fps.  Set 30 to restore the
    # reference bound.
    lk_max_iteration: int = 10
    lk_track_precision: float = 0.01
    pyramid_levels: int = 3  # LK maxLevel; pyramid has levels 0..3
    patch_size: int = 15
    # Hard-coded stereo-matcher cuts (reference stereo_matcher.py:75-80).
    fwd_bwd_error_px: float = 3.0
    max_vertical_disparity_px: float = 20.0
    # OpenCV LK minimum-eigenvalue reject threshold (cv2 default).
    lk_min_eig_threshold: float = 1e-4
    # The stereo fwd/bwd consistency check's backward LK runs only at pyramid
    # level 0 by default: its initial guess (the original cam0 point) is
    # already sub-pixel for true matches, so the coarse levels add cost but
    # no discrimination.  Set True for the reference's full-pyramid backward.
    stereo_full_backward: bool = False
    # Iteration cap for the stereo BACKWARD LK (0 = lk_max_iteration).  The
    # backward pass exists only to feed the 3 px fwd/bwd error gate; its
    # initial guess (the original cam0 point) is exact for true matches, so
    # convergence is 1-2 iterations and the cap only bounds mismatches —
    # which drift AWAY and still fail the gate.  MEASURED AND REJECTED as a
    # default: on the mild bench world a cap of 3 is ATE-equal (0.00492 vs
    # 0.00500 m, scripts/exp_lk_budget.py), but on the hard-motion preset
    # head-to-head a cap of 5 pushed ours/ref ATE from 1.028 to 1.094 (easy)
    # and 0.962 to 1.079 (medium) — fewer backward iterations let a FALSE
    # match drift less from its seed, weakening the 3 px gate exactly where
    # outliers are plentiful.  (It HELPED difficult, 0.873 -> 0.819: more
    # surviving matches aid continuity there.)  Keep 0 = uncapped.
    stereo_bwd_max_iter: int = 0
    # Pyramid levels for the stereo FORWARD LK (-1 = full pyramid, the
    # reference behavior, the default).  Measured on the synthetic world
    # (scripts/exp_stereo_levels.py): truncating to 2 levels buys only ~14%
    # fps and costs 6x ATE (0.0063 -> 0.038 m) — near-scene disparities
    # exceed the truncated search range.  Kept as a knob for wide-baseline
    # configs where disparity is known-small; do not change the default.
    stereo_fwd_levels: int = -1
    # True: build the 7x7 detection mask from post-stereo tracked features
    # (the reference's exact order, costs one extra LK batch); False: build
    # it from pre-stereo temporal tracks so tracked + candidate stereo
    # matches run as one batched call.
    exact_adder_mask: bool = False
    # Disparity-seeded stereo fast path (measured at-or-better ATE, see
    # scripts/exp_lk_budget.py): tracked features seed the forward LK at
    # their previous-frame disparity, new candidates at their nearest
    # tracked neighbor's disparity, and the forward pyramid truncates to
    # ``stereo_seeded_levels`` because every seed is already near the true
    # match.  Falls back to the full-pyramid reference path (one lax.cond)
    # whenever fewer than ``stereo_seed_min_tracked`` temporal tracks
    # survive, so recovery from feature starvation is unaffected.  Set
    # ``stereo_seeded=False`` to restore the reference's rotation-projected
    # seeds + full pyramid unconditionally.
    stereo_seeded: bool = True
    # 2 forward levels with disparity seeds measured BETTER ATE than the
    # full unseeded pyramid (0.00520 vs 0.00624 m) at ~1.4x fps; 1 level is
    # faster still but measurably worse (0.00593 m).  exp_lk_budget.py.
    stereo_seeded_levels: int = 2
    stereo_seed_min_tracked: int = 8
    # False drops the lax.cond fallback (always-seeded): under fleet vmap a
    # cond lowers to select and BOTH stereo paths would execute every frame.
    stereo_seed_fallback: bool = True
    # True replaces every LK level's Gauss-Newton while_loop with
    # ``max_iter`` straight-line gated steps (ops/lk.py::_iterate_level):
    # bit-identical math (verified), no cross-feature any(~conv) sync
    # between steps.  Measured (scripts/exp_lk_budget.py, 200 frames):
    # +6% fps alone; within run noise of the while_loop once
    # lk_max_iteration_upper=5 is set — kept True because under fleet vmap
    # a while_loop always runs to the batch-max trip count, so the static
    # form is never worse and drops the per-step reduction.
    lk_static_iters: bool = True
    # Store the banded block tilings (ops/extract.py) as bfloat16.  Exact,
    # not approximate: pyramid levels are integer-valued 0..255 (cv2 uint8
    # pyrDown semantics, ops/pyramid.py) and bfloat16 represents them
    # bit-perfectly; LK lifts windows back to float32 at the sampling
    # matmul.  Halves the HBM traffic of the ~9x-replicated band arrays —
    # the banding copies, the prev-pyramid scan carry, and every
    # Gauss-Newton iteration's window reads.
    band_bf16: bool = True
    # Shift-extract each LK level's exact search span (win+1+2*LK_MARGIN =
    # 32 px) out of its 48-px block before iterating (ops/lk.py::
    # _iterate_level).  MEASURED WORSE and kept off: v5e tiles pad the
    # minor dimension to 128 lanes, so shrinking the sampling matmuls
    # 48->32 saves almost nothing while the two extra one-hot shift matmuls
    # per level cost real time (bench 429.8 vs 435.6 fps), and it narrows
    # the freeze margin to a uniform LK_MARGIN=8 px (vs 8..23 phase slack).
    lk_compact_windows: bool = False
    # Iteration cap for pyramid levels > 0 (0 = use lk_max_iteration).
    # Upper levels only place the level-0 start inside its convergence
    # basin; they don't need level-0 precision.  Measured: 5 is +11% fps at
    # slightly BETTER ATE (0.00500 vs 0.00520 m); 3 is faster still but
    # measurably worse (0.00537 m).  exp_lk_budget.py.
    lk_max_iteration_upper: int = 5
    # Pyramid depth of the TEMPORAL tracker's LK (0 = full pyramid, the
    # reference behavior).  The IMU homography warp already removes the
    # rotation-induced flow — the dominant term on EuRoC-like motion — so
    # the coarse levels mostly re-confirm a guess that is already inside
    # level-1's convergence basin.  Each level costs lk_max_iteration_upper
    # sequential Gauss-Newton steps (~60 us/level on v5e).  Measured
    # (exp_lk_budget.py, 200-frame bench world): 2 levels 0.00505 m vs full
    # pyramid 0.00512 m ATE; hard-motion preset head-to-head re-validated
    # with this default (see PARITY.md round-4 table).  Set 0 to restore the
    # full reference pyramid.
    #
    # LONG-HORIZON CAVEAT (round-5 measured, PARITY.md): at EuRoC length
    # (180 s) on the medium-motion preset the truncated search range lets a
    # slow drift accumulate that 20 s runs never see — 0.238 m vs the
    # reference's 0.185 (ratio 1.29); 3 levels measures 0.173 m (ratio
    # 0.93, BETTER than the reference) at ~8% fps (552 -> 506).  Use
    # ``long_horizon_config()`` (or set 3 here) for missions beyond ~60 s.
    lk_temporal_levels: int = 2

    @property
    def grid_num(self) -> int:
        return self.grid_row * self.grid_col


@dataclass(frozen=True)
class FilterConfig:
    """MSCKF noise / window parameters (reference src/config.py:49-87)."""

    gravity_acc: float = 9.81
    frame_rate: float = 20.0
    max_cam_state_size: int = 20
    position_std_threshold: float = 2.0  # online-reset trigger; <=0 disables

    # Keyframe selection thresholds (reference src/config.py:67-69).
    rotation_threshold: float = 0.15
    translation_threshold: float = 0.2
    tracking_rate_threshold: float = 0.5

    # Noise variances (not std devs), reference src/config.py:72-76.
    gyro_noise: float = 0.005**2
    acc_noise: float = 0.05**2
    gyro_bias_noise: float = 0.001**2
    acc_bias_noise: float = 0.01**2
    observation_noise: float = 0.035**2

    # Camera-prune update via the rank-12 Woodbury form (every prune block
    # row touches only the two removed camera states, so S is a rank-12
    # perturbation and all factorizations collapse to (12,12) — see
    # update.apply_update_rank12).  Algebraically identical to the stacked
    # QR path it replaces, which paid a (848,141) QR on ~45% of frames.
    # False restores the generic stacked-buffer update.
    prune_rank12: bool = True

    # Initial covariance diagonal blocks (reference src/config.py:83-87).
    velocity_cov: float = 0.25
    gyro_bias_cov: float = 0.01
    acc_bias_cov: float = 0.01
    extrinsic_rotation_cov: float = 3.0462e-4
    extrinsic_translation_cov: float = 2.5e-5


@dataclass(frozen=True)
class CalibrationConfig:
    """Stereo rig calibration (reference src/config.py:93-123)."""

    T_imu_cam0: Mat4 = _T_IMU_CAM0
    T_imu_cam1: Mat4 = _T_IMU_CAM1
    T_cn_cnm1: Mat4 = _T_CN_CNM1
    T_imu_body: Mat4 = _EYE4
    cam0_distortion_model: str = "radtan"
    cam0_distortion_coeffs: Tuple[float, ...] = (
        -0.28340811,
        0.07395907,
        0.00019359,
        1.76187114e-05,
    )
    cam0_intrinsics: Tuple[float, ...] = (458.654, 457.296, 367.215, 248.375)
    cam0_resolution: Tuple[int, int] = (752, 480)
    cam1_distortion_model: str = "radtan"
    cam1_distortion_coeffs: Tuple[float, ...] = (
        -0.28368365,
        0.07451284,
        -0.00010473,
        -3.55590700e-05,
    )
    cam1_intrinsics: Tuple[float, ...] = (457.587, 456.134, 379.999, 255.238)
    cam1_resolution: Tuple[int, int] = (752, 480)


@dataclass(frozen=True)
class CapacityConfig:
    """Static shape capacities for the fixed-shape, masked XLA design.

    The reference grows/shrinks Python containers per frame; under jit every
    shape must be static, so each dynamic structure becomes a padded array
    with a validity mask.  These bounds were sized from the reference's own
    invariants (grid 4x5 * 5 features, <=20 cam states, the 1500-row
    Jacobian-stack cap at reference src/msckf.py:667).
    """

    max_features: int = 104  # front-end feature slots (>= grid_num * grid_max = 100)
    max_map_features: int = 256  # estimator map-server slots
    max_cam_states: int = 20  # sliding window (== max_cam_state_size)
    max_imu_per_frame: int = 64  # padded per-frame IMU slice
    max_lost_per_frame: int = 64  # features marginalized per frame
    max_prune_feats: int = 128  # features processed per cam-prune update
    # (>= max_features + marginalization slack: the set of features observed
    # by BOTH pruned cam states is bounded by the live tracked set, so 128
    # covers it; prune_cam_states raises the warn flag if ever exceeded)
    max_update_rows: int = 1680  # 1500-row cap + one 77-row block, rounded
    max_prune_rows: int = 848  # prune-update row buffer
    fast_candidates: int = 1024  # detector candidates kept on first frame
    imu_init_msgs: int = 200  # msgs for gravity/bias init (ref msckf.py:173)

    @property
    def state_dim(self) -> int:
        return 21 + 6 * self.max_cam_states


@dataclass(frozen=True)
class Config:
    """Top-level configuration, EuRoC defaults."""

    triangulation: TriangulationConfig = field(default_factory=TriangulationConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    calib: CalibrationConfig = field(default_factory=CalibrationConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    dtype: str = "float32"  # filter/compute dtype ("float32" | "float64")

    # ------------------------------------------------------------------
    # numpy helpers (host side)
    # ------------------------------------------------------------------
    def np_T_imu_cam0(self):
        return np.asarray(self.calib.T_imu_cam0, dtype=np.float64)

    def np_T_imu_cam1(self):
        return np.asarray(self.calib.T_imu_cam1, dtype=np.float64)

    def np_T_cn_cnm1(self):
        return np.asarray(self.calib.T_cn_cnm1, dtype=np.float64)

    def np_T_imu_body(self):
        return np.asarray(self.calib.T_imu_body, dtype=np.float64)

    def np_gravity(self):
        return np.array([0.0, 0.0, -self.filter.gravity_acc], dtype=np.float64)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)

        def _de(cls, dd):
            kw = {}
            for f in dataclasses.fields(cls):
                v = dd[f.name]
                if dataclasses.is_dataclass(f.type) or f.name in (
                    "triangulation",
                    "frontend",
                    "filter",
                    "calib",
                    "capacity",
                ):
                    sub = {
                        "triangulation": TriangulationConfig,
                        "frontend": FrontendConfig,
                        "filter": FilterConfig,
                        "calib": CalibrationConfig,
                        "capacity": CapacityConfig,
                    }[f.name]
                    kw[f.name] = _de(sub, v)
                elif isinstance(v, list):
                    kw[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
                else:
                    kw[f.name] = v
            return cls(**kw)

        return _de(Config, d)


def euroc_config(**overrides) -> Config:
    """The EuRoC default configuration (reference ConfigEuRoC)."""
    return dataclasses.replace(Config(), **overrides)


def long_horizon_config(**overrides) -> Config:
    """EuRoC defaults tuned for missions beyond ~60 s: a 3-level temporal
    LK pyramid.  The 2-level fast default accumulates a slow medium-motion
    drift that only shows at EuRoC length (measured, 180 s medium preset:
    0.238 m vs 0.173 m here vs 0.185 m reference — PARITY.md round-5), at
    ~8% single-chip fps (552 -> 506 frames/s).  Everything else matches
    ``euroc_config``."""
    cfg = euroc_config(**overrides)
    return dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, lk_temporal_levels=3))
