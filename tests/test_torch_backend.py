"""The PyTorch port's MSCKF back-end against the JAX package, on the CPU.

Inputs are the synthetic oracle scenario of tests/test_msckf_backend.py and
views in the style of tests/test_triangulation.py.  The unit functions
(propagation K14's plain version, feature_block, the chi-square gate, the
EKF updates, triangulation) are compared in float64 to 1e-9 on a realistic
filter state; the whole back-end sequence is compared per frame.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.oracle.synthetic import make_scenario, window_imu
from uav_airvision_tpu.config import euroc_config
from uav_airvision_tpu.models.msckf import propagation as jprop
from uav_airvision_tpu.models.msckf import state as jstate
from uav_airvision_tpu.models.msckf import step as jstep
from uav_airvision_tpu.models.msckf import triangulation as jtri
from uav_airvision_tpu.models.msckf import update as jupd
from uav_airvision_tpu_torch import config as tconfig
from uav_airvision_tpu_torch import convert
from uav_airvision_tpu_torch.utils import tree
from uav_airvision_tpu_torch.models.msckf import propagation as tprop
from uav_airvision_tpu_torch.models.msckf import state as tstate
from uav_airvision_tpu_torch.models.msckf import step as tstep
from uav_airvision_tpu_torch.models.msckf import triangulation as ttri
from uav_airvision_tpu_torch.models.msckf import update as tupd
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
JAX_TYPES = {c.__name__: c for c in (jstate.FilterState, jstate.ImuState, jstate.CamWindow,
                                     jstate.FeatureTable, jstate.MsckfParams)}


def to_jax(tree):
    """The port's NamedTuple tree of tensors -> the JAX package's classes."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return JAX_TYPES[type(tree).__name__](*(to_jax(x) for x in tree))
    return jnp.asarray(tree.numpy())


def port_config(cfg):
    """The port's own Config with the same values as the JAX package's."""
    return tconfig.Config.from_json(cfg.to_json())


def assert_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol:.0e}"


def scenario_inputs(cfg, scenario):
    """Per-frame numpy backend inputs, as tests/test_msckf_backend.py builds them."""
    cap = cfg.capacity
    active = [t >= scenario.imu[cap.imu_init_msgs - 1][0] for t, _ in scenario.frames]
    windows = window_imu(scenario, active)
    I, K = cap.max_imu_per_frame, cap.max_features
    frames = []
    for k, (t, meas) in enumerate(scenario.frames):
        _, window = windows[k]
        f = dict(timestamp=np.float64(t), imu_t=np.zeros(I), imu_w=np.zeros((I, 3)),
                 imu_a=np.zeros((I, 3)), imu_mask=np.zeros(I, bool),
                 feat_ids=np.full(K, -1, np.int32), feat_uv=np.zeros((K, 4)),
                 feat_mask=np.zeros(K, bool), active=bool(active[k]))
        for j, (mt, w, a) in enumerate(window[:I]):
            f["imu_t"][j], f["imu_w"][j], f["imu_a"][j], f["imu_mask"][j] = mt, w, a, True
        for j, (fid, u0, v0, u1, v1) in enumerate(meas[:K]):
            f["feat_ids"][j], f["feat_uv"][j], f["feat_mask"][j] = fid, (u0, v0, u1, v1), True
        frames.append(f)
    return frames


@pytest.fixture(scope="module")
def scenario64():
    cfg = euroc_config(dtype="float64")
    sc = make_scenario(euroc_config(), duration=4.0, seed=3)
    return cfg, sc, scenario_inputs(cfg, sc)


def run_port(cfg, sc, frames, n=None):
    cfg = port_config(cfg)
    params = tstate.make_params(cfg, CPU)
    state = tstate.init_state(cfg, params, sc.gyro_bias, sc.acc_mean)
    outs = []
    for f in frames[:n]:
        fr = tstep.FrameInput(**{k: (v if k == "active" else torch.as_tensor(v))
                                 for k, v in f.items()})
        state, out = tstep.backend_step(state, fr, params, cfg)
        outs.append(out)
    return state, params, outs


@pytest.fixture(scope="module")
def port_run(scenario64):
    cfg, sc, frames = scenario64
    return run_port(cfg, sc, frames)


@pytest.fixture(scope="module")
def jax_step64(scenario64):
    """The JAX back-end step, jitted once for the float64 config."""
    cfg = scenario64[0]
    jparams = jstate.make_params(cfg, dtype=jnp.float64)
    return jparams, jax.jit(functools.partial(jstep.backend_step, params=jparams, config=cfg))


def compare_sequences(cfg, sc, frames, touts, jax_step64, p_tol):
    """Run the JAX back-end over ``frames``; per active frame, hold the
    port's outputs to it.  Returns (n_prune, n_lost) frame counts."""
    jparams, step = jax_step64
    jst = jstate.init_state(cfg, jparams, sc.gyro_bias, sc.acc_mean, dtype=jnp.float64)
    n_prune = n_lost = 0
    for f, tout in zip(frames, touts):
        fr = jstep.FrameInput(**{k: jnp.asarray(v) for k, v in f.items()})
        jst, jout = step(jst, fr)
        assert bool(jout.active) == bool(tout.active)
        if not bool(jout.active):
            continue
        n_prune += int(jout.n_prune_feats) > 0
        n_lost += int(jout.n_update_rows) > 0
        for f_ in ("n_cams", "n_features", "n_update_rows", "n_prune_feats",
                   "n_lost_overflow"):
            assert int(getattr(tout, f_)) == int(getattr(jout, f_)), f_
        np.testing.assert_allclose(tout.p.numpy(), np.asarray(jout.p), atol=p_tol, rtol=0)
        np.testing.assert_allclose(tout.q.numpy(), np.asarray(jout.q), atol=p_tol / 10, rtol=0)
    return n_prune, n_lost


def test_backend_sequence_matches_jax(scenario64, port_run, jax_step64):
    """Per-frame poses of the whole back-end (propagation, augmentation,
    lost-feature updates, rank-12 prunes) within 1e-6 m / 1e-7 in float64:
    the two packages round in different orders, and the filter carries those
    last-digit differences across frames."""
    cfg, sc, frames = scenario64
    n_prune, n_lost = compare_sequences(cfg, sc, frames, port_run[2], jax_step64, 1e-6)
    assert n_prune > 0 and n_lost > 0  # both update paths ran


def test_lost_overflow_second_pass_matches_jax(scenario64, jax_step64):
    """More than max_lost_per_frame (64) features lost at once: the second
    marginalization pass (the scenario of tests/test_msckf_backend.py).
    Within 1e-5 m: the second pass relinearizes after the first update."""
    cfg = scenario64[0]
    base = make_scenario(euroc_config(), duration=4.0, n_landmarks=120, track_len=80, seed=11)
    kcut = len(base.frames) - 8  # all features vanish here
    k0 = kcut - 4  # ...after exactly 4 observations each
    sc = dataclasses.replace(base, frames=[(t, meas if k0 <= k < kcut else [])
                                           for k, (t, meas) in enumerate(base.frames)])
    frames = scenario_inputs(cfg, sc)
    _, _, touts = run_port(cfg, sc, frames)
    compare_sequences(cfg, sc, frames, touts, jax_step64, 1e-5)
    n_feat = [int(o.n_features) for o in touts if bool(o.active)]
    assert np.diff(n_feat).min() < -cfg.capacity.max_lost_per_frame  # both passes ran


# the IMU slices K14 is held to: n valid samples packed first, or the first
# 24 slots with holes (masked samples that still carry their timestamps)
PROP_CASES = [11, 40, 0, 1, 64, "holes"]
PROP_HOLES = np.array([4, 5, 6, 13, 20])


def prop_mask(case, I):
    if case == "holes":
        mask = np.arange(I) < 24
        mask[PROP_HOLES] = False
        return mask
    return np.arange(I) < case


@pytest.mark.parametrize("dtype,n_valid", [(d, n) for n in (11, 40) for d in ("float32", "float64")]
                         + [(d, n) for n in PROP_CASES[2:] for d in ("float32", "float64")])
def test_propagate_plain_matches_jax(dtype, n_valid):
    """K14's plain version: relative error <= 1e-5 in float32 (sums in
    another order), <= 1e-12 in float64; with no valid sample, one, a full
    64-slot slice, and a slice with holes."""
    cfg = euroc_config(dtype=dtype)
    npdt = np.dtype(dtype)
    rng = np.random.default_rng(n_valid if isinstance(n_valid, int) else 99)
    jparams = jstate.make_params(cfg)
    js = jstate.init_state(cfg, jparams, np.array([2e-3, -1e-3, 5e-4]),
                           np.array([0.3, -0.2, 9.79]))
    D = cfg.capacity.state_dim
    A = rng.normal(0, 0.05, (D, D))
    q = rng.normal(0, 1, 4)
    qn = q + rng.normal(0, 0.01, 4)
    imu = js.imu._replace(
        q=jnp.asarray((q / np.linalg.norm(q)).astype(npdt)),
        q_null=jnp.asarray((qn / np.linalg.norm(qn)).astype(npdt)),
        v=jnp.asarray(rng.normal(0, 0.5, 3).astype(npdt)),
        p=jnp.asarray(rng.normal(0, 1, 3).astype(npdt)),
        v_null=jnp.asarray(rng.normal(0, 0.5, 3).astype(npdt)),
        p_null=jnp.asarray(rng.normal(0, 1, 3).astype(npdt)),
        ba=jnp.asarray(rng.normal(0, 0.01, 3).astype(npdt)),
        timestamp=jnp.asarray(npdt.type(3.0)))
    js = js._replace(imu=imu, cov=jnp.asarray((A @ A.T + 0.01 * np.eye(D)).astype(npdt)))
    I = cfg.capacity.max_imu_per_frame
    mask = prop_mask(n_valid, I)
    n = int(np.nonzero(mask)[0].max()) + 1 if mask.any() else 0  # slots with a time
    imu_t = np.zeros(I, npdt)
    imu_t[:n] = 3.0 + 0.005 * np.arange(1, n + 1)
    imu_w = np.zeros((I, 3), npdt)
    imu_w[:n] = rng.normal(0, 0.3, (n, 3))
    imu_a = np.zeros((I, 3), npdt)
    imu_a[:n] = rng.normal([0, 0, 9.81], 0.5, (n, 3))
    want = jax.jit(jprop.propagate)(js, jparams, jnp.asarray(imu_t), jnp.asarray(imu_w),
                                    jnp.asarray(imu_a), jnp.asarray(mask))
    got = tprop.propagate(convert.to_torch(js, CPU), convert.to_torch(jparams, CPU),
                          torch.as_tensor(imu_t), torch.as_tensor(imu_w),
                          torch.as_tensor(imu_a), torch.as_tensor(mask))
    tol = 1e-5 if dtype == "float32" else 1e-12
    for f in ("q", "v", "p", "q_null", "v_null", "p_null", "timestamp"):
        assert_close(getattr(got.imu, f).numpy(), getattr(want.imu, f), tol, f)
    assert int(got.imu.sid) == int(want.imu.sid)
    assert_close(got.cov.numpy(), want.cov, tol, "cov")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [0, 1, 5, 11, 16, 17, 40, 64])
def test_fold_pairs_up_to_the_next_power_of_two_exact(dtype, L):
    """K14 folds the (Phi_i, Q_i) pairs only up to the next power of two
    above the last valid slot L: the identity pairs past it compose exactly,
    so that fold equals the plain version's over the whole 64-slot slice
    bit for bit (holes inside the first L slots included)."""
    rng = np.random.default_rng(L)
    I, d = 64, 21
    Phi = np.tile(np.eye(d), (I, 1, 1))
    Q = np.zeros((I, d, d))
    live = np.arange(I) < L
    live[PROP_HOLES[PROP_HOLES < L - 1]] = False
    n = int(live.sum())
    Phi[live] += rng.normal(0, 0.1, (n, d, d))
    A = rng.normal(0, 0.1, (n, d, d))
    Q[live] = A @ A.transpose(0, 2, 1)
    Phi, Q = torch.as_tensor(Phi, dtype=dtype), torch.as_tensor(Q, dtype=dtype)
    n2 = 1 << max(L - 1, 0).bit_length()
    full = tprop.fold_pairs(Phi, Q)
    cut = tprop.fold_pairs(Phi[:n2], Q[:n2])
    assert torch.equal(full[0], cut[0]) and torch.equal(full[1], cut[1])


@pytest.fixture(scope="module")
def blocks(scenario64):
    """A realistic float64 filter state (41 frames into the scenario: a
    19-camera window) and up to 16 features with >= 3 observations."""
    cfg, sc, frames = scenario64
    state, params, _ = run_port(cfg, sc, frames, n=41)
    t = state.features
    cand = (t.valid & (t.obs_mask.sum(1) >= 3)).numpy()
    sel = torch.as_tensor(np.nonzero(cand)[0][:16])
    assert len(sel) >= 4
    return state, params, sel


def _jax_feature_blocks(jst, jparams, sel, D):
    @jax.jit
    def blocks(jst, jparams, sel):
        c, t = jst.cams, jst.features
        return jax.vmap(lambda s: jupd.feature_block(
            c.q, c.p, c.q_null, c.p_null, t.obs[s], t.obs_mask[s], t.position[s],
            jst.gravity, jparams.R_cam0_cam1, jparams.t_cam0_cam1, D))(sel)

    return blocks(jst, jparams, jnp.asarray(sel.numpy()))


def test_feature_block_and_gate_match_jax(blocks):
    state, params, sel = blocks
    cfg = euroc_config(dtype="float64")
    D = cfg.capacity.state_dim
    jst, jparams = to_jax(state), to_jax(params)
    jH, jr, jrows = _jax_feature_blocks(jst, jparams, sel, D)
    c, t = state.cams, state.features
    H, r, rows = tupd.feature_block(c.q, c.p, c.q_null, c.p_null, t.obs[sel], t.obs_mask[sel],
                                    t.position[sel], state.gravity, params.R_cam0_cam1,
                                    params.t_cam0_cam1, D)
    assert_close(H.numpy(), jH, 1e-9, "H_proj")
    assert_close(r.numpy(), jr, 1e-9, "r_proj")
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    dof = t.obs_mask[sel].sum(1).to(torch.int32) - 1
    # residual scales that land on the bounds' pass side, the fail side and
    # the undecided band (exact Cholesky, both row tiers)
    jgate = jax.jit(jupd.gating_test_batch)
    for scale in (1e-3, 1.0, 30.0, 1e3):
        for rows_true in (rows, torch.full_like(rows, 77)):
            want = jgate(jH, jr * scale, jnp.asarray(rows_true.numpy()),
                                          jst.cov, jparams.obs_noise, jparams.chi2_table,
                                          jnp.asarray(dof.numpy()))
            got = tupd.gating_test_batch(H, r * scale, rows_true, state.cov, params.obs_noise,
                                         params.chi2_table, dof)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _two_view_slots(t):
    """The two window slots that the most features are seen from together
    (the prune's ``rm``), and those features."""
    both = (t.obs_mask[:, :, None] & t.obs_mask[:, None, :] & t.valid[:, None, None]).sum(0)
    both.fill_diagonal_(0)
    i, j = divmod(int(both.argmax()), both.shape[0])
    rm = torch.tensor(sorted((i, j)))
    return rm, torch.nonzero(t.valid & (t.obs_mask[:, rm].sum(1) == 2))[:, 0][:16]


@pytest.mark.parametrize("site", ["lost", "prune"])
def test_feature_block_rows_matches_jax_call_sites(blocks, site):
    """The plain ``feature_block_rows`` (K9's row-indexed entry, which the
    back-end's two call sites call) against the JAX package's call-site
    sequence on the same state (``step.py``: the lost features' blocks, a
    cond on ``proc`` per map row; the prune's blocks over the two slots
    ``rm``, their 12 columns masked by ``proc``): float64 within 1e-9,
    rows exact.  ``sel`` ends in padding rows whose ``proc`` is false, as
    ``smallest_k_indices`` pads it, and ``proc`` is false on some real rows."""
    state, params, sel = blocks
    c, t = state.cams, state.features
    D = euroc_config(dtype="float64").capacity.state_dim
    N = c.q.shape[0]
    rm = None
    if site == "prune":
        rm, sel = _two_view_slots(t)
        assert len(sel) >= 4
    rng = np.random.default_rng(9)
    sel = torch.cat([sel, torch.as_tensor(rng.integers(0, t.obs.shape[0], 8))])
    proc = torch.as_tensor(rng.uniform(size=len(sel)) < 0.75)
    proc[-8:] = False
    H, r, rows = tupd.feature_block_rows(c.q, c.p, c.q_null, c.p_null, t.obs, t.obs_mask,
                                         t.position, sel, proc, state.gravity,
                                         params.R_cam0_cam1, params.t_cam0_cam1, D, rm=rm)
    jst, jparams = to_jax(state), to_jax(params)
    jc, jt = jst.cams, jst.features
    fb = functools.partial(jupd.feature_block, gravity=jst.gravity,
                           R_c0c1=jparams.R_cam0_cam1, t_c0c1=jparams.t_cam0_cam1, state_dim=D)
    jsel, jproc = jnp.asarray(sel.numpy()), jnp.asarray(proc.numpy())
    if rm is None:
        def block_one(slot, is_proc):
            def run(_):
                return fb(jc.q, jc.p, jc.q_null, jc.p_null, jt.obs[slot], jt.obs_mask[slot],
                          jt.position[slot])

            def skip(_):
                return (jnp.zeros((4 * N - 3, D), jnp.float64),
                        jnp.zeros((4 * N - 3,), jnp.float64), jnp.zeros((), jnp.int32))

            return jax.lax.cond(is_proc, run, skip, None)

        jH, jr, jrows = jax.jit(jax.vmap(block_one))(jsel, jproc)
    else:
        jrm = jnp.asarray(rm.numpy())

        def block_one(slot):
            H, r, rows = fb(jc.q[jrm], jc.p[jrm], jc.q_null[jrm], jc.p_null[jrm],
                            jt.obs[slot][jrm], jt.obs_mask[slot][jrm], jt.position[slot])
            return H[:, tstate.IMU_DIM:tstate.IMU_DIM + 12], r, rows

        jH, jr, jrows = jax.jit(jax.vmap(block_one))(jsel)
        jH = jnp.where(jproc[:, None, None], jH, 0.0)
        jr = jnp.where(jproc[:, None], jr, 0.0)
        jrows = jnp.where(jproc, jrows, 0)
        assert not bool(H[:, :, :tstate.IMU_DIM].any())
        H = H[:, :, tstate.IMU_DIM:]
        assert set(t.obs_mask[sel[proc]][:, rm].sum(1).tolist()) == {2}
    assert_close(H.numpy(), jH, 1e-9, "H_proj")
    assert_close(r.numpy(), jr, 1e-9, "r_proj")
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert not bool(H[~proc].any()) and not bool(rows[~proc].any())


def _gate_cases(H, r, cov, s2, thresh):
    """Per-block residual scales that force each branch of the gate: r'r
    far under the pass bound (1e-3 of it), far over the fail bound (1e3 x),
    or at the geometric middle of the undecided band between them."""
    rtr = (r * r).sum(-1)
    tr = ((H @ cov) * H).sum((1, 2))
    targets = {"pass": 1e-3 * thresh * s2, "fail": 1e3 * thresh * (s2 + tr),
               "undecided": thresh * torch.sqrt(s2 * (s2 + tr))}
    return {k: torch.sqrt(v / rtr) for k, v in targets.items()}


def test_gate_selection_matches_jax(blocks):
    """The gate's selection (bounds only, the 32-row tier, all rows) against
    the jitted JAX function, on forced cases: every block decided and
    passing; decided blocks mixing pass and fail; one undecided block with
    max(rows_true) <= 32 and with max(rows_true) > 32; R <= 32 prefixes."""
    state, params, sel = blocks
    D = state.cov.shape[0]
    jst, jparams = to_jax(state), to_jax(params)
    jH, jr, _ = _jax_feature_blocks(jst, jparams, sel, D)
    H, r = torch.as_tensor(np.array(jH)), torch.as_tensor(np.array(jr))
    B, R = r.shape
    dof = state.features.obs_mask[sel].sum(1).to(torch.int32) - 1
    thresh = params.chi2_table[dof.long()]
    s2 = params.obs_noise
    scale = _gate_cases(H, r, state.cov, s2, thresh)
    odd = torch.arange(B) % 2 == 1
    one = torch.arange(B) == B // 2
    cases = {
        "all pass": (scale["pass"], torch.full((B,), 20), (B, 0, 0)),
        "pass and fail": (torch.where(odd, scale["fail"], scale["pass"]), torch.full((B,), 20),
                          (B - int(odd.sum()), int(odd.sum()), 0)),
        "undecided, rows <= 32": (torch.where(one, scale["undecided"], scale["pass"]),
                                  torch.full((B,), 20), (B - 1, 0, 1)),
        "undecided, rows > 32": (torch.where(one, scale["undecided"], scale["fail"]),
                                 torch.full((B,), R), (0, B - 1, 1)),
    }
    jgate = jax.jit(jupd.gating_test_batch)
    for name, (sc, rows_true, counts) in cases.items():
        rs = r * sc[:, None]
        ps, fs = tupd.gate_bounds_plain(H, rs, state.cov, s2, thresh)
        assert (int(ps.sum()), int(fs.sum()), int((~(ps | fs)).sum())) == counts, name
        rows_true = rows_true.to(torch.int32)
        want = jgate(jH, jnp.asarray(rs.numpy()), jnp.asarray(rows_true.numpy()), jst.cov,
                     jparams.obs_noise, jparams.chi2_table, jnp.asarray(dof.numpy()))
        got = tupd.gating_test_batch(H, rs, rows_true, state.cov, s2, params.chi2_table, dof)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    # R <= 32: gamma on every row of the prefix, the bounds never consulted
    rs = r * torch.where(one, scale["undecided"], scale["pass"])[:, None]
    rows_true = torch.full((B,), 20, dtype=torch.int32)
    want = jgate(jH[:, :32], jnp.asarray(rs[:, :32].numpy()), jnp.asarray(rows_true.numpy()),
                 jst.cov, jparams.obs_noise, jparams.chi2_table, jnp.asarray(dof.numpy()))
    got = tupd.gating_test_batch(H[:, :32], rs[:, :32], rows_true, state.cov, s2,
                                 params.chi2_table, dof)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg="R <= 32")


@pytest.mark.parametrize("n_rows", [60, 200, 700], ids=["T1", "T2", "QR"])
def test_apply_update_matches_jax(blocks, n_rows):
    state, params, sel = blocks
    D = state.cov.shape[0]
    rng = np.random.default_rng(n_rows)
    H = np.zeros((1680, D))
    H[:n_rows, 21:] = rng.normal(0, 0.5, (n_rows, D - 21))
    H[:n_rows, :21] = rng.normal(0, 0.05, (n_rows, 21))
    r = np.zeros(1680)
    r[:n_rows] = rng.normal(0, 0.01, n_rows)
    jst, jparams = to_jax(state), to_jax(params)
    want, jwarn = jax.jit(jupd.apply_update)(jst, jparams, jnp.asarray(H), jnp.asarray(r),
                                             jnp.asarray(n_rows, jnp.int32))
    got, twarn = tupd.apply_update(state, params, torch.as_tensor(H), torch.as_tensor(r), n_rows)
    for a, b, name in ((got.imu.p, want.imu.p, "p"), (got.imu.q, want.imu.q, "q"),
                       (got.cams.p, want.cams.p, "cams.p"), (got.cams.q, want.cams.q, "cams.q"),
                       (got.cov, want.cov, "cov")):
        assert_close(a.numpy(), b, 1e-9, name)
    assert bool(twarn) == bool(jwarn)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_rows", [60, 200, 700], ids=["T1", "T2", "QR"])
def test_ekf_update_plain_matches_jax(blocks, n_rows, dtype):
    """K11's plain version (delta and the covariance, before the injection)
    against the JAX update on each row tier.  float64 within 1e-9 of
    max(|P|, 1).  float32: both sides factor S = H P H' + s2 I in float32,
    whose condition number (~tr(H P H') / s2, ~1e3 for this stack) scales
    the rounding of either one, so the two float32 results are held within
    1e-4 of max(|P|, 1) of each other and of the float64 update."""
    state, params, _ = blocks
    D = state.cov.shape[0]
    rng = np.random.default_rng(n_rows)
    H = np.zeros((1680, D))
    H[:n_rows, 21:] = rng.normal(0, 0.05, (n_rows, D - 21))
    H[:n_rows, :21] = rng.normal(0, 0.005, (n_rows, 21))
    r = np.zeros(1680)
    r[:n_rows] = rng.normal(0, 0.01, n_rows)
    npdt = np.dtype(dtype)
    tol = 1e-9 if dtype == "float64" else 1e-4
    tdt = torch.float64 if dtype == "float64" else torch.float32
    jst = to_jax(state)._replace(cov=jnp.asarray(state.cov.numpy().astype(npdt)))
    jparams = to_jax(params)._replace(obs_noise=jnp.asarray(params.obs_noise.numpy().astype(npdt)))
    want, _ = jax.jit(jupd.apply_update)(jst, jparams, jnp.asarray(H.astype(npdt)),
                                         jnp.asarray(r.astype(npdt)),
                                         jnp.asarray(n_rows, jnp.int32))
    args = (torch.as_tensor(H).to(tdt), torch.as_tensor(r).to(tdt),
            params.obs_noise.to(tdt), n_rows)
    delta, P_new = tupd.ekf_update(state.cov.to(tdt), *args)
    assert delta.dtype == P_new.dtype == tdt and torch.equal(P_new, P_new.T)
    assert tupd.update_tier(1680, D, n_rows) == {60: "T1", 200: "T2", 700: "QR"}[n_rows]
    assert_close(P_new.numpy(), want.cov, tol, "cov")
    delta64, P64 = tupd.ekf_update_plain(state.cov, torch.as_tensor(H), torch.as_tensor(r),
                                         params.obs_noise, n_rows)
    assert_close(P_new.numpy(), P64.numpy(), tol, "cov against float64")
    assert float((delta.double() - delta64).abs().max()) <= (
        tol * 10 * max(float(delta64.abs().max()), 1e-3))
    if dtype == "float64":  # the injected state moves by the same delta
        got, _ = tupd.apply_update(state, params, *args[:2], rows_true=n_rows)
        assert_close((got.imu.p - state.imu.p).numpy(), delta[12:15].numpy(), 1e-12, "p += delta")


def _wide_state(state, N, count, seed):
    """``state`` (float64) with an N-slot window, its poses repeated and
    nudged, ``count`` of them live, and a random SPD covariance of 21 + 6N
    rows."""
    c = state.cams
    idx = torch.arange(N) % c.q.shape[0]
    nudge = 1e-3 * (torch.arange(N) // c.q.shape[0]).to(c.p.dtype)[:, None]
    cams = c._replace(q=c.q[idx], p=c.p[idx] + nudge, q_null=c.q_null[idx],
                      p_null=c.p_null[idx], timestamp=c.timestamp[idx], sid=c.sid[idx],
                      count=torch.tensor(count, dtype=torch.int32))
    D = 21 + 6 * N
    A = np.random.default_rng(seed).normal(0, 0.02, (D, D))
    return state._replace(cams=cams, cov=torch.as_tensor(A @ A.T / D + 1e-4 * np.eye(D)))


def _cast_tree(tree, dtype):
    return torch.utils._pytree.tree_map(
        lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x, tree)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N,n_rows", [(20, None), (20, 60), (20, 200), (20, 700), (90, 80),
                                      (90, 1122), (90, 1500)],
                         ids=["all", "T1", "T2", "QR", "N90-T1", "N90-T2", "N90-QR"])
def test_apply_update_state_matches_jax(blocks, N, n_rows, dtype):
    """The port's apply_update (the plain version the fused kernel K11 is
    held to on the card) against JAX apply_update as a whole injected state
    (IMU pose, velocity, biases, extrinsics, window poses, covariance,
    too_large) on every row tier: a buffer no taller than T2 ("all"), T1,
    T2 and QR, at the bench window (D = 141) and at max_cam_states = 90
    (D = 561, T2 = 1122 rows: past the old one-block limit of K11 and the
    limits of K13 and K9).  float64 within 1e-9 of max(|x|, 1) per field;
    float32 within 1e-4 (both factor S in float32)."""
    state, params, _ = blocks
    if N != 20:
        state = _wide_state(state, N, N - 5, N)
    D = state.cov.shape[0]
    R = 200 if n_rows is None else (1680 if N == 20 else 1784)
    m = R if n_rows is None else n_rows
    rng = np.random.default_rng(D + m)
    H = np.zeros((R, D))
    H[:m, 21:] = rng.normal(0, 0.05, (m, D - 21))
    H[:m, :21] = rng.normal(0, 0.005, (m, 21))
    r = np.zeros(R)
    r[:m] = rng.normal(0, 0.01, m)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    state, params = _cast_tree(state, tdt), _cast_tree(params, tdt)
    npdt = np.dtype(dtype)
    want, jwarn = jax.jit(jupd.apply_update)(to_jax(state), to_jax(params),
                                             jnp.asarray(H.astype(npdt)),
                                             jnp.asarray(r.astype(npdt)),
                                             jnp.asarray(m, jnp.int32))
    got, twarn = tupd.apply_update(state, params, torch.as_tensor(H).to(tdt),
                                   torch.as_tensor(r).to(tdt), m)
    assert tupd.update_tier(R, D, m) == ("all" if n_rows is None else
                                         "T1" if m <= tupd.update_tiers(D)[0] else
                                         "T2" if m <= tupd.update_tiers(D)[1] else "QR")
    tol = 1e-9 if dtype == "float64" else 1e-4
    for name in ("q", "bg", "v", "ba", "p", "R_imu_cam0", "t_cam0_imu"):
        assert_close(getattr(got.imu, name).numpy(), getattr(want.imu, name), tol, name)
    assert_close(got.cams.q.numpy(), want.cams.q, tol, "cams.q")
    assert_close(got.cams.p.numpy(), want.cams.p, tol, "cams.p")
    assert_close(got.cov.numpy(), want.cov, tol, "cov")
    assert got.cov.dtype == tdt and bool(twarn) == bool(jwarn)


def test_apply_update_rank12_matches_jax(blocks):
    state, params, _ = blocks
    rng = np.random.default_rng(12)
    r0, r1 = 4, 9
    cols = np.concatenate([21 + 6 * r0 + np.arange(6), 21 + 6 * r1 + np.arange(6)])
    B = rng.normal(0, 0.8, (60, 12))
    B[25:35] = 0.0
    r = rng.normal(0, 0.02, 60)
    jst, jparams = to_jax(state), to_jax(params)
    want, _ = jupd.apply_update_rank12(jst, jparams, jnp.asarray(B), jnp.asarray(r),
                                       jnp.asarray(cols))
    got, _ = tupd.apply_update_rank12(state, params, torch.as_tensor(B), torch.as_tensor(r),
                                      torch.as_tensor(cols))
    for a, b, name in ((got.imu.p, want.imu.p, "p"), (got.cams.p, want.cams.p, "cams.p"),
                       (got.cov, want.cov, "cov")):
        assert_close(a.numpy(), b, 1e-9, name)


@pytest.mark.parametrize("n_in", [1, 9, 16])
def test_apply_update_rank12_rows_matches_jax(blocks, n_in):
    """The plain row-indexed K12 entry (what the wrapper runs on CPU
    tensors) against the JAX package's prune call site: the blocks of the
    excluded features masked by ``jnp.where``, stacked, then
    ``apply_update_rank12``; float64 within 1e-9.  16 blocks of 5 rows, of
    which ``n_in`` are included; the excluded ones hold NaN, which the
    masks keep out."""
    state, params, _ = blocks
    rng = np.random.default_rng(n_in)
    cols = np.concatenate([21 + 6 * 4 + np.arange(6), 21 + 6 * 9 + np.arange(6)])
    H = rng.normal(0, 0.8, (16, 5, 33))
    r_blk = rng.normal(0, 0.02, (16, 5))
    include = np.zeros(16, bool)
    include[rng.choice(16, n_in, replace=False)] = True
    H[~include] = np.nan
    r_blk[~include] = np.nan
    jst, jparams = to_jax(state), to_jax(params)
    jinc = jnp.asarray(include)
    B = jnp.where(jinc[:, None, None], jnp.asarray(H[:, :, 21:]), 0.0).reshape(80, 12)
    r_s = jnp.where(jinc[:, None], jnp.asarray(r_blk), 0.0).reshape(80)
    want, jwarn = jupd.apply_update_rank12(jst, jparams, B, r_s, jnp.asarray(cols))
    got, twarn = tupd.apply_update_rank12_rows(state, params, torch.as_tensor(H)[:, :, 21:],
                                               torch.as_tensor(r_blk), torch.as_tensor(include),
                                               torch.as_tensor(cols))
    for a, b, name in ((got.imu.p, want.imu.p, "p"), (got.imu.q, want.imu.q, "q"),
                       (got.cams.p, want.cams.p, "cams.p"), (got.cams.q, want.cams.q, "cams.q"),
                       (got.cov, want.cov, "cov")):
        assert_close(a.numpy(), b, 1e-9, name)
    assert bool(twarn) == bool(jwarn)


def _random_views_inputs(rng, n_feats, N=20, noise=0.002):
    """Window poses and stereo observations of landmarks (the style of
    tests/test_triangulation.py), float64."""
    cam_q = np.zeros((N, 4))
    cam_q[:, 3] = 1.0
    cam_p = np.zeros((N, 3))
    for i in range(N):
        q = np.concatenate([rng.normal(0, 0.05, 3) * 0.5, [1.0]])
        cam_q[i] = q / np.linalg.norm(q)
        cam_p[i] = rng.normal(0, 0.3, 3)
    R_c0c1, t_c0c1 = np.eye(3), np.array([0.11, 0.0, 0.0])
    obs = np.zeros((n_feats, N, 4))
    mask = np.zeros((n_feats, N), bool)
    from uav_airvision_tpu.utils import quaternion as jq

    Rs = np.asarray(jq.to_rotation(jnp.asarray(cam_q)))
    for f in range(n_feats):
        p_w = rng.normal(0, 1.0, 3) + np.array([0.0, 0.0, 4.0])
        first = int(rng.integers(0, N - 3))
        for i in range(first, min(N, first + int(rng.integers(2, 20)))):
            pc0 = Rs[i] @ (p_w - cam_p[i])
            pc1 = pc0 - t_c0c1
            obs[f, i, :2] = pc0[:2] / pc0[2] + rng.normal(0, noise, 2)
            obs[f, i, 2:] = pc1[:2] / pc1[2] + rng.normal(0, noise, 2)
            mask[f, i] = True
    return cam_q, cam_p, obs, mask, R_c0c1, t_c0c1


@pytest.mark.parametrize("noise", [0.0005, 0.01, 0.05])
def test_triangulate_matches_jax(noise):
    rng = np.random.default_rng(int(noise * 1e4))
    cam_q, cam_p, obs, mask, R, t = _random_views_inputs(rng, 24, noise=noise)
    tri_cfg = euroc_config().triangulation
    t_tri_cfg = tconfig.euroc_config().triangulation
    active = rng.uniform(size=24) < 0.85
    @jax.jit
    def jax_tri(obs, mask, active):
        jv = jax.vmap(lambda o, m: jtri.build_views(jnp.asarray(cam_q), jnp.asarray(cam_p), o,
                                                    m, jnp.asarray(R), jnp.asarray(t)))(obs, mask)
        return jax.vmap(lambda v, a: jtri.triangulate(v, tri_cfg, active=a))(jv, active)

    jpos, jok = jax_tri(jnp.asarray(obs), jnp.asarray(mask), jnp.asarray(active))
    window = (torch.as_tensor(x) for x in (cam_q, cam_p, obs, mask, R, t))
    tpos, tok = ttri.triangulate_plain(*window, t_tri_cfg, active=torch.as_tensor(active))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert_close(tpos.numpy(), jpos, 1e-9, "position")


def test_convert_round_trip_exact(port_run):
    state, params, _ = port_run
    for tree in (state, params):
        back = convert.to_numpy(convert.to_torch(convert.to_numpy(tree), CPU))
        for a, b in zip(jax.tree_util.tree_leaves(tuple(convert.to_numpy(tree))),
                        jax.tree_util.tree_leaves(tuple(back))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # JAX trees convert to the same values the port builds itself
    from uav_airvision_tpu.models.frontend.params import make_frontend_params as j_fparams
    from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params

    cfg, tcfg = euroc_config(), tconfig.euroc_config()
    jparams = jstate.make_params(cfg)
    pairs = ((jstate.init_state(cfg, jparams, np.zeros(3), np.array([0.1, 0.2, 9.8])),
              tstate.init_state(tcfg, tstate.make_params(tcfg, CPU), np.zeros(3),
                                np.array([0.1, 0.2, 9.8]))),
             (jparams, tstate.make_params(tcfg, CPU)),
             (j_fparams(cfg), make_frontend_params(tcfg, CPU)))
    for jtree, ttree in pairs:
        conv = convert.to_torch(jtree, CPU)
        for a, b, c in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(tuple(conv)),
                           jax.tree_util.tree_leaves(tuple(ttree))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert b.dtype == c.dtype
            np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=1e-6, atol=1e-7)


# every option of the port's config that the default path leaves off, with
# the JAX package's field names; each must run (none raises)
OPTIONS = [("frontend", dict(exact_adder_mask=True)), ("frontend", dict(stereo_full_backward=True)),
           ("frontend", dict(stereo_seeded=False)), ("frontend", dict(stereo_fwd_levels=2)),
           ("frontend", dict(lk_compact_windows=True)),
           ("frontend", dict(stereo_seed_fallback=False)),
           ("filter", dict(prune_rank12=False)), ("triangulation", dict(translation_threshold=0.05))]


def _run_frames(state, params, cfg, frames, ks):
    outs = []
    for k in ks:
        fr = tstep.FrameInput(**{n: (v if n == "active" else torch.as_tensor(v))
                                 for n, v in frames[k].items()})
        state, out = tstep.backend_step(state, fr, params, cfg)
        outs.append(out)
    return state, outs


def test_ported_options_run(scenario64, blocks):
    """Each of the eight options that the port refused before it ported them
    runs: the front-end ones through two frames of frontend_step (first
    frame, then tracking), the back-end ones through frames 41-44 of the
    oracle scenario (lost-feature updates and a camera prune)."""
    from uav_airvision_tpu_torch.models.frontend import pipeline as tpipe
    from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params
    from tests.test_torch_ops import shifted, textured

    frames = scenario64[2]
    state41, params, _ = blocks
    base = tconfig.euroc_config()
    img0 = textured(120, 160, seed=3, cell=5)
    img2 = shifted(img0, 1.5, -0.8)
    pairs = [(torch.as_tensor(a), torch.as_tensor(shifted(a, -6.0, 0.4))) for a in (img0, img2)]
    for group, over in OPTIONS:
        cfg = dataclasses.replace(base, **{group: dataclasses.replace(getattr(base, group),
                                                                      **over)})
        if group == "frontend":
            fparams = make_frontend_params(cfg, CPU)
            st = tpipe.init_frontend_state(cfg, CPU)
            for c0, c1 in pairs:
                st, out = tpipe.frontend_step(st, c0, c1, torch.zeros(3), torch.tensor(0.05),
                                              fparams, cfg)
            assert int(out.mask.sum()) > 0 and torch.isfinite(out.uv).all(), over
        else:
            cfg = dataclasses.replace(cfg, dtype="float64")
            _, outs = _run_frames(state41, params, cfg, frames, range(41, 45))
            assert any(int(o.n_prune_feats) > 0 for o in outs), over
            assert all(torch.isfinite(o.p).all() for o in outs), over


@pytest.fixture(scope="module")
def pre_prune(scenario64, blocks):
    """The port's float64 filter state as the first camera prune after frame
    41 receives it (a full 20-camera window), captured from backend_step."""
    cfg, _, frames = scenario64
    state41, params, _ = blocks
    captured = []
    orig = tstep.prune_cam_states

    def spy(state, params, config, count):
        if count >= config.filter.max_cam_state_size:
            captured.append((state, count))
        return orig(state, params, config, count)

    tstep.prune_cam_states = spy
    try:
        _run_frames(state41, params, port_config(cfg), frames, range(41, 45))
    finally:
        tstep.prune_cam_states = orig
    state, count = captured[0]
    return state, params, count


@pytest.mark.parametrize("rank12", [True, False], ids=["rank12", "stacked"])
def test_prune_cam_states_matches_jax(pre_prune, rank12):
    """The camera prune under both update forms against JAX
    ``prune_cam_states`` on the same state, float64 within 1e-9 (the bars of
    test_apply_update_matches_jax).  ``stacked`` (filter.prune_rank12=False)
    scatters the gated 5-row blocks into the max_prune_rows buffer in map
    order and runs the EKF update (K11's plain version) on its row tier."""
    state, params, count = pre_prune
    cfg = euroc_config(dtype="float64")
    cfg = dataclasses.replace(cfg, filter=dataclasses.replace(cfg.filter, prune_rank12=rank12))
    tcfg = port_config(cfg)
    jst, jparams = to_jax(state), to_jax(params)
    want, jwarn = jax.jit(functools.partial(jstep.prune_cam_states, params=jparams,
                                            config=cfg))(jst)
    got, twarn, n_two = tstep.prune_cam_states(state, params, tcfg, count)
    assert n_two > 0
    for a, b, name in ((got.imu.p, want.imu.p, "p"), (got.imu.q, want.imu.q, "q"),
                       (got.cams.p, want.cams.p, "cams.p"), (got.cams.q, want.cams.q, "cams.q"),
                       (got.cov, want.cov, "cov")):
        assert_close(a.numpy(), b, 1e-9, name)
    assert int(got.cams.count) == int(want.cams.count) == count - 2
    np.testing.assert_array_equal(got.features.obs_mask.numpy(), np.asarray(want.features.obs_mask))
    assert bool(twarn) == bool(jwarn)
    # the two forms are the same update
    other = dataclasses.replace(tcfg, filter=dataclasses.replace(tcfg.filter,
                                                                 prune_rank12=not rank12))
    alt, _, _ = tstep.prune_cam_states(state, params, other, count)
    assert_close(alt.cov.numpy(), got.cov.numpy(), 1e-9, "rank-12 vs stacked")


@pytest.mark.parametrize("gate", ["as_is", "strict"])
def test_prune_cam_states_rows_entry_matches_jax(pre_prune, gate, monkeypatch):
    """The rank-12 camera prune goes through K12's row-indexed entry
    (``apply_update_rank12_rows``, once, with the gate's ``include``) and
    matches JAX ``prune_cam_states`` on the same state, float64 within
    1e-9.  ``strict``: the chi-square table scaled by 0.01 in both
    packages, so that the gate excludes some of the two-view features."""
    state, params, count = pre_prune
    if gate == "strict":
        params = params._replace(chi2_table=params.chi2_table * 0.01)
    cfg = euroc_config(dtype="float64")
    calls = []
    orig = tstep.apply_update_rank12_rows

    def spy(*args):
        calls.append(args[4].clone())
        return orig(*args)

    monkeypatch.setattr(tstep, "apply_update_rank12_rows", spy)
    got, twarn, n_two = tstep.prune_cam_states(state, params, port_config(cfg), count)
    jst, jparams = to_jax(state), to_jax(params)
    want, jwarn = jax.jit(functools.partial(jstep.prune_cam_states, params=jparams,
                                            config=cfg))(jst)
    assert n_two > 0 and len(calls) == 1
    if gate == "strict":  # the gate leaves out real two-view features
        assert 0 < int(calls[0].sum()) < n_two
    for a, b, name in ((got.imu.p, want.imu.p, "p"), (got.imu.q, want.imu.q, "q"),
                       (got.cams.p, want.cams.p, "cams.p"), (got.cams.q, want.cams.q, "cams.q"),
                       (got.cov, want.cov, "cov")):
        assert_close(a.numpy(), b, 1e-9, name)
    assert bool(twarn) == bool(jwarn)


@pytest.mark.parametrize("threshold", [-1.0, 0.05], ids=["motion_off", "motion_0.05"])
def test_triangulate_rows_matches_jax(blocks, threshold):
    """The back-end's triangulation entry (``triangulate_rows``, its plain
    version on the CPU) against JAX ``_triangulate_one`` vmapped over the
    selected map rows with its call site's writes (JAX step.py:305-320), on
    the 41-frame float64 state: 16 rows with >= 3 observations (every third
    already initialized) and 4 unselected ones.  Validity, the motion
    check, init_fail and the new initialized column identical; positions
    within 1e-9."""
    state, params, sel = blocks
    cfg = euroc_config(dtype="float64")
    cfg = dataclasses.replace(cfg, triangulation=dataclasses.replace(
        cfg.triangulation, translation_threshold=threshold))
    tri_cfg = port_config(cfg).triangulation
    t = state.features
    initialized = t.initialized.clone()
    initialized[sel] = False
    initialized[sel[1::3]] = True
    free = torch.nonzero(~t.valid)[:4, 0]
    rows = torch.cat([sel, free])
    sel_ok = torch.cat([torch.ones_like(sel, dtype=torch.bool),
                        torch.zeros_like(free, dtype=torch.bool)])
    t = t._replace(initialized=initialized)
    jst, jparams = to_jax(state._replace(features=t)), to_jax(params)

    @jax.jit
    def jax_rows(jst, sel, sel_ok):
        table = jst.features
        need = sel_ok & ~table.initialized[sel]
        motion, pos, valid = jax.vmap(lambda slot, act: jstep._triangulate_one(
            jst, jparams, cfg, slot, table.obs_mask[slot], act))(sel, need)
        done = need & motion & valid
        return (table.position.at[sel].set(jnp.where(done[:, None], pos, table.position[sel])),
                table.initialized.at[sel].set(table.initialized[sel] | done),
                need & (~motion | ~valid), motion, valid)

    jpos, jinit, jfail, jmotion, jvalid = jax_rows(jst, jnp.asarray(rows.numpy()),
                                                   jnp.asarray(sel_ok.numpy()))
    c = state.cams
    args = (c.q, c.p, t.obs, t.obs_mask, t.position, t.initialized, rows, sel_ok,
            params.R_cam0_cam1, params.t_cam0_cam1, tri_cfg)
    pos, init, fail = ttri.triangulate_rows(*args)
    need = sel_ok & ~t.initialized[rows]
    _, valid = ttri.triangulate_plain(c.q, c.p, t.obs[rows], t.obs_mask[rows],
                                      params.R_cam0_cam1, params.t_cam0_cam1, tri_cfg,
                                      active=need)
    np.testing.assert_array_equal(valid.numpy()[need.numpy()], np.asarray(jvalid)[need.numpy()])
    if threshold >= 0:
        motion = ttri.check_motion(c.q, c.p, t.obs[rows], t.obs_mask[rows], tri_cfg)
        np.testing.assert_array_equal(motion.numpy()[need.numpy()],
                                      np.asarray(jmotion)[need.numpy()])
    np.testing.assert_array_equal(fail.numpy(), np.asarray(jfail))
    np.testing.assert_array_equal(init.numpy(), np.asarray(jinit))
    assert_close(pos.numpy(), jpos, 1e-9, "position")
    # motion off: some rows get a position; at 0.05 m the check rejects rows
    assert bool(fail.any()) if threshold >= 0 else bool((init != t.initialized).any())
    assert torch.equal(t.initialized, initialized)  # the inputs stay as they were


@pytest.mark.parametrize("threshold", [0.2, 0.4, 0.6])
def test_check_motion_matches_jax(threshold):
    """The triangulation motion check (translation_threshold >= 0) against
    JAX ``check_motion`` per feature: identical decisions."""
    rng = np.random.default_rng(int(threshold * 100))
    cam_q, cam_p, obs, mask, R, t = _random_views_inputs(rng, 48)
    tri_cfg = dataclasses.replace(euroc_config().triangulation, translation_threshold=threshold)
    t_tri_cfg = dataclasses.replace(tconfig.euroc_config().triangulation,
                                    translation_threshold=threshold)

    @jax.jit
    def jax_motion(obs, mask):
        def one(o, m):
            views = jtri.build_views(jnp.asarray(cam_q), jnp.asarray(cam_p), o, m,
                                     jnp.asarray(R), jnp.asarray(t))
            first_z = o[jnp.argmax(m), :2]
            return jtri.check_motion(views, m, first_z, tri_cfg, jnp.asarray(cam_q),
                                     jnp.asarray(cam_p))
        return jax.vmap(one)(obs, mask)

    want = np.asarray(jax_motion(jnp.asarray(obs), jnp.asarray(mask)))
    got = ttri.check_motion(torch.as_tensor(cam_q), torch.as_tensor(cam_p), torch.as_tensor(obs),
                            torch.as_tensor(mask), t_tri_cfg)
    assert 0 < want.sum() < len(want)  # both outcomes occur
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("option", ["stereo_fwd_levels", "stereo_full_backward",
                                    "stereo_seeded=False", "stereo_seed_fallback=False",
                                    "lk_compact_windows"])
def test_stereo_match_options_match_jax(option):
    """``stereo_match`` as the front-end calls it under each stereo option,
    against JAX: inlier flags equal on >= 98% of points and matched points
    within 1e-3 px where both keep them (the LK bar of test_torch_ops.py).
    stereo_seeded=False: rotation-projected seeds, the full pyramid;
    stereo_seed_fallback=False: always the disparity seeds on
    stereo_seeded_levels levels."""
    from uav_airvision_tpu.models.frontend import stereo as jstereo
    from uav_airvision_tpu.models.frontend.params import make_frontend_params as j_fparams
    from uav_airvision_tpu.ops import extract as jext
    from uav_airvision_tpu.ops import pyramid as jpyr
    from uav_airvision_tpu_torch.models.frontend import stereo as tstereo
    from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params
    from uav_airvision_tpu_torch.ops import pyramid as tpyr
    from tests.test_torch_ops import shifted, textured

    over = {"stereo_fwd_levels": dict(stereo_fwd_levels=2),
            "stereo_full_backward": dict(stereo_full_backward=True),
            "stereo_seeded=False": dict(stereo_seeded=False),
            "stereo_seed_fallback=False": dict(stereo_seed_fallback=False),
            "lk_compact_windows": dict(lk_compact_windows=True)}[option]
    cfg = euroc_config()
    # lk_static_iters=False: the same steps as a while loop (config.py), a
    # shorter JAX compile; the port has one form
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, **over,
                                                                lk_static_iters=False))
    tcfg = port_config(cfg)
    H, W = 240, 320
    img0 = textured(H, W, seed=11, cell=6)
    img1 = shifted(img0, -4.3, 0.6)
    rng = np.random.default_rng(12)
    pts = rng.uniform([15, 15], [W - 15, H - 15], (96, 2)).astype(np.float32)
    valid = rng.uniform(size=96) < 0.9
    seeded = option == "stereo_seed_fallback=False"
    seed = (pts + np.array([-4.0, 0.5], np.float32)
            + rng.normal(0, 0.7, (96, 2)).astype(np.float32))
    seed_ok = rng.uniform(size=96) < 0.8
    kw = dict(n_fwd_levels=cfg.frontend.stereo_seeded_levels) if seeded else {}
    jp0 = jext.band_pyramid(jpyr.build_pyramid_padded(jnp.asarray(img0), 3), dtype=jnp.bfloat16)
    jp1 = jext.band_pyramid(jpyr.build_pyramid_padded(jnp.asarray(img1), 3), dtype=jnp.bfloat16)
    jargs = (jnp.asarray(seed), jnp.asarray(seed_ok)) if seeded else (None, None)
    jcall = jax.jit(lambda a, b, p, v, s, o: jstereo.stereo_match(
        a, b, p, v, j_fparams(cfg), cfg, init_cam1=s, init_ok=o, **kw))
    jp, jin = jcall(jp0, jp1, jnp.asarray(pts), jnp.asarray(valid), *jargs)
    targs = (torch.as_tensor(seed), torch.as_tensor(seed_ok)) if seeded else (None, None)
    tp, tin = tstereo.stereo_match(tpyr.build_pyramid_padded(torch.as_tensor(img0), 3),
                                   tpyr.build_pyramid_padded(torch.as_tensor(img1), 3),
                                   torch.as_tensor(pts), torch.as_tensor(valid),
                                   make_frontend_params(tcfg, CPU), tcfg, init_cam1=targs[0],
                                   init_ok=targs[1], **kw)
    jp, jin, tp, tin = np.asarray(jp), np.asarray(jin), tp.numpy(), tin.numpy()
    assert (tin == jin).mean() >= 0.98
    both = tin & jin
    assert both.sum() >= 30
    np.testing.assert_allclose(tp[both], jp[both], atol=1e-3, rtol=0)


@pytest.mark.parametrize("kernel", ["K11 mixed tiers", "K12"])
def test_fleet_update_plain_matches_jax(blocks, kernel):
    """The batched plain versions of K11 (``apply_update_fleet_plain``) and
    K12 (``apply_update_rank12_rows_fleet_plain``) on three instances (the
    41-frame state, inputs from a numpy seed: K11 on a T1, a T2 and a QR
    stack, K12 on 16, 8 and 12 features with their own two cameras) against
    the JAX package: K11 ``apply_update`` instance by instance at each row
    tier, K12 ``jax.vmap`` of ``apply_update_rank12`` over the masked
    stacks; float64 within 1e-9 of max(|x|, 1) per field."""
    state, params, _ = blocks
    S, D = 3, state.cov.shape[0]
    rng = np.random.default_rng(31)
    bstate = tree.map_leaves(lambda x: torch.stack([x] * S), state)
    jst, jparams = to_jax(state), to_jax(params)
    upd, mask = [True] * S, torch.ones(S, dtype=torch.bool)
    if kernel.startswith("K11"):
        rows = [60, 200, 700]
        H = np.zeros((S, 1680, D))
        r = np.zeros((S, 1680))
        for b, m in enumerate(rows):
            H[b, :m, 21:] = rng.normal(0, 0.5, (m, D - 21))
            H[b, :m, :21] = rng.normal(0, 0.05, (m, 21))
            r[b, :m] = rng.normal(0, 0.01, m)
        got, twarn = tupd.apply_update_fleet_plain(bstate, params, torch.as_tensor(H),
                                                   torch.as_tensor(r), rows, upd, mask)
        fn = jax.jit(jupd.apply_update)
        wants = [fn(jst, jparams, jnp.asarray(H[b]), jnp.asarray(r[b]),
                    jnp.asarray(m, jnp.int32)) for b, m in enumerate(rows)]
        want = jax.tree.map(lambda *xs: jnp.stack(xs), *[w for w, _ in wants])
        jwarn = np.array([bool(w) for _, w in wants])
    else:
        n_feats, K = [16, 8, 12], 16
        H = rng.normal(0, 0.8, (S, K, 5, 33))
        r_blk = rng.normal(0, 0.02, (S, K, 5))
        include = rng.uniform(size=(S, K)) < 0.7
        for b, k in enumerate(n_feats):
            include[b, k:] = False
        H[~include], r_blk[~include] = np.nan, np.nan
        cols = np.stack([np.concatenate([21 + 6 * a + np.arange(6), 21 + 6 * c + np.arange(6)])
                         for a, c in ((4, 9), (2, 3), (10, 15))])
        got, twarn = tupd.apply_update_rank12_rows_fleet_plain(
            bstate, params, torch.as_tensor(H)[..., 21:], torch.as_tensor(r_blk),
            torch.as_tensor(include), torch.as_tensor(cols), upd, mask, n_feats)
        jinc = jnp.asarray(include)
        B = jnp.where(jinc[..., None, None], jnp.asarray(H[..., 21:]), 0.0).reshape(S, K * 5, 12)
        r_s = jnp.where(jinc[..., None], jnp.asarray(r_blk), 0.0).reshape(S, K * 5)
        jbst = jax.tree.map(lambda x: jnp.stack([x] * S), jst)
        want, jwarn = jax.vmap(jupd.apply_update_rank12, in_axes=(0, None, 0, 0, 0))(
            jbst, jparams, B, r_s, jnp.asarray(cols))
    for a, b, name in ((got.imu.p, want.imu.p, "p"), (got.imu.q, want.imu.q, "q"),
                       (got.imu.v, want.imu.v, "v"), (got.cams.p, want.cams.p, "cams.p"),
                       (got.cams.q, want.cams.q, "cams.q"), (got.cov, want.cov, "cov")):
        for i in range(S):
            assert_close(a[i].numpy(), b[i], 1e-9, f"instance {i}: {name}")
    np.testing.assert_array_equal(twarn.numpy(), np.asarray(jwarn))
