"""Gram-phase masked sweep (ops/sweep_masked_gram.py): parity with a
naive NumPy phase-order masked oracle, chunked segment-sum parity, the
Gram objective identity, driver routing/fallbacks, and inner_reps reuse.

The oracle computes the per-topic masked quantities directly from the
partially-updated factors (reference ``nmf.py:687-746`` subproblems in
phase order), so any mistake in the Γ/Θ factorization or the
Gauss-Seidel correction terms breaks parity at O(1)."""

import numpy as np
import pytest
import scipy.sparse as sp

from rri_nmf_tpu.matrixops import EPS_DIV_BY_ZERO
from rri_nmf_tpu.nmf import nmf


def _proj_simplex(v, s):
    u = np.sort(v)[::-1]
    css = np.cumsum(u)
    rho = np.nonzero(u * np.arange(1, v.size + 1) > (css - s))[0][-1]
    theta = (css[rho] - s) / (rho + 1.0)
    return np.clip(v - theta, 0, None)


def _qf_vec(w, c, s, ub):
    """qf_min_vector_c semantics (optimization.py:120-144): solve on the
    c > 0 coordinates, clip to ub, guarded rescale to sum s."""
    if ub is None:
        ub_eff = s if s else None
    elif np.isscalar(ub):
        ub_eff = min(ub, s) if s else ub
    else:
        ub_eff = np.minimum(ub, s) if s else ub
    x = np.where(c > 0, np.maximum(-w, 0.0)
                 / (np.where(c > 0, c, 1.0) + EPS_DIV_BY_ZERO), 0.0)
    if ub_eff is not None:
        x = np.minimum(x, ub_eff)
    nx = x.sum()
    if s is not None and nx > 0:
        x = s * x / nx
    return x


def _numpy_masked_phase_sweep(X, M, W, T, *, inner_reps=1,
                              reg_w_l1=0.0, reg_w_l2=0.0,
                              reg_t_l1=0.0, reg_t_l2=0.0,
                              project_T_each_iter=False,
                              project_W_each_iter=False,
                              t_row_sum=None, w_row_sum=None,
                              fix_T=False, fix_W=False):
    """Phase-order masked sweep, naive per-topic masked contractions.
    No scale transfer (disabled in phase order) and no resets."""
    k = W.shape[1]
    s_t = t_row_sum if project_T_each_iter else None
    MX = M * X
    if not fix_T:
        A = W.T @ MX                                   # frozen all phase
        for _ in range(inner_reps):
            for t in range(k):
                Gt = (W[:, t:t + 1] * W).T @ M         # (k, d) Γ[t, :]
                corr = (Gt * T).sum(0) - Gt[t] * T[t]
                wR = A[t] - corr
                nw = Gt[t]
                T[t] = _qf_vec(-(wR - reg_t_l1), nw + reg_t_l2, s_t,
                               t_row_sum)
                if t_row_sum and project_T_each_iter and \
                        abs(T[t].sum() - t_row_sum) > 1e-15:
                    T[t] = _proj_simplex(T[t], t_row_sum)
    if not fix_W:
        C = MX @ T.T                                   # (n, k)
        for _ in range(inner_reps):
            for t in range(k):
                Ht = M @ (T[t:t + 1, :] * T).T         # (n, k) Θ[t, :]
                corr = (Ht * W).sum(1) - Ht[:, t] * W[:, t]
                Rt = C[:, t] - corr
                nt = Ht[:, t]
                W[:, t] = _qf_vec(-(Rt - reg_w_l1), nt + reg_w_l2, None,
                                  w_row_sum)
    if project_W_each_iter and not fix_W and w_row_sum is not None:
        wrs = (np.broadcast_to(w_row_sum, (W.shape[0],))
               if not np.isscalar(w_row_sum)
               else np.full(W.shape[0], w_row_sum))
        for i in range(W.shape[0]):
            W[i] = _proj_simplex(W[i], wrs[i])
    return W, T


def _problem(seed, n=30, d=24, k=4, density=0.35):
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density).astype(float)
    X = rng.rand(n, d) * M
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, M, W0, T0


def _run_gram(X, M, W0, T0, sweeps, **kw):
    """Drive make_masked_gram_sweep directly (f64, no driver layers)."""
    import jax
    import jax.numpy as jnp

    from rri_nmf_tpu.ops.sweep_masked_gram import (make_masked_gram_sweep,
                                                   plan_masked_gram)
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig

    cfg = SweepConfig(k=W0.shape[1], masked=True, masked_sparse=True,
                      update_order='phase', reset_topic_method=None,
                      **kw)
    plan = plan_masked_gram(X, sp.csr_matrix(M), np.float64)
    sweep = make_masked_gram_sweep(cfg)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    out = []
    for _ in range(sweeps):
        W, T, key, r = sweep(plan, W, T, key, r, key)
        out.append((np.array(W), np.array(T)))
    return out


ORACLE_CONFIGS = [
    dict(),
    dict(project_T_each_iter=True, t_row_sum=1.0),
    dict(reg_t_l2=0.1, reg_w_l2=0.05),
    dict(reg_t_l1=0.02, reg_w_l1=0.01),
    dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
         project_W_each_iter=True),
    dict(w_row_sum=2.0),
    dict(inner_reps=3, project_T_each_iter=True, t_row_sum=1.0),
    dict(fix_T=True),
    dict(fix_W=True, project_T_each_iter=True, t_row_sum=1.0),
]


@pytest.mark.parametrize('kw', ORACLE_CONFIGS)
def test_gram_sweep_matches_phase_oracle(kw):
    X, M, W0, T0 = _problem(0)
    cfg_kw = dict(kw)
    cfg_kw.setdefault('inner_reps', 1)
    traj = _run_gram(X, M, W0, T0, 3, **cfg_kw)
    Wn, Tn = W0.copy(), T0.copy()
    for it, (Wj, Tj) in enumerate(traj):
        Wn, Tn = _numpy_masked_phase_sweep(X, M, Wn, Tn, **kw)
        np.testing.assert_allclose(Wj, Wn, atol=1e-10, rtol=0,
                                   err_msg='sweep %d %r' % (it, kw))
        np.testing.assert_allclose(Tj, Tn, atol=1e-10, rtol=0,
                                   err_msg='sweep %d %r' % (it, kw))


@pytest.mark.parametrize('seed', range(4))
def test_gram_sweep_oracle_randomized(seed):
    rng = np.random.RandomState(200 + seed)
    n = int(rng.randint(15, 45))
    d = int(rng.randint(12, 40))
    k = int(rng.randint(2, 6))
    X, M, W0, T0 = _problem(300 + seed, n=n, d=d, k=k,
                            density=float(rng.uniform(0.2, 0.6)))
    kw = {}
    if rng.rand() < 0.6:
        kw['project_T_each_iter'] = True
        kw['t_row_sum'] = float(rng.choice([1.0, 2.0]))
    if rng.rand() < 0.4:
        kw['w_row_sum'] = float(rng.choice([1.0, 3.0]))
        kw['project_W_each_iter'] = rng.rand() < 0.5
    for r in ('reg_w_l1', 'reg_w_l2', 'reg_t_l1', 'reg_t_l2'):
        if rng.rand() < 0.4:
            kw[r] = float(rng.choice([0.01, 0.1]))
    inner = int(rng.choice([1, 1, 2]))
    traj = _run_gram(X, M, W0, T0, 2, inner_reps=inner, **kw)
    Wn, Tn = W0.copy(), T0.copy()
    for it, (Wj, Tj) in enumerate(traj):
        Wn, Tn = _numpy_masked_phase_sweep(X, M, Wn, Tn,
                                           inner_reps=inner, **kw)
        np.testing.assert_allclose(Wj, Wn, atol=1e-10, rtol=0,
                                   err_msg=repr((seed, kw, it)))
        np.testing.assert_allclose(Tj, Tn, atol=1e-10, rtol=0,
                                   err_msg=repr((seed, kw, it)))


def test_vector_w_row_sum_matches_oracle():
    X, M, W0, T0 = _problem(5)
    wrs = 0.5 + np.random.RandomState(5).rand(X.shape[0])
    import jax
    import jax.numpy as jnp

    from rri_nmf_tpu.ops.sweep_masked_gram import (make_masked_gram_sweep,
                                                   plan_masked_gram)
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig
    cfg = SweepConfig(k=4, masked=True, masked_sparse=True,
                      update_order='phase', reset_topic_method=None,
                      w_row_sum_is_vector=True, project_W_each_iter=True)
    plan = plan_masked_gram(X, sp.csr_matrix(M), np.float64)
    sweep = make_masked_gram_sweep(cfg)
    key = jax.random.PRNGKey(0)
    W, T, _, _ = sweep(plan, jnp.asarray(W0), jnp.asarray(T0), key,
                       jnp.asarray(0, jnp.int32), key, jnp.asarray(wrs))
    Wn, Tn = _numpy_masked_phase_sweep(X, M, W0.copy(), T0.copy(),
                                       w_row_sum=wrs,
                                       project_W_each_iter=True)
    np.testing.assert_allclose(np.array(W), Wn, atol=1e-10, rtol=0)
    np.testing.assert_allclose(np.array(T), Tn, atol=1e-10, rtol=0)


def test_mxu_segmented_plan_matches_segsum(monkeypatch):
    """The segment sums run over observation chunks (bounded O(chunk·k²)
    temporaries): a tiny chunk — several full chunks plus a remainder —
    gives the same sweep and objective as one chunk."""
    import jax
    import jax.numpy as jnp
    import rri_nmf_tpu.ops.sweep_masked_gram as smg
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig
    X, M, W0, T0 = _problem(12, n=300, d=200, k=4, density=0.5)
    t1 = _run_gram(X, M, W0, T0, 1)
    monkeypatch.setattr(smg, '_SEG_CHUNK', 997)
    plan = smg.plan_masked_gram(X, sp.csr_matrix(M), np.float64)
    assert plan.nnz > 3 * 997
    cfg = SweepConfig(k=4, masked=True, masked_sparse=True,
                      update_order='phase', reset_topic_method=None)
    sweep = smg.make_masked_gram_sweep.__wrapped__(cfg)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    for (W1, T1) in t1:
        W, T, key, r = sweep(plan, W, T, key, r, key)
        np.testing.assert_allclose(np.array(W), W1, atol=1e-9, rtol=0)
        np.testing.assert_allclose(np.array(T), T1, atol=1e-9, rtol=0)
    fn = smg.make_masked_gram_objective()
    direct = 0.5 * np.sum(M * (X - np.array(W) @ np.array(T)) ** 2)
    np.testing.assert_allclose(float(fn(plan, W, T)), direct, rtol=1e-9)


@pytest.mark.parametrize('chunk', [7, 64])
def test_mxu_backend_matches_segsum(monkeypatch, chunk):
    """Chunked segment sums at chunk sizes that do and do not divide the
    padded observation count agree with the one-chunk sweep on the full
    TM constraint set."""
    import rri_nmf_tpu.ops.sweep_masked_gram as smg
    X, M, W0, T0 = _problem(7, n=40, d=33, k=5)
    kw = dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
              project_W_each_iter=True)
    t1 = _run_gram(X, M, W0, T0, 2, **kw)
    monkeypatch.setattr(smg, '_SEG_CHUNK', chunk)
    smg.make_masked_gram_sweep.cache_clear()
    try:
        t2 = _run_gram(X, M, W0, T0, 2, **kw)
    finally:
        smg.make_masked_gram_sweep.cache_clear()
    for (W1, T1), (W2, T2) in zip(t1, t2):
        np.testing.assert_allclose(W2, W1, atol=1e-9, rtol=0)
        np.testing.assert_allclose(T2, T1, atol=1e-9, rtol=0)


def test_gram_objective_identity():
    """‖√M⊙(X−WT)‖² via the Gram identity equals the direct masked
    objective."""
    import jax.numpy as jnp

    from rri_nmf_tpu.ops.sweep_masked_gram import (
        make_masked_gram_objective, plan_masked_gram)
    X, M, W0, T0 = _problem(9)
    regs = dict(reg_w_l2=0.02, reg_t_l2=0.01, reg_w_l1=0.005,
                reg_t_l1=0.003)
    direct = 0.5 * np.sum(M * (X - W0 @ T0) ** 2) \
        + 0.5 * regs['reg_w_l2'] * np.sum(W0 ** 2) \
        + 0.5 * regs['reg_t_l2'] * np.sum(T0 ** 2) \
        + regs['reg_w_l1'] * np.sum(np.abs(W0)) \
        + regs['reg_t_l1'] * np.sum(np.abs(T0))
    plan = plan_masked_gram(X, sp.csr_matrix(M), np.float64)
    fn = make_masked_gram_objective(**regs)
    got = float(fn(plan, jnp.asarray(W0), jnp.asarray(T0)))
    np.testing.assert_allclose(got, direct, rtol=1e-10)


def _driver_kw(**extra):
    """Exact-update config (no T-row rescale, no post-loop W projection):
    every phase-order update is an exact coordinate minimization, so
    descent is monotone and the final in-loop objective is the returned
    factors' objective."""
    kw = dict(max_iter=10, compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None,
              reg_t_l1=0.01, reg_w_l1=0.01)
    kw.update(extra)
    return kw


def test_driver_routes_phase_to_gram(caplog):
    """nmf() with a scipy-sparse W_mat + update_order='phase' runs the
    Gram-phase sweep: monotone descent and a final objective at least as
    good as the interleaved O(nnz) sweep's on the same data."""
    X, M, _, _ = _problem(1)
    Ms = sp.csr_matrix(M)
    rg = nmf(X, 4, W_mat=Ms, update_order='phase',
             **_driver_kw(max_iter=30))
    ri = nmf(X, 4, W_mat=Ms, update_order='interleaved',
             **_driver_kw(max_iter=30))
    og = np.array(rg['obj_history'])
    assert np.all(np.diff(og) <= 1e-12), 'gram-phase descent broken'
    # different cyclic orders reach different (comparable) stationary
    # points under L1; exact semantics are pinned by the oracle tests
    assert og[-1] <= ri['obj_history'][-1] * 1.25
    # the returned obj_calculator keeps evaluating on the Gram plan
    oc = rg['obj_calculator']
    assert abs(oc.true_objective() - og[-1]) < 1e-10


def test_driver_gram_projected_near_monotone():
    """With project_T_each_iter + a VECTOR curvature the reference's
    qf rescale-to-sum is a heuristic (not an exact simplex step) — the
    same approximation the interleaved masked sweep inherits
    (optimization.py:140-143). Descent holds to that heuristic's slack
    in phase order too, and the run still converges."""
    X, M, _, _ = _problem(1)
    Ms = sp.csr_matrix(M)
    kw = dict(max_iter=12, compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None, w_row_sum=1.0, t_row_sum=1.0,
              project_T_each_iter=True)
    rg = nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    og = np.array(rg['obj_history'])
    assert np.all(np.diff(og) <= 0.05 * np.abs(og[:-1])), og
    assert og[-1] <= og[0]
    assert np.allclose(rg['T'].sum(axis=1), 1.0, atol=1e-12)


def test_driver_gram_inner_reps_stepped_equals_batch():
    """inner_reps>1 is supported on the Gram route (A/Γ reuse is exact),
    and grouped dispatch preserves bitwise results."""
    X, M, _, _ = _problem(2)
    Ms = sp.csr_matrix(M)
    kw = _driver_kw(inner_reps=2)
    r1 = nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    r2 = nmf(X, 4, W_mat=Ms, update_order='phase', sweeps_per_dispatch=5,
             **kw)
    np.testing.assert_array_equal(r1['W'], r2['W'])
    np.testing.assert_array_equal(r1['T'], r2['T'])
    assert np.all(np.diff(r1['obj_history']) <= 1e-12)


def test_driver_fallbacks_to_interleaved():
    """phase + (resets | huge Gram) falls back to the interleaved masked
    sweep — bitwise equal to asking for interleaved directly, and LOUD:
    a RuntimeWarning names the declined gate and the cost (a perf cliff
    must not hide at INFO)."""
    X, M, _, _ = _problem(3)
    Ms = sp.csr_matrix(M)
    kw = _driver_kw(reset_topic_method='random', n_resets=2)
    with pytest.warns(RuntimeWarning, match=r'k O\(nnz\) passes'):
        rp = nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    ri = nmf(X, 4, W_mat=Ms, update_order='interleaved', **kw)
    np.testing.assert_array_equal(rp['W'], ri['W'])
    np.testing.assert_array_equal(rp['T'], ri['T'])


def test_driver_gram_dp_noise_runs():
    """The DP Gaussian mechanism runs on the Gram route (per-topic noise
    on the T numerator/denominator) and the result is reproducible for a
    fixed random_state."""
    X, M, _, _ = _problem(6)
    Ms = sp.csr_matrix(M)
    kw = _driver_kw(eps_gauss_t=1e4, delta_gauss_t=0.1, max_iter=4)
    r1 = nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    r2 = nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    assert np.all(np.isfinite(r1['W'])) and np.all(np.isfinite(r1['T']))
    np.testing.assert_array_equal(r1['W'], r2['W'])


def test_obj_calculator_pickles_gram_plan():
    import pickle
    X, M, _, _ = _problem(8)
    r = nmf(X, 4, W_mat=sp.csr_matrix(M), update_order='phase',
            **_driver_kw(max_iter=3))
    oc = pickle.loads(pickle.dumps(r['obj_calculator']))
    assert abs(oc.true_objective() - r['obj_history'][-1]) < 1e-10


def test_checkpoint_resume_gram(tmp_path):
    """Resume from a mid-fit checkpoint reproduces the straight Gram-phase
    run (the MaskedGramPlan round-trips through its COO core)."""
    X, M, _, _ = _problem(10)
    Ms = sp.csr_matrix(M)
    ckpt = str(tmp_path / 'gram_ck')
    kw = _driver_kw(max_iter=8)
    r1 = nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    nmf(X, 4, W_mat=Ms, update_order='phase',
        checkpoint=ckpt, checkpoint_every=3, **_driver_kw(max_iter=5))
    r2 = nmf(X, 4, W_mat=Ms, update_order='phase',
             checkpoint=ckpt, checkpoint_every=100, **kw)
    np.testing.assert_allclose(r2['W'], r1['W'], atol=1e-12)
    np.testing.assert_allclose(r2['T'], r1['T'], atol=1e-12)
    assert len(r2['obj_history']) == len(r1['obj_history'])


def test_rs_estimator_gram_recipe():
    """NMF_RS_Estimator(sparse_obs=True, nmf_kwargs=dict(
    update_order='phase')) rides the Gram-phase sweep end to end —
    including validation early stopping — and scores comparably to the
    default interleaved fit."""
    from rri_nmf_tpu.sklearn_interface import NMF_RS_Estimator
    rng = np.random.RandomState(0)
    n, d, k = 60, 45, 4
    Mask = rng.rand(n, d) < 0.3
    Xr = (rng.rand(n, k) @ rng.rand(k, d)) * Mask * 5
    I, J = Mask.nonzero()
    X = np.stack([I, J], 1)
    R = Xr[I, J]
    e1 = NMF_RS_Estimator(n, d, k, random_state=0, max_iter=10,
                          sparse_obs=True).fit(X, R)
    e2 = NMF_RS_Estimator(n, d, k, random_state=0, max_iter=10,
                          sparse_obs=True,
                          nmf_kwargs=dict(update_order='phase')).fit(X, R)
    s1, s2 = e1.score(X, R), e2.score(X, R)
    assert s2 < max(1.0, 1.5 * s1), (s1, s2)
    assert len(e2.nmf_outputs['obj_history']) >= 2


def test_plan_masked_gram_layouts():
    """The plan's COO arrays are padded with zero-weight entries, sum_mx2
    is the exact observed second moment, and the plan round-trips to
    scipy."""
    from rri_nmf_tpu.ops.sweep_masked_gram import plan_masked_gram
    X, M, _, _ = _problem(11, n=21, d=13)
    plan = plan_masked_gram(X, sp.csr_matrix(M), np.float64)
    assert plan.nnz == int(M.sum())
    assert plan.coo.rows.shape[0] >= plan.nnz
    assert float(np.asarray(plan.coo.m_vals)[plan.nnz:].sum()) == 0.0
    np.testing.assert_allclose(float(plan.sum_mx2),
                               np.sum(M * X ** 2), rtol=1e-12)
    Ms2, Xs2 = plan.to_scipy()
    np.testing.assert_array_equal(Ms2.toarray(), M)


# ---------------------------------------------------------------------------
# k-panel tiling (VERDICT r5 item 3): Γ/Θ built in (p, k, ·) tiles
# ---------------------------------------------------------------------------

def _run_gram_panel(X, M, W0, T0, sweeps, panel, **kw):
    import jax
    import jax.numpy as jnp

    from rri_nmf_tpu.ops.sweep_masked_gram import (make_masked_gram_sweep,
                                                   plan_masked_gram)
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig

    cfg = SweepConfig(k=W0.shape[1], masked=True, masked_sparse=True,
                      update_order='phase', reset_topic_method=None,
                      **kw)
    plan = plan_masked_gram(X, sp.csr_matrix(M), np.float64)
    sweep = make_masked_gram_sweep(cfg, panel=panel)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    out = []
    for _ in range(sweeps):
        W, T, key, r = sweep(plan, W, T, key, r, key)
        out.append((np.array(W), np.array(T)))
    return out


@pytest.mark.parametrize('panel', [1, 2, 3])
@pytest.mark.parametrize('kw', [
    dict(),
    dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
         project_W_each_iter=True),
    dict(reg_t_l1=0.02, reg_w_l2=0.05),
    dict(inner_reps=2),
    dict(fix_T=True),
])
def test_panel_sweep_bitwise_equals_full(panel, kw):
    """Panel-tiled sweeps run the IDENTICAL Gauss-Seidel sequence as the
    full-tensor path — every panel's corrections read the current
    partially-updated factor, so results agree to f64 roundoff for any
    panel size (including ragged last panels: k=4 with p=3)."""
    X, M, W0, T0 = _problem(21, k=4)
    full = _run_gram(X, M, W0, T0, 3, **kw)
    tiled = _run_gram_panel(X, M, W0, T0, 3, panel, **kw)
    for (W1, T1), (W2, T2) in zip(full, tiled):
        np.testing.assert_allclose(W2, W1, atol=1e-13, rtol=0)
        np.testing.assert_allclose(T2, T1, atol=1e-13, rtol=0)


def test_panel_sweep_mxu_backend(monkeypatch):
    """Panel contractions over small observation chunks match the
    one-chunk panel path."""
    import rri_nmf_tpu.ops.sweep_masked_gram as smg
    X, M, W0, T0 = _problem(22, n=40, d=33, k=5)
    t1 = _run_gram_panel(X, M, W0, T0, 2, 2)
    monkeypatch.setattr(smg, '_SEG_CHUNK', 13)
    smg.make_masked_gram_sweep.cache_clear()
    try:
        t2 = _run_gram_panel(X, M, W0, T0, 2, 2)
    finally:
        smg.make_masked_gram_sweep.cache_clear()
    for (W1, T1), (W2, T2) in zip(t1, t2):
        np.testing.assert_allclose(W2, W1, atol=1e-9, rtol=0)
        np.testing.assert_allclose(T2, T1, atol=1e-9, rtol=0)


def test_panel_objective_matches_full():
    from rri_nmf_tpu.ops.sweep_masked_gram import (
        make_masked_gram_objective, plan_masked_gram)
    import jax.numpy as jnp
    X, M, W0, T0 = _problem(23, k=5)
    plan = plan_masked_gram(X, sp.csr_matrix(M), np.float64)
    regs = dict(reg_w_l2=0.02, reg_t_l1=0.003)
    full = make_masked_gram_objective(**regs)
    tiled = make_masked_gram_objective(panel=2, **regs)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    np.testing.assert_allclose(float(tiled(plan, W, T)),
                               float(full(plan, W, T)), rtol=1e-13)


def test_auto_panel_policy():
    from rri_nmf_tpu.ops.capability import device_bytes_limit
    from rri_nmf_tpu.ops.sweep_masked_gram import (GRAM_BUDGET_FRACTION,
        auto_panel, gram_budget_bytes)
    # the default budget is a share of what the device reports
    assert gram_budget_bytes() == GRAM_BUDGET_FRACTION * \
        device_bytes_limit()
    # tiny problem: full tensors fit
    assert auto_panel(8, 100, 80, 8) is None
    # k=128 at the 100k×50k shape, f32: full Γ/Θ would be 98 GB — on a
    # 4 GB budget panels engage with 1 <= p < k
    p = auto_panel(128, 100_000, 50_000, 4, budget=4e9)
    assert p is not None and 1 <= p < 128
    assert p * 128 * 150_000 * 4 <= 4e9
    # a budget that holds the full tensors keeps the one-pass path
    assert auto_panel(64, 10_000, 5_000, 4, budget=4e9) is None
    # absurd k: even one panel row over budget -> 0 (decline)
    assert auto_panel(10_000_000, 1_000_000, 1_000_000, 8) == 0


def test_driver_routes_large_k_to_panels(monkeypatch):
    """The driver engages the Gram path with panel tiling when the full
    tensors exceed the budget (instead of silently falling back to the
    interleaved sweep), and the fit matches the full-tensor fit."""
    import rri_nmf_tpu.ops.sweep_masked_gram as smg
    X, M, _, _ = _problem(24, n=40, d=30, k=4)
    Ms = sp.csr_matrix(M)
    kw = _driver_kw(max_iter=6)
    r_full = nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    # shrink the budget so k=4 at (40, 30) needs 2-panels
    unit = 4 * (40 + 30) * 8
    monkeypatch.setattr(smg, 'gram_budget_bytes', lambda: 2 * unit)
    r_tiled = nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    np.testing.assert_allclose(np.asarray(r_tiled['W']),
                               np.asarray(r_full['W']), atol=1e-13)
    np.testing.assert_allclose(np.asarray(r_tiled['T']),
                               np.asarray(r_full['T']), atol=1e-13)
    assert np.all(np.diff(r_tiled['obj_history']) <= 1e-12)
