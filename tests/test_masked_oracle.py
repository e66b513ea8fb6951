"""The dense-mask WRRI sweep (``make_sweep`` with ``masked=True``) against
the definitional NumPy masked oracle (``test_consistency``), over the
config grid the masked path serves: padding-free odd shapes,
regularizers (incl. negative L1), W/T row constraints, the fixed-T
inference path of the RS estimator and its 'random' resets. The masked
path is plain XLA on every backend, so ``use_pallas`` must not change
what it computes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
from test_consistency import _numpy_masked_sweep, _proj_simplex_np


def _problem(n, d, k, seed=0, density=0.5):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < density).astype(float)
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, M, W0, T0


def _run(sweep, X, M, W, T, iters=3):
    key = jax.random.PRNGKey(0)
    resets = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W), jnp.asarray(T)
    for _ in range(iters):
        W, T, key, resets = sweep(jnp.asarray(X), W, T, key, resets, key,
                                  jnp.asarray(M))
    return np.array(W), np.array(T)


def _oracle(X, M, W, T, iters=3, project_W_sum=None, **kw):
    W, T = W.copy(), T.copy()
    for _ in range(iters):
        W, T = _numpy_masked_sweep(X, M, W, T, **kw)
        if project_W_sum is not None:
            W = np.stack([_proj_simplex_np(r, project_W_sum) for r in W])
    return W, T


@pytest.mark.parametrize('shape', [(30, 20, 3), (300, 600, 5),
                                   (520, 130, 4)])
def test_masked_sweep_matches_oracle(shape):
    n, d, k = shape
    X, M, W0, T0 = _problem(n, d, k)
    cfg = SweepConfig(k=k, masked=True, reset_topic_method=None,
                      t_row_sum=1.0)
    Wx, Tx = _run(make_sweep(cfg), X, M, W0, T0)
    Wn, Tn = _oracle(X, M, W0, T0, t_row_sum=1.0)
    assert np.allclose(Wx, Wn, atol=1e-9)
    assert np.allclose(Tx, Tn, atol=1e-9)


def test_masked_with_regularization():
    n, d, k = 70, 40, 3
    X, M, W0, T0 = _problem(n, d, k, seed=2)
    cfg = SweepConfig(k=k, masked=True, reset_topic_method=None,
                      t_row_sum=1.0, reg_w_l1=0.1, reg_t_l1=0.05)
    Wx, Tx = _run(make_sweep(cfg), X, M, W0, T0)
    Wn, Tn = _oracle(X, M, W0, T0, t_row_sum=1.0, reg_w_l1=0.1,
                     reg_t_l1=0.05)
    assert np.allclose(Wx, Wn, atol=1e-9)
    assert np.allclose(Tx, Tn, atol=1e-9)


def test_dense_phase_sweep_declines_masked_configs():
    """The GS kernel's sweep covers unmasked phase-order configs only;
    masked, reset, DP and gradient-store configs stay on the XLA
    sweeps."""
    from rri_nmf_tpu.ops.dense_phase import supports_dense_phase
    ok = SweepConfig(k=3, reset_topic_method=None, update_order='phase')
    assert supports_dense_phase(ok)
    for bad in (dict(masked=True), dict(update_order='interleaved'),
                dict(reset_topic_method='max_resid_document'),
                dict(dp_sigma=1.0), dict(store_gradients=True)):
        kw = dict(k=3, reset_topic_method=None, update_order='phase')
        kw.update(bad)
        assert not supports_dense_phase(SweepConfig(**kw)), bad


def test_nmf_driver_masked_path_monotone(recsys_train):
    """End-to-end: the nmf() driver's masked path keeps the masked
    objective monotone on the reference recsys fixture, whatever
    ``use_pallas`` asks for."""
    from rri_nmf_tpu.nmf import nmf
    X = recsys_train
    Wm = np.zeros(X.shape)
    I, J = X.nonzero()
    Wm[I, J] = 1.0
    soln = nmf(X, k=7, W_mat=Wm, max_iter=10, random_state=0,
               reset_topic_method=None, compute_obj_each_iter=True,
               early_stop=False, t_row_sum=1.0,
               use_pallas='interpret')
    oh = soln['obj_history']
    assert np.all(np.diff(oh) <= 0)


def test_masked_project_W_each_iter_matches_oracle():
    """project_W_each_iter is applied after every masked sweep (reference
    nmf.py:481-484)."""
    n, d, k = 60, 45, 3
    X, M, W0, T0 = _problem(n, d, k, seed=4)
    cfg = SweepConfig(k=k, masked=True, reset_topic_method=None,
                      project_W_each_iter=True, w_row_sum=1.0,
                      t_row_sum=1.0)
    Wx, Tx = _run(make_sweep(cfg), X, M, W0, T0)
    Wn, Tn = _oracle(X, M, W0, T0, t_row_sum=1.0, w_row_sum=1.0,
                     project_W_sum=1.0)
    assert np.allclose(Wx, Wn, atol=1e-9)
    assert np.allclose(Tx, Tn, atol=1e-9)
    assert np.max(np.abs(Wx.sum(axis=1) - 1.0)) < 1e-12  # rows on simplex


def test_masked_t_drift_reprojection_matches_oracle():
    """With project_T_each_iter + t_row_sum and no resets, a drifted T row
    is re-projected (reference nmf.py:758-761)."""
    n, d, k = 40, 130, 3
    X, M, W0, T0 = _problem(n, d, k, seed=5)
    cfg = SweepConfig(k=k, masked=True, reset_topic_method=None,
                      project_T_each_iter=True, t_row_sum=1.0)
    Wx, Tx = _run(make_sweep(cfg), X, M, W0, T0, iters=4)
    Wn, Tn = _oracle(X, M, W0, T0, iters=4, t_row_sum=1.0,
                     project_T_each_iter=True)
    assert np.allclose(Wx, Wn, atol=1e-9)
    assert np.allclose(Tx, Tn, atol=1e-9)
    assert np.max(np.abs(Tx.sum(axis=1) - 1.0)) < 1e-12


@pytest.mark.parametrize('shape', [(30, 20, 3), (300, 600, 5),
                                   (520, 130, 4)])
def test_masked_fix_T_matches_oracle(shape):
    """fix_T masked sweeps — the RS estimator's transform path (reference
    sklearn_interface.py:144-156)."""
    n, d, k = shape
    X, M, W0, T0 = _problem(n, d, k, seed=5)
    cfg = SweepConfig(k=k, masked=True, fix_T=True,
                      reset_topic_method=None, t_row_sum=1.0)
    Wx, Tx = _run(make_sweep(cfg), X, M, W0, T0, iters=4)
    Wn, _ = _oracle(X, M, W0, T0, iters=4, t_row_sum=1.0, fix_T=True)
    assert np.allclose(Tx, T0)          # T truly fixed
    assert np.allclose(Wx, Wn, atol=1e-9)


def test_masked_fix_T_with_regs_and_row_bounds():
    n, d, k = 140, 90, 4
    X, M, W0, T0 = _problem(n, d, k, seed=6)
    cfg = SweepConfig(k=k, masked=True, fix_T=True,
                      reset_topic_method=None, reg_w_l1=0.05,
                      reg_w_l2=0.02, w_row_sum=1.0,
                      project_W_each_iter=True)
    Wx, _ = _run(make_sweep(cfg), X, M, W0, T0, iters=3)
    Wn, _ = _oracle(X, M, W0, T0, t_row_sum=None, fix_T=True,
                    reg_w_l1=0.05, reg_w_l2=0.02, w_row_sum=1.0,
                    project_W_sum=1.0)
    assert np.allclose(Wx, Wn, atol=1e-9)
    assert np.allclose(Wx.sum(1), 1.0, atol=1e-10)


def test_rs_estimator_transform_ignores_use_pallas(recsys_train,
                                                   recsys_test):
    """Estimator-level: NMF_RS_Estimator.transform runs the masked XLA
    sweep whatever ``use_pallas`` says (the kernel covers unmasked
    phase-order configs only)."""
    from rri_nmf_tpu.sklearn_interface import NMF_RS_Estimator

    n, d = recsys_train.shape
    est = NMF_RS_Estimator(n, d, 4, random_state=0, max_iter=6)
    est.fit_from_Xtr(recsys_train)
    est.nmf_kwargs = {'use_pallas': False}
    W_xla = est.transform(recsys_test)
    est.nmf_kwargs = {'use_pallas': 'interpret'}
    W_int = est.transform(recsys_test)
    assert np.array_equal(W_xla, W_int)


def test_masked_fix_T_random_reset_fires():
    """A dead topic (zero T row with T fixed -> zero W update) triggers
    the 'random' reset (the RS transform preset) and spends budget."""
    n, d, k = 70, 50, 3
    X, M, W0, T0 = _problem(n, d, k, seed=7)
    T0 = T0.copy()
    T0[1] = 0.0                             # dead topic
    cfg = SweepConfig(k=k, masked=True, fix_T=True,
                      reset_topic_method='random', t_row_sum=1.0)
    sweep = make_sweep(cfg)
    key = jax.random.PRNGKey(0)
    resets = jnp.asarray(23, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    for _ in range(2):
        W, T, key, resets = sweep(jnp.asarray(X), W, T, key, resets,
                                  jax.random.PRNGKey(0), jnp.asarray(M))
    assert not np.allclose(np.array(T)[1], 0.0)   # reset actually fired
    assert int(resets) < 23
    assert np.all(np.isfinite(np.array(W)))


def test_masked_negative_l1_no_phantom_mass():
    """Negative L1 regularizers with a positive L2 promote mass onto
    unobserved coordinates only as the subproblem dictates: pinned
    against the oracle on a tiny, mostly-unobserved problem."""
    n, d, k = 6, 5, 3
    X, M, W0, T0 = _problem(n, d, k, seed=3)
    kw = dict(reg_t_l1=-0.1, reg_t_l2=0.5, reg_w_l1=-0.05, reg_w_l2=0.5)
    cfg = SweepConfig(k=k, masked=True, reset_topic_method=None,
                      project_T_each_iter=True, t_row_sum=1.0, **kw)
    Wx, Tx = _run(make_sweep(cfg), X, M, W0, T0, iters=2)
    Wn, Tn = _oracle(X, M, W0, T0, iters=2, t_row_sum=1.0,
                     project_T_each_iter=True, **kw)
    assert np.allclose(Wx, Wn, atol=1e-9), np.abs(Wx - Wn).max()
    assert np.allclose(Tx, Tn, atol=1e-9), np.abs(Tx - Tn).max()


def test_fix_t_reset_fires_with_negative_l1():
    """Dead topics on all-zero data fire resets under a negative W L1."""
    n, d, k = 6, 5, 3
    rng = np.random.RandomState(4)
    X = np.zeros((n, d))
    M = np.ones((n, d))
    W0 = np.abs(rng.rand(n, k)) + 0.1
    T0 = np.abs(rng.rand(k, d)) + 0.1
    cfg = SweepConfig(k=k, masked=True, fix_T=True,
                      reset_topic_method='random',
                      reg_w_l1=-1e-3, reg_w_l2=1.0)
    key = jax.random.PRNGKey(0)
    W, T, key, resets = make_sweep(cfg)(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0), key,
        jnp.asarray(5, jnp.int32), key, jnp.asarray(M))
    assert int(resets) < 5
    assert np.all(np.isfinite(np.array(W)))


def test_gs_tile_policy():
    """The kernel's tile: k padded to a power of two >= 16, a
    power-of-two column width in [16, 128], and a 16384-value tile."""
    from rri_nmf_tpu.ops.dense_phase import gs_tile
    for k, kp in [(1, 16), (12, 16), (50, 64), (128, 128), (129, 256),
                  (256, 256), (1000, 1024)]:
        got_kp, B, warps = gs_tile(k)
        assert got_kp == kp and B & (B - 1) == 0 and 16 <= B <= 128
        assert kp * B <= 16384 or B == 16
        assert warps in (4, 8)


def test_masked_factor_dtype_follows_w():
    """Direct calls with a narrow X and f32 factors must not silently
    quantize the factors (resolve_mixed_dtypes: factor dtype follows
    W)."""
    n, d, k = 30, 20, 3
    X, M, W0, T0 = _problem(n, d, k, seed=5)
    cfg = SweepConfig(k=k, masked=True, reset_topic_method=None)
    key = jax.random.PRNGKey(0)
    W1, T1, _, _ = make_sweep(cfg)(
        jnp.asarray(X, jnp.bfloat16), jnp.asarray(W0, jnp.float32),
        jnp.asarray(T0, jnp.float32), key, jnp.asarray(0, jnp.int32),
        key, jnp.asarray(M, jnp.bfloat16))
    assert W1.dtype == jnp.float32 and T1.dtype == jnp.float32
