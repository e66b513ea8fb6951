"""Driver features not covered by the ported reference suite:
fix_W/fix_T, max_time, dtype pinning, diagnostics content, masked DP,
early-stop via objective history, sentinel guards."""

import numpy as np
import pytest

from rri_nmf_tpu.nmf import nmf


def _problem(n=30, d=20, k=3, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))


def test_fix_T_keeps_T(recsys_train):
    X = recsys_train.astype(float)
    T_in = np.abs(np.random.RandomState(0).rand(4, X.shape[1]))
    soln = nmf(X, 4, T_in=T_in.copy(), fix_T=True, max_iter=3,
               random_state=0, early_stop=False)
    # T passes through _initialize_and_validate's clip but is never updated
    assert np.allclose(soln['T'], np.maximum(T_in, 0))
    assert not np.allclose(soln['W'], 0)


def test_fix_W_keeps_W():
    """fix_W skips the W-phase. NB: with all regs zero the reference's
    scale transfer still multiplies W columns inside the T-phase
    (nmf.py:450-452), so pin W with a nonzero reg (transfer disabled) and
    resets off."""
    X = _problem()
    W_in = np.abs(np.random.RandomState(1).rand(X.shape[0], 3))
    soln = nmf(X, 3, W_in=W_in.copy(), fix_W=True, max_iter=3,
               random_state=0, early_stop=False, reg_t_l1=0.01,
               reset_topic_method=None)
    assert np.allclose(soln['W'], np.maximum(W_in, 0))

    # and with regs zero, columns change only by positive scale factors
    soln2 = nmf(X, 3, W_in=W_in.copy(), fix_W=True, max_iter=1,
                random_state=0, early_stop=False, reset_topic_method=None)
    ratio = soln2['W'] / np.maximum(W_in, 1e-300)
    assert np.allclose(ratio, ratio[0:1, :], rtol=1e-8)  # per-column scalar


def test_max_time_stops_early():
    X = _problem(n=60, d=40)
    # budget is max_time - 10 (reference nmf.py:333); 10.01 leaves ~10ms
    soln = nmf(X, 3, max_iter=5000, max_time=10.01, random_state=0,
               early_stop=False)
    assert len(soln['iter_cputime']) < 5000


def test_dtype_pinning():
    import jax.numpy as jnp
    X = _problem()
    soln = nmf(X, 3, max_iter=2, dtype=jnp.float32, random_state=0,
               early_stop=False)
    # results are converted to numpy but computed in f32
    assert soln['W'].dtype == np.float32


def test_diagnostics_callback_contents():
    X = _problem()
    calls = []

    def track_norm(X_, W_, T_):
        calls.append((W_.shape, T_.shape))
        return float(np.linalg.norm(X_ - W_ @ T_))

    soln = nmf(X, 3, max_iter=4, random_state=0, early_stop=False,
               diagnostics=[track_norm])
    vals = soln['diagnostics']['track_norm']
    # called once pre-loop + once per iteration (reference nmf.py:373-375,
    # 495-500)
    assert len(vals) == 5
    # reconstruction improves
    assert vals[-1] < vals[0]
    assert all(s == ((30, 3), (3, 20)) for s in calls)


def test_early_stop_non_callable_uses_obj_history():
    """early_stop=True (non-callable) stops when obj_history rises
    (reference nmf.py:382-389). Monotone solver never triggers it."""
    X = _problem()
    soln = nmf(X, 3, max_iter=6, random_state=0, early_stop=True,
               compute_obj_each_iter=True, eps_stop=0.0,
               reset_topic_method=None)
    assert len(soln['obj_history']) == 6


def test_early_stop_callable_rollback():
    """A score that increases after iteration 2 rolls back to the iter-2
    factors (reference nmf.py:391-403)."""
    X = _problem()
    state = {'n': 0}
    snapshots = []

    def rising_score(X_, W_, T_):
        state['n'] += 1
        snapshots.append((W_.copy(), T_.copy()))
        return 0.0 if state['n'] <= 3 else 1.0  # rise at check 4

    soln = nmf(X, 3, max_iter=10, random_state=0, early_stop=rising_score,
               reset_topic_method=None)
    # rollback returns the factors snapshotted at the last good check
    W_prev, T_prev = snapshots[2]
    assert np.allclose(soln['W'], W_prev)
    assert np.allclose(soln['T'], T_prev)


def test_early_stop_no_per_iteration_gathers(monkeypatch):
    """Early-stop snapshots/rollback are device-side (VERDICT r3 item 4):
    an objective-scored early-stop fit performs NO per-iteration factor
    gathers — only the final W/T materialization (2 _to_host calls)."""
    import rri_nmf_tpu.nmf as nmf_mod
    X = _problem()
    calls = {'n': 0}
    real = nmf_mod._to_host

    def counting(a):
        calls['n'] += 1
        return real(a)

    monkeypatch.setattr(nmf_mod, '_to_host', counting)
    soln = nmf(X, 3, max_iter=5, random_state=0, early_stop=True,
               compute_obj_each_iter=True, eps_stop=0.0,
               reset_topic_method=None)
    assert len(soln['obj_history']) == 5
    assert calls['n'] == 2, \
        'early stopping gathered factors mid-loop (%d calls)' % calls['n']


def test_early_stop_device_ok_callable():
    """A scorer marked ``device_ok`` receives device arrays and drives
    the same rollback as the host-contract callable."""
    import jax
    X = _problem()
    state = {'n': 0}
    snapshots = []

    def rising_score(X_, W_, T_):
        assert isinstance(W_, jax.Array) and isinstance(T_, jax.Array)
        state['n'] += 1
        snapshots.append((np.asarray(W_), np.asarray(T_)))
        return 0.0 if state['n'] <= 3 else 1.0

    rising_score.device_ok = True
    soln = nmf(X, 3, max_iter=10, random_state=0, early_stop=rising_score,
               reset_topic_method=None)
    W_prev, T_prev = snapshots[2]
    assert np.allclose(soln['W'], W_prev)
    assert np.allclose(soln['T'], T_prev)


def test_dp_noise_masked_path():
    X = _problem()
    M = (np.random.RandomState(3).rand(*X.shape) < 0.7).astype(float)
    clean = nmf(X, 3, W_mat=M, max_iter=3, random_state=0,
                reset_topic_method=None, early_stop=False, t_row_sum=1.0)
    noisy = nmf(X, 3, W_mat=M, max_iter=3, random_state=0,
                reset_topic_method=None, early_stop=False, t_row_sum=1.0,
                eps_gauss_t=1e3, delta_gauss_t=1e-3)
    assert not np.allclose(clean['T'], noisy['T'], atol=1e-8)
    assert np.all(np.isfinite(noisy['T']))


def test_unbounded_w_guard_sentinel():
    X = _problem()
    soln = nmf(X, 3, reg_w_l2=-0.5, max_iter=5)
    assert soln['obj_history'] == [-np.inf]
    assert float(soln['W'].max()) == 1e6


def test_project_T_with_l1_reg_disabled():
    """project_T_each_iter + L1 regs is rejected with a warning and
    proceeds unprojected (reference nmf.py:280-285)."""
    X = _problem()
    soln = nmf(X, 3, project_T_each_iter=True, t_row_sum=1.0,
               reg_t_l1=0.1, max_iter=3, random_state=0, early_stop=False,
               compute_obj_each_iter=True)
    # would be exactly 1.0 per row if projection had stayed on
    assert not np.allclose(soln['T'].sum(1), 1.0)
    assert np.all(np.diff(soln['obj_history']) <= 0)


def test_n_le_k_forces_random_init():
    X = np.abs(np.random.RandomState(0).rand(3, 10))
    soln = nmf(X, 5, max_iter=2, random_state=0, early_stop=False)
    assert soln['W'].shape == (3, 5)
    assert np.all(np.isfinite(soln['W']))


def test_matmul_precision_kwarg():
    """matmul_precision threads through to the sweeps and the objective
    (on CPU f64 the precision context is a no-op, so results must match
    the default exactly — the knob matters on a GPU, where the default
    f32 dot runs in TF32)."""
    import numpy as np
    from rri_nmf_tpu.nmf import nmf
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(30, 4) @ rng.rand(4, 25))
    kw = dict(k=4, max_iter=6, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase')
    a = nmf(X, **kw)
    b = nmf(X, matmul_precision='float32', **kw)
    assert np.allclose(a['W'], b['W'], atol=1e-13)
    assert np.all(np.diff(b['obj_history']) <= 0)


def test_invalid_update_order_and_sparse_mode_rejected():
    """Typos in `update_order` / `sparse` must raise instead of silently
    running the interleaved/dense path (a user writing sparse='coo' or
    update_order='phases' would otherwise get a densified dense fit with
    no indication)."""
    import scipy.sparse as sp
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(20, 15))
    with pytest.raises(ValueError, match='update_order'):
        nmf(X, 3, update_order='phases', max_iter=1)
    with pytest.raises(ValueError, match='sparse'):
        nmf(sp.csr_matrix(X), 3, sparse='coo', max_iter=1,
            update_order='phase', reset_topic_method=None)


def test_invalid_k_rejected():
    """Non-positive / non-integer k raises a clear ValueError instead of
    an sklearn internals error from the init's randomized SVD."""
    X = np.abs(np.random.RandomState(0).rand(20, 15))
    for bad in (-1, 0, 2.5, 'three', None):
        with pytest.raises(ValueError, match='positive integer'):
            nmf(X, bad, max_iter=1)
    # integral values in any numeric type are fine
    assert np.asarray(nmf(X, np.int64(2), max_iter=1)['W']).shape == (20, 2)


def test_vector_w_row_sum_without_per_iter_projection():
    """A vector w_row_sum with project_W_each_iter=False (the documented
    project-once-at-the-end mode) must run, not crash on ndarray
    truthiness in the unbounded-objective guard, and the final projection
    must hit the per-row targets."""
    X = _problem(n=24, d=16, k=3)
    wrs = 1.0 + 0.5 * np.random.RandomState(1).rand(24)
    soln = nmf(X, 3, w_row_sum=wrs, max_iter=4, random_state=0,
               early_stop=False, reset_topic_method=None)
    assert np.allclose(soln['W'].sum(1), wrs, atol=1e-8)


def test_unbounded_sentinel_carries_documented_keys():
    """The unbounded-objective early returns carry the documented
    random_state / n_resets_remaining keys."""
    X = _problem()
    s = nmf(X, 3, reg_t_l2=-0.1, random_state=7, max_iter=2)
    assert s['obj_history'] == [-np.inf]
    assert s['random_state'] == 7
    assert 'n_resets_remaining' in s
    s2 = nmf(X, 3, reg_w_l1=-0.1, random_state=3, max_iter=2)
    assert s2['random_state'] == 3


def test_sparse_int_rejected():
    """sparse=1/0 must raise, not slip through bool==int equality and
    silently densify."""
    import scipy.sparse as sp
    X = sp.csr_matrix(_problem())
    with pytest.raises(ValueError):
        nmf(X, 3, sparse=1, max_iter=2)
    with pytest.raises(ValueError):
        nmf(X, 3, sparse=0, max_iter=2)
    # np.bool_ normalizes instead of raising
    s = nmf(X, 3, sparse=np.False_, max_iter=2, random_state=0,
            early_stop=False)
    assert np.isfinite(s['W']).all()


def test_sparse_auto_fix_t_stays_sparse():
    """sparse='auto' fix_T transforms engage the sparse sweep even at the
    default interleaved order (the fix_T order coercion must run BEFORE
    the auto decision): a beyond-RAM corpus must never densify."""
    import scipy.sparse as sp

    class NoDensify(sp.csr_matrix):
        def toarray(self, *a, **k):
            raise AssertionError('sparse fix_T transform densified X')

    rng = np.random.RandomState(0)
    X = sp.random(40, 30, density=0.3, random_state=0, format='csr')
    T_in = np.abs(rng.rand(3, 30)) + 0.01
    s = nmf(NoDensify(X), 3, T_in=T_in, fix_T=True, max_iter=3,
            random_state=0, early_stop=False, reset_topic_method=None)
    assert np.isfinite(s['W']).all()


def test_early_stop_without_tracking_warns(caplog):
    """early_stop=True without compute_obj_each_iter can never trigger;
    the driver must say so instead of silently fetching W/T per iter."""
    import logging
    X = _problem()
    with caplog.at_level(logging.WARNING, logger='rri_nmf_tpu.nmf'):
        s = nmf(X, 3, early_stop=True, max_iter=3, random_state=0)
    assert any('never trigger' in r.message for r in caplog.records)
    assert np.isfinite(s['W']).all()


def test_w_row_refit_reproducible():
    """Row-weighted fits are reproducible: the post-solve W re-fit
    inherits random_state (it previously drew a clock seed)."""
    X = _problem(n=25, d=18, k=3)
    w = 0.5 + np.random.RandomState(2).rand(25)
    a = nmf(X, 3, w_row=w, random_state=0, max_iter=4, early_stop=False)
    b = nmf(X, 3, w_row=w, random_state=0, max_iter=4, early_stop=False)
    assert np.array_equal(a['W'], b['W'])
    assert np.array_equal(a['T'], b['T'])


def test_obj_calculator_holds_device_mask():
    """TrueObjComputer gets DEVICE copies of the mask/row weights — the
    host arrays would re-cross the (slow) host->device link on every
    objective evaluation."""
    import jax
    X = _problem()
    M = (np.random.RandomState(0).rand(*X.shape) < 0.7).astype(float)
    s = nmf(X, 3, W_mat=M, compute_obj_each_iter=True, max_iter=2,
            random_state=0, early_stop=False, reset_topic_method=None)
    calc = s['obj_calculator']
    assert isinstance(calc.Wm, jax.Array)
    assert np.isfinite(calc.true_objective())


def test_checkpoint_es_score_saved_and_resumed(tmp_path):
    """Checkpoints written by early-stop runs carry the comparison score
    (last_score), and a resumed run loads it — without it a resumed run
    misses the stop+rollback a straight run performs."""
    from rri_nmf_tpu.checkpoint import NMFCheckpointer

    X = _problem(n=24, d=16, k=3)

    def score(Xh, W, T):
        return float(np.linalg.norm(Xh - W @ T))

    kw = dict(k=3, random_state=0, reset_topic_method=None, eps_stop=0.0,
              early_stop=score)
    ck = str(tmp_path / 'es')
    nmf(X, max_iter=4, checkpoint=ck, checkpoint_every=4, **kw)
    st = NMFCheckpointer(ck).restore()
    assert st.es_score is not None
    # the saved score is the straight run's last_score at that point:
    # score() evaluated at the post-sweep-3 factors (assigned at the TOP
    # of iteration 3, where 3 sweeps have completed, before its sweep)
    ref = nmf(X, max_iter=3, **kw)
    assert np.isclose(st.es_score, score(X, ref['W'], ref['T']), rtol=1e-10)
    # and resume equals straight for the early-stop fit
    straight = nmf(X, max_iter=8, **kw)
    resumed = nmf(X, max_iter=8, checkpoint=ck, checkpoint_every=100, **kw)
    assert np.allclose(straight['W'], resumed['W'], atol=1e-12)
