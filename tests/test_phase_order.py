"""Phase update order (all T rows, then all W columns).

Every update remains an exact coordinate minimization of the current
objective — monotone descent and the stationarity conditions are unchanged
from the reference's interleaving; only the cyclic order differs (it is the
order sklearn's CD solver uses). The payoff is the W-phase batching into
one ``X @ Tᵀ`` GEMM.
"""

import numpy as np
import pytest

from rri_nmf_tpu.nmf import nmf


def _problem(n=100, d=80, k=8, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))


PRESETS = {
    'tm': dict(project_T_each_iter=True, project_W_each_iter=True,
               t_row_sum=1.0, w_row_sum=1.0),
    'plain': dict(reset_topic_method=None),
    'regularized': dict(reg_t_l2=0.1, reg_w_l1=0.05,
                        reset_topic_method=None),
}


@pytest.mark.parametrize('preset', sorted(PRESETS))
def test_phase_order_monotone(preset):
    X = _problem()
    soln = nmf(X, 8, max_iter=15, random_state=0, early_stop=False,
               compute_obj_each_iter=True, eps_stop=0,
               update_order='phase', **PRESETS[preset])
    oh = soln['obj_history']
    assert np.all(np.diff(oh) <= 0), preset
    assert np.all(soln['W'] >= 0) and np.all(soln['T'] >= 0)


def test_phase_order_converges_comparably():
    """Phase order must reach an objective at least as good as interleaved
    given the same sweep count (it has no reason to be worse: same exact
    updates, different cyclic order)."""
    X = _problem(seed=3)
    kw = dict(k=8, max_iter=25, random_state=0, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0,
              reset_topic_method=None)
    inter = nmf(X, update_order='interleaved', **kw)
    phase = nmf(X, update_order='phase', **kw)
    assert phase['obj_history'][-1] <= inter['obj_history'][-1] * 1.05


def test_phase_order_same_stationary_family():
    """Both orders satisfy the same per-coordinate stationarity at
    convergence: T[t] = [wᵀX − (wᵀW)₋ₜT]₊ / ||w||² (no regs, no
    constraints)."""
    X = _problem(seed=1, n=40, d=30, k=3)
    soln = nmf(X, 3, max_iter=300, random_state=0, early_stop=False,
               reset_topic_method=None, update_order='phase', eps_stop=0)
    W, T = soln['W'], soln['T']
    for t in range(3):
        w = W[:, t]
        wW = w @ W
        wW[t] = 0
        numer = w @ X - wW @ T
        denom = w @ w
        expected = np.maximum(numer, 0) / (denom + np.spacing(10))
        assert np.allclose(T[t], expected, atol=1e-4)


def test_phase_order_stepped_equals_batch():
    """The stepped ≡ batch warm-restart contract (reference
    tests/test_nmf.py:97-110) holds under the phase order too."""
    from rri_nmf_tpu.sklearn_interface import NMF_TM_Estimator
    X = _problem(n=60, d=45, k=4, seed=7)
    X = X / X.sum(axis=1, keepdims=True)
    kw = dict(random_state=0, nmf_kwargs={'update_order': 'phase'})
    M = NMF_TM_Estimator(60, 45, 4, max_iter=6, **kw).fit(X)
    M2 = NMF_TM_Estimator(60, 45, 4, max_iter=2, do_final_project_W=False,
                          **kw).fit(X)
    for _ in range(3):
        M2 = M2.one_iter(X)
    M2 = M2.one_iter(X)
    from rri_nmf_tpu.matrixops import proj_mat_to_simplex
    M2.W = np.asarray(proj_mat_to_simplex(M2.W))
    assert np.allclose(M2.T, M.T)
    assert np.allclose(M2.W, M.W)


def test_phase_order_under_mesh():
    """Phase order shards like the interleaved sweep: the XT GEMM psums
    over tp, everything else is unchanged."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    from rri_nmf_tpu.parallel import make_mesh
    X = _problem(n=64, d=40, k=3, seed=0)
    kw = dict(k=3, max_iter=6, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase')
    single = nmf(X, **kw)
    sharded = nmf(X, mesh=make_mesh(8), **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-12)
    assert np.allclose(single['T'], sharded['T'], atol=1e-12)


def test_phase_order_fix_T_transform():
    """fix_T + phase order: the W-phase alone with the XT GEMM (the
    transform path at scale). Compared at the make_sweep level so the
    driver's fix_T auto-upgrade (nmf.py) cannot make both arms take the
    phase path — this pins the genuine interleaved == phase equivalence."""
    import jax
    import jax.numpy as jnp
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep

    X = _problem(seed=2)
    k = 8
    T_in = np.abs(np.random.RandomState(5).rand(k, X.shape[1]))
    W_in = np.abs(np.random.RandomState(6).rand(X.shape[0], k))

    def run(order):
        cfg = SweepConfig(k=k, fix_T=True, reset_topic_method=None,
                          update_order=order)
        sweep = make_sweep(cfg)
        W, T = jnp.asarray(W_in), jnp.asarray(T_in)
        key = jax.random.PRNGKey(0)
        resets = jnp.asarray(0, jnp.int32)
        for _ in range(4):
            W, T, key, resets = sweep(jnp.asarray(X), W, T, key, resets,
                                      key)
        return np.array(W)

    # with fix_T there is no ordering difference at all: results identical
    assert np.allclose(run('interleaved'), run('phase'), atol=1e-12)
