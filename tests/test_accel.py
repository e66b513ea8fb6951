"""HER extrapolation (ops/accel.py; nmf(accel='her')).

The reference has no acceleration scheme at all — HER is the rebuild's
answer to the ill-conditioned convergence plateau of plain RRI/HALS (the
reference algorithm in f64 NumPy stalls around 1e-3 on U[0,1]-factor
data)."""

import jax
import numpy as np
import pytest

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.parallel import make_mesh

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason='needs 8 virtual devices')


def _uniform_factor_problem(n=256, d=128, k=8, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n, k) @ rng.rand(k, d)


KW = dict(k=8, random_state=0, early_stop=False, update_order='phase',
          reset_topic_method=None, eps_stop=0.0)


def _rel(X, s):
    return np.linalg.norm(X - s['W'] @ s['T']) / np.linalg.norm(X)


def test_her_accelerates_uniform_factor_problem():
    """At equal sweeps HER reaches a (much) lower error than plain
    sweeps on the mean-dominated problem class, stays finite/feasible,
    and its tracked objective descends overall (restart sweeps may tick
    up but the run must end below the plain run)."""
    X = _uniform_factor_problem()
    kw = dict(KW, compute_obj_each_iter=True)
    plain = nmf(X, max_iter=120, **kw)
    her = nmf(X, max_iter=120, accel='her', **kw)
    r_plain, r_her = _rel(X, plain), _rel(X, her)
    assert np.isfinite(r_her)
    assert (her['W'] >= 0).all() and (her['T'] >= 0).all()
    assert r_her < r_plain * 0.65, (r_her, r_plain)
    assert her['obj_history'][-1] <= plain['obj_history'][-1]
    assert her['obj_history'][-1] < her['obj_history'][0]


def test_her_grouped_dispatch_matches_per_iteration():
    """The grouped fast path runs the same HER recursion as the
    per-iteration loop."""
    X = _uniform_factor_problem(seed=1)
    a = nmf(X, max_iter=12, accel='her', **KW)
    b = nmf(X, max_iter=12, accel='her', sweeps_per_dispatch=4, **KW)
    assert np.allclose(a['W'], b['W'], atol=1e-12)
    assert np.allclose(a['T'], b['T'], atol=1e-12)


def test_her_composes_with_mixed_x_dtype():
    """HER over the mixed-storage sweep (x_dtype bf16, f32 factors):
    finite, f32 factors out, and still clearly better than plain at
    equal sweeps (the objective check runs f32 against the bf16 X)."""
    X = _uniform_factor_problem(seed=2)
    kw = dict(KW, dtype='float32', x_dtype='bfloat16')
    plain = nmf(X, max_iter=100, **kw)
    her = nmf(X, max_iter=100, accel='her', **kw)
    assert her['W'].dtype == np.float32
    r_plain, r_her = _rel(X, plain), _rel(X, her)
    assert np.isfinite(r_her)
    assert r_her < r_plain * 0.8, (r_her, r_plain)


def test_her_with_constraints_and_regs():
    """HER composes with the TM constraint set and regularizers; the
    accepted iterates respect feasibility."""
    X = _uniform_factor_problem(seed=2)
    s = nmf(X, max_iter=15, accel='her', project_T_each_iter=True,
            t_row_sum=1.0, w_row_sum=1.0, project_W_each_iter=True,
            reg_w_l2=0.01, **KW)
    assert np.allclose(s['W'].sum(1), 1.0, atol=1e-10)
    assert np.allclose(s['T'].sum(1), 1.0, atol=1e-10)
    assert (s['W'] >= -1e-15).all() and (s['T'] >= -1e-15).all()


def test_her_interleaved_order():
    """HER is kernel-agnostic: the interleaved (reference) update order
    accelerates too."""
    X = _uniform_factor_problem(seed=4)
    kw = dict(KW)
    kw.pop('update_order')
    plain = nmf(X, max_iter=120, **kw)
    her = nmf(X, max_iter=120, accel='her', **kw)
    assert _rel(X, her) < _rel(X, plain) * 0.7


@requires_8_devices
def test_her_mesh_matches_single_device():
    """HER composes with a (4,2) mesh: the extrapolation/restart ops are
    elementwise (GSPMD keeps the factor shardings) and the objective
    check runs as a distributed residual. Same recursion ⇒ same iterates
    up to reduction order (f64 CPU: ~1e-9)."""
    X = _uniform_factor_problem(seed=5)
    a = nmf(X, max_iter=20, accel='her', **KW)
    b = nmf(X, max_iter=20, accel='her', mesh=make_mesh(8), **KW)
    assert np.allclose(a['W'], b['W'], atol=1e-9)
    assert np.allclose(a['T'], b['T'], atol=1e-9)


@requires_8_devices
def test_her_mesh_grouped_dispatch():
    """Grouped dispatch (fori_loop of HER steps) under the mesh matches
    the per-iteration mesh loop."""
    X = _uniform_factor_problem(seed=6)
    mesh = make_mesh(8)
    a = nmf(X, max_iter=12, accel='her', mesh=mesh, **KW)
    b = nmf(X, max_iter=12, accel='her', mesh=mesh,
            sweeps_per_dispatch=4, **KW)
    assert np.allclose(a['W'], b['W'], atol=1e-12)
    assert np.allclose(a['T'], b['T'], atol=1e-12)


def test_her_masked_accelerates():
    """HER over the masked WRRI sweep (recommender fit class): the
    restart check uses the masked objective, and at equal sweeps the
    masked error on observed entries beats plain sweeps on the
    mean-dominated class."""
    X = _uniform_factor_problem(seed=7)
    M = (np.random.RandomState(7).rand(*X.shape) < 0.7).astype(float)
    kw = dict(k=8, random_state=0, early_stop=False,
              reset_topic_method=None, eps_stop=0.0,
              compute_obj_each_iter=True, W_mat=M)
    plain = nmf(X, max_iter=80, **kw)
    her = nmf(X, max_iter=80, accel='her', **kw)

    def _masked_rel(s):
        R = M * (X - s['W'] @ s['T'])
        return np.linalg.norm(R) / np.linalg.norm(M * X)

    r_plain, r_her = _masked_rel(plain), _masked_rel(her)
    assert np.isfinite(r_her)
    assert (her['W'] >= 0).all() and (her['T'] >= 0).all()
    assert r_her < r_plain * 0.9, (r_her, r_plain)
    assert her['obj_history'][-1] <= plain['obj_history'][-1]


def test_her_masked_grouped_dispatch_matches():
    X = _uniform_factor_problem(seed=8)
    M = (np.random.RandomState(8).rand(*X.shape) < 0.6).astype(float)
    kw = dict(KW)
    kw.pop('update_order')     # masked path is interleaved by construction
    a = nmf(X, max_iter=10, accel='her', W_mat=M, **kw)
    b = nmf(X, max_iter=10, accel='her', W_mat=M, sweeps_per_dispatch=5,
            **kw)
    assert np.allclose(a['W'], b['W'], atol=1e-12)
    assert np.allclose(a['T'], b['T'], atol=1e-12)


def test_her_validation():
    X = _uniform_factor_problem()
    with pytest.raises(ValueError):
        nmf(X, 8, accel='nope')
    with pytest.raises(ValueError):        # resets on (default)
        nmf(X, 8, accel='her', max_iter=2)
    with pytest.raises(ValueError):        # masked with resets on
        nmf(X, 8, accel='her', W_mat=np.ones_like(X), max_iter=2)
    with pytest.raises(ValueError):        # fixed factor
        nmf(X, 8, accel='her', fix_T=True, reset_topic_method=None,
            T_in=np.abs(np.random.RandomState(0).rand(8, X.shape[1])),
            max_iter=2)


def test_accel_opts_tuning_knobs():
    """accel_opts exposes HER's gamma/beta0/beta_max; different knobs
    change the trajectory, defaults match omitting the dict, unknown
    keys and accel=None usage raise."""
    X = _uniform_factor_problem(seed=9)
    a = nmf(X, max_iter=15, accel='her', **KW)
    b = nmf(X, max_iter=15, accel='her',
            accel_opts=dict(gamma=1.05, beta0=0.5, beta_max=0.9999), **KW)
    assert np.array_equal(a['W'], b['W'])      # explicit defaults == none
    c = nmf(X, max_iter=15, accel='her',
            accel_opts=dict(gamma=1.5, beta0=0.9), **KW)
    assert np.isfinite(c['W']).all()
    assert not np.allclose(a['W'], c['W'])     # knobs actually bite
    # grouped dispatch uses the same knobs
    d = nmf(X, max_iter=15, accel='her', sweeps_per_dispatch=5,
            accel_opts=dict(gamma=1.5, beta0=0.9), **KW)
    assert np.allclose(c['W'], d['W'], atol=1e-12)
    with pytest.raises(ValueError):
        nmf(X, max_iter=2, accel='her', accel_opts=dict(nope=1.0), **KW)
    with pytest.raises(ValueError):
        nmf(X, max_iter=2, accel_opts=dict(gamma=1.1), **KW)


def test_her_returns_best_accepted_iterate():
    """An extrapolated sweep can jump to (and converge inside) a WORSE
    basin on small simplex-projected problems — fuzz soak seeds 13/26:
    the accepted sequence ends ~1% above its first sweep. Per Ang &
    Gillis ("output the solution with the lowest error") the fit must
    return the best accepted iterate, so the returned solution is never
    worse than the first (plain-BCD) sweep."""
    rng = np.random.RandomState(26)
    n, d, k = int(rng.randint(20, 60)), int(rng.randint(15, 50)), 7
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    kw = dict(max_iter=6, random_state=26, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0,
              reset_topic_method=None, project_T_each_iter=True,
              t_row_sum=1.0, project_W_each_iter=True, w_row_sum=1.0,
              reg_w_l2=0.01, reg_t_l2=0.01, init='smart_random',
              accel='her')
    soln = nmf(X, k, **kw)
    oh = np.asarray(soln['obj_history'], float)
    final = soln['obj_calculator'].true_objective()
    tol = 1e-10 * max(1.0, abs(oh[0]))
    assert final <= oh[0] + tol, (final, oh)
    assert final <= oh.min() + tol, (final, oh)
    # grouped dispatch tracks the same best iterate
    kwg = dict(kw, compute_obj_each_iter=False, sweeps_per_dispatch=3)
    kws = dict(kw, compute_obj_each_iter=False)
    a = nmf(X, k, **kws)
    b = nmf(X, k, **kwg)
    assert np.allclose(a['W'], b['W'], atol=1e-12)
    assert np.allclose(a['T'], b['T'], atol=1e-12)
    # and the solutions agree with the tracked run's returned factors
    assert np.allclose(a['W'], soln['W'], atol=1e-12)
