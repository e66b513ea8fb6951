"""inner_reps: repeated Gauss-Seidel passes per phase (accelerated HALS).

Within a phase the frozen factor's Gram and the X-contraction numerators
are constant, so extra topic-loop passes are additional exact cyclic BCD
sweeps on the same subproblems — monotone descent must be preserved and
the result must match a literal NumPy re-execution of the passes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
from rri_nmf_tpu.ops.sweep_sparse import make_sparse_sweep, to_bcoo
from rri_nmf_tpu.ops.dense_phase import make_dense_phase_sweep


def _problem(n=60, d=40, k=5, seed=0):
    rng = np.random.RandomState(seed)
    return (np.abs(rng.rand(n, d)), np.abs(rng.rand(n, k)),
            np.abs(rng.rand(k, d)))


def _oracle_phase_sweep(X, W, T, reps, reg_t_l1=0.0, reg_t_l2=0.0,
                        reg_w_l1=0.0, reg_w_l2=0.0):
    """Literal per-topic phase sweep with `reps` Gauss-Seidel passes per
    phase; numerators/Grams computed once per phase (W frozen through the
    T-phase, T through the W-phase)."""
    eps = float(np.spacing(10))
    W = W.copy()
    T = T.copy()
    k = W.shape[1]
    N = W.T @ X              # (k, d), constant through the T-phase
    G = W.T @ W
    for _ in range(reps):
        for t in range(k):
            corr = G[t] @ T - G[t, t] * T[t]
            numer = N[t] - corr - reg_t_l1
            T[t] = np.maximum(numer, 0.0) / (G[t, t] + reg_t_l2 + eps)
    N2 = X @ T.T             # (n, k), constant through the W-phase
    G2 = T @ T.T
    for _ in range(reps):
        for t in range(k):
            corr = W @ G2[:, t] - G2[t, t] * W[:, t]
            numer = N2[:, t] - corr - reg_w_l1
            W[:, t] = np.maximum(numer, 0.0) / (G2[t, t] + reg_w_l2 + eps)
    return W, T


@pytest.mark.parametrize('reps', [1, 2, 3])
def test_inner_reps_matches_numpy_oracle(reps):
    X, W0, T0 = _problem()
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase',
                      reg_t_l2=0.03, reg_w_l1=0.01, inner_reps=reps)
    sweep = make_sweep(cfg)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W1, T1, _, _ = sweep(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                         key, r, key)
    Wo, To = _oracle_phase_sweep(X, W0, T0, reps,
                                 reg_t_l2=0.03, reg_w_l1=0.01)
    assert np.allclose(np.array(W1), Wo, atol=1e-11)
    assert np.allclose(np.array(T1), To, atol=1e-11)


def test_inner_reps_pallas_matches_xla():
    X, W0, T0 = _problem(seed=1)
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase',
                      inner_reps=3)
    a = make_sweep(cfg)
    b = make_dense_phase_sweep(cfg, 'interpret')
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Wa, Ta, _, _ = a(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                     key, r, key)
    Wb, Tb, _, _ = b(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                     key, r, key)
    assert np.allclose(np.array(Wa), np.array(Wb), atol=1e-11)
    assert np.allclose(np.array(Ta), np.array(Tb), atol=1e-11)


def test_inner_reps_sparse_matches_dense():
    X, W0, T0 = _problem(seed=2)
    X[X < 0.7] = 0.0
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase',
                      inner_reps=2)
    dense = make_sweep(cfg)
    sparse = make_sparse_sweep(cfg)
    Xb = to_bcoo(scipy.sparse.csr_matrix(X), jnp.asarray(X).dtype)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Wd, Td, _, _ = dense(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                         key, r, key)
    Ws, Ts, _, _ = sparse(Xb, jnp.asarray(W0), jnp.asarray(T0), key, r, key)
    assert np.allclose(np.array(Ws), np.array(Wd), atol=1e-11)
    assert np.allclose(np.array(Ts), np.array(Td), atol=1e-11)


def test_inner_reps_sharded_sparse_parity():
    from rri_nmf_tpu.parallel.mesh import make_mesh
    X, _, _ = _problem(n=64, d=48, seed=3)
    X[X < 0.7] = 0.0
    Xs = scipy.sparse.csr_matrix(X)
    kw = dict(k=5, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None, sparse=True,
              inner_reps=3, compute_obj_each_iter=True)
    single = nmf(Xs, **kw)
    sharded = nmf(Xs, mesh=make_mesh(8, mesh_shape=(4, 2)), **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['obj_history'], sharded['obj_history'],
                       atol=1e-9)


def test_inner_reps_driver_monotone_and_no_worse():
    """Driver fit with inner_reps=3: still monotone, and reaches an
    objective no worse than inner_reps=1 after the same sweep count
    (deterministic problem/seed — pinned, not a theorem)."""
    X, _, _ = _problem(n=100, d=70, seed=4)
    kw = dict(k=6, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, update_order='phase',
              reset_topic_method=None, project_T_each_iter=True,
              t_row_sum=1.0, w_row_sum=1.0, eps_stop=0)
    base = nmf(X, **kw)
    fast = nmf(X, inner_reps=3, **kw)
    assert np.all(np.diff(fast['obj_history']) <= 1e-10)
    assert fast['obj_history'][-1] <= base['obj_history'][-1] + 1e-9


def test_inner_reps_validation():
    X, _, _ = _problem()
    with pytest.raises(ValueError):
        nmf(X, 5, inner_reps=2)                     # interleaved order
    with pytest.raises(ValueError):
        nmf(X, 5, inner_reps=2, update_order='phase')  # resets on
    with pytest.raises(ValueError):
        nmf(X, 5, inner_reps=0, update_order='phase',
            reset_topic_method=None)
    with pytest.raises(ValueError):
        nmf(X, 5, inner_reps=2, update_order='phase',
            reset_topic_method=None, W_mat=np.ones_like(X))
