"""Sparse-X (BCOO) sweep: parity with the dense path and driver wiring.

The reference densifies sparse input (``sklearn_interface.py:78-83``);
this path keeps X sparse end to end (phase update order: the sweep touches
X through exactly two BCOO contractions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep, make_objective
from rri_nmf_tpu.ops.sweep_sparse import (
    make_sparse_objective, make_sparse_sweep, supports_sparse, to_bcoo,
)


def _problem(n=90, d=70, k=5, seed=0, density=0.2):
    rng = np.random.RandomState(seed)
    Xd = np.abs(rng.rand(n, k) @ rng.rand(k, d))
    Xd[rng.rand(n, d) >= density] = 0.0
    return Xd, np.abs(rng.rand(n, k)), np.abs(rng.rand(k, d))


def test_sparse_sweep_matches_dense():
    Xd, W0, T0 = _problem()
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, project_W_each_iter=True,
                      t_row_sum=1.0, w_row_sum=1.0)
    assert supports_sparse(cfg)
    dense = make_sweep(cfg)
    sparse = make_sparse_sweep(cfg)
    Xb = to_bcoo(scipy.sparse.csr_matrix(Xd), jnp.asarray(Xd).dtype)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Wd, Td = jnp.asarray(W0), jnp.asarray(T0)
    Ws, Ts = jnp.asarray(W0), jnp.asarray(T0)
    for _ in range(4):
        Wd, Td, _, _ = dense(jnp.asarray(Xd), Wd, Td, key, r, key)
        Ws, Ts, _, _ = sparse(Xb, Ws, Ts, key, r, key)
    assert np.allclose(np.array(Ws), np.array(Wd), atol=1e-11)
    assert np.allclose(np.array(Ts), np.array(Td), atol=1e-11)


def test_sparse_objective_exact():
    Xd, W, T = _problem(seed=2)
    f_dense = make_objective(False, False, 0.1, 0.2, 0.05, 0.01)
    f_sparse = make_sparse_objective(0.1, 0.2, 0.05, 0.01)
    a = float(f_dense(jnp.asarray(Xd), jnp.asarray(W), jnp.asarray(T)))
    b = float(f_sparse(to_bcoo(scipy.sparse.csr_matrix(Xd)),
                       jnp.asarray(W), jnp.asarray(T)))
    assert abs(a - b) < 1e-8 * max(1.0, a)


def test_driver_sparse_auto_matches_dense():
    Xd, _, _ = _problem(n=120, d=90)
    Xs = scipy.sparse.csr_matrix(Xd)
    kw = dict(k=5, max_iter=6, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase', eps_stop=0)
    dense = nmf(Xd, **kw)
    sp = nmf(Xs, **kw)   # 'auto' engages: settings already sparse-viable
    assert np.allclose(dense['W'], sp['W'], atol=1e-11)
    assert np.allclose(dense['obj_history'], sp['obj_history'], atol=1e-8)
    assert np.all(np.diff(sp['obj_history']) <= 0)


def test_driver_sparse_auto_conservative():
    """'auto' must NOT change semantics: default settings (interleaved,
    resets on) densify like the reference rather than silently switching
    order/resets."""
    Xd, _, _ = _problem(n=60, d=40)
    Xs = scipy.sparse.csr_matrix(Xd)
    a = nmf(Xd, k=4, max_iter=4, random_state=0, early_stop=False)
    b = nmf(Xs, k=4, max_iter=4, random_state=0, early_stop=False)
    assert np.allclose(a['W'], b['W'], atol=1e-12)


def test_driver_sparse_true_forces_and_validates():
    Xd, _, _ = _problem(n=60, d=40)
    Xs = scipy.sparse.csr_matrix(Xd)
    soln = nmf(Xs, k=4, max_iter=5, random_state=0, early_stop=False,
               sparse=True, compute_obj_each_iter=True)
    assert np.all(np.diff(soln['obj_history']) <= 0)
    with pytest.raises(ValueError):
        nmf(Xs, k=4, sparse=True, W_mat=np.ones(Xd.shape))


def test_tm_estimator_sparse_end_to_end():
    """TM estimator on a scipy-sparse corpus: preprocessing stays sparse
    (tfidf/normalize sparse branches) and nmf_kwargs={'sparse': True}
    keeps the whole fit on the BCOO path."""
    from rri_nmf_tpu.sklearn_interface import NMF_TM_Estimator
    rng = np.random.RandomState(0)
    counts = (rng.rand(150, 300) > 0.96) * rng.randint(1, 5, (150, 300))
    Xs = scipy.sparse.csr_matrix(counts.astype(float))
    M = NMF_TM_Estimator(150, 300, 5, random_state=0, max_iter=6,
                         handle_tfidf=True, handle_normalization=True,
                         nmf_kwargs={'sparse': True,
                                     'compute_obj_each_iter': True})
    M.fit(Xs)
    oh = M.nmf_outputs['obj_history']
    assert np.all(np.diff(oh) <= 0)
    assert np.allclose(np.asarray(M.W).sum(1), 1.0, atol=1e-8)
    assert np.all(np.asarray(M.T) >= -1e-12)


def test_sparse_fix_T_transform():
    Xd, _, T0 = _problem(seed=4)
    Xs = scipy.sparse.csr_matrix(Xd)
    soln = nmf(Xs, k=5, T_in=T0.copy(), fix_T=True, max_iter=3,
               random_state=0, early_stop=False, sparse=True)
    assert np.allclose(soln['T'], np.maximum(T0, 0))
    assert np.all(np.isfinite(soln['W']))


def test_sparse_gs_kernels_match_xla_gs():
    """The sparse sweep with gs_kernels=True (fused Pallas GS, interpret
    mode on CPU) must match the Gram-blocked XLA GS exactly."""
    Xd, W0, T0 = _problem(seed=3)
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase',
                      reg_t_l2=0.05)
    a = make_sparse_sweep(cfg)
    b = make_sparse_sweep(cfg, gs='interpret')
    Xb = to_bcoo(scipy.sparse.csr_matrix(Xd), jnp.asarray(Xd).dtype)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Wa, Ta = jnp.asarray(W0), jnp.asarray(T0)
    Wb, Tb = jnp.asarray(W0), jnp.asarray(T0)
    for _ in range(3):
        Wa, Ta, key, r = a(Xb, Wa, Ta, key, r, key)
        Wb, Tb, key, r = b(Xb, Wb, Tb, key, r, key)
    assert np.allclose(np.array(Wa), np.array(Wb), atol=1e-11)
    assert np.allclose(np.array(Ta), np.array(Tb), atol=1e-11)


def test_sparse_gemm_dtype_bf16_descends():
    """gemm_dtype=bfloat16 (the reduced-precision contraction path) still descends
    monotonically; values track the f32 path to bf16-input-rounding
    accuracy."""
    Xd, W0, T0 = _problem(seed=5)
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase')
    f32 = make_sparse_sweep(cfg)
    b16 = make_sparse_sweep(cfg, gemm_dtype=jnp.bfloat16)
    Xb = to_bcoo(scipy.sparse.csr_matrix(Xd), jnp.float32)
    obj = make_sparse_objective()
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Wa = jnp.asarray(W0, jnp.float32); Ta = jnp.asarray(T0, jnp.float32)
    Wb, Tb = Wa, Ta
    objs = []
    for _ in range(5):
        Wa, Ta, key, r = f32(Xb, Wa, Ta, key, r, key)
        Wb, Tb, key, r = b16(Xb, Wb, Tb, key, r, key)
        objs.append(float(obj(Xb, Wb, Tb)))
    assert np.all(np.diff(objs) <= 1e-5 * np.abs(objs[0]))
    # bf16 input rounding: agreement to ~1e-2 relative
    assert np.allclose(np.array(Wa), np.array(Wb),
                       atol=3e-2 * float(np.max(np.abs(np.array(Wa)))))


def test_sparse_objective_chunked_matches_oneshot():
    """Past the gather budget the cross term accumulates over nnz chunks
    (the one-shot form is O(nnz*k) of gather temporaries — 512 GB at the
    beyond-HBM scale); the chunked sum must equal the one-shot exactly,
    including a zero-padded tail chunk."""
    rng = np.random.RandomState(0)
    Xs = scipy.sparse.random(37, 29, density=0.3, random_state=0,
                             format='csr')
    X = to_bcoo(Xs, jnp.float64)
    W = jnp.asarray(np.abs(rng.rand(37, 5)))
    T = jnp.asarray(np.abs(rng.rand(5, 29)))
    one = make_sparse_objective(0.1, 0.2, 0.05, 0.01)
    chunked = make_sparse_objective(0.1, 0.2, 0.05, 0.01,
                                    chunk=64, gather_budget=0)
    assert np.isclose(float(one(X, W, T)), float(chunked(X, W, T)),
                      rtol=1e-13)


def test_make_sweep_rejects_inner_reps_with_resets():
    """Direct make_sweep callers get the same inner_reps guard as the
    driver: a mid-phase reset invalidates the cached per-phase
    numerators, so the extra passes would silently use wrong math."""
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
    with pytest.raises(ValueError):
        make_sweep(SweepConfig(k=4, update_order='phase',
                               reset_topic_method='max_resid_document',
                               inner_reps=2))
    with pytest.raises(ValueError):
        make_sweep(SweepConfig(k=4, update_order='interleaved',
                               reset_topic_method=None, inner_reps=2))


def test_sparse_sweep_accepts_matmul_precision():
    """matmul_precision threads through the sparse sweep (previously
    silently ignored); on CPU the results are identical to the default,
    which pins that the wrapper at least composes."""
    rng = np.random.RandomState(0)
    Xs = scipy.sparse.random(40, 30, density=0.3, random_state=0,
                             format='csr')
    W0 = np.abs(rng.rand(40, 4))
    T0 = np.abs(rng.rand(4, 30))
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)

    def run(cfg):
        Xb = to_bcoo(Xs, jnp.float64)
        sweep = make_sparse_sweep(cfg)
        return sweep(Xb, jnp.asarray(W0), jnp.asarray(T0), key, r, key)

    a = run(SweepConfig(k=4, update_order='phase',
                        reset_topic_method=None))
    b = run(SweepConfig(k=4, update_order='phase', reset_topic_method=None,
                        matmul_precision='float32'))
    assert np.allclose(np.array(a[0]), np.array(b[0]), atol=1e-12)
