"""The BCOO sparse phase sweep (``ops/sweep_sparse.py``) against the dense
phase sweep, over the shapes and configs of the beyond-memory corpus
path: odd edges, empty bands, duplicate COO entries, the TM constraint
set, inner reps, bf16 contraction inputs, the mesh-sharded form, and the
Gauss-Seidel kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.ops.sweep_sparse import make_sparse_sweep, to_bcoo
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep


def _one_sweep(sweep, X, W, T):
    key = jax.random.PRNGKey(0)
    W1, T1, _, _ = sweep(X, jnp.asarray(W), jnp.asarray(T), key,
                         jnp.asarray(0, jnp.int32), key)
    return np.array(W1), np.array(T1)


@pytest.mark.parametrize('n,d,k,dens', [
    (300, 260, 7, 0.02),        # odd edges
    (128, 128, 4, 0.05),
    (513, 200, 16, 0.005),      # sparse tail rows
    (64, 1000, 3, 0.01),        # wide
])
def test_bcoo_sweep_matches_dense(n, d, k, dens):
    rng = np.random.RandomState(hash((n, d)) % 2**31)
    Xd = rng.rand(n, d) * (rng.rand(n, d) < dens)
    W = rng.rand(n, k)
    T = rng.rand(k, d)
    cfg = SweepConfig(k=k, update_order='phase', reset_topic_method=None)
    Ws, Ts = _one_sweep(make_sparse_sweep(cfg), to_bcoo(
        sp.csr_matrix(Xd), np.float64), W, T)
    Wd, Td = _one_sweep(make_sweep(cfg), jnp.asarray(Xd), W, T)
    assert np.abs(Ws - Wd).max() < 1e-10
    assert np.abs(Ts - Td).max() < 1e-10


def test_bcoo_duplicates_sum_and_empty_bands():
    """Duplicate COO entries sum (scipy semantics) and all-zero column
    bands stay exactly zero in the contraction."""
    X = sp.coo_matrix((np.array([1.0, 2.0, 3.0]),
                       (np.array([5, 5, 9]), np.array([7, 7, 130]))),
                      shape=(200, 400))
    bc = to_bcoo(X, np.float64)
    W = np.random.RandomState(0).rand(200, 3)
    from jax.experimental import sparse as jsparse
    out = np.array(jsparse.bcoo_dot_general(
        bc, jnp.asarray(W), dimension_numbers=(((0,), (0,)), ((), ()))).T)
    ref = W.T @ X.toarray()
    assert np.abs(out - ref).max() < 1e-12
    assert np.all(out[:, 256:] == 0.0)


def test_bcoo_empty_matrix_sweep_is_finite():
    X = sp.csr_matrix((50, 70))
    rng = np.random.RandomState(0)
    cfg = SweepConfig(k=3, update_order='phase', reset_topic_method=None,
                      t_row_sum=1.0, w_row_sum=1.0)
    W1, T1 = _one_sweep(make_sparse_sweep(cfg), to_bcoo(X, np.float64),
                        rng.rand(50, 3), rng.rand(3, 70))
    assert np.all(np.isfinite(W1)) and np.all(np.isfinite(T1))


def test_driver_sparse_matches_dense():
    """nmf(X_csr, sparse=True) == the dense fit to 1e-11 (same sweeps)."""
    rng = np.random.RandomState(3)
    Xd = np.abs(rng.rand(150, 90))
    Xd[Xd < 0.7] = 0.0
    kw = dict(k=6, max_iter=5, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              compute_obj_each_iter=True, eps_stop=0)
    dense = nmf(Xd, **kw)
    sparse = nmf(sp.csr_matrix(Xd), sparse=True, **kw)
    assert np.allclose(dense['W'], sparse['W'], atol=1e-11)
    assert np.allclose(dense['T'], sparse['T'], atol=1e-11)
    assert np.allclose(dense['obj_history'], sparse['obj_history'],
                       atol=1e-9)
    assert np.all(np.diff(sparse['obj_history']) <= 1e-10)


def test_driver_sparse_inner_reps_and_tm_preset():
    """Sparse path with inner_reps and the TM constraint set (simplex T
    via the projected Gram-blocked loop, W row sums)."""
    rng = np.random.RandomState(4)
    Xd = np.abs(rng.rand(130, 80))
    Xd[Xd < 0.6] = 0.0
    kw = dict(k=5, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
              inner_reps=2, eps_stop=0)
    dense = nmf(Xd, **kw)
    sparse = nmf(sp.csr_matrix(Xd), sparse=True, **kw)
    assert np.allclose(dense['W'], sparse['W'], atol=1e-11)
    assert np.allclose(dense['T'], sparse['T'], atol=1e-11)


@pytest.mark.parametrize('mode', ['mxu', 'dma', 'bcoo'])
def test_driver_sparse_mode_validation(mode):
    """Only True/False/'auto' name a sparse mode."""
    Xd = np.abs(np.random.RandomState(5).rand(40, 30))
    with pytest.raises(ValueError, match='sparse must be one of'):
        nmf(sp.csr_matrix(Xd), 4, sparse=mode)


@pytest.mark.parametrize('shape', [(8, 1), (4, 2)])
def test_sharded_sparse_matches_single_device(shape):
    """Mesh-sharded BCOO sweep (per-device COO blocks under shard_map,
    psum'd numerators/Grams) == the single-device sparse fit."""
    from rri_nmf_tpu.parallel.mesh import make_mesh
    rng = np.random.RandomState(6)
    Xd = np.abs(rng.rand(300, 260))
    Xd[Xd < 0.8] = 0.0
    Xs = sp.csr_matrix(Xd)
    kw = dict(k=6, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              compute_obj_each_iter=True, eps_stop=0)
    single = nmf(Xs, sparse=True, **kw)
    sharded = nmf(Xs, sparse=True, mesh=make_mesh(8, mesh_shape=shape),
                  **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['obj_history'], sharded['obj_history'],
                       atol=1e-9)


def test_sharded_sparse_tm_preset_no_padded_row_leak():
    """TM preset (per-topic T simplex projection) through the sharded
    BCOO sweep with n not a multiple of dp: T rows sum to t_row_sum on
    the true columns and the fit matches the single-device fit."""
    from rri_nmf_tpu.parallel.mesh import make_mesh
    rng = np.random.RandomState(11)
    Xd = 0.05 * np.abs(rng.rand(97, 80))
    Xd[Xd < 0.04] = 0.0
    Xs = sp.csr_matrix(Xd)
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              project_T_each_iter=True, t_row_sum=1.0, eps_stop=0)
    single = nmf(Xs, sparse=True, **kw)
    sharded = nmf(Xs, sparse=True, mesh=make_mesh(8, mesh_shape=(8, 1)),
                  **kw)
    assert np.allclose(sharded['T'].sum(axis=1), 1.0, atol=1e-6)
    assert np.allclose(single['T'], sharded['T'], atol=1e-9)
    assert np.allclose(single['W'], sharded['W'], atol=1e-9)


def test_sharded_sparse_bf16_contraction_accumulates_f32():
    """The sharded COO sweep's contractions must cast the dense operand
    to f32 BEFORE the dot under bf16 storage (bf16 accumulation over
    n_loc terms produces garbage numerators): the bf16 sharded fit stays
    close to the bf16 single-device fit."""
    from rri_nmf_tpu.parallel.mesh import make_mesh
    rng = np.random.RandomState(12)
    Xd = np.abs(rng.rand(256, 96))
    Xd[Xd < 0.6] = 0.0
    Xs = sp.csr_matrix(Xd.astype(np.float32))
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              dtype='bfloat16', eps_stop=0)
    single = nmf(Xs, sparse=True, **kw)
    sharded = nmf(Xs, sparse=True, mesh=make_mesh(8, mesh_shape=(8, 1)),
                  **kw)
    ref = np.asarray(single['W'], np.float32)
    got = np.asarray(sharded['W'], np.float32)
    assert np.abs(got - ref).max() <= 0.03 * np.abs(ref).max()


def test_sharded_sparse_inner_reps_and_empty_device():
    """A device with an all-zero block plus inner_reps through the
    sharded BCOO path."""
    from rri_nmf_tpu.parallel.mesh import make_mesh
    rng = np.random.RandomState(7)
    Xd = np.abs(rng.rand(200, 150))
    Xd[Xd < 0.85] = 0.0
    Xd[:50] = 0.0          # first dp block row empty
    Xs = sp.csr_matrix(Xd)
    kw = dict(k=5, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              inner_reps=2, eps_stop=0)
    single = nmf(Xs, sparse=True, **kw)
    sharded = nmf(Xs, sparse=True, mesh=make_mesh(8, mesh_shape=(4, 2)),
                  **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['T'], sharded['T'], atol=1e-11)


def test_sparse_bf16_contraction_inputs():
    """gemm_dtype=bfloat16 rounds the contraction inputs only: one sweep
    within bf16 input-rounding tolerance of the f64 sweep."""
    rng = np.random.RandomState(8)
    Xd = rng.rand(300, 260) * (rng.rand(300, 260) < 0.03)
    W = rng.rand(300, 5)
    T = rng.rand(5, 260)
    cfg = SweepConfig(k=5, update_order='phase', reset_topic_method=None)
    X = to_bcoo(sp.csr_matrix(Xd), np.float64)
    W16, _ = _one_sweep(make_sparse_sweep(cfg, gemm_dtype=jnp.bfloat16),
                        X, W, T)
    W64, _ = _one_sweep(make_sparse_sweep(cfg), X, W, T)
    assert np.abs(W16 - W64).max() < 4e-2 * np.abs(W64).max()


@pytest.mark.parametrize('kw', [
    dict(),
    dict(reg_t_l1=0.01, reg_w_l2=0.1),
    dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0),
    dict(inner_reps=2),
])
def test_sparse_sweep_gs_kernel_interpret_matches_xla(kw):
    """The sparse sweep's topic loops through the Triton GS kernel (Pallas
    interpreter) == the XLA loop."""
    rng = np.random.RandomState(9)
    Xd = rng.rand(90, 70) * (rng.rand(90, 70) < 0.1)
    W = rng.rand(90, 6)
    T = rng.rand(6, 70)
    cfg = SweepConfig(k=6, update_order='phase', reset_topic_method=None,
                      **kw)
    X = to_bcoo(sp.csr_matrix(Xd), np.float64)
    Wx, Tx = _one_sweep(make_sparse_sweep(cfg, gs='xla'), X, W, T)
    Wk, Tk = _one_sweep(make_sparse_sweep(cfg, gs='interpret'), X, W, T)
    assert np.allclose(Wx, Wk, atol=1e-11)
    assert np.allclose(Tx, Tk, atol=1e-11)
