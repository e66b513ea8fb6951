"""Mesh-sharded sparse path (parallel/sparse_mesh.py): parity with the
single-device sparse sweep on the 8-virtual-device CPU mesh.

This is the BASELINE.md #5 configuration class (row-sharded sparse corpus,
per-topic reductions psum'd over the mesh) that the reference cannot run
at all: it densifies sparse input (``sklearn_interface.py:78-83``) and has
no distributed runtime (SURVEY.md §2.2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.ops.sweep_sparse import (
    make_sparse_objective, to_bcoo,
)
from rri_nmf_tpu.ops.sweep_xla import SweepConfig
from rri_nmf_tpu.parallel.mesh import make_mesh
from rri_nmf_tpu.parallel.sparse_mesh import (
    make_sharded_sparse_objective, make_sharded_sparse_sweep,
    partition_coo, supports_sharded_sparse,
)


def _sparse_problem(n=80, d=50, k=5, seed=0, density=0.15):
    rng = np.random.RandomState(seed)
    Xd = np.abs(rng.rand(n, k) @ rng.rand(k, d))
    Xd[rng.rand(n, d) >= density] = 0.0
    return scipy.sparse.csr_matrix(Xd), Xd


def test_partition_coo_roundtrip_and_duplicates():
    mesh = make_mesh(8, mesh_shape=(4, 2))
    # duplicate coordinates must SUM (reference coo_matrix semantics)
    rows = np.array([0, 0, 3, 7, 7])
    cols = np.array([1, 1, 2, 0, 0])
    vals = np.array([1.0, 2.0, 5.0, 3.0, -1.0])
    X = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(9, 5))
    Xs = partition_coo(X, mesh)
    dense = np.zeros((Xs.n_loc * 4, Xs.d_loc * 2))
    data = np.array(Xs.data).reshape(4, 2, -1)
    rr = np.array(Xs.rows).reshape(4, 2, -1)
    cc = np.array(Xs.cols).reshape(4, 2, -1)
    for i in range(4):
        for j in range(2):
            np.add.at(dense, (i * Xs.n_loc + rr[i, j],
                              j * Xs.d_loc + cc[i, j]), data[i, j])
    assert np.allclose(dense[:9, :5], X.toarray())
    assert dense[9:].sum() == 0 and dense[:, 5:].sum() == 0


def test_sharded_sparse_matches_single_device_tm():
    """TM preset (per-iteration T projection + row sums) on a pure
    row-sharded (8, 1) mesh == single-device sparse to 1e-11."""
    X, _ = _sparse_problem()
    kw = dict(k=5, max_iter=6, init='nndsvd', random_state=0,
              early_stop=False, compute_obj_each_iter=True,
              update_order='phase', reset_topic_method=None,
              project_T_each_iter=True, t_row_sum=1.0,
              w_row_sum=1.0, project_W_each_iter=True, sparse=True)
    single = nmf(X, **kw)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    sharded = nmf(X, mesh=mesh, **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['T'], sharded['T'], atol=1e-11)
    assert np.allclose(single['obj_history'], sharded['obj_history'],
                       atol=1e-9)
    assert np.all(np.diff(sharded['obj_history']) <= 1e-12)


def test_sharded_sparse_2d_mesh_with_regs():
    """(4, 2) mesh — both psum axes live — with L1/L2 regularizers."""
    X, _ = _sparse_problem(n=70, d=60, seed=1)
    kw = dict(k=5, max_iter=6, random_state=0, early_stop=False,
              compute_obj_each_iter=True, update_order='phase',
              reset_topic_method=None, reg_w_l1=0.01, reg_t_l2=0.05,
              sparse=True)
    single = nmf(X, **kw)
    mesh = make_mesh(8, mesh_shape=(4, 2))
    sharded = nmf(X, mesh=mesh, **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['T'], sharded['T'], atol=1e-11)
    assert np.allclose(single['obj_history'], sharded['obj_history'],
                       atol=1e-9)


def test_sharded_sparse_vector_w_row_sum():
    X, _ = _sparse_problem(n=64, d=40, seed=2)
    ws = 0.5 + np.arange(64) / 64.0
    kw = dict(k=4, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              w_row_sum=ws, project_W_each_iter=True, sparse=True)
    single = nmf(X, **kw)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    sharded = nmf(X, mesh=mesh, **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['T'], sharded['T'], atol=1e-11)
    assert np.allclose(np.asarray(sharded['W']).sum(1), ws, atol=1e-8)


def test_sharded_sparse_grouped_dispatch():
    X, _ = _sparse_problem(seed=3)
    kw = dict(k=5, max_iter=6, random_state=0, early_stop=False,
              compute_obj_each_iter=False, update_order='phase',
              reset_topic_method=None, sparse=True)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    a = nmf(X, mesh=mesh, **kw)
    b = nmf(X, mesh=mesh, sweeps_per_dispatch=3, **kw)
    assert np.allclose(a['W'], b['W'], atol=1e-12)
    assert np.allclose(a['T'], b['T'], atol=1e-12)


def test_sharded_sparse_objective_exact():
    X, Xd = _sparse_problem(seed=4)
    rng = np.random.RandomState(7)
    W = np.abs(rng.rand(80, 5))
    T = np.abs(rng.rand(5, 50))
    mesh = make_mesh(8, mesh_shape=(4, 2))
    f_single = make_sparse_objective(0.1, 0.2, 0.05, 0.01)
    f_mesh = make_sharded_sparse_objective(mesh, 0.1, 0.2, 0.05, 0.01)
    a = float(f_single(to_bcoo(X), jnp.asarray(W), jnp.asarray(T)))
    b = float(f_mesh(partition_coo(X, mesh), jnp.asarray(W),
                     jnp.asarray(T)))
    assert abs(a - b) < 1e-9 * max(1.0, a)


def test_sharded_sparse_tp_gate():
    """T-row sum constraints need tp == 1; a (4, 2) mesh must be
    rejected loudly, not silently mis-sharded."""
    X, _ = _sparse_problem()
    mesh = make_mesh(8, mesh_shape=(4, 2))
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0)
    assert not supports_sharded_sparse(cfg, mesh)
    assert supports_sharded_sparse(cfg, make_mesh(8, mesh_shape=(8, 1)))
    with pytest.raises(ValueError):
        nmf(X, k=5, sparse=True, mesh=mesh, update_order='phase',
            reset_topic_method=None, project_T_each_iter=True,
            t_row_sum=1.0, max_iter=2)


def test_sharded_sparse_auto_engages(monkeypatch):
    """sparse='auto' + mesh + already-sparse-viable settings routes
    through partition_coo (X never densifies)."""
    import rri_nmf_tpu.parallel.sparse_mesh as spm
    calls = {'n': 0}
    orig = spm.partition_coo

    def spy(*a, **k):
        calls['n'] += 1
        return orig(*a, **k)

    monkeypatch.setattr(spm, 'partition_coo', spy)
    X, Xd = _sparse_problem(seed=5)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    kw = dict(k=5, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None)
    soln = nmf(X, mesh=mesh, **kw)          # 'auto' default
    assert calls['n'] == 1
    dense = nmf(Xd, **kw)                   # single-device dense oracle
    assert np.allclose(soln['W'], dense['W'], atol=1e-11)
    assert np.allclose(soln['T'], dense['T'], atol=1e-11)


def test_sharded_sparse_fix_T_transform():
    """fix_T (the estimators' transform path) under the sparse mesh."""
    X, _ = _sparse_problem(seed=6)
    rng = np.random.RandomState(1)
    T0 = np.abs(rng.rand(5, 50))
    mesh = make_mesh(8, mesh_shape=(8, 1))
    kw = dict(k=5, T_in=T0.copy(), fix_T=True, max_iter=3,
              random_state=0, early_stop=False, sparse=True,
              update_order='phase', reset_topic_method=None)
    single = nmf(X, **kw)
    sharded = nmf(X, mesh=mesh, **kw)
    assert np.allclose(sharded['T'], np.maximum(T0, 0))
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)


def _sweep_builders():
    """(name, builder) for every sweep nmf() routes a phase-order fit to;
    each builder takes a SweepConfig and returns (sweep, args)."""
    from rri_nmf_tpu.ops.dense_phase import make_dense_phase_sweep
    from rri_nmf_tpu.ops.sweep_sparse import make_sparse_sweep
    from rri_nmf_tpu.ops.sweep_xla import make_sweep
    from rri_nmf_tpu.parallel.sharded_dense import make_sharded_dense_sweep
    Xs, Xd = _sparse_problem(n=16, d=8, k=2)
    W = jnp.ones((16, 2))
    T = jnp.ones((2, 8))
    key = jax.random.PRNGKey(0)
    tail = (key, jnp.asarray(0, jnp.int32), key)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    return {
        'make_sweep': lambda c: (make_sweep(c), (jnp.asarray(Xd), W, T)),
        'dense_phase': lambda c: (make_dense_phase_sweep(c, 'xla'),
                                  (jnp.asarray(Xd), W, T)),
        'sparse': lambda c: (make_sparse_sweep(c), (to_bcoo(Xs), W, T)),
        'sharded_dense': lambda c: (make_sharded_dense_sweep(c, mesh),
                                    (jnp.asarray(Xd), W, T)),
        'sharded_sparse': lambda c: (
            make_sharded_sparse_sweep(c, mesh),
            (partition_coo(Xs, mesh), W, T)),
    }, tail


@pytest.mark.parametrize('name', ['make_sweep', 'dense_phase', 'sparse',
                                  'sharded_dense', 'sharded_sparse'])
def test_sweeps_honour_matmul_precision(name):
    """matmul_precision='highest' reaches the dots of every phase-order
    sweep (on a GPU the default float32 dot runs in TF32; a sweep that
    ignored the setting would silently fit at that precision)."""
    builders, tail = _sweep_builders()
    cfg = SweepConfig(k=2, update_order='phase', reset_topic_method=None,
                      matmul_precision='highest')
    sweep, args = builders[name](cfg)
    text = sweep.lower(*args, *tail).as_text()
    assert 'HIGHEST' in text
    plain = SweepConfig(k=2, update_order='phase', reset_topic_method=None)
    sweep, args = builders[name](plain)
    assert 'HIGHEST' not in sweep.lower(*args, *tail).as_text()
