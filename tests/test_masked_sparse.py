"""Sparse-mask WRRI path (ops/sweep_masked_sparse.py): parity with the
dense masked sweep, monotone descent, estimator integration, and guards.

The dense masked sweep is itself pinned against the reference
(tests/test_nmf.py, tests/test_consistency.py), so f64 parity against it
transitively pins the O(nnz) path to reference semantics. VERDICT r3
item 1's done-criterion: parity at small shapes (1e-10 f64)."""

import numpy as np
import pytest
import scipy.sparse as sp

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.sklearn_interface import NMF_RS_Estimator


def _problem(seed, n=30, d=24, k=4, density=0.35, scale=1.0):
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density).astype(float)
    X = rng.rand(n, d) * M * scale
    return X, M


def _fit_pair(X, M, k, **kwargs):
    """(dense-mask result, sparse-mask result) for identical settings."""
    r_dense = nmf(X, k, W_mat=M, **kwargs)
    r_sparse = nmf(X, k, W_mat=sp.csr_matrix(M), **kwargs)
    return r_dense, r_sparse


def _assert_parity(rd, rs, atol=1e-10):
    np.testing.assert_allclose(rs['W'], rd['W'], atol=atol, rtol=0)
    np.testing.assert_allclose(rs['T'], rd['T'], atol=atol, rtol=0)
    if 'obj_history' in rd:
        np.testing.assert_allclose(rs['obj_history'], rd['obj_history'],
                                   rtol=1e-9)


@pytest.mark.parametrize('regs', [
    dict(),                                      # scale-transfer path
    dict(reg_w_l1=0.01, reg_t_l1=0.01),
    dict(reg_w_l1=0.05, reg_t_l1=0.0),
    dict(reg_w_l2=0.02, reg_t_l2=0.02),
])
def test_parity_reg_configs(regs):
    X, M = _problem(0)
    rd, rs = _fit_pair(X, M, 4, max_iter=8, compute_obj_each_iter=True,
                       reset_topic_method=None, random_state=0, **regs)
    _assert_parity(rd, rs)
    oh = np.array(rs['obj_history'])
    assert np.all(np.diff(oh) <= 1e-12), 'masked sparse descent broken'


def test_parity_simplex_projected():
    """project_T_each_iter + t_row_sum: the hoisted drift reprojection and
    the per-iteration W projection (TM-flavored masked config)."""
    X, M = _problem(4)
    rd, rs = _fit_pair(X, M, 4, max_iter=8, compute_obj_each_iter=True,
                       reset_topic_method=None, project_T_each_iter=True,
                       t_row_sum=1.0, w_row_sum=1.0,
                       project_W_each_iter=True, random_state=4)
    _assert_parity(rd, rs)
    assert np.allclose(rs['T'].sum(axis=1), 1.0, atol=1e-12)


def test_parity_vector_w_row_sum():
    X, M = _problem(7)
    wrs = 0.5 + np.random.RandomState(7).rand(X.shape[0])
    rd, rs = _fit_pair(X, M, 4, max_iter=5, compute_obj_each_iter=True,
                       reset_topic_method=None, w_row_sum=wrs,
                       project_W_each_iter=True, random_state=7)
    _assert_parity(rd, rs)


def test_parity_nonbinary_weights():
    """General entrywise weights, not just a binary mask (Ho Lemma 6.5
    in full)."""
    rng = np.random.RandomState(8)
    X, M = _problem(8)
    Mw = M * (0.5 + rng.rand(*M.shape))
    rd, rs = _fit_pair(X, Mw, 4, max_iter=6, compute_obj_each_iter=True,
                       reset_topic_method=None, random_state=8)
    _assert_parity(rd, rs)


def test_parity_dp_noise():
    """The DP Gaussian mechanism consumes the same key schedule and
    shapes as the dense masked sweep, so the noisy runs agree exactly."""
    X, M = _problem(6)
    rd, rs = _fit_pair(X, M, 4, max_iter=5, compute_obj_each_iter=True,
                       reset_topic_method=None, eps_gauss_t=1e4,
                       delta_gauss_t=0.1, project_T_each_iter=True,
                       t_row_sum=1.0, random_state=6)
    _assert_parity(rd, rs)


@pytest.mark.parametrize('fix_seed', [True, False])
def test_parity_random_resets_fire(fix_seed):
    """Strong T-L1 on tiny values kills topics, so the budgeted 'random'
    resets actually fire — and the rank-one residual patch plus the
    shared reset key schedule keep both paths bitwise aligned."""
    X, M = _problem(11, n=25, d=20, k=6, density=0.4, scale=0.05)
    rd, rs = _fit_pair(X, M, 6, max_iter=8, compute_obj_each_iter=True,
                       reset_topic_method='random', fix_reset_seed=fix_seed,
                       n_resets=10, reg_t_l1=0.3, random_state=12)
    fired = 10 - rd['n_resets_remaining']
    assert fired > 0, 'test problem no longer triggers resets'
    assert rs['n_resets_remaining'] == rd['n_resets_remaining']
    _assert_parity(rd, rs)


def test_parity_fix_T_transform():
    """The RS estimator's transform preset: fixed-T masked sweeps with
    'random' resets."""
    rng = np.random.RandomState(5)
    X, M = _problem(5)
    k = 4
    T_in = np.abs(rng.rand(k, X.shape[1]))
    T_in /= T_in.sum(axis=1, keepdims=True)
    rd, rs = _fit_pair(X, M, k, max_iter=4, reset_topic_method='random',
                       T_in=T_in, fix_T=True, t_row_sum=1.0,
                       compute_obj_each_iter=True, random_state=5)
    _assert_parity(rd, rs)


def test_grouped_dispatch_matches_per_iteration():
    X, M = _problem(9)
    Ms = sp.csr_matrix(M)
    common = dict(max_iter=6, compute_obj_each_iter=False,
                  reset_topic_method=None, random_state=9)
    r1 = nmf(X, 4, W_mat=Ms, **common)
    r2 = nmf(X, 4, W_mat=Ms, sweeps_per_dispatch=3, **common)
    np.testing.assert_array_equal(r1['W'], r2['W'])
    np.testing.assert_array_equal(r1['T'], r2['T'])


def test_sparse_X_input_and_objective():
    """X itself scipy-sparse (values only at observed entries) and the
    O(nnz) objective equals the dense masked objective."""
    X, M = _problem(1)
    common = dict(max_iter=8, compute_obj_each_iter=True,
                  reset_topic_method=None, reg_w_l1=0.01, reg_t_l1=0.01,
                  t_row_sum=1.0, random_state=0)
    rd = nmf(X, 4, W_mat=M, **common)
    rs = nmf(sp.csr_matrix(X), 4, W_mat=sp.csr_matrix(M), **common)
    _assert_parity(rd, rs)
    # the returned obj_calculator keeps evaluating after the fit
    oc = rs['obj_calculator']
    assert abs(oc.true_objective() - rs['obj_history'][-1]) < 1e-10


def test_obj_calculator_pickles():
    import pickle
    X, M = _problem(2)
    rs = nmf(sp.csr_matrix(X), 4, W_mat=sp.csr_matrix(M), max_iter=3,
             compute_obj_each_iter=True, reset_topic_method=None,
             random_state=10)
    oc = pickle.loads(pickle.dumps(rs['obj_calculator']))
    assert abs(oc.true_objective() - rs['obj_history'][-1]) < 1e-10


def test_guards():
    X, M = _problem(3)
    Ms = sp.csr_matrix(M)
    with pytest.raises(NotImplementedError, match='w_row'):
        nmf(X, 4, W_mat=Ms, w_row=np.ones(X.shape[0]), max_iter=1)
    with pytest.raises(ValueError, match='store_gradients'):
        nmf(X, 4, W_mat=Ms, store_gradients=True, max_iter=1)
    # 'max_resid_document' (the default) is auto-disabled with a log,
    # not an error — the fit must still run
    r = nmf(X, 4, W_mat=Ms, reset_topic_method='max_resid_document',
            max_iter=2, compute_obj_each_iter=True, random_state=0)
    assert len(r['obj_history']) == 2


def test_estimator_sparse_obs_parity(recsys_train):
    """NMF_RS_Estimator(sparse_obs=True) reproduces the dense fit on the
    reference recsys fixture — including the validation early stopping."""
    n, d = recsys_train.shape
    I, J = recsys_train.nonzero()
    R = recsys_train[I, J]
    X = np.stack([I, J], axis=1)
    ed = NMF_RS_Estimator(n, d, 5, random_state=0, max_iter=8,
                          sparse_obs=False).fit(X, R)
    es = NMF_RS_Estimator(n, d, 5, random_state=0, max_iter=8,
                          sparse_obs=True).fit(X, R)
    np.testing.assert_allclose(es.W, ed.W, atol=1e-9)
    np.testing.assert_allclose(es.T, ed.T, atol=1e-9)
    assert len(es.nmf_outputs['obj_history']) == \
        len(ed.nmf_outputs['obj_history'])
    assert es.score(X, R) < 1.0  # reference quality floor


def test_estimator_sparse_transform(recsys_train, recsys_test):
    n, d = recsys_train.shape
    est = NMF_RS_Estimator(n, d, 5, random_state=0, max_iter=6,
                           sparse_obs=True)
    est.fit_from_Xtr(sp.csr_matrix(recsys_train))
    Wt_sparse = est.transform(sp.csr_matrix(recsys_test))
    Wt_dense = est.transform(recsys_test)
    np.testing.assert_allclose(Wt_sparse, Wt_dense, atol=1e-9)


def test_estimator_auto_threshold():
    est = NMF_RS_Estimator(100, 100, 5)              # small: dense
    assert est._use_sparse_obs() is False
    est = NMF_RS_Estimator(100_000, 50_000, 5)       # 40 GB dense: sparse
    assert est._use_sparse_obs() is True
    assert NMF_RS_Estimator(10, 10, 2,
                            sparse_obs=True)._use_sparse_obs() is True


def test_mesh_parity_row_sharded():
    """(8, 1) mesh sparse-mask sweep == single-device, with n NOT
    divisible by the mesh (ghost-row padding path)."""
    import jax
    from rri_nmf_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    X, M = _problem(0, n=83, d=40, k=5)
    Ms = sp.csr_matrix(M)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    common = dict(max_iter=8, compute_obj_each_iter=True,
                  reset_topic_method=None, reg_w_l1=0.01, reg_t_l1=0.01,
                  t_row_sum=1.0, random_state=0)
    r1 = nmf(X, 5, W_mat=Ms, **common)
    r2 = nmf(X, 5, W_mat=Ms, mesh=mesh, **common)
    _assert_parity(r1, r2)


def test_mesh_parity_projected_transfer():
    """Simplex projections + scale transfer on the mesh (divisible n)."""
    import jax
    from rri_nmf_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    X, M = _problem(1, n=80, d=40, k=5)
    Ms = sp.csr_matrix(M)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    common = dict(max_iter=6, compute_obj_each_iter=True,
                  reset_topic_method=None, project_T_each_iter=True,
                  t_row_sum=1.0, w_row_sum=1.0, project_W_each_iter=True,
                  random_state=1)
    r1 = nmf(X, 5, W_mat=Ms, **common)
    r2 = nmf(X, 5, W_mat=Ms, mesh=mesh, **common)
    _assert_parity(r1, r2)


def test_mesh_guards():
    import jax
    from rri_nmf_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 devices')
    X, M = _problem(2)
    Ms = sp.csr_matrix(M)
    with pytest.raises(ValueError, match='row blocks'):
        nmf(X, 4, W_mat=Ms, mesh=make_mesh(8, mesh_shape=(4, 2)),
            max_iter=1)
    with pytest.raises(ValueError, match='random'):
        nmf(X, 4, W_mat=Ms, mesh=make_mesh(8, mesh_shape=(8, 1)),
            reset_topic_method='random', max_iter=1)


def test_plan_padding_and_roundtrip():
    from rri_nmf_tpu.ops.sweep_masked_sparse import (_PAD_TO,
                                                     plan_masked_coo)
    X, M = _problem(13, n=17, d=11, density=0.3)
    plan = plan_masked_coo(X, sp.csr_matrix(M), np.float64)
    assert plan.rows.shape[0] % _PAD_TO == 0
    assert plan.nnz == int(M.sum())
    assert float(plan.m_vals[plan.nnz:].sum()) == 0.0
    Ms2, Xs2 = plan.to_scipy()
    np.testing.assert_array_equal(Ms2.toarray(), M)
    np.testing.assert_array_equal(Xs2.toarray(), X * M)


def test_plan_padding_preserves_sorted_rows():
    """seg_rows promises ``indices_are_sorted=True`` to segment_sum, so
    the padded row stream must be GLOBALLY non-decreasing — zero-index
    tail padding after sorted real rows violated the contract (an
    accelerator's sorted-scatter lowering may mis-sum; the CPU backend
    ignores the hint, which is why only an index audit can pin this)."""
    from rri_nmf_tpu.ops.sweep_masked_sparse import plan_masked_coo
    X, M = _problem(29, n=23, d=9, density=0.4)
    plan = plan_masked_coo(X, sp.csr_matrix(M), np.float64)
    rows = np.asarray(plan.rows)
    assert np.all(np.diff(rows) >= 0), 'padded row stream not sorted'
    assert float(np.asarray(plan.m_vals)[plan.nnz:].sum()) == 0.0
    assert float(np.asarray(plan.x_vals)[plan.nnz:].sum()) == 0.0

    # mesh partitioner: every device block's local row stream sorted too
    import jax
    if len(jax.devices()) >= 8:
        from rri_nmf_tpu.parallel import make_mesh
        from rri_nmf_tpu.parallel.masked_sparse_mesh import (
            partition_masked_coo)
        coo = partition_masked_coo(X, sp.csr_matrix(M),
                                   make_mesh(8, mesh_shape=(8, 1)),
                                   np.float64)
        r_b = np.asarray(coo.rows)
        m_b = np.asarray(coo.m_vals)
        for b in range(r_b.shape[0]):
            assert np.all(np.diff(r_b[b]) >= 0), f'block {b} not sorted'
        # padded entries everywhere carry zero weight
        x_b = np.asarray(coo.x_vals)
        recon = (m_b > 0).sum()
        assert recon == int(M.sum()) - (np.asarray(
            sp.csr_matrix(M).data) == 0).sum()
