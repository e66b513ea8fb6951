"""Multi-host wiring helpers (parallel/multihost.py).

There is no multi-process fabric in CI; these pin the single-process
contracts (exact equivalence with the local-mesh helpers) plus the
layout math that must hold for any process count."""

import jax
import jax.numpy as jnp
import numpy as np

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.parallel import (
    distribute_dense, distribute_factors, initialize_distributed,
    make_global_mesh, make_mesh, process_row_block)


def test_initialize_distributed_single_process_noop():
    p, r = initialize_distributed()
    assert (p, r) == (0, 1)
    # idempotent
    assert initialize_distributed() == (0, 1)


def test_global_mesh_matches_local_single_process():
    m = make_global_mesh()
    assert m.axis_names == ('dp', 'tp')
    assert m.devices.size == len(jax.devices())
    assert m.shape == make_mesh(len(jax.devices())).shape
    m2 = make_global_mesh(mesh_shape=(8, 1))
    assert m2.shape == {'dp': 8, 'tp': 1}


def test_process_row_block_covers_everything():
    n = 173
    start, stop = process_row_block(n, make_global_mesh())
    assert (start, stop) == (0, n)       # single process owns all rows


def test_distribute_dense_and_factors_roundtrip():
    mesh = make_global_mesh(mesh_shape=(4, 2))
    rng = np.random.RandomState(0)
    X = rng.rand(64, 32)
    Xg = distribute_dense(X, X.shape, mesh)
    assert Xg.shape == X.shape
    np.testing.assert_allclose(np.asarray(Xg), X)
    # canonical layout: rows over dp, cols over tp
    assert Xg.sharding.spec == jax.sharding.PartitionSpec('dp', 'tp')
    W, T = rng.rand(64, 5), rng.rand(5, 32)
    Wg, Tg = distribute_factors(W, T, 64, mesh)
    np.testing.assert_allclose(np.asarray(Wg), W)
    np.testing.assert_allclose(np.asarray(Tg), T)
    assert Wg.sharding.spec == jax.sharding.PartitionSpec('dp', None)


def test_global_mesh_drives_a_sharded_fit():
    """A make_global_mesh mesh is a drop-in for nmf(mesh=...): parity
    with the single-device fit."""
    rng = np.random.RandomState(2)
    X = np.abs(rng.rand(96, 64))
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None, eps_stop=0)
    single = nmf(X, **kw)
    sharded = nmf(X, mesh=make_global_mesh(mesh_shape=(4, 2)), **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['T'], sharded['T'], atol=1e-11)


def test_process_row_block_clamped_and_mesh_aware():
    """process_row_block derives from the dp coordinates this process's
    devices own (clamped ceil-chunks) — the single process owns every
    row for ANY n (previously a naive even split left the start
    unclamped past n for tiny n), and dp > 1 does not change that."""
    for mesh in (make_mesh(8, mesh_shape=(8, 1)),
                 make_mesh(8, mesh_shape=(4, 2))):
        for n in (100, 5, 64, 17, 3):
            lo, hi = process_row_block(n, mesh)
            assert (lo, hi) == (0, n), (mesh.devices.shape, n, lo, hi)


def test_distribute_masked_coo_single_process():
    """Single-process distribute_masked_coo == partition_masked_coo /
    partition_masked_gram value-wise, and the plan drives nmf() directly
    (the multi-controller masked entry, VERDICT r5 item 6)."""
    import scipy.sparse as sp

    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import (distribute_factors,
        distribute_masked_coo, make_global_mesh, process_row_block)

    n, d, k = 32, 24, 4
    rng = np.random.RandomState(1)
    M = (rng.rand(n, d) < 0.35).astype(float)
    X = rng.rand(n, d) * M
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    Ms = sp.csr_matrix(M)
    mesh = make_global_mesh(mesh_shape=(8, 1))
    lo, hi = process_row_block(n, mesh)
    assert (lo, hi) == (0, n)

    plan = distribute_masked_coo(X[lo:hi], Ms[lo:hi], (n, d), mesh)
    from rri_nmf_tpu.parallel.masked_sparse_mesh import \
        partition_masked_coo
    ref = partition_masked_coo(X, Ms, mesh, np.dtype(np.float64))
    assert plan.nnz == ref.nnz and plan.n_loc == ref.n_loc
    np.testing.assert_array_equal(np.asarray(plan.rows),
                                  np.asarray(ref.rows))
    np.testing.assert_array_equal(np.asarray(plan.x_vals),
                                  np.asarray(ref.x_vals))

    Wg, Tg = distribute_factors(W0, T0, n, mesh)
    kw = dict(max_iter=4, random_state=7, compute_obj_each_iter=True,
              reset_topic_method=None, t_row_sum=1.0)
    rp = nmf(plan, k, W_in=Wg, T_in=Tg, mesh=mesh, **kw)
    ro = nmf(X, k, W_mat=Ms, W_in=W0, T_in=T0, **kw)
    np.testing.assert_allclose(np.asarray(rp['W']), np.asarray(ro['W']),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(rp['T']), np.asarray(ro['T']),
                               atol=1e-10)

    # Gram-phase plans value-match the single-controller partitioner's
    plan_gm = distribute_masked_coo(X[lo:hi], Ms[lo:hi], (n, d), mesh,
                                    gram=True)
    from rri_nmf_tpu.parallel.masked_gram_mesh import \
        partition_masked_gram
    ref_gm = partition_masked_gram(X, Ms, mesh, np.dtype(np.float64))
    assert plan_gm.n_loc == ref_gm.n_loc and plan_gm.nnz == ref_gm.nnz
    for f in ('rows', 'cols', 'x_vals', 'm_vals'):
        np.testing.assert_array_equal(np.asarray(getattr(plan_gm.coo, f)),
                                      np.asarray(getattr(ref_gm.coo, f)))
    np.testing.assert_allclose(float(plan_gm.sum_mx2),
                               float(ref_gm.sum_mx2), rtol=1e-14)

    # Gram-phase plan: phase order, monotone, parity, live objective
    plan_g = distribute_masked_coo(X[lo:hi], Ms[lo:hi], (n, d), mesh,
                                   gram=True)
    kwg = dict(max_iter=4, random_state=7, compute_obj_each_iter=True,
               reset_topic_method=None, update_order='phase',
               reg_t_l1=0.01)
    rg = nmf(plan_g, k, W_in=Wg, T_in=Tg, mesh=mesh, **kwg)
    rgo = nmf(X, k, W_mat=Ms, W_in=W0, T_in=T0, **kwg)
    np.testing.assert_allclose(np.asarray(rg['W']), np.asarray(rgo['W']),
                               atol=1e-10)
    assert np.all(np.diff(rg['obj_history']) <= 1e-12)
    oc = rg['obj_calculator']
    assert abs(oc.true_objective() - rg['obj_history'][-1]) < 1e-9


def test_process_row_block_tiled():
    """The row block stays clamped and covering for any n — including n
    small enough that later dp rows own EMPTY ranges (the
    multi-controller empty-slab case the 2-process tests drive
    end-to-end)."""
    for shape in ((8, 1), (4, 2)):
        mesh = make_mesh(8, mesh_shape=shape)
        dp = shape[0]
        for n in (64, 128, 129, 1024, 3, 1000):
            lo, hi = process_row_block(n, mesh)
            # single process owns everything, clamped to n
            assert (lo, hi) == (0, n), (shape, n, lo, hi)
            per = -(-n // dp)
            assert per * dp >= n


def test_distribute_sparse_coo_single_process():
    """Single-process distribute_sparse_coo == partition_coo value-wise,
    and the plan drives nmf() directly — the
    multi-controller UNMASKED sparse entry (the corpus never exists on
    one host; reference densifies all sparse input,
    sklearn_interface.py:78-83)."""
    import scipy.sparse as sp

    from rri_nmf_tpu.parallel import (distribute_factors,
        distribute_sparse_coo, make_global_mesh, partition_coo,
        process_row_block)

    # n divides both dp extents (distribute_factors shards W rows over
    # dp); d deliberately off the tp quantum — the sweep pads internally
    n, d, k = 40, 29, 4
    rng = np.random.RandomState(1)
    X = sp.random(n, d, density=0.25, random_state=3, format='csr')
    X.data += 0.5
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    kw = dict(k=k, max_iter=4, random_state=0, early_stop=False,
              compute_obj_each_iter=True, project_W_each_iter=True,
              w_row_sum=1.0, reg_t_l2=0.05, reset_topic_method=None)

    # COO backend on a (dp, tp) grid — tp IS supported here (unlike the
    # row-partitioned masked plans)
    mesh = make_global_mesh(mesh_shape=(4, 2))
    lo, hi = process_row_block(n, mesh)
    assert (lo, hi) == (0, n)
    plan = distribute_sparse_coo(X[lo:hi], (n, d), mesh,
                                 dtype=np.float64)
    ref_plan = partition_coo(X, mesh, np.float64)
    for f in ('data', 'rows', 'cols'):
        np.testing.assert_array_equal(np.asarray(getattr(plan, f)),
                                      np.asarray(getattr(ref_plan, f)))
    Wg, Tg = distribute_factors(W0, T0, n, mesh)
    rp = nmf(plan, W_in=Wg, T_in=Tg, mesh=mesh, **kw)
    ro = nmf(X, sparse=True, W_in=W0, T_in=T0, mesh=mesh, **kw)
    np.testing.assert_allclose(np.asarray(rp['W']), np.asarray(ro['W']),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(rp['T']), np.asarray(ro['T']),
                               atol=1e-10)
    np.testing.assert_allclose(rp['obj_history'], ro['obj_history'],
                               atol=1e-10)

    # the (8, 1) row layout: same plan, same fit as the single-device
    # sparse sweep
    mesh1 = make_global_mesh(mesh_shape=(8, 1))
    lo, hi = process_row_block(n, mesh1)
    assert (lo, hi) == (0, n)
    plan1 = distribute_sparse_coo(X[lo:hi], (n, d), mesh1,
                                  dtype=np.float64)
    Wg, Tg = distribute_factors(W0, T0, n, mesh1)
    r1 = nmf(plan1, W_in=Wg, T_in=Tg, mesh=mesh1, **kw)
    r0 = nmf(X, sparse=True, W_in=W0, T_in=T0, **kw)
    np.testing.assert_allclose(np.asarray(r1['W']),
                               np.asarray(r0['W']), atol=1e-10)
    np.testing.assert_allclose(r1['obj_history'], r0['obj_history'],
                               atol=1e-10)
    assert np.all(np.diff(r1['obj_history']) <= 1e-12)


def test_distribute_sparse_coo_guards():
    import pytest
    import scipy.sparse as sp

    from rri_nmf_tpu.parallel import (distribute_sparse_coo,
        make_global_mesh)

    n, d, k = 37, 29, 4
    rng = np.random.RandomState(2)
    X = sp.random(n, d, density=0.25, random_state=5, format='csr')
    X.data += 0.5
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    mesh = make_global_mesh(mesh_shape=(8, 1))
    with pytest.raises(ValueError, match='process_row_block'):
        distribute_sparse_coo(X[:10], (n, d), mesh)
    with pytest.raises(ValueError, match='columns'):
        distribute_sparse_coo(X[:, :10], (n, d), mesh)
    with pytest.raises(TypeError):
        distribute_sparse_coo(X, (n, d), mesh, backend='mxu')

    plan = distribute_sparse_coo(X, (n, d), mesh, dtype=np.float64)
    # plan input needs explicit warm starts
    with pytest.raises(ValueError, match='W_in AND T_in'):
        nmf(plan, k, mesh=mesh, max_iter=2)
    # a plan without its mesh (or alongside a W_mat) fails with
    # instructions, not np.asarray(plan) garbage
    with pytest.raises(ValueError, match='mesh=None'):
        nmf(plan, k, W_in=W0, T_in=T0, max_iter=2)
    with pytest.raises(ValueError, match='W_mat'):
        nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh, max_iter=2,
            W_mat=sp.csr_matrix(np.ones((n, d))))
    # wrong-mesh plans are caught on BOTH block axes (a (4,2)-built
    # plan has d_loc=ceil(d/2) — the dp-only check used to pass it for
    # n where ceil(n/4)==ceil(n/8))
    mesh42 = make_global_mesh(mesh_shape=(4, 2))
    plan42 = distribute_sparse_coo(X, (n, d), mesh42, dtype=np.float64)
    with pytest.raises(ValueError, match='rebuild'):
        nmf(plan42, 4, W_in=W0, T_in=T0,
            mesh=make_global_mesh(mesh_shape=(4, 1)), max_iter=2)
    # the sparse kwarg must not contradict the plan type
    with pytest.raises(ValueError, match='conflicts'):
        nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh, max_iter=2,
            sparse=False)
    with pytest.raises(ValueError, match='sparse must be one of'):
        nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh, max_iter=2,
            sparse='mxu')
    # mesh mismatch: plan partitioned for another dp count
    mesh4 = make_global_mesh(mesh_shape=(4, 2))
    with pytest.raises(ValueError, match='rebuild'):
        nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh4, max_iter=2)
    # dtype mismatch is refused, not silently promoted
    with pytest.raises(ValueError, match='dtype'):
        nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh, max_iter=2,
            dtype=np.float32)
    # diagnostics / callable early_stop consume the host X a plan
    # cannot carry — refused loudly, not np.asarray(plan) garbage
    with pytest.raises(ValueError, match='diagnostics'):
        nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh, max_iter=2,
            diagnostics=lambda X, W, T: float(np.sum(W)))
    with pytest.raises(ValueError, match='host X'):
        nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh, max_iter=2,
            early_stop=lambda X, W, T, d2: False)


def test_distribute_masked_coo_guards():
    import pytest
    import scipy.sparse as sp

    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import (distribute_masked_coo,
        make_global_mesh)

    n, d, k = 32, 24, 4
    rng = np.random.RandomState(2)
    M = (rng.rand(n, d) < 0.4).astype(float)
    X = rng.rand(n, d) * M
    Ms = sp.csr_matrix(M)
    mesh = make_global_mesh(mesh_shape=(8, 1))
    mesh2 = make_global_mesh(mesh_shape=(4, 2))
    with pytest.raises(ValueError, match='row-partitioned'):
        distribute_masked_coo(X, Ms, (n, d), mesh2)
    with pytest.raises(ValueError, match='scipy-sparse'):
        distribute_masked_coo(X, M, (n, d), mesh)
    with pytest.raises(ValueError, match='process_row_block'):
        distribute_masked_coo(X[:10], Ms[:10], (n, d), mesh)
    with pytest.raises(TypeError):
        distribute_masked_coo(X, Ms, (n, d), mesh, backend='segsum')

    plan = distribute_masked_coo(X, Ms, (n, d), mesh)
    # plan input needs explicit warm starts
    with pytest.raises(ValueError, match='W_in AND T_in'):
        nmf(plan, k, mesh=mesh, max_iter=2)
    # gram plan built for phase order refuses interleaved
    plan_g = distribute_masked_coo(X, Ms, (n, d), mesh, gram=True)
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    with pytest.raises(ValueError, match='phase'):
        nmf(plan_g, k, W_in=W0, T_in=T0, mesh=mesh, max_iter=2,
            reset_topic_method=None)
    # COO plan + phase request warns and runs the reference order
    with pytest.warns(RuntimeWarning, match='Gram plan'):
        r = nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh, max_iter=2,
                update_order='phase', reset_topic_method=None)
    assert np.isfinite(np.asarray(r['W'])).all()
    # mesh mismatch: plan partitioned for another dp count
    mesh4 = make_global_mesh(mesh_shape=(4, 1))
    with pytest.raises(ValueError, match='rebuild'):
        nmf(plan, k, W_in=W0, T_in=T0, mesh=mesh4, max_iter=2)
