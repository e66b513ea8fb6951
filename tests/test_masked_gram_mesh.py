"""Mesh-sharded Gram-phase masked sweep (parallel/masked_gram_mesh.py):
parity with the single-device Gram sweep on the 8-virtual-device CPU
mesh, chunked segment-sum parity, the sharded Gram objective identity,
and driver routing.

The Gram path runs distributed — one psum per T-phase, zero W-phase
communication. The
single-device sweep is itself pinned against a NumPy phase-order oracle
(tests/test_masked_gram.py), so parity here transitively pins the mesh
sweep to the oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.ops.sweep_xla import SweepConfig
from rri_nmf_tpu.parallel.mesh import make_mesh

requires_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason='needs 8 (virtual) devices')


def _problem(seed, n=30, d=24, k=4, density=0.35):
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density).astype(float)
    X = rng.rand(n, d) * M
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, M, W0, T0


def _cfg(k, **kw):
    return SweepConfig(k=k, masked=True, masked_sparse=True,
                       update_order='phase', reset_topic_method=None,
                       **kw)


def _run_single(X, M, W0, T0, sweeps, **kw):
    from rri_nmf_tpu.ops.sweep_masked_gram import (make_masked_gram_sweep,
                                                   plan_masked_gram)
    plan = plan_masked_gram(X, sp.csr_matrix(M), np.float64)
    sweep = make_masked_gram_sweep(_cfg(W0.shape[1], **kw))
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    out = []
    for _ in range(sweeps):
        W, T, key, r = sweep(plan, W, T, key, r, key)
        out.append((np.array(W), np.array(T)))
    return out


def _run_mesh(X, M, W0, T0, sweeps, mesh, **kw):
    from rri_nmf_tpu.parallel.masked_gram_mesh import (
        make_sharded_masked_gram_sweep, partition_masked_gram)
    plan = partition_masked_gram(X, sp.csr_matrix(M), mesh, np.float64)
    sweep = make_sharded_masked_gram_sweep(_cfg(W0.shape[1], **kw), mesh)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    out = []
    for _ in range(sweeps):
        W, T, key, r = sweep(plan, W, T, key, r, key)
        out.append((np.array(W), np.array(T)))
    return out


MESH_CONFIGS = [
    dict(),
    dict(project_T_each_iter=True, t_row_sum=1.0),
    dict(reg_t_l2=0.1, reg_w_l2=0.05),
    dict(reg_t_l1=0.02, reg_w_l1=0.01),
    dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
         project_W_each_iter=True),
    dict(inner_reps=2),
    dict(fix_T=True),
    dict(fix_W=True),
]


@requires_8_devices
@pytest.mark.parametrize('kw', MESH_CONFIGS)
def test_mesh_matches_single_device(kw):
    """(8, 1) mesh sweep == single-device Gram sweep at f64 roundoff.
    n = 30 does not divide 8 devices → ghost-row padding is live."""
    X, M, W0, T0 = _problem(1)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    ts = _run_single(X, M, W0, T0, 3, **kw)
    tm = _run_mesh(X, M, W0, T0, 3, mesh, **kw)
    for (W1, T1), (W2, T2) in zip(ts, tm):
        np.testing.assert_allclose(W2, W1, atol=1e-12, rtol=0)
        np.testing.assert_allclose(T2, T1, atol=1e-12, rtol=0)


def _fresh_mesh_sweeps():
    from rri_nmf_tpu.parallel import masked_gram_mesh as mgm
    mgm.make_sharded_masked_gram_sweep.cache_clear()


@requires_8_devices
def test_mesh_mxu_backend_matches_segsum(monkeypatch):
    """Per-device segment sums over small observation chunks (several
    full chunks + a remainder per device) == one-chunk mesh sweep."""
    import rri_nmf_tpu.parallel.masked_gram_mesh as mgm
    X, M, W0, T0 = _problem(7, n=40, d=33, k=5)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    kw = dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
              project_W_each_iter=True)
    t1 = _run_mesh(X, M, W0, T0, 2, mesh, **kw)
    monkeypatch.setattr(mgm, '_SEG_CHUNK', 5)
    _fresh_mesh_sweeps()
    try:
        t2 = _run_mesh(X, M, W0, T0, 2, mesh, **kw)
    finally:
        _fresh_mesh_sweeps()
    for (W1, T1), (W2, T2) in zip(t1, t2):
        np.testing.assert_allclose(W2, W1, atol=1e-9, rtol=0)
        np.testing.assert_allclose(T2, T1, atol=1e-9, rtol=0)


@requires_8_devices
def test_mesh_mxu_segmented_and_padded_plans(monkeypatch):
    """Skewed per-device observation counts: device blocks are padded to
    a common length with zero-weight entries and summed in small chunks;
    the mesh sweep and the sharded Gram objective still match the
    single-device sweep and the direct objective."""
    import rri_nmf_tpu.parallel.masked_gram_mesh as mgm
    rng = np.random.RandomState(12)
    n, d, k = 300, 200, 4
    dens = np.linspace(0.05, 0.7, n)[:, None]
    M = (rng.rand(n, d) < dens).astype(float)
    X = rng.rand(n, d) * M
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    mesh = make_mesh(8, mesh_shape=(8, 1))
    plan = mgm.partition_masked_gram(X, sp.csr_matrix(M), mesh,
                                     np.float64)
    counts = np.asarray(plan.coo.m_vals).astype(bool).sum(axis=1)
    assert counts.min() < counts.max() // 4       # skew is real
    t1 = _run_single(X, M, W0, T0, 1)
    monkeypatch.setattr(mgm, '_SEG_CHUNK', 512)
    sweep = mgm.make_sharded_masked_gram_sweep.__wrapped__(_cfg(k), mesh)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    W, T, key, r = sweep(plan, W, T, key, r, key)
    np.testing.assert_allclose(np.array(W), t1[0][0], atol=1e-9, rtol=0)
    np.testing.assert_allclose(np.array(T), t1[0][1], atol=1e-9, rtol=0)
    fn = mgm.make_sharded_masked_gram_objective(mesh)
    direct = 0.5 * np.sum(M * (X - np.array(W) @ np.array(T)) ** 2)
    np.testing.assert_allclose(float(fn(plan, W, T)), direct, rtol=1e-9)


@requires_8_devices
def test_mesh_objective_identity_with_regs():
    from rri_nmf_tpu.parallel.masked_gram_mesh import (
        make_sharded_masked_gram_objective, partition_masked_gram)
    X, M, W0, T0 = _problem(9)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    regs = dict(reg_w_l2=0.02, reg_t_l2=0.01, reg_w_l1=0.005,
                reg_t_l1=0.003)
    plan = partition_masked_gram(X, sp.csr_matrix(M), mesh, np.float64)
    fn = make_sharded_masked_gram_objective(mesh, **regs)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    direct = (0.5 * np.sum(M * (X - W0 @ T0) ** 2)
              + 0.5 * regs['reg_w_l2'] * np.sum(W0 ** 2)
              + 0.5 * regs['reg_t_l2'] * np.sum(T0 ** 2)
              + regs['reg_w_l1'] * np.abs(W0).sum()
              + regs['reg_t_l1'] * np.abs(T0).sum())
    np.testing.assert_allclose(float(fn(plan, W, T)), direct, rtol=1e-12)


@requires_8_devices
def test_driver_mesh_gram_end_to_end():
    """nmf() routes a masked phase fit on an (8, 1) mesh through the
    Gram mesh sweep: parity with the single-device Gram fit, monotone
    descent, and a working (mesh-backed) obj_calculator."""
    X, M, _, _ = _problem(3, n=44, d=30, k=4)
    Ms = sp.csr_matrix(M)
    kw = dict(max_iter=8, compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None, reg_t_l1=0.01, reg_w_l1=0.01,
              update_order='phase')
    single = nmf(X, 4, W_mat=Ms, **kw)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    sharded = nmf(X, 4, W_mat=Ms, mesh=mesh, **kw)
    np.testing.assert_allclose(sharded['W'], single['W'], atol=1e-11)
    np.testing.assert_allclose(sharded['T'], single['T'], atol=1e-11)
    np.testing.assert_allclose(sharded['obj_history'],
                               single['obj_history'], atol=1e-9)
    assert np.all(np.diff(sharded['obj_history']) <= 1e-12)
    oc = sharded['obj_calculator']
    assert abs(oc.true_objective() - sharded['obj_history'][-1]) < 1e-10
    # pickling drops the per-device plan (same contract as the
    # interleaved mesh fit)
    import pickle
    oc2 = pickle.loads(pickle.dumps(oc))
    with pytest.raises(ValueError, match='mesh-sharded'):
        oc2.true_objective()


@requires_8_devices
def test_driver_mesh_gram_tm_preset():
    """Projected TM-style preset (row sums + per-iteration projections)
    on the mesh == single-device."""
    X, M, _, _ = _problem(5, n=40, d=28, k=3)
    Ms = sp.csr_matrix(M)
    kw = dict(max_iter=6, compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None, update_order='phase',
              project_T_each_iter=True, t_row_sum=1.0,
              w_row_sum=1.0, project_W_each_iter=True)
    single = nmf(X, 3, W_mat=Ms, **kw)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    sharded = nmf(X, 3, W_mat=Ms, mesh=mesh, **kw)
    np.testing.assert_allclose(sharded['W'], single['W'], atol=1e-11)
    np.testing.assert_allclose(sharded['T'], single['T'], atol=1e-11)
    assert np.allclose(np.asarray(sharded['T']).sum(axis=1), 1.0,
                       atol=1e-12)


@requires_8_devices
def test_driver_mesh_gram_dp_noise_reproducible():
    """The DP Gaussian mechanism runs replicated (identical draws on
    every device): reproducible for a fixed random_state and equal to
    the single-device Gram DP fit."""
    X, M, _, _ = _problem(6, n=32, d=20, k=3)
    Ms = sp.csr_matrix(M)
    kw = dict(max_iter=4, random_state=0, reset_topic_method=None,
              update_order='phase', eps_gauss_t=1e4, delta_gauss_t=0.1)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    single = nmf(X, 3, W_mat=Ms, **kw)
    r1 = nmf(X, 3, W_mat=Ms, mesh=mesh, **kw)
    r2 = nmf(X, 3, W_mat=Ms, mesh=mesh, **kw)
    np.testing.assert_array_equal(np.asarray(r1['W']),
                                  np.asarray(r2['W']))
    np.testing.assert_allclose(np.asarray(r1['W']),
                               np.asarray(single['W']), atol=1e-11)
    np.testing.assert_allclose(np.asarray(r1['T']),
                               np.asarray(single['T']), atol=1e-11)


@requires_8_devices
def test_driver_mesh_gram_fix_T_transform():
    """fix_T (transform) on the mesh: T untouched, W rows match the
    single-device transform — the W-phase runs with ZERO collectives."""
    X, M, _, _ = _problem(8, n=36, d=22, k=3)
    Ms = sp.csr_matrix(M)
    T_fixed = np.abs(np.random.RandomState(0).rand(3, 22))
    kw = dict(max_iter=4, random_state=0, reset_topic_method=None,
              update_order='phase', fix_T=True, T_in=T_fixed,
              W_in=np.full((36, 3), 1.0 / 3))
    single = nmf(X, 3, W_mat=Ms, **kw)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    sharded = nmf(X, 3, W_mat=Ms, mesh=mesh, **kw)
    np.testing.assert_array_equal(np.asarray(sharded['T']), T_fixed)
    np.testing.assert_allclose(np.asarray(sharded['W']),
                               np.asarray(single['W']), atol=1e-11)


# ---------------------------------------------------------------------------
# randomized differential draw (standalone for benchmarks/soak_fuzz.py)
# ---------------------------------------------------------------------------

def masked_gram_mesh_draw(seed):
    """One randomized mesh-vs-single-device Gram parity draw: random
    shapes (ghost rows likely), random config (projections, regs,
    inner_reps, DP noise, fix_T), 2 sweeps, 1e-10 f64 parity.
    Occasionally drives the premade-plan nmf() entry instead of the raw
    sweeps."""
    if jax.device_count() < 8:
        import pytest
        pytest.skip('needs 8 (virtual) devices')
    rng = np.random.RandomState(1000 + seed)
    n = int(rng.randint(17, 61))
    d = int(rng.randint(12, 48))
    k = int(rng.randint(2, 7))
    X, M, W0, T0 = _problem(2000 + seed, n=n, d=d, k=k,
                            density=float(rng.uniform(0.2, 0.6)))
    kw = {}
    if rng.rand() < 0.5:
        kw['project_T_each_iter'] = True
        kw['t_row_sum'] = float(rng.choice([1.0, 2.0]))
    if rng.rand() < 0.4:
        kw['w_row_sum'] = float(rng.choice([1.0, 3.0]))
        kw['project_W_each_iter'] = rng.rand() < 0.5
    for r in ('reg_w_l1', 'reg_w_l2', 'reg_t_l1', 'reg_t_l2'):
        if rng.rand() < 0.3:
            kw[r] = float(rng.choice([0.01, 0.1]))
    if rng.rand() < 0.25:
        kw['inner_reps'] = int(rng.randint(2, 4))
    if rng.rand() < 0.15:
        kw['fix_T'] = True
    rng.rand()       # keeps later draws of each seed unchanged
    mesh = make_mesh(8, mesh_shape=(8, 1))

    if rng.rand() < 0.3:
        # premade-plan driver entry (multi-controller form, 1-process)
        import scipy.sparse as sps

        from rri_nmf_tpu.nmf import nmf
        from rri_nmf_tpu.parallel import (distribute_factors,
            distribute_masked_coo)
        n -= n % 8
        if n == 0:
            return
        X, M, W0 = X[:n], M[:n], W0[:n]
        dkw = dict(max_iter=3, random_state=seed,
                   compute_obj_each_iter=True, reset_topic_method=None,
                   update_order='phase',
                   **{kk: v for kk, v in kw.items()
                      if kk not in ('fix_T',)})
        plan = distribute_masked_coo(X, sps.csr_matrix(M), (n, d), mesh,
                                     gram=True)
        Wg, Tg = distribute_factors(W0, T0, n, mesh)
        rp = nmf(plan, k, W_in=Wg, T_in=Tg, mesh=mesh, **dkw)
        ro = nmf(X, k, W_mat=sps.csr_matrix(M), W_in=W0, T_in=T0, **dkw)
        np.testing.assert_allclose(np.asarray(rp['W']),
                                   np.asarray(ro['W']), atol=1e-10,
                                   rtol=0, err_msg=repr((seed, dkw)))
        np.testing.assert_allclose(np.asarray(rp['T']),
                                   np.asarray(ro['T']), atol=1e-10,
                                   rtol=0, err_msg=repr((seed, dkw)))
        return

    ts = _run_single(X, M, W0, T0, 2, **kw)
    tm = _run_mesh(X, M, W0, T0, 2, mesh, **kw)
    for (W1, T1), (W2, T2) in zip(ts, tm):
        np.testing.assert_allclose(W2, W1, atol=1e-10, rtol=0,
                                   err_msg=repr((seed, kw)))
        np.testing.assert_allclose(T2, T1, atol=1e-10, rtol=0,
                                   err_msg=repr((seed, kw)))


@pytest.mark.parametrize('seed', range(4))
def test_masked_gram_mesh_fuzz_prefix(seed):
    """Suite samples a prefix of the soak draw range."""
    masked_gram_mesh_draw(seed)


# ---------------------------------------------------------------------------
# k-panel tiling on the mesh (round-5: large-k recommender fits distribute)
# ---------------------------------------------------------------------------

def _run_mesh_panel(X, M, W0, T0, sweeps, mesh, panel, **kw):
    from rri_nmf_tpu.parallel.masked_gram_mesh import (
        make_sharded_masked_gram_sweep, partition_masked_gram)
    plan = partition_masked_gram(X, sp.csr_matrix(M), mesh, np.float64)
    sweep = make_sharded_masked_gram_sweep(
        _cfg(W0.shape[1], **kw), mesh, panel=panel)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    out = []
    for _ in range(sweeps):
        W, T, key, r = sweep(plan, W, T, key, r, key)
        out.append((np.array(W), np.array(T)))
    return out


@requires_8_devices
@pytest.mark.parametrize('panel', [1, 3])
@pytest.mark.parametrize('kw', [
    dict(),
    dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
         project_W_each_iter=True),
    dict(inner_reps=2),
    dict(fix_T=True),
])
def test_mesh_panel_bitwise_equals_full(panel, kw):
    """Mesh panel tiling == mesh full-tensor == single-device at f64
    roundoff (same Gauss-Seidel sequence; one psum per Γ panel)."""
    X, M, W0, T0 = _problem(31, k=4)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    full = _run_mesh(X, M, W0, T0, 2, mesh, **kw)
    tiled = _run_mesh_panel(X, M, W0, T0, 2, mesh, panel, **kw)
    single = _run_single(X, M, W0, T0, 2, **kw)
    for (W1, T1), (W2, T2), (W3, T3) in zip(full, tiled, single):
        np.testing.assert_allclose(W2, W1, atol=1e-13, rtol=0)
        np.testing.assert_allclose(T2, T1, atol=1e-13, rtol=0)
        np.testing.assert_allclose(W2, W3, atol=1e-12, rtol=0)
        np.testing.assert_allclose(T2, T3, atol=1e-12, rtol=0)


@requires_8_devices
def test_mesh_panel_mxu_backend(monkeypatch):
    """Mesh panel contractions over small observation chunks == the
    one-chunk panel path."""
    import rri_nmf_tpu.parallel.masked_gram_mesh as mgm
    X, M, W0, T0 = _problem(32, n=40, d=33, k=5)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    t1 = _run_mesh_panel(X, M, W0, T0, 2, mesh, 2)
    monkeypatch.setattr(mgm, '_SEG_CHUNK', 3)
    _fresh_mesh_sweeps()
    try:
        t2 = _run_mesh_panel(X, M, W0, T0, 2, mesh, 2)
    finally:
        _fresh_mesh_sweeps()
    for (W1, T1), (W2, T2) in zip(t1, t2):
        np.testing.assert_allclose(W2, W1, atol=1e-9, rtol=0)
        np.testing.assert_allclose(T2, T1, atol=1e-9, rtol=0)


@requires_8_devices
def test_driver_mesh_routes_large_k_to_panels(monkeypatch):
    """A mesh masked phase fit whose full Gram tensors exceed the budget
    engages the panel-tiled mesh sweep (not the interleaved order) and
    matches the full-tensor mesh fit."""
    import rri_nmf_tpu.ops.sweep_masked_gram as smg
    X, M, _, _ = _problem(33, n=40, d=30, k=4)
    Ms = sp.csr_matrix(M)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    kw = dict(max_iter=5, compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None, update_order='phase',
              reg_t_l1=0.01, mesh=mesh)
    r_full = nmf(X, 4, W_mat=Ms, **kw)
    unit = 4 * (40 / 8 + 30) * 8
    monkeypatch.setattr(smg, 'gram_budget_bytes', lambda: 2 * unit)
    r_tiled = nmf(X, 4, W_mat=Ms, **kw)
    np.testing.assert_allclose(np.asarray(r_tiled['W']),
                               np.asarray(r_full['W']), atol=1e-13)
    np.testing.assert_allclose(np.asarray(r_tiled['T']),
                               np.asarray(r_full['T']), atol=1e-13)
    assert np.all(np.diff(r_tiled['obj_history']) <= 1e-12)


@requires_8_devices
@pytest.mark.parametrize('backend', ['one_chunk', 'small_chunks'])
def test_mesh_panel_objective_matches_full(backend, monkeypatch):
    from rri_nmf_tpu.parallel.masked_gram_mesh import (
        make_sharded_masked_gram_objective, partition_masked_gram)
    X, M, W0, T0 = _problem(34, k=5)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    if backend == 'small_chunks':
        import rri_nmf_tpu.parallel.masked_gram_mesh as mgm
        monkeypatch.setattr(mgm, '_SEG_CHUNK', 4)
    plan = partition_masked_gram(X, sp.csr_matrix(M), mesh, np.float64)
    regs = dict(reg_w_l2=0.02, reg_t_l1=0.003)
    full = make_sharded_masked_gram_objective(mesh, **regs)
    tiled = make_sharded_masked_gram_objective(mesh, panel=2, **regs)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    np.testing.assert_allclose(float(tiled(plan, W, T)),
                               float(full(plan, W, T)), rtol=1e-12)
