"""Mixed-precision (bfloat16 storage, float32 accumulation) mode.

It halves the bytes of X the sweep reads; these CPU tests pin that the
mode stays numerically sane: monotone descent under the f32-evaluated
objective and convergence toward the f32 solution.
"""

import jax.numpy as jnp
import numpy as np

from rri_nmf_tpu.nmf import nmf


def _problem(n=48, d=32, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))


def test_bf16_dense_monotone_and_converges():
    X = _problem()
    kw = dict(k=4, max_iter=12, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None)
    b16 = nmf(X, dtype=jnp.bfloat16, **kw)
    f64 = nmf(X, **kw)
    oh = np.asarray(b16['obj_history'], dtype=float)
    assert np.all(np.diff(oh) <= 1e-3 * oh[0] + 1e-6)
    # bf16 fit lands within a few relative percent of the f64 objective
    assert oh[-1] <= f64['obj_history'][-1] * 1.1 + 1e-6
    assert b16['W'].dtype == np.float32 or str(b16['W'].dtype) == 'bfloat16'


def test_bf16_pallas_masked_descends():
    """The masked sweep under bfloat16 storage (f32 accumulators) keeps
    the f32-evaluated objective decreasing."""
    import jax
    import jax.numpy as jnp
    from rri_nmf_tpu.ops.sweep_xla import (SweepConfig, make_objective,
                                           make_sweep)

    X = _problem(seed=4).astype(np.float32)
    M = (np.random.RandomState(5).rand(*X.shape) < 0.6).astype(np.float32)
    rng = np.random.RandomState(6)
    W = jnp.asarray(np.abs(rng.rand(X.shape[0], 3)), jnp.bfloat16)
    T = jnp.asarray(np.abs(rng.rand(3, X.shape[1])), jnp.bfloat16)
    Xd = jnp.asarray(X, jnp.bfloat16)
    Md = jnp.asarray(M, jnp.bfloat16)

    cfg = SweepConfig(k=3, masked=True, reset_topic_method=None,
                      t_row_sum=1.0)
    sweep = make_sweep(cfg)
    obj = make_objective(masked=True, row_weighted=False)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    hist = [float(obj(Xd, W, T, Md))]
    for _ in range(5):
        W, T, key, r = sweep(Xd, W, T, key, r, key, Md)
        hist.append(float(obj(Xd, W, T, Md)))
    hist = np.asarray(hist)
    assert np.all(np.isfinite(hist))
    assert np.all(np.diff(hist) <= 1e-3 * hist[0] + 1e-6)
    assert hist[-1] < hist[0]


def test_mixed_x_dtype_dense_monotone_and_close_to_f32():
    """Mixed storage (``x_dtype='bfloat16'``, f32 factors): the dense
    phase sweep keeps monotone descent and tracks the f32 fit to within
    bf16 input-rounding tolerance. Factors must come back f32."""
    X = _problem()
    kw = dict(k=4, max_iter=12, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase', dtype='float32')
    mix = nmf(X, x_dtype='bfloat16', **kw)
    f32 = nmf(X, **kw)
    oh = np.asarray(mix['obj_history'], dtype=float)
    assert np.all(np.diff(oh) <= 1e-3 * oh[0] + 1e-6)
    assert oh[-1] <= f32['obj_history'][-1] * 1.05 + 1e-6
    assert mix['W'].dtype == np.float32 and mix['T'].dtype == np.float32
    assert np.max(np.abs(mix['W'] - f32['W'])) < 0.05


def test_mixed_x_dtype_interleaved_resets_run():
    """Mixed storage through the reference-order XLA sweep including the
    reset machinery (whose argmax carry must use the promoted dtype)."""
    X = _problem(seed=3)
    # dead warm-start topic forces a reset through the mixed-dtype path
    rng = np.random.RandomState(7)
    W0 = np.abs(rng.rand(X.shape[0], 4))
    T0 = np.abs(rng.rand(4, X.shape[1]))
    W0[:, 2] = 0.0
    T0[2] = 0.0
    soln = nmf(X, k=4, x_dtype='bfloat16', dtype='float32', W_in=W0,
               T_in=T0, max_iter=5, random_state=0,
               reset_topic_method='max_resid_document',
               compute_obj_each_iter=True, early_stop=False)
    oh = np.asarray(soln['obj_history'], dtype=float)
    assert np.all(np.isfinite(oh))
    assert soln['n_resets_remaining'] < 23
    assert float(np.sum(soln['T'][2])) > 1e-10


def test_mixed_x_dtype_mesh_parity():
    """Sharded dense sweep under mixed storage: factors stay f32 and the
    mesh run matches the single-device mixed run. The GEMMs run at
    'highest' so the factor operand is not rounded to bf16: under the
    default precision that rounding turns the mesh's different (correct)
    psum order into bf16-ulp jumps that grow over sweeps, and parity
    would not be defined."""
    import jax
    from rri_nmf_tpu.parallel import make_mesh

    X = _problem(n=64, d=48, k=4)
    mesh = make_mesh(min(8, len(jax.devices())))
    kw = dict(k=4, max_iter=6, random_state=0, early_stop=False,
              reset_topic_method=None, update_order='phase',
              dtype='float32', x_dtype='bfloat16',
              matmul_precision='highest', use_pallas='interpret')
    single = nmf(X, **kw)
    meshed = nmf(X, mesh=mesh, **kw)
    assert meshed['W'].dtype == np.float32
    assert np.allclose(single['W'], meshed['W'], atol=1e-5)
    assert np.allclose(single['T'], meshed['T'], atol=1e-5)


def test_mixed_x_dtype_dense_pallas_single_device():
    """The dense phase sweep with the GS kernel under mixed storage, in
    interpreter mode, on shapes off the kernel's tile so the pad buffers
    exercise the decoupled dtypes (X bf16, factor tiles f32). Parity vs
    the XLA sweep on the same bf16 X."""
    import jax
    import jax.numpy as jnp
    from rri_nmf_tpu.ops.dense_phase import make_dense_phase_sweep
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep

    rng = np.random.RandomState(8)
    n, d, k = 140, 100, 5          # off every power of two
    Xb = jnp.asarray(rng.rand(n, d), jnp.bfloat16)
    W0 = jnp.asarray(np.abs(rng.rand(n, k)), jnp.float32)
    T0 = jnp.asarray(np.abs(rng.rand(k, d)), jnp.float32)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase')
    key = jax.random.PRNGKey(0)
    rl = jnp.asarray(0, jnp.int32)
    Wp, Tp, _, _ = make_dense_phase_sweep(cfg, 'interpret')(
        Xb, W0, T0, key, rl, key)
    Wx, Tx, _, _ = make_sweep(cfg)(Xb, W0, T0, key, rl, key)
    assert Wp.dtype == jnp.float32 and Tp.dtype == jnp.float32
    # the dense phase path down-casts the factor GEMM operand to bf16 (the
    # XLA path promotes), so agreement is at bf16-rounding tolerance
    assert np.allclose(np.asarray(Wp), np.asarray(Wx), atol=0.02)
    assert np.allclose(np.asarray(Tp), np.asarray(Tx), atol=0.02)


def test_mixed_x_dtype_sparse_auto_densifies():
    """A scipy-sparse X with x_dtype under the default sparse='auto'
    densifies (declining auto sparse mode) instead of raising; explicit
    sparse=True still errors."""
    import pytest
    import scipy.sparse as sps

    X = _problem()
    Xs = sps.csr_matrix(X * (np.random.RandomState(3).rand(*X.shape) < 0.4))
    soln = nmf(Xs, k=3, x_dtype='bfloat16', dtype='float32',
               update_order='phase', reset_topic_method=None, max_iter=4,
               random_state=0)
    assert soln['W'].dtype == np.float32
    assert np.isfinite(soln['W']).all()
    with pytest.raises(ValueError, match='x_dtype'):
        nmf(Xs, k=3, sparse=True, x_dtype='bfloat16', dtype='float32',
            update_order='phase', reset_topic_method=None, max_iter=2)


def test_bf16_masked_runs():
    X = _problem(seed=1)
    M = (np.random.RandomState(2).rand(*X.shape) < 0.6).astype(float)
    soln = nmf(X, k=3, W_mat=M, dtype=jnp.bfloat16, max_iter=6,
               random_state=0, reset_topic_method=None, t_row_sum=1.0,
               compute_obj_each_iter=True, early_stop=False)
    oh = np.asarray(soln['obj_history'], dtype=float)
    assert np.all(np.isfinite(oh))
    assert oh[-1] < oh[0]
