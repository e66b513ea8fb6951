"""Direct unit tests for small shared helpers that were previously only
exercised through the driver (reset row/col builders, the shared
drifted-row reprojection, debug validation, device budgets, dtype
resolution). All CPU-fast: no sweep compiles."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_reproject_row_if_drifted_semantics():
    from rri_nmf_tpu.matrixops import reproject_row_if_drifted

    # feasible row: returned bit-identical (Duchi shortcut + untaken cond)
    row = jnp.asarray(np.array([0.25, 0.25, 0.5]))
    out = reproject_row_if_drifted(row, 1.0, row.dtype)
    assert np.array_equal(np.asarray(out), np.asarray(row))

    # drifted row: projected onto the simplex
    drift = jnp.asarray(np.array([0.5, 0.5, 0.5]))
    out = reproject_row_if_drifted(drift, 1.0, drift.dtype)
    o = np.asarray(out)
    assert abs(o.sum() - 1.0) < 1e-12 and (o >= 0).all()

    # extra_pred False blocks the projection even when drifted (the reset
    # check's aliveness guard: a dead row must not become uniform)
    out = reproject_row_if_drifted(drift, 1.0, drift.dtype,
                                   extra_pred=jnp.asarray(False))
    assert np.array_equal(np.asarray(out), np.asarray(drift))


def test_make_reset_rowcol_max_resid_picks_argmax_row():
    from rri_nmf_tpu.ops.sweep_xla import (SweepConfig, make_reset_factors,
                                           make_reset_rowcol)

    rng = np.random.RandomState(0)
    n, d, k = 12, 9, 3
    X = np.abs(rng.rand(n, d))
    W = np.abs(rng.rand(n, k))
    T = np.abs(rng.rand(k, d))
    X[5] += 10.0                       # row 5 has the largest residual
    key = jax.random.PRNGKey(0)

    for blockwise in (False, True):
        cfg = SweepConfig(k=k, reset_topic_method='max_resid_document',
                          reset_blockwise=blockwise)
        row, col, _ = make_reset_rowcol(cfg)(
            jnp.asarray(X), jnp.asarray(W), jnp.asarray(T), 1, key, key)
        expect = np.maximum(X[5] - W[5] @ T, 0.0)
        assert np.allclose(np.asarray(row), expect, atol=1e-12)
        c = np.asarray(col)
        assert c[5] == 1.0 and c.sum() == 1.0   # one-hot at the argmax row

        # the whole-matrix wrapper writes exactly that row/column
        W2, T2, _ = make_reset_factors(cfg)(
            jnp.asarray(X), jnp.asarray(W), jnp.asarray(T), 1, key, key)
        assert np.allclose(np.asarray(T2)[1], expect, atol=1e-12)
        assert np.allclose(np.asarray(W2)[:, 1], c)
        assert np.allclose(np.asarray(W2)[:, [0, 2]], W[:, [0, 2]])


def test_make_reset_rowcol_random_fixed_seed_deterministic():
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_reset_rowcol

    rng = np.random.RandomState(1)
    X = np.abs(rng.rand(10, 8))
    W = np.abs(rng.rand(10, 2))
    T = np.abs(rng.rand(2, 8))
    cfg = SweepConfig(k=2, reset_topic_method='random',
                      fix_reset_seed=True)
    fn = make_reset_rowcol(cfg)
    k1 = jax.random.PRNGKey(3)
    r1, c1, key1 = fn(jnp.asarray(X), jnp.asarray(W), jnp.asarray(T),
                      0, k1, jax.random.PRNGKey(7))
    r2, c2, key2 = fn(jnp.asarray(X), jnp.asarray(W), jnp.asarray(T),
                      0, k1, jax.random.PRNGKey(7))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))
    assert np.array_equal(np.asarray(c1), np.asarray(c2))
    # fixed seed: the carried key must NOT advance
    assert np.array_equal(np.asarray(key1), np.asarray(k1))
    assert abs(float(jnp.sum(r1)) - 1.0) < 1e-6   # T row lands on simplex


def test_validate_factors_catches_violations():
    from rri_nmf_tpu.utils.debug import (FactorValidationError,
                                         validate_factors)

    W = jnp.asarray(np.full((4, 2), 0.5))
    T = jnp.asarray(np.full((2, 3), 1.0 / 3))
    assert validate_factors(W, T, w_row_sum=1.0, t_row_sum=1.0,
                            project_W_each_iter=True,
                            project_T_each_iter=True)   # feasible: ok

    with pytest.raises(FactorValidationError, match='negative'):
        validate_factors(W.at[0, 0].set(-0.1), T)
    with pytest.raises(FactorValidationError, match='non-finite'):
        validate_factors(W.at[0, 0].set(jnp.nan), T)
    with pytest.raises(FactorValidationError, match='row-sum'):
        validate_factors(W, T, t_row_sum=2.0, project_T_each_iter=True)


def test_tm_proj_fits_boundary(monkeypatch):
    """Memory budgets come from the device: the CPU backend reports the
    host's RAM; an accelerator without a ``bytes_limit`` is an error, not
    a guessed default."""
    from rri_nmf_tpu.ops import capability

    assert capability.device_bytes_limit() > 0
    assert capability.memory_budget_bytes(0.25) == \
        0.25 * capability.device_bytes_limit()

    class _Dev:
        platform = 'gpu'

        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    assert capability.device_bytes_limit(_Dev({'bytes_limit': 1234})) == 1234
    with pytest.raises(RuntimeError, match='no memory limit'):
        capability.device_bytes_limit(_Dev({}))
    with pytest.raises(RuntimeError, match='no memory limit'):
        capability.device_bytes_limit(_Dev(None))


def test_resolve_mixed_dtypes():
    from rri_nmf_tpu.ops.sweep_xla import resolve_mixed_dtypes

    dt, acc, _ = resolve_mixed_dtypes(jnp.dtype(jnp.bfloat16),
                                      jnp.dtype(jnp.bfloat16), None)
    assert dt == jnp.bfloat16 and acc == jnp.float32
    dt, acc, _ = resolve_mixed_dtypes(jnp.dtype(jnp.float64),
                                      jnp.dtype(jnp.float64), None)
    assert dt == jnp.float64 and acc == jnp.float64
    # mixed storage: factors f32, X bf16 — factor dtype follows W
    dt, acc, _ = resolve_mixed_dtypes(jnp.dtype(jnp.bfloat16),
                                      jnp.dtype(jnp.float32), None)
    assert dt == jnp.float32 and acc == jnp.float32


def test_validate_factors_dtype_aware_tolerance():
    """debug-check row-sum thresholds scale with the factor dtype: an
    f32 simplex projection's ~1e-7 per-row residue must pass (the fixed
    f64-calibrated 1e-10 spuriously flagged healthy f32 fits), while an
    explicit tol is honored."""
    from rri_nmf_tpu.utils.debug import (FactorValidationError,
                                         validate_factors)
    rng = np.random.RandomState(0)
    W = np.abs(rng.rand(50, 4)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    W += np.float32(3e-7) * rng.randn(50, 4).astype(np.float32)
    W = np.abs(W)
    T = np.abs(rng.rand(4, 30)).astype(np.float32)
    assert validate_factors(W, T, w_row_sum=1.0, project_W_each_iter=True)
    with pytest.raises(FactorValidationError):
        validate_factors(W, T, w_row_sum=1.0, project_W_each_iter=True,
                         tol=1e-12)


@pytest.mark.parametrize('n,B', [(37, 8), (40, 8), (37, 64), (8, 8)])
def test_blockwise_objective_matches_oneshot(n, B):
    """make_objective(block_rows=B) accumulates the residual norm over
    row blocks with a clamped final block + overlap correction (used
    near the HBM limit, nmf.py block_rows); it must equal the fused
    evaluation exactly at f64 — including when B does not divide n
    (the overlap-masked rows), when B > n (single clamped block), and
    for the masked and row-weighted variants."""
    from rri_nmf_tpu.ops.sweep_xla import make_objective

    rng = np.random.RandomState(n + B)
    d, k = 23, 5
    X = jnp.asarray(np.abs(rng.rand(n, d)))
    W = jnp.asarray(np.abs(rng.rand(n, k)))
    T = jnp.asarray(np.abs(rng.rand(k, d)))
    M = jnp.asarray((rng.rand(n, d) < 0.6).astype(float))
    wr = jnp.asarray(rng.rand(n, 1) + 0.1)

    regs = dict(reg_w_l2=0.1, reg_t_l2=0.05, reg_w_l1=0.02, reg_t_l1=0.01)
    for masked, row_weighted, extras in [
            (False, False, ()), (True, False, (M,)),
            (False, True, (wr,)), (True, True, (M, wr))]:
        full = make_objective(masked, row_weighted, **regs)
        blk = make_objective(masked, row_weighted, block_rows=B, **regs)
        a = float(full(X, W, T, *extras))
        b = float(blk(X, W, T, *extras))
        assert abs(a - b) <= 1e-12 * max(1.0, abs(a)), \
            (n, B, masked, row_weighted, a, b)


def test_blockwise_reset_scan_multiblock_matches_naive():
    """The max_resid_document reset's blockwise residual-norm argmax
    (B=4096 row blocks, clamped+overlapping final block — the O(B*d)
    form that never materializes the n*d residual) must pick the same
    document as the naive full-residual argmax, including when B does
    not divide n and when the maximum is duplicated across blocks
    (strict > keeps the FIRST max, like argmax). Only multi-block at
    n > 4096, which the driver-level tests never reach."""
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_reset_rowcol

    rng = np.random.RandomState(0)
    n, d, k = 5000, 12, 3   # two blocks: [0,4096) + clamped [904,5000)
    X = np.abs(rng.rand(n, d))
    W = np.abs(rng.rand(n, k))
    T = np.abs(rng.rand(k, d))
    # duplicate the max row across blocks: naive argmax picks the first
    X[4500] = X[100] = X[2].copy() + 5.0
    W[4500] = W[100] = W[2].copy()

    cfg = SweepConfig(k=k, reset_topic_method='max_resid_document',
                      update_order='phase')
    rowcol = make_reset_rowcol(cfg)
    key = jax.random.PRNGKey(0)
    row, onehot, _ = rowcol(jnp.asarray(X), jnp.asarray(W), jnp.asarray(T),
                            0, key, key)

    R = np.maximum(X - W @ T, 0.0)
    mi = int(np.argmax(np.sum(R * R, axis=1)))
    assert mi == 100   # the first of the duplicated maxima
    assert int(np.argmax(np.asarray(onehot))) == mi
    np.testing.assert_allclose(np.asarray(row), R[mi], atol=1e-12)
