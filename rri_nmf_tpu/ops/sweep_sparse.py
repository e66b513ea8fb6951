"""Sparse-X RRI sweep: BCOO data matrix, dense factors.

The reference *densifies* sparse input (its RS estimator materializes COO
to dense, ``sklearn_interface.py:78-83``; SURVEY.md §5.7 flags this as the
missing scale answer). With the phase update order the sweep touches X
through exactly two contractions per sweep — ``WᵀX`` before the T-phase
and ``X Tᵀ`` before the W-phase — and everything else involves only the
small dense factors.

Design:

1. **The two contractions are BCOO gather/scatter** (XLA's sparse
   lowering). When the DENSE form fits device memory the
   driver instead transfers the compressed form, densifies ON DEVICE —
   one O(nnz) scatter — and runs the dense phase sweep, whose GEMMs are
   faster; this module is the beyond-memory path. A 1M×100k TF-IDF
   corpus at 1% density is ~8 GB as BCOO vs 400 GB dense.
2. **Gauss-Seidel topic loops** are the dense phase sweep's
   (:func:`rri_nmf_tpu.ops.dense_phase.gs_panel`): the frozen factor's
   Gram is computed once per phase, and the loop runs as the Triton
   kernel or the Gram-blocked XLA loop (``gs``).

Restrictions (asserted): unweighted (no mask — the masked path maintains a
dense residual by construction), ``update_order='phase'``,
``reset_topic_method=None`` (resets scan residual rows, which would need
sparse row slicing), no gradient stores, no DP noise.

The sparse objective never materializes ``W T``::

    ||X - WT||_F² = ||X||² - 2·Σ_nnz X_ij·(W_i·T_j) + tr((WᵀW)(TTᵀ))

— the middle term gathers factor rows at the nnz coordinates (O(nnz·k)),
the last is O((n+d)k² + k³).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import sparse as jsparse

from rri_nmf_tpu.matrixops import _proj_simplex_core
from rri_nmf_tpu.ops.dense_phase import gs_panel, phase_bounds
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, resolve_mixed_dtypes


def to_bcoo(X, dtype=None):
    """SciPy sparse / dense array → jax BCOO (row-major sorted)."""
    if isinstance(X, jsparse.BCOO):
        return X if dtype is None else X.astype(dtype)
    if hasattr(X, 'tocsr'):  # scipy sparse: csr->coo is row-major sorted
        coo = X.tocsr().tocoo()
        indices = jnp.asarray(np.stack([coo.row, coo.col], axis=1),
                              dtype=jnp.int32)
        data = jnp.asarray(coo.data, dtype=dtype)
        return jsparse.BCOO((data, indices), shape=coo.shape,
                            indices_sorted=True, unique_indices=True)
    return jsparse.BCOO.fromdense(jnp.asarray(X, dtype=dtype))


def supports_sparse(cfg: SweepConfig) -> bool:
    return (not cfg.masked and cfg.update_order == 'phase'
            and cfg.reset_topic_method is None
            and not cfg.store_gradients and cfg.dp_sigma is None)


@lru_cache(maxsize=16)
def make_sparse_sweep(cfg: SweepConfig, gs='xla', gemm_dtype=None):
    """Phase-order sweep over a BCOO X. Same call signature as
    ``make_sweep`` (without mask extras)::

        sweep(X_bcoo, W, T, key, resets_left, reset_key[, w_row_sum_vec])

    ``gs`` picks the Gauss-Seidel topic-loop implementation
    (:func:`rri_nmf_tpu.ops.dense_phase.gs_panel`; a projected T-phase
    always runs the XLA loop). ``gemm_dtype=jnp.bfloat16`` runs the two
    sparse contractions with bf16 inputs — the Gauss-Seidel updates stay
    in the accumulation dtype.
    """
    assert supports_sparse(cfg), 'config not supported by the sparse sweep'
    k = cfg.k
    t_bound, w_bound = phase_bounds(cfg)
    proj_t = bool(cfg.t_row_sum and cfg.project_T_each_iter)

    def sweep(X, W, T, key, resets_left, reset_key, *extras):
        w_row_sum_vec = (extras[0].reshape(-1)
                         if cfg.w_row_sum_is_vector else None)
        # sparse X is stored as nonzeros in the factor dtype (the driver
        # forbids x_dtype here), so the shared rule resolves on W alone
        dtype, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype,
                                             cfg.matmul_precision)
        if gemm_dtype is not None and X.data.dtype != gemm_dtype:
            # materialize the converted data (optimization_barrier): if the
            # cast fuses into the contraction's gather, the gather reads
            # the 4-byte buffer
            Xc = jsparse.BCOO(
                (lax.optimization_barrier(X.data.astype(gemm_dtype)),
                 X.indices), shape=X.shape,
                indices_sorted=X.indices_sorted,
                unique_indices=X.unique_indices)
            cd = gemm_dtype
        else:
            Xc = X
            cd = gemm_dtype if gemm_dtype is not None else acc

        def _cast_dense(A):
            # materialize casts feeding the sparse contraction: a fused
            # cast makes the gather read the wide buffer
            if A.dtype == cd:
                return A
            return lax.optimization_barrier(A.astype(cd))

        if not cfg.fix_T:
            WX = jsparse.bcoo_dot_general(
                Xc, _cast_dense(W),
                dimension_numbers=(((0,), (0,)), ((), ()))
                ).T.astype(acc)                              # (k, d)
            G = jnp.dot(W.T, W, preferred_element_type=acc)
            T = gs_panel(WX, T, G, impl=gs, k=k, reg_l1=cfg.reg_t_l1,
                         reg_l2=cfg.reg_t_l2, ub=t_bound, acc=acc,
                         dtype=dtype, reps=cfg.inner_reps,
                         qf_s=cfg.t_update_s,
                         reproject_sum=cfg.t_row_sum if proj_t else None)

        if not cfg.fix_W:
            XT = jsparse.bcoo_dot_general(
                Xc, _cast_dense(T.T),
                dimension_numbers=(((1,), (0,)), ((), ()))
                ).T.astype(acc)                              # (k, n)
            G2 = jnp.dot(T, T.T, preferred_element_type=acc)
            ub = w_row_sum_vec if cfg.w_row_sum_is_vector else w_bound
            W = gs_panel(XT, W.T, G2, impl=gs, k=k, reg_l1=cfg.reg_w_l1,
                         reg_l2=cfg.reg_w_l2, ub=ub, acc=acc, dtype=dtype,
                         reps=cfg.inner_reps).T

        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
            if cfg.w_row_sum_is_vector:
                s_vec = w_row_sum_vec.astype(dtype)
            else:
                s_vec = jnp.full((W.shape[0],), cfg.w_row_sum, dtype=dtype)
            W = jax.vmap(_proj_simplex_core)(W, s_vec)

        return W, T, key, resets_left

    if cfg.matmul_precision is not None:
        # honor the explicit precision request exactly like make_sweep:
        # the Grams and Gram-blocked correction dots otherwise run at the
        # backend's default precision
        _sweep_body = sweep

        def sweep(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _sweep_body(*args)

    return jax.jit(sweep)


def make_sparse_objective(reg_w_l2=0.0, reg_t_l2=0.0,
                          reg_w_l1=0.0, reg_t_l1=0.0,
                          chunk=1 << 18, gather_budget=2 << 30):
    """``0.5||X - WT||² + regs`` for BCOO X without materializing WT.

    The cross term Σ_nnz X_ij (W_i · T_j) gathers factor rows per
    nonzero; one-shot gathers are O(nnz·k) temporaries — 512 GB at the
    module's stated beyond-HBM scale (1e9 nnz, k=128). Past ~2 GB of
    gather temporaries the sum accumulates over ``chunk``-nonzero slices
    in a fori_loop instead (zero-padded tail contributes exactly 0)."""

    def objective(X, W, T):
        acc = jnp.float32 if W.dtype in (jnp.bfloat16, jnp.float16) \
            else W.dtype
        W = W.astype(acc)
        T = T.astype(acc)
        data = X.data.astype(acc)
        x2 = jnp.sum(data ** 2)
        rows = X.indices[:, 0]
        cols = X.indices[:, 1]
        nnz = int(data.shape[0])
        k = int(W.shape[1])
        if nnz * k * jnp.dtype(acc).itemsize <= gather_budget:
            # Σ_nnz X_ij (W_i · T_j): O(nnz · k) gather, one shot
            cross = jnp.sum(data * jnp.sum(W[rows] * T[:, cols].T, axis=1))
        else:
            nch = -(-nnz // chunk)
            pad = nch * chunk - nnz
            d_p = jnp.pad(data, (0, pad))          # zero data ⇒ zero term
            r_p = jnp.pad(rows, (0, pad))
            c_p = jnp.pad(cols, (0, pad))

            def blk(i, s):
                db = lax.dynamic_slice(d_p, (i * chunk,), (chunk,))
                rb = lax.dynamic_slice(r_p, (i * chunk,), (chunk,))
                cb = lax.dynamic_slice(c_p, (i * chunk,), (chunk,))
                return s + jnp.sum(db * jnp.sum(W[rb] * T[:, cb].T, axis=1))

            cross = lax.fori_loop(0, nch, blk, jnp.zeros((), acc))
        wtw = W.T @ W
        ttt = T @ T.T
        wt2 = jnp.sum(wtw * ttt)        # tr((W^T W)(T T^T)) = ||WT||²
        obj = 0.5 * (x2 - 2.0 * cross + wt2)
        obj = obj + 0.5 * reg_w_l2 * jnp.sum(W ** 2)
        obj = obj + 0.5 * reg_t_l2 * jnp.sum(T ** 2)
        obj = obj + reg_t_l1 * jnp.sum(jnp.abs(T))
        obj = obj + reg_w_l1 * jnp.sum(jnp.abs(W))
        return obj

    return jax.jit(objective)
