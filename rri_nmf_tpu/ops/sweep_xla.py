"""The RRI / WRRI sweep as a single jitted XLA computation.

This is the re-design of the reference's per-topic Python loop
(reference ``nmf.py:415-478`` with helpers ``_compute_update_T``
``nmf.py:633-715``, ``_compute_update_W`` ``nmf.py:718-747``,
``_project_and_check_reset_t`` ``nmf.py:750-783``, ``_check_reset_W``
``nmf.py:786-816``). One call = one full sweep over all k topics, compiled
once; the topic loop is a ``lax.fori_loop`` that preserves the reference's
Gauss-Seidel ordering exactly (each topic's update sees all earlier topics'
updates within the same sweep — required for the monotone-descent tests).

Design decisions (none of these exist in the reference):

1. **T-phase GEMM batching (unweighted RRI).** The reference computes
   ``wX = W[:,t]^T X`` as k separate GEMVs per sweep (``nmf.py:672``). But
   each column ``W[:,t]`` is only modified during its *own* topic's phases
   (scale transfer ``nmf.py:450-452``, the W-update ``nmf.py:469``, resets),
   so at the time topic t reads it, ``W[:,t]`` still holds its value from
   the start of the sweep. Hence all k numerators come from ONE
   ``W^T X`` GEMM (one device-memory read of X instead of k), and all k
   denominators ``||W[:,t]||^2`` from one column-norm pass. This halves the
   sweep's memory traffic and moves half its FLOPs from GEMV to GEMM.

2. **Incremental MASKED residual for the masked WRRI path.** The reference
   rebuilds the full ``R_t = X - W_{-t} T`` per topic — an O(ndk) GEMM per
   topic, O(ndk^2) per sweep, the documented "k times slower" path
   (``nmf.py:355-356,687-693``). Here ``MR = M ⊙ (X - W T)`` is maintained
   with masked rank-one updates (the rank-2 correction runs as a
   2-column GEMM; the mask multiply fuses into the elementwise add), and
   the per-topic quantities follow from the identities::

       numer_T = w^T (M ⊙ (R + w t^T)) = w^T MR + t ⊙ ((w²)^T M)
       numer_W = (M ⊙ (R + w t^T)) t  = MR t + w ⊙ (M t²)

   so each topic costs O(nd) and a sweep is O(ndk) — the asymptotic fix the
   reference's README wishes for from a Cython kernel (``README.md:19``).
   Carrying the masked residual (not the raw one) keeps every contraction a
   CANONICAL dot on a materialized buffer — XLA:CPU only dispatches
   canonical dots to the threaded Eigen/oneDNN kernels (a dot with a fused
   elementwise operand falls back to a single-threaded loop emitter,
   measured ~20x slower at 1500×1000) — and saves the two per-topic
   ``M ⊙ R`` materializations everywhere else. MR is refreshed from
   (X, W, T) at the start of every sweep, bounding floating-point drift to
   one sweep.

3. **Sharding-transparent.** Everything is plain matmuls, reductions, and
   row-local projections; under a ``jax.sharding.Mesh`` with X/W row-sharded
   and T replicated (or X column-sharded too), GSPMD auto-inserts the
   ``psum``s for the per-topic inner products. See
   ``rri_nmf_tpu.parallel``.

4. **Explicit randomness.** The reference's global
   ``np.random.seed(t + argmax(T[t]))`` reset trick (``nmf.py:780,812-813``)
   becomes ``jax.random.fold_in`` on a dedicated reset key, so resets are
   deterministic and agree across shards.
"""

import dataclasses
from functools import lru_cache
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from rri_nmf_tpu.optimization import qf_min_scalar_c, qf_min_vector_c
from rri_nmf_tpu.matrixops import (_proj_simplex_core,
    reproject_row_if_drifted)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static (compile-time) configuration of one sweep.

    Field names mirror the reference ``nmf()`` kwargs (``nmf.py:98-108``).
    ``w_row_sum``/``t_row_sum`` are static floats here; a per-row vector
    ``w_row_sum`` is passed as a traced array instead (``w_row_sum_is_vector``).
    """
    k: int
    fix_W: bool = False
    fix_T: bool = False
    masked: bool = False
    # the mask/observed set is a COO plan (O(nnz) memory) instead of a
    # dense n×d array — the sweep runs ops/sweep_masked_sparse.py and X
    # is a MaskedCOOPlan, not an array (implies masked=True)
    masked_sparse: bool = False
    project_T_each_iter: bool = False
    project_W_each_iter: bool = False
    t_row_sum: Optional[float] = None
    w_row_sum: Optional[float] = None
    w_row_sum_is_vector: bool = False
    reg_w_l2: float = 0.0
    reg_t_l2: float = 0.0
    reg_w_l1: float = 0.0
    reg_t_l1: float = 0.0
    reset_topic_method: Optional[str] = 'max_resid_document'
    fix_reset_seed: bool = False
    dp_sigma: Optional[float] = None   # Gaussian-mechanism noise std, or None
    store_gradients: bool = False
    store_rows: Optional[Tuple[int, ...]] = None
    # 'interleaved' (reference order: T[t] then W[:,t] per topic) or
    # 'phase' (all T rows, then all W columns — same exact coordinate
    # minimizations and fixed points, ~(k+1)/2 x less memory traffic; see the
    # sweep body). Ignored on the masked path.
    update_order: str = 'interleaved'
    # max-residual reset strategy: True = blockwise scan (O(B*d) temps —
    # essential near the single-device memory ceiling), False = materialize the
    # full residual in one piece. With ``mesh`` set, resets instead run as
    # a shard_map: per-device blockwise residual row norms, psum over the
    # column axis, argmax combined over the row axis — no n×d temporary
    # and no GSPMD gathers (the dynamic_slice scan would gather a
    # dp-sharded X).
    reset_blockwise: bool = True
    # jax.sharding.Mesh the sweep will run under (hashable; compile-time).
    # Only consulted by the reset path — everything else is
    # sharding-transparent through GSPMD.
    mesh: Optional[Any] = None
    # matmul precision for the sweep's contractions (None = backend
    # default). On a GPU the default f32 dot runs in TF32 (~2^-11
    # relative noise), which floors the reachable relative
    # reconstruction error; pass 'highest' to converge below that
    # (slower GEMMs).
    matmul_precision: Optional[str] = None
    # Inner Gauss-Seidel repetitions per phase (phase order only). The
    # numerators (WᵀX / X Tᵀ) and the frozen factor's Gram are CONSTANT
    # through a phase, so the GS topic loop can re-run ``inner_reps``
    # times at O(k²·m) each while the O(ndk) X-contraction is paid once —
    # every pass is still exact cyclic BCD on the same subproblems, so
    # descent stays monotone (the accelerated-HALS inner iteration of
    # Gillis & Glineur 2012). Requires reset_topic_method=None for
    # >1 (a reset would invalidate the cached numerator row).
    inner_reps: int = 1

    @property
    def scale_transfer(self) -> bool:
        """Diagonal scale-invariance transfer ``W[:,t] *= ||t_new||_1`` is
        only valid when the objective is scale invariant, i.e. all four
        regularizers are zero (reference ``nmf.py:449-452``).

        Disabled in phase update order: the transfer is a heuristic rescale
        (not an exact coordinate step) that the reference's interleaving
        corrects immediately via the following W-update; with all T rows
        updated first, the rescaled columns would poison the remaining
        T-updates. Without it every phase-order update is an exact
        coordinate minimization, so descent is guaranteed.

        Phase order reaches the unweighted path and the sparse-mask
        Gram-phase sweep (``ops/sweep_masked_gram.py``, which relies on W
        being frozen through the T-phase — the transfer would invalidate
        its Γ tensor); the DENSE masked sweep is interleaved by
        construction (the driver coerces the order), so a dense-masked
        config always keeps the reference's interleaved transfer
        semantics.
        """
        if self.update_order == 'phase':
            return False
        return (abs(self.reg_w_l1) + abs(self.reg_w_l2) +
                abs(self.reg_t_l1) + abs(self.reg_t_l2)) == 0

    @property
    def t_update_s(self):
        """Sum constraint passed to the T-row subproblem
        (reference ``nmf.py:442-445``)."""
        return self.t_row_sum if self.project_T_each_iter else None


def _w_ub(cfg, w_row_sum_vec):
    """Upper bound argument for the W-column subproblem."""
    if cfg.w_row_sum_is_vector:
        return w_row_sum_vec
    return cfg.w_row_sum


def resolve_mixed_dtypes(x_dtype, w_dtype, matmul_precision=None):
    """Storage-dtype resolution shared by every dense sweep variant
    (this module, ``ops.dense_phase``, ``parallel.sharded_dense``).

    Returns ``(dtype, acc, x_narrow)``:

    - ``dtype`` — the FACTOR storage dtype, which follows W/T (mixed
      storage: the nmf driver's ``x_dtype='bfloat16'`` keeps X narrow
      while the factors stay f32);
    - ``acc`` — accumulator dtype: float32 whenever the promoted pair is
      16-bit, else the promotion (f64 stays f64 on CPU);
    - ``x_narrow`` — whether the X GEMMs should explicitly down-cast
      their (small) factor operand to X's dtype for one native bf16
      GEMM. True ONLY for bfloat16 X under DEFAULT matmul precision (the
      default f32 dot already rounds its operands on the tensor cores).
      float16 is deliberately excluded
      (f16's 65504 max overflows to inf on transiently large factor
      entries, e.g. under negative L1 — promotion handles f16 X safely);
      an explicit ``matmul_precision`` keeps full-precision passes via
      ordinary promotion.
    """
    dtype = jnp.dtype(w_dtype)
    wide = jnp.promote_types(jnp.dtype(x_dtype), dtype)
    acc = jnp.float32 if wide in (jnp.bfloat16, jnp.float16) else wide
    x_narrow = (jnp.dtype(x_dtype) == jnp.bfloat16
                and matmul_precision is None)
    return dtype, acc, x_narrow


def _gram_block_size(k: int) -> int:
    """Topic-block size for the Gram-blocked phase sweep: the largest
    divisor of k that is <= 16 (so no padding/guarding is needed; ~sqrt(k)
    minimizes block-GEMM + in-block traffic, and perf-relevant k are
    16-multiples). Worst case (prime k) degenerates to B=1, which still
    eliminates the per-topic re-read of the FROZEN factor's Gram."""
    for b in range(min(16, k), 0, -1):
        if k % b == 0:
            return b
    return 1


def make_objective(masked: bool, row_weighted: bool,
                   reg_w_l2=0.0, reg_t_l2=0.0, reg_w_l1=0.0, reg_t_l1=0.0,
                   block_rows=None, matmul_precision=None):
    """Build the jitted full-objective function.

    Mirrors ``TrueObjComputer.true_objective`` (reference ``nmf.py:71-94``):
    ``0.5 ||M ⊙ (X - WT)||_F^2`` (entrywise- and/or row-weighted) plus the
    four regularization terms. Extra args (mask / row weights) exist only
    when the corresponding flag is set, keeping the jit signature tight.

    ``block_rows``: accumulate the residual norm over row blocks of this
    size instead of materializing the full ``W @ T`` product — use for
    matrices near the device memory budget (the fused form needs one extra n×d
    temporary).
    """
    def _res_sq(acc_dt, X, W, T, *extras):
        # 16-bit storage evaluates in float32 so descent comparisons
        # aren't drowned by quantization noise; the casts sit INSIDE the
        # (possibly blockwise) evaluation so a narrow X is widened one
        # block at a time, never materialized as a full f32 copy (the
        # bf16-X north-star shape would not fit device memory widened).
        i = 0
        R = (X.astype(acc_dt)
             - jnp.dot(W.astype(acc_dt), T.astype(acc_dt),
                       preferred_element_type=acc_dt)) ** 2
        if masked:
            R = extras[i].astype(acc_dt) * R
            i += 1
        if row_weighted:
            R = extras[i].astype(acc_dt) * R
            i += 1
        return jnp.sum(R)

    def objective(X, W, T, *extras):
        from rri_nmf_tpu.ops.quantized import (
            QuantizedX, dequantize_x, qx_row_block)
        qx = X if isinstance(X, QuantizedX) else None
        _, acc_dt, _ = resolve_mixed_dtypes(X.dtype, W.dtype)

        if block_rows is None:
            base = _res_sq(acc_dt, dequantize_x(qx) if qx is not None
                           else X, W, T, *extras)
        else:
            n, d = X.shape
            B = min(n, int(block_rows))
            nb = -(-n // B)

            def _blk(i, acc):
                start = jnp.minimum(i * B, n - B)
                if qx is not None:
                    Xb = qx_row_block(qx, start, B, acc_dt)
                else:
                    Xb = lax.dynamic_slice(X, (start, 0), (B, d))
                Wb = lax.dynamic_slice(W, (start, 0), (B, W.shape[1]))
                eb = [lax.dynamic_slice(e, (start, 0), (B, e.shape[1]))
                      if e.ndim == 2 and e.shape[0] == n else e
                      for e in extras]
                # overlap correction for the clamped final block
                prev_end = jnp.minimum(i * B, n)
                overlap = jnp.maximum(prev_end - start, 0)
                row_ids = jnp.arange(B)
                mask_rows = (row_ids >= overlap).astype(Xb.dtype)
                contrib = _res_sq(acc_dt, Xb * mask_rows[:, None],
                                  Wb * mask_rows[:, None], T, *eb)
                return acc + contrib

            base = lax.fori_loop(0, nb, _blk,
                                 jnp.asarray(0.0, dtype=acc_dt))
        Wa = W.astype(acc_dt)
        Ta = T.astype(acc_dt)
        obj = 0.5 * base
        obj = obj + 0.5 * reg_w_l2 * jnp.sum(Wa ** 2)
        obj = obj + 0.5 * reg_t_l2 * jnp.sum(Ta ** 2)
        obj = obj + reg_t_l1 * jnp.sum(jnp.abs(Ta))
        obj = obj + reg_w_l1 * jnp.sum(jnp.abs(Wa))
        return obj

    if matmul_precision is not None:
        _obj_body = objective

        def objective(*args):
            with jax.default_matmul_precision(matmul_precision):
                return _obj_body(*args)

    return jax.jit(objective)


def make_reset_rowcol(cfg: SweepConfig):
    """Topic-reset builder: returns ``reset(X, W, T, t, key, reset_key)
    -> (t_row, w_col, key)`` implementing ``cfg.reset_topic_method``.

    Returns the NEW T row ``(d,)`` and W column ``(n,)`` instead of
    whole factor matrices so the reset can sit inside a ``lax.cond``
    whose carried payload is O(n + d): carrying (W, T) through the
    branch tuples makes XLA materialize fresh copies of both on every
    topic even when the (rare) reset branch is never taken."""
    method = cfg.reset_topic_method

    def _reset_rowcol(X, W, T, t, key, reset_key):
        """Shared topic-reset: produces new T[t] and W[:,t]
        (reference ``nmf.py:770-783`` and ``nmf.py:804-816``; the
        reference's 'random' T-branch has an undefined-``n`` bug at
        ``nmf.py:783`` which is fixed here)."""
        n, d = X.shape
        if method == 'max_resid_document' and cfg.mesh is not None:
            # shard_map reset (ROADMAP #6): per-device blockwise residual
            # row norms with a psum over the column (tp) axis, argmax
            # combined over the row (dp) axis via an all_gather of two
            # scalars per device; the winning row and the one-hot W column
            # are produced shard-local. No n×d temporary, no gathers.
            try:
                from jax import shard_map as _shard_map
            except ImportError:  # pragma: no cover
                from jax.experimental.shard_map import shard_map \
                    as _shard_map
            from jax.sharding import PartitionSpec as P
            mesh = cfg.mesh
            dp, tp = mesh.axis_names

            def _local(X, W, T):
                n_loc, d_loc = X.shape
                B = min(n_loc, 4096)
                nb = -(-n_loc // B)

                def _blk(i, carry):
                    best_val, best_idx = carry
                    start = jnp.minimum(i * B, n_loc - B)
                    Xb = lax.dynamic_slice(X, (start, 0), (B, d_loc))
                    Wb = lax.dynamic_slice(W, (start, 0), (B, W.shape[1]))
                    Rb = jnp.maximum(Xb - Wb @ T, 0.0)
                    rts = lax.psum(jnp.sum(Rb * Rb, axis=1), tp)
                    j = jnp.argmax(rts)
                    v = rts[j]
                    better = v > best_val
                    return (jnp.where(better, v, best_val),
                            jnp.where(better,
                                      (start + j).astype(jnp.int32),
                                      best_idx))

                val, li = lax.fori_loop(
                    0, nb, _blk,
                    # residual promotes to the wider of X/W (mixed storage)
                    (jnp.asarray(-jnp.inf,
                                 dtype=jnp.promote_types(X.dtype, W.dtype)),
                     jnp.asarray(0, jnp.int32)))
                row_off = (lax.axis_index(dp) * n_loc).astype(jnp.int32)
                vals = lax.all_gather(val, dp)          # (|dp|,)
                idxs = lax.all_gather(row_off + li, dp)
                a = jnp.argmax(vals)                    # first max wins
                mi = idxs[a]
                # the owner shard contributes the winning row; psum
                # broadcasts it across dp (all other contributions are 0)
                has = jnp.logical_and(mi >= row_off,
                                      mi < row_off + n_loc)
                lmi = jnp.clip(mi - row_off, 0, n_loc - 1)
                row = jnp.maximum(X[lmi] - W[lmi] @ T, 0.0) * \
                    has.astype(X.dtype)
                row = lax.psum(row, dp)                 # (d_loc,)
                onehot = (row_off + jnp.arange(n_loc, dtype=jnp.int32)
                          == mi).astype(W.dtype)        # (n_loc,)
                return row, onehot

            row, onehot = _shard_map(
                _local, mesh=mesh,
                in_specs=(P(dp, tp), P(dp, None), P(None, tp)),
                out_specs=(P(tp), P(dp)),
                check_vma=False)(X, W, T)
            return row.astype(T.dtype), onehot.astype(W.dtype), key
        if method == 'max_resid_document' and not cfg.reset_blockwise:
            # full-residual form: one n×d temporary (shard-local under
            # GSPMD — the blockwise scan's dynamic_slice would gather)
            Rt = jnp.maximum(X - W @ T, 0.0)
            Rts = jnp.sum(Rt * Rt, axis=1)
            mi = jnp.argmax(Rts)
            onehot = (jnp.arange(W.shape[0], dtype=jnp.int32)
                      == mi).astype(W.dtype)
            return Rt[mi].astype(T.dtype), onehot, key
        if method == 'max_resid_document':
            # blockwise residual-norm argmax: never materializes the full
            # n×d residual (at the 1M×100k BASELINE scale the naive form
            # costs ~270 GB of temporaries per device; this is O(B·d)).
            B = min(n, 4096)
            nb = -(-n // B)

            def _blk(i, carry):
                best_val, best_idx = carry
                start = jnp.minimum(i * B, n - B)
                Xb = lax.dynamic_slice(X, (start, 0), (B, d))
                Wb = lax.dynamic_slice(W, (start, 0), (B, W.shape[1]))
                Rb = jnp.maximum(Xb - Wb @ T, 0.0)
                rts = jnp.sum(Rb * Rb, axis=1)
                j = jnp.argmax(rts)
                v = rts[j]
                better = v > best_val  # strict: first max wins, like argmax
                return (jnp.where(better, v, best_val),
                        jnp.where(better,
                                  (start + j).astype(jnp.int32), best_idx))

            _, mi = lax.fori_loop(
                0, nb, _blk,
                (jnp.asarray(-jnp.inf,
                             dtype=jnp.promote_types(X.dtype, W.dtype)),
                 jnp.asarray(0, dtype=jnp.int32)))
            row = jnp.maximum(X[mi] - W[mi] @ T, 0.0)
            onehot = (jnp.arange(W.shape[0], dtype=jnp.int32)
                      == mi).astype(W.dtype)
            return row.astype(T.dtype), onehot, key
        elif method == 'random':
            if cfg.fix_reset_seed:
                # deterministic analog of np.random.seed(t + argmax(T[t]))
                # (reference nmf.py:780): same key on every shard/run.
                rk = jax.random.fold_in(
                    reset_key, t + jnp.argmax(T[t]).astype(jnp.int32))
            else:
                key, rk = jax.random.split(key)
            k1, k2 = jax.random.split(rk)
            trow = jax.random.uniform(k1, (d,), dtype=T.dtype)
            return (trow / jnp.sum(trow),
                    jax.random.uniform(k2, (n,), dtype=W.dtype), key)
        else:
            raise ValueError('unknown reset_topic_method %r' % (method,))
    return _reset_rowcol


def make_reset_factors(cfg: SweepConfig):
    """Whole-matrix convenience form of :func:`make_reset_rowcol` —
    returns ``reset(X, W, T, t, key, reset_key) -> (W, T, key)``. All
    in-tree sweeps use the row/column form (small ``lax.cond``
    payloads); this wrapper remains for external callers and tests."""
    rowcol = make_reset_rowcol(cfg)

    def _reset_factors(X, W, T, t, key, reset_key):
        row, col, key = rowcol(X, W, T, t, key, reset_key)
        return W.at[:, t].set(col), T.at[t].set(row), key

    return _reset_factors


@lru_cache(maxsize=64)
def make_sweep(cfg: SweepConfig):
    """Build the jitted one-sweep function for a static config.

    Returned callable signature::

        sweep(X, W, T, key, resets_left, reset_key, *extras)
            -> (W, T, key, resets_left [, numer_store, denom_store])

    where ``extras`` is ``(W_mat,)`` if ``cfg.masked`` and additionally
    ``(w_row_sum_vec,)`` if ``cfg.w_row_sum_is_vector`` (in that order).
    ``resets_left`` is the global finite reset budget carried across
    iterations (reference ``nmf.py:192-193,765-769``).
    """
    k = cfg.k
    method = cfg.reset_topic_method
    if cfg.inner_reps > 1 and (cfg.update_order != 'phase' or cfg.masked
                               or method is not None or cfg.store_gradients
                               or cfg.dp_sigma is not None):
        # mirror the driver's rule (nmf.py) for direct callers: the extra
        # passes reuse the per-phase numerators, which these features
        # invalidate — e.g. a mid-phase reset rewrites W[:, t] but
        # WX_pre[t] keeps the pre-reset contraction, so pass 2's
        # T-update would use a wrong numerator (silently non-monotone)
        raise ValueError(
            "inner_reps > 1 requires update_order='phase', unmasked, "
            'reset_topic_method=None, no store_gradients, no DP noise')

    # ----- shared pieces -------------------------------------------------

    def _maybe_reproject_t_row(T, t):
        """Re-project T[t] if it drifted off the simplex
        (reference ``nmf.py:759-761``; threshold 1e-15). The cond
        carries only the ``(d,)`` row — not T — so the untaken branch
        never copies the factor (see _project_and_check_reset_t).

        Masked configs skip this: their reprojection is hoisted into the
        T-phase itself, BEFORE the rank-2 residual bookkeeping (a
        post-step reprojection would leave the carried masked residual
        stale by the projection delta for the rest of the sweep)."""
        if cfg.masked or not (cfg.t_row_sum and cfg.project_T_each_iter):
            return T
        row = reproject_row_if_drifted(T[t], cfg.t_row_sum, T.dtype)
        return T.at[t].set(row)

    _reset_rowcol = make_reset_rowcol(cfg)

    def _project_and_check_reset_t(X, W, T, R, t, key, resets_left,
                                   reset_key, W_mat=None):
        """Reference ``nmf.py:750-783``. Also refreshes the masked residual
        when a reset rewrites a factor.

        The reset cond carries only the new ``(d,)`` row / ``(n,)``
        column / key — never (W, T): a whole-matrix cond payload makes
        XLA materialize fresh copies of both factors per topic even on
        the never-taken branch. The unconditional
        write-back of the unchanged row/column is bitwise identity."""
        if method is None:
            # `nt1 > 1e-10 or reset_topic_method is None` always takes the
            # projection branch (reference nmf.py:758) — which still
            # re-projects a drifted T row (reference nmf.py:759-761)
            return W, _maybe_reproject_t_row(T, t), R, key, resets_left

        alive = jnp.sum(T[t]) > 1e-10
        do_reset = jnp.logical_and(jnp.logical_not(alive), resets_left > 0)

        def _keep():
            # alive: re-project a drifted row (reference nmf.py:758-761);
            # dead without budget: everything unchanged (reference's skip
            # branch — a dead row must NOT be reprojected, Duchi would
            # turn it uniform). The dead∧drifted combination is actually
            # unreachable through the sweep (reproject requires t_row_sum
            # + project_T_each_iter, whose qf_min update always returns a
            # simplex row), but the guard keeps this function equivalent
            # to the nested-cond form for any caller state.
            row = T[t]
            if (cfg.t_row_sum and cfg.project_T_each_iter
                    and not cfg.masked):
                # masked configs reproject inside the T-phase instead
                # (before the rank-2 residual bookkeeping) — see
                # _maybe_reproject_t_row
                row = reproject_row_if_drifted(row, cfg.t_row_sum,
                                               T.dtype, extra_pred=alive)
            return row, W[:, t], key

        row, col, key = lax.cond(
            do_reset,
            lambda: _reset_rowcol(X, W, T, t, key, reset_key),
            _keep)
        W = W.at[:, t].set(col)
        T = T.at[t].set(row)
        resets_left = resets_left - do_reset.astype(resets_left.dtype)
        if cfg.masked:
            # rank-one bookkeeping invalidated by a reset: rebuild the
            # masked residual carry (the untaken branch passes R through)
            R = lax.cond(do_reset, lambda: W_mat * (X - W @ T),
                         lambda: R)
        return W, T, R, key, resets_left

    def _check_reset_W(X, W, T, R, t, key, resets_left, reset_key,
                       W_mat=None):
        """Reference ``nmf.py:786-816``."""
        if method is None:
            return W, T, R, key, resets_left

        alive = jnp.sum(W[:, t]) > 1e-10
        do_reset = jnp.logical_and(jnp.logical_not(alive), resets_left > 0)
        row, col, key = lax.cond(
            do_reset,
            lambda: _reset_rowcol(X, W, T, t, key, reset_key),
            lambda: (T[t], W[:, t], key))
        W = W.at[:, t].set(col)
        T = T.at[t].set(row)
        resets_left = resets_left - do_reset.astype(resets_left.dtype)
        if cfg.masked:
            R = lax.cond(do_reset, lambda: W_mat * (X - W @ T),
                         lambda: R)
        return W, T, R, key, resets_left

    def _dp_noise(key, wR, nw):
        """Gaussian-mechanism noise on the T-update numerator/denominator
        (reference ``nmf.py:422-435``)."""
        key, k1, k2 = jax.random.split(key, 3)
        wR = wR + cfg.dp_sigma * jax.random.normal(k1, wR.shape, wR.dtype)
        noise_nw = cfg.dp_sigma * jax.random.normal(
            k2, jnp.shape(nw), wR.dtype)
        nw = jnp.maximum(nw + noise_nw, 0.0)
        return key, wR, nw

    # ----- the sweep -----------------------------------------------------

    def sweep(X, W, T, key, resets_left, reset_key, *extras):
        i = 0
        if cfg.masked:
            W_mat = extras[i]; i += 1
        else:
            W_mat = None
        if cfg.w_row_sum_is_vector:
            w_row_sum_vec = extras[i].reshape(-1); i += 1
        else:
            w_row_sum_vec = None

        n, d = X.shape
        # Mixed precision: with bfloat16/float16 storage (memory traffic
        # halves — X reads dominate the sweep) all reductions, numerators,
        # and subproblem solves run in float32; only the stored factors are
        # low precision. For f32/f64 inputs acc == dtype and nothing
        # changes. The FACTOR dtype follows W (mixed storage: the nmf
        # driver's ``x_dtype`` keeps X bf16 while the factors stay f32 —
        # the X contractions read half the bytes; XLA fuses the widening
        # convert into the dot's operand read).
        dtype, acc, _ = resolve_mixed_dtypes(X.dtype, W.dtype,
                                             cfg.matmul_precision)

        if cfg.masked:
            # masked residual carry MR = M ⊙ (X - WT), refreshed each sweep
            # and kept rank-one-updated (see module docstring, point 2)
            R = W_mat * (X - W @ T)
            WX_pre = None
            Wcoln_pre = None
        else:
            R = jnp.zeros((0, 0), dtype=dtype)
            if cfg.fix_T:
                WX_pre = None     # T-phase never runs: skip the X read
                Wcoln_pre = None
            else:
                # One GEMM replaces k GEMVs: every column W[:,t] is
                # untouched until its own topic's phases (see module
                # docstring, point 1).
                WX_pre = jnp.dot(W.T, X, preferred_element_type=acc)  # (k,d)
                Wcoln_pre = jnp.sum(W.astype(acc) ** 2, axis=0)       # (k,)

        if cfg.store_gradients:
            numer_store = jnp.zeros((k, d), dtype=acc)
            denom_store = jnp.zeros((k, d if cfg.masked else 1), dtype=acc)
            if cfg.store_rows is not None:
                rows = jnp.asarray(np.asarray(cfg.store_rows, dtype=np.int32))
                X_rows = X[rows]
                M_rows = W_mat[rows] if cfg.masked else None
            else:
                rows = None
        else:
            numer_store = jnp.zeros((0, 0), dtype=dtype)
            denom_store = jnp.zeros((0, 0), dtype=dtype)

        def make_topic_body(do_t, do_w, XT=None):
            """One Gauss-Seidel topic step, restricted to the requested
            phase(s). ``XT`` (n, k) supplies the W-phase contraction
            ``X @ T[t]`` when the T rows are already final for the sweep
            (phase update order) — the key to collapsing the k W-phase
            GEMVs into one GEMM."""
            return lambda t, carry: topic_body(t, carry, do_t, do_w, XT)

        def topic_body(t, carry, do_t, do_w, XT=None):
            W, T, R, key, resets_left, numer_store, denom_store = carry

            # ---------------- T-phase (reference nmf.py:417-458) ---------
            if do_t:
                w = W[:, t]
                if cfg.masked:
                    # R carries the MASKED residual: both contractions are
                    # canonical dots (threaded GEMV on CPU, cuBLAS on GPU)
                    nw = jnp.dot(w * w, W_mat,
                                 preferred_element_type=acc)  # (d,) vector
                    wR = jnp.dot(w, R, preferred_element_type=acc) \
                        + T[t].astype(acc) * nw               # (d,)
                else:
                    wW = jnp.dot(w, W, preferred_element_type=acc)  # (k,)
                    wW = wW.at[t].set(0.0)
                    wR = WX_pre[t] - jnp.dot(wW, T.astype(acc))     # (d,)
                    nw = Wcoln_pre[t]               # scalar

                if cfg.store_gradients:
                    if rows is None:
                        numer_store = numer_store.at[t].set(wR.astype(acc))
                        denom_store = denom_store.at[t].set(
                            jnp.broadcast_to(nw, denom_store.shape[1:]
                                             ).astype(acc))
                    else:
                        ws = W[rows, t]
                        if cfg.masked:
                            Rt_rows = R[rows] + M_rows * \
                                jnp.outer(w[rows], T[t])
                            wR_s = ws @ Rt_rows
                            nw_s = (ws * ws) @ M_rows
                        else:
                            wXs = ws @ X_rows
                            wWs = ws @ W[rows]
                            wWs = wWs.at[t].set(0.0)
                            wR_s = wXs - wWs @ T
                            nw_s = jnp.sum(ws * ws)
                        numer_store = numer_store.at[t].set(wR_s.astype(acc))
                        denom_store = denom_store.at[t].set(
                            jnp.broadcast_to(nw_s, denom_store.shape[1:]
                                             ).astype(acc))

                if cfg.dp_sigma is not None:
                    key, wR, nw = _dp_noise(key, wR, nw)

                numer = wR - cfg.reg_t_l1
                denom = nw + cfg.reg_t_l2

                if cfg.masked:
                    t_new, nt1 = qf_min_vector_c(
                        -numer, denom, s=cfg.t_update_s, ub=cfg.t_row_sum)
                else:
                    t_new, nt1 = qf_min_scalar_c(
                        -numer, denom, s=cfg.t_update_s, ub=cfg.t_row_sum)

                t_old = T[t]
                if cfg.scale_transfer:
                    # diagonal scale-invariance transfer (nmf.py:450-452)
                    W = W.at[:, t].multiply(nt1.astype(dtype))
                    w_eff = w * nt1.astype(dtype)
                else:
                    w_eff = w
                t_stored = t_new.astype(dtype)
                if (cfg.masked and cfg.t_row_sum
                        and cfg.project_T_each_iter):
                    # drift reprojection HOISTED before the rank-2
                    # residual bookkeeping: reprojecting after it (as the
                    # reset-check step does for the unmasked path) would
                    # leave R != M ⊙ (X − WT) by the projection delta for
                    # the rest of the sweep. Same aliveness guard as
                    # _project_and_check_reset_t._keep.
                    _pred = (jnp.sum(t_stored) > 1e-10
                             if method is not None else None)
                    t_stored = reproject_row_if_drifted(
                        t_stored, cfg.t_row_sum, dtype, extra_pred=_pred)
                T = T.at[t].set(t_stored)

                if cfg.masked:
                    # MR <- MR + M ⊙ (w_old t_old^T - w_eff t_new^T): the
                    # rank-2 correction runs as one (n,2)x(2,d)
                    # GEMM; the mask multiply fuses into the add. Uses the
                    # STORED (dtype) t_new so MR tracks T exactly. The two
                    # products nearly cancel, so the GEMM runs at full
                    # precision: a TF32 rounding of each (the GPU's
                    # default for f32) accumulates into MR over the sweep
                    # and drove the dense-mask fit's objective up ninefold
                    # at the MovieLens-1M shape.
                    U2 = jnp.stack([w, -w_eff], axis=1)
                    V2 = jnp.stack([t_old, T[t]], axis=0)
                    R = R + (W_mat * jnp.dot(
                        U2, V2, precision=lax.Precision.HIGHEST)
                    ).astype(dtype)

                W, T, R, key, resets_left = _project_and_check_reset_t(
                    X, W, T, R, t, key, resets_left, reset_key, W_mat)

            # ---------------- W-phase (reference nmf.py:460-476) ---------
            if do_w:
                trow = T[t]
                w_old = W[:, t]
                if cfg.masked:
                    mt2 = jnp.dot(W_mat, (trow * trow).astype(dtype),
                                  preferred_element_type=acc)  # (n,)
                    Rt = jnp.dot(R, trow, preferred_element_type=acc) \
                        + w_old.astype(acc) * mt2
                    nt = mt2
                else:
                    if XT is not None:
                        Xt = XT[:, t]
                    else:
                        Xt = jnp.dot(X, trow, preferred_element_type=acc)
                    Tt = jnp.dot(T, trow, preferred_element_type=acc)
                    Tt = Tt.at[t].set(0.0)
                    Rt = Xt - jnp.dot(W.astype(acc), Tt)
                    nt = jnp.sum(trow.astype(acc) ** 2)

                numer = Rt - cfg.reg_w_l1
                denom = nt + cfg.reg_w_l2

                if cfg.masked:
                    w_new, _nw1 = qf_min_vector_c(
                        -numer, denom, s=None,
                        ub=_w_ub(cfg, w_row_sum_vec))
                else:
                    w_new, _nw1 = qf_min_scalar_c(
                        -numer, denom, s=None,
                        ub=_w_ub(cfg, w_row_sum_vec))

                W = W.at[:, t].set(w_new.astype(dtype))
                if cfg.masked:
                    R = R + (W_mat * jnp.outer(w_old - w_new.astype(dtype),
                                               trow)).astype(dtype)

                W, T, R, key, resets_left = _check_reset_W(
                    X, W, T, R, t, key, resets_left, reset_key, W_mat)

            return W, T, R, key, resets_left, numer_store, denom_store

        # ----- Gram-blocked phase sweep -------------------------------------
        # Phase order: all T-row updates (exact, sequential), then all
        # W-column updates (exact, sequential). Every update remains an
        # exact coordinate minimization of the current objective, so
        # monotone descent and the stationarity conditions are unchanged;
        # only the cyclic order differs from the reference's interleaving
        # (this is the order sklearn's CD solver uses).
        #
        # Traffic design: within each phase the OTHER factor is frozen, so
        # its Gram matrix (G_W = WᵀW for the T-phase, G_T = TTᵀ for the
        # W-phase) is computed ONCE per phase; the Gauss-Seidel correction
        # for topic t needs Σ_{s≠t} G[t,s]·factor[s] against the CURRENT
        # (partially updated) factor, which is handled by processing topics
        # in blocks of B: one (B,k)×(k,d) GEMM against the block-start
        # factor + per-topic corrections that touch only the (B,d) in-block
        # delta slab. Per-topic memory traffic drops from O((n+d)·k) full
        # factor re-reads (the reference's k GEMVs, nmf.py:672-676,729-734)
        # to O(B·d): the sweep reads X twice and the factors ~(B + k/B)
        # times instead of k+1 times each. Topic resets (rare, inside
        # lax.cond) rank-one-patch the Gram and the block caches so the
        # math stays exact.
        def t_phase_blocked(W, T, key, resets_left):
            B = _gram_block_size(k)
            G = jnp.dot(W.T, W, preferred_element_type=acc)      # (k, k)

            def topic_body(i, carry2):
                W, T, G, C, T_blk0, D, bs, key, resets_left = carry2
                t = bs + i
                g_blk = lax.dynamic_slice(G, (t, bs), (1, B))[0]  # (B,)
                corr = (C[i] + jnp.dot(g_blk, D)
                        - g_blk[i] * T_blk0[i].astype(acc))
                wR = WX_pre[t] - corr
                nw = g_blk[i]                    # = G[t,t] = ||W[:,t]||²
                numer = wR - cfg.reg_t_l1
                denom = nw + cfg.reg_t_l2
                t_new, _nt1 = qf_min_scalar_c(
                    -numer, denom, s=cfg.t_update_s, ub=cfg.t_row_sum)
                T = T.at[t].set(t_new.astype(dtype))
                # no scale transfer in (effective) phase order, so W only
                # changes here through resets.
                W, T, _R, key, resets_left2 = _project_and_check_reset_t(
                    X, W, T, R, t, key, resets_left, reset_key)
                fired = resets_left2 < resets_left

                def _fix(ops):
                    # a reset rewrote W[:,t]: patch the Gram row/column and
                    # the block cache C (stale by ΔG[·,t]·T_blockstart[t]).
                    G, C = ops
                    g_new = jnp.dot(W[:, t], W, preferred_element_type=acc)
                    dg_blk = (lax.dynamic_slice(
                        g_new.reshape(1, -1), (0, bs), (1, B))[0]
                        - lax.dynamic_slice(G, (bs, t), (B, 1))[:, 0])
                    C = C + jnp.outer(dg_blk, T_blk0[i].astype(acc))
                    G = G.at[:, t].set(g_new).at[t, :].set(g_new)
                    return G, C

                G, C = lax.cond(fired, _fix, lambda ops: ops, (G, C))
                # in-block delta (covers the update, drift re-projection,
                # and any reset rewrite of T[t])
                D = D.at[i].set((T[t] - T_blk0[i]).astype(acc))
                return W, T, G, C, T_blk0, D, bs, key, resets_left2

            def block_body(bi, carry):
                W, T, G, key, resets_left = carry
                # inner_reps > 1 cycles over the k//B blocks again: WX_pre
                # and G depend only on W, frozen for the whole T-phase
                # (resets are disallowed for >1), so each pass is another
                # exact GS sweep over the same subproblems
                bs = (bi % (k // B)) * B
                Gblk = lax.dynamic_slice(G, (bs, 0), (B, k))
                C = jnp.dot(Gblk, T, preferred_element_type=acc)  # (B, d)
                T_blk0 = lax.dynamic_slice(T, (bs, 0), (B, d))
                D = jnp.zeros((B, d), acc)
                # unrolled: the in-block ops are tiny (k- and B-vectors
                # against the (B,d) delta slab); loop-control latency would
                # dominate them at accelerator dispatch granularity
                W, T, G, C, T_blk0, D, bs, key, resets_left = lax.fori_loop(
                    0, B, topic_body,
                    (W, T, G, C, T_blk0, D, bs, key, resets_left),
                    unroll=True)
                return W, T, G, key, resets_left

            W, T, G, key, resets_left = lax.fori_loop(
                0, cfg.inner_reps * (k // B), block_body,
                (W, T, G, key, resets_left))
            return W, T, key, resets_left

        def w_phase_blocked(W, T, key, resets_left):
            B = _gram_block_size(k)
            G = jnp.dot(T, T.T, preferred_element_type=acc)      # (k, k)
            XT = jnp.dot(X, T.T, preferred_element_type=acc)     # (n, k)

            def topic_body(i, carry2):
                W, T, G, C, W_blk0, D, bs, key, resets_left = carry2
                t = bs + i
                gcol_blk = lax.dynamic_slice(G, (bs, t), (B, 1))[:, 0]
                corr = (C[:, i] + jnp.dot(D, gcol_blk)
                        - W_blk0[:, i].astype(acc) * gcol_blk[i])
                Rt = XT[:, t] - corr
                nt = gcol_blk[i]                 # = G[t,t] = ||T[t]||²
                numer = Rt - cfg.reg_w_l1
                denom = nt + cfg.reg_w_l2
                w_new, _nw1 = qf_min_scalar_c(
                    -numer, denom, s=None, ub=_w_ub(cfg, w_row_sum_vec))
                W = W.at[:, t].set(w_new.astype(dtype))
                W, T, _R, key, resets_left2 = _check_reset_W(
                    X, W, T, R, t, key, resets_left, reset_key)
                fired = resets_left2 < resets_left

                def _fix(ops):
                    # a reset rewrote T[t]: patch the Gram row/column and
                    # the block cache C (stale by W_blockstart[t]·ΔG[t,·]).
                    G, C = ops
                    g_new = jnp.dot(T, T[t], preferred_element_type=acc)
                    dg_blk = (lax.dynamic_slice(
                        g_new.reshape(1, -1), (0, bs), (1, B))[0]
                        - lax.dynamic_slice(G, (bs, t), (B, 1))[:, 0])
                    C = C + jnp.outer(W_blk0[:, i].astype(acc), dg_blk)
                    G = G.at[:, t].set(g_new).at[t, :].set(g_new)
                    return G, C

                G, C = lax.cond(fired, _fix, lambda ops: ops, (G, C))
                D = D.at[:, i].set((W[:, t] - W_blk0[:, i]).astype(acc))
                return W, T, G, C, W_blk0, D, bs, key, resets_left2

            def block_body(bi, carry):
                W, T, G, key, resets_left = carry
                # see t_phase_blocked: extra passes reuse XT and G (T is
                # frozen for the whole W-phase when inner_reps > 1)
                bs = (bi % (k // B)) * B
                Gcols = lax.dynamic_slice(G, (0, bs), (k, B))
                C = jnp.dot(W, Gcols, preferred_element_type=acc)  # (n, B)
                W_blk0 = lax.dynamic_slice(W, (0, bs), (n, B))
                D = jnp.zeros((n, B), acc)
                W, T, G, C, W_blk0, D, bs, key, resets_left = lax.fori_loop(
                    0, B, topic_body,
                    (W, T, G, C, W_blk0, D, bs, key, resets_left),
                    unroll=True)
                return W, T, G, key, resets_left

            W, T, G, key, resets_left = lax.fori_loop(
                0, cfg.inner_reps * (k // B), block_body,
                (W, T, G, key, resets_left))
            return W, T, key, resets_left

        carry = (W, T, R, key, resets_left, numer_store, denom_store)
        phase_blocked_ok = (cfg.update_order == 'phase' and not cfg.masked
                            and not cfg.store_gradients
                            and cfg.dp_sigma is None)
        if phase_blocked_ok:
            if not cfg.fix_T:
                W, T, key, resets_left = t_phase_blocked(
                    W, T, key, resets_left)
            if not cfg.fix_W:
                W, T, key, resets_left = w_phase_blocked(
                    W, T, key, resets_left)
        elif cfg.update_order == 'phase' and not cfg.masked:
            # phase order with gradient stores / DP noise: per-topic path
            # (still batches the W-phase contractions into one X @ Tᵀ GEMM)
            if not cfg.fix_T:
                carry = lax.fori_loop(
                    0, k, make_topic_body(do_t=True, do_w=False), carry)
            if not cfg.fix_W:
                T_cur = carry[1]
                XT = jnp.dot(X, T_cur.T, preferred_element_type=acc)
                carry = lax.fori_loop(
                    0, k, make_topic_body(do_t=False, do_w=True, XT=XT),
                    carry)
            (W, T, R, key, resets_left, numer_store, denom_store) = carry
        else:
            W, T, R, key, resets_left, numer_store, denom_store = \
                lax.fori_loop(0, k, make_topic_body(not cfg.fix_T,
                                                    not cfg.fix_W), carry)

        # per-iteration W row projection (reference nmf.py:481-484)
        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
            if cfg.w_row_sum_is_vector:
                s_vec = w_row_sum_vec.astype(W.dtype)
            else:
                s_vec = jnp.full((W.shape[0],), cfg.w_row_sum, dtype=W.dtype)
            W = jax.vmap(_proj_simplex_core)(W, s_vec)

        if cfg.store_gradients:
            return W, T, key, resets_left, numer_store, denom_store
        return W, T, key, resets_left

    if cfg.matmul_precision is not None:
        _sweep_body = sweep

        def sweep(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _sweep_body(*args)

    return jax.jit(sweep)


@lru_cache(maxsize=64)
def make_multi_sweep(sweep, n_sweeps: int):
    """``n_sweeps`` applications of a sweep function (any of the
    ``make_*sweep`` builders' results, same call signature without the
    gradient-store variant) as ONE jitted fori_loop.

    For production fits with no per-iteration host work (no objective
    tracking / early stopping / callbacks) this collapses n dispatches and
    host synchronizations into one.
    """

    def multi(X, W, T, key, resets_left, reset_key, *extras):
        def body(i, carry):
            W, T, key, resets_left = carry
            return sweep(X, W, T, key, resets_left, reset_key, *extras)
        return lax.fori_loop(0, n_sweeps, body, (W, T, key, resets_left))

    return jax.jit(multi)
