"""Sparse-mask WRRI sweep: the observed-entries masked path.

The reference's masked (WRRI) path requires a dense ``X`` *and* a dense
``n×d`` weight matrix ``W_mat`` and rebuilds the full residual per topic —
O(ndk²) per sweep and O(nd) memory (reference ``nmf.py:687-746``; its RS
estimator even densifies the ratings COO, ``sklearn_interface.py:78-102``).
The dense-mask rebuild here (``ops/sweep_xla.py`` masked branch) already
fixes the FLOPs to O(ndk), but still carries O(nd) arrays, so the
recommender pillar could not leave one device's memory while real ratings
matrices are the sparsest workloads in the library.

This module is the O(nnz) redesign. Per Ho's Lemma 6.5 (the reference's
own comment at ``nmf.py:702-705``) every per-topic quantity is an
observed-entry contraction:

    numer_T = wᵀ(M ⊙ (R + w tᵀ)) = wᵀ(M⊙R) + t ⊙ nw,   nw = (w²)ᵀ M
    numer_W = (M ⊙ (R + w tᵀ)) t = (M⊙R) t + w ⊙ nt,   nt = M t²

With the observed set stored as sorted COO (``rows, cols, x, m``), the
masked residual ``r = m ⊙ (x − (W T)_obs)`` is carried as an (nnz,)
vector, refreshed from (plan, W, T) once per sweep (bounding drift to one
sweep, exactly like the dense masked carry), and rank-one-updated per
topic in O(nnz):

- ``wᵀ(M⊙R)``  = segment-sum of ``w[rows] · r``   keyed by column  → (d,)
- ``(w²)ᵀM``   = segment-sum of ``w[rows]² · m``  keyed by column  → (d,)
- ``(M⊙R) t``  = segment-sum of ``r · t[cols]``   keyed by row     → (n,)
- ``M t²``     = segment-sum of ``t[cols]² · m``  keyed by row     → (n,)
- update:  ``r += m · (w_old[rows]·t_old[cols] − w_new[rows]·t_new[cols])``

One sweep costs O(nnz·k) gather/segment-sum traffic and O(nnz + (n+d)k)
memory — the MovieLens-class config (6k×4k, 1M observed) drops from 24M
dense elements to 1M, and shapes whose dense form exceeds HBM entirely
(200k×150k at 0.2%) fit in a few hundred MB. The segment sums are XLA
scatter-adds (the same cost class as the unmasked BCOO path,
``ops/sweep_sparse.py``); when the dense form *fits* HBM the driver's
dense masked path can be the faster choice — this module is the
beyond-HBM path.

Semantics parity: Gauss-Seidel interleaved topic order, the scale
transfer, the hoisted drift reprojection (before the residual
bookkeeping), DP noise on the T numerator/denominator, and ``'random'``
topic resets all match the dense masked sweep bit-for-bit at f64 small
shapes (``tests/test_masked_sparse.py``). ``'max_resid_document'`` resets
are rejected: they scan the FULL (unmasked) residual, which does not
exist in O(nnz) form.
"""

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from rri_nmf_tpu.matrixops import (_proj_simplex_core,
    reproject_row_if_drifted)
from rri_nmf_tpu.optimization import qf_min_vector_c
from rri_nmf_tpu.ops.sweep_xla import (SweepConfig, make_reset_rowcol,
                                       resolve_mixed_dtypes)

# segment-sum padding quantum: plans pad nnz to a multiple of this so the
# chunked O(nnz·k) refresh/objective loops never need an overlap-corrected
# tail block (padding entries carry m = x = 0 and contribute exactly 0 to
# every contraction: the residual refresh multiplies by m before anything
# reads r)
_PAD_TO = 512


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class MaskedCOOPlan:
    """Observed-entry COO plan for the sparse-mask WRRI sweep.

    ``rows``/``cols``/``x_vals``/``m_vals`` are (nnz_pad,) device arrays
    sorted row-major (CSR order — the row-keyed segment sums exploit it);
    padding entries sit at the tail with ``rows`` = the last real row
    (keeping the row stream non-decreasing for the sorted segment sums),
    ``cols`` = d-1, and ``x = m = 0``. ``shape`` is the dense (n, d);
    ``nnz`` the number of real (unpadded) observations.
    """
    rows: jnp.ndarray     # (nnz_pad,) int32
    cols: jnp.ndarray     # (nnz_pad,) int32
    x_vals: jnp.ndarray   # (nnz_pad,) weighted-entry values of X
    m_vals: jnp.ndarray   # (nnz_pad,) mask/weight values (0 on padding)
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return ((self.rows, self.cols, self.x_vals, self.m_vals),
                (self.shape, self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, shape=aux[0], nnz=aux[1])

    def to_scipy(self):
        """Host (W_mat, X) reconstruction as scipy COO matrices (pickle /
        round-trip support; padding is dropped)."""
        import scipy.sparse as sp
        nz = self.nnz
        r = np.asarray(self.rows)[:nz]
        c = np.asarray(self.cols)[:nz]
        M = sp.coo_matrix((np.asarray(self.m_vals)[:nz], (r, c)),
                          shape=self.shape)
        X = sp.coo_matrix((np.asarray(self.x_vals)[:nz], (r, c)),
                          shape=self.shape)
        return M, X


def masked_coo_host_arrays(X, W_mat, dtype):
    """Host-side (numpy) sorted-COO observed set: ``(rows, cols, x, m,
    shape, nnz)``, padded to :data:`_PAD_TO` with zero-weight entries.
    Shared by :func:`plan_masked_coo` and the Gram planner
    (``ops/sweep_masked_gram.plan_masked_gram``), which must slice the
    arrays on the HOST — never fetching them back off the device."""
    Mc = W_mat.tocsr()
    Mc.eliminate_zeros()
    Mc.sum_duplicates()
    M = Mc.tocoo()   # csr->coo is row-major sorted
    rows = M.row.astype(np.int32)
    cols = M.col.astype(np.int32)
    m = np.asarray(M.data, dtype=dtype)
    if hasattr(X, 'tocsr'):
        Xc = X.tocsr()
        Xc.sum_duplicates()
        if (Xc.indptr.shape == Mc.indptr.shape
                and np.array_equal(Xc.indptr, Mc.indptr)
                and np.array_equal(Xc.indices, Mc.indices)):
            # X and the mask share the sparsity structure (the usual
            # recommender case: both built from the same triples) — the
            # CSR data vectors already align with the COO order; skip
            # scipy's O(nnz)-pair fancy indexing (minutes at 25M pairs)
            x = np.asarray(Xc.data, dtype=dtype)
        else:
            x = np.asarray(Xc[rows, cols]).ravel().astype(dtype)
    else:
        x = np.asarray(X)[rows, cols].astype(dtype)
    nnz = rows.shape[0]
    pad = (-nnz) % _PAD_TO
    if pad:
        # pad indices with the LAST row / max column so the row stream
        # stays non-decreasing — seg_rows passes indices_are_sorted=True
        # to segment_sum, and a trailing block of row-0 padding after
        # sorted real rows would violate that contract (XLA's sorted
        # scatter lowering may mis-sum; zero-index padding only
        # happened to work on the CPU backend, which ignores the hint).
        # Padding values stay m = x = 0, contributing exactly 0.
        pr = rows[-1] if nnz else np.int32(max(X.shape[0] - 1, 0))
        pc = np.int32(max(X.shape[1] - 1, 0))
        rows = np.pad(rows, (0, pad), constant_values=pr)
        cols = np.pad(cols, (0, pad), constant_values=pc)
        x = np.pad(x, (0, pad))
        m = np.pad(m, (0, pad))
    return rows, cols, x, m, (int(X.shape[0]), int(X.shape[1])), int(nnz)


def plan_masked_coo(X, W_mat, dtype):
    """Build a :class:`MaskedCOOPlan` from a scipy-sparse mask/weight
    matrix ``W_mat`` and a dense-or-sparse ``X``.

    Only X's values AT observed (mask-nonzero) coordinates are kept —
    the dense X never has to exist (pass X scipy-sparse with values on
    a superset of the mask's pattern). Explicit zeros in the mask are
    dropped (a zero weight is "unobserved" in every contraction).
    """
    rows, cols, x, m, shape, nnz = masked_coo_host_arrays(X, W_mat, dtype)
    return MaskedCOOPlan(
        rows=jnp.asarray(rows), cols=jnp.asarray(cols),
        x_vals=jnp.asarray(x), m_vals=jnp.asarray(m),
        shape=shape, nnz=nnz)


def supports_masked_sparse(cfg: SweepConfig) -> bool:
    """Config coverage of the O(nnz) masked sweep. The driver coerces
    the update order to 'interleaved' for every masked config and
    rejects gradient stores / 'max_resid_document' resets before
    building the plan."""
    return (cfg.masked and cfg.masked_sparse
            and cfg.update_order == 'interleaved'
            and cfg.reset_topic_method in (None, 'random')
            and not cfg.store_gradients)


def _predicted_obs(rows, cols, W, T, acc,
                   chunk=1 << 18, gather_budget=2 << 30):
    """(W T) gathered at the observed coordinates: (nnz_pad,) in ``acc``.

    One-shot when the O(nnz·k) gather temporaries fit ``gather_budget``;
    otherwise accumulated over ``chunk``-entry slices (nnz_pad is a
    multiple of :data:`_PAD_TO`, and chunks are too, so no tail
    handling). Shared by the residual refresh and the objective.
    """
    Wa = W.astype(acc)
    Ta = T.astype(acc)
    nnz = int(rows.shape[0])
    k = int(W.shape[1])
    if nnz * k * jnp.dtype(acc).itemsize <= gather_budget:
        return jnp.sum(Wa[rows] * Ta[:, cols].T, axis=1)
    chunk = min(chunk, nnz)
    # nnz_pad % _PAD_TO == 0 but not necessarily % chunk: round the loop
    # over full chunks and handle the remainder as one smaller slice
    full = nnz // chunk

    def blk(i, out):
        rb = lax.dynamic_slice(rows, (i * chunk,), (chunk,))
        cb = lax.dynamic_slice(cols, (i * chunk,), (chunk,))
        pb = jnp.sum(Wa[rb] * Ta[:, cb].T, axis=1)
        return lax.dynamic_update_slice(out, pb, (i * chunk,))

    out = lax.fori_loop(0, full, blk, jnp.zeros((nnz,), acc))
    rem = nnz - full * chunk
    if rem:
        rb = rows[full * chunk:]
        cb = cols[full * chunk:]
        out = out.at[full * chunk:].set(
            jnp.sum(Wa[rb] * Ta[:, cb].T, axis=1))
    return out


@lru_cache(maxsize=16)
def make_masked_sparse_sweep(cfg: SweepConfig):
    """Build the jitted O(nnz) masked sweep. Call signature mirrors
    ``make_sweep``'s masked form with the mask riding inside X::

        sweep(plan, W, T, key, resets_left, reset_key[, w_row_sum_vec])
            -> (W, T, key, resets_left)
    """
    assert supports_masked_sparse(cfg), \
        'config not supported by the masked sparse sweep'
    k = cfg.k
    method = cfg.reset_topic_method
    _reset_rowcol = make_reset_rowcol(cfg)  # 'random' only touches shape

    def sweep(plan, W, T, key, resets_left, reset_key, *extras):
        w_row_sum_vec = (extras[0].reshape(-1)
                         if cfg.w_row_sum_is_vector else None)
        dtype, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype,
                                             cfg.matmul_precision)
        n, d = plan.shape
        rows, cols = plan.rows, plan.cols
        x = plan.x_vals.astype(acc)
        m = plan.m_vals.astype(acc)

        def seg_cols(data):
            return jax.ops.segment_sum(data, cols, num_segments=d)

        def seg_rows(data):
            return jax.ops.segment_sum(data, rows, num_segments=n,
                                       indices_are_sorted=True)

        # masked residual carry at observed entries, refreshed each sweep
        # (drift bounded to one sweep, like the dense masked MR carry)
        r = m * (x - _predicted_obs(rows, cols, W, T, acc))

        def _rank_one_patch(r, w_a, t_a, w_b, t_b):
            """r += m · (w_a[rows]·t_a[cols] − w_b[rows]·t_b[cols])."""
            return r + m * (w_a.astype(acc)[rows] * t_a.astype(acc)[cols]
                            - w_b.astype(acc)[rows] * t_b.astype(acc)[cols])

        def _check_reset(W, T, r, t, key, resets_left, alive_vec):
            """Shared T/W-phase reset check (reference ``nmf.py:750-816``
            'random' branch): on a dead row/column with budget left, draw
            a fresh topic and rank-one-patch the carried residual —
            O(nnz), where the dense masked path rebuilds MR in O(ndk)."""
            if method is None:
                return W, T, r, key, resets_left
            alive = jnp.sum(alive_vec) > 1e-10
            do_reset = jnp.logical_and(jnp.logical_not(alive),
                                       resets_left > 0)
            row, col, key = lax.cond(
                do_reset,
                lambda: _reset_rowcol(plan, W, T, t, key, reset_key),
                lambda: (T[t], W[:, t], key))
            t_pre = T[t]
            w_pre = W[:, t]
            W = W.at[:, t].set(col)
            T = T.at[t].set(row)
            resets_left = resets_left - do_reset.astype(resets_left.dtype)
            r = lax.cond(
                do_reset,
                lambda: _rank_one_patch(r, w_pre, t_pre, W[:, t], T[t]),
                lambda: r)
            return W, T, r, key, resets_left

        def topic_body(t, carry):
            W, T, r, key, resets_left = carry

            # ---- T-phase (reference nmf.py:687-714, O(nnz) form) ----
            if not cfg.fix_T:
                w = W[:, t]
                wr = w.astype(acc)[rows]
                nw = seg_cols(wr * wr * m)                        # (d,)
                wR = seg_cols(wr * r) + T[t].astype(acc) * nw     # (d,)

                if cfg.dp_sigma is not None:
                    # Gaussian mechanism on the T numerator/denominator
                    # (reference nmf.py:422-435; same draws as the dense
                    # masked sweep — shapes and key schedule identical)
                    key, k1, k2 = jax.random.split(key, 3)
                    wR = wR + cfg.dp_sigma * jax.random.normal(
                        k1, wR.shape, wR.dtype)
                    nw = jnp.maximum(
                        nw + cfg.dp_sigma * jax.random.normal(
                            k2, nw.shape, wR.dtype), 0.0)

                numer = wR - cfg.reg_t_l1
                denom = nw + cfg.reg_t_l2
                t_new, nt1 = qf_min_vector_c(
                    -numer, denom, s=cfg.t_update_s, ub=cfg.t_row_sum)

                t_old = T[t]
                if cfg.scale_transfer:
                    W = W.at[:, t].multiply(nt1.astype(dtype))
                    wr_eff = wr * nt1.astype(acc)
                else:
                    wr_eff = wr
                t_stored = t_new.astype(dtype)
                if cfg.t_row_sum and cfg.project_T_each_iter:
                    # drift reprojection hoisted BEFORE the residual
                    # bookkeeping (same as the dense masked sweep — a
                    # post-hoc reprojection would leave r stale by the
                    # projection delta for the rest of the sweep)
                    _pred = (jnp.sum(t_stored) > 1e-10
                             if method is not None else None)
                    t_stored = reproject_row_if_drifted(
                        t_stored, cfg.t_row_sum, dtype, extra_pred=_pred)
                T = T.at[t].set(t_stored)
                r = r + m * (wr * t_old.astype(acc)[cols]
                             - wr_eff * t_stored.astype(acc)[cols])
                W, T, r, key, resets_left = _check_reset(
                    W, T, r, t, key, resets_left, T[t])

            # ---- W-phase (reference nmf.py:735-746, O(nnz) form) ----
            if not cfg.fix_W:
                trow = T[t]
                tc = trow.astype(acc)[cols]
                nt = seg_rows(tc * tc * m)                        # (n,)
                w_old = W[:, t]
                Rt = seg_rows(r * tc) + w_old.astype(acc) * nt    # (n,)

                numer = Rt - cfg.reg_w_l1
                denom = nt + cfg.reg_w_l2
                ub = (w_row_sum_vec if cfg.w_row_sum_is_vector
                      else cfg.w_row_sum)
                w_new, _nw1 = qf_min_vector_c(-numer, denom, s=None, ub=ub)

                W = W.at[:, t].set(w_new.astype(dtype))
                r = r + m * ((w_old.astype(acc)
                              - w_new.astype(acc))[rows] * tc)
                W, T, r, key, resets_left = _check_reset(
                    W, T, r, t, key, resets_left, W[:, t])

            return W, T, r, key, resets_left

        W, T, r, key, resets_left = lax.fori_loop(
            0, k, topic_body, (W, T, r, key, resets_left))

        # per-iteration W row projection (reference nmf.py:481-484)
        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
            if cfg.w_row_sum_is_vector:
                s_vec = w_row_sum_vec.astype(W.dtype)
            else:
                s_vec = jnp.full((W.shape[0],), cfg.w_row_sum,
                                 dtype=W.dtype)
            W = jax.vmap(_proj_simplex_core)(W, s_vec)

        return W, T, key, resets_left

    if cfg.matmul_precision is not None:
        _sweep_body = sweep

        def sweep(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _sweep_body(*args)

    return jax.jit(sweep)


def make_masked_sparse_objective(reg_w_l2=0.0, reg_t_l2=0.0,
                                 reg_w_l1=0.0, reg_t_l1=0.0):
    """``0.5 Σ_obs m·(x − (WT))² + regs`` over a :class:`MaskedCOOPlan`.

    The masked objective touches ONLY observed entries (M is zero
    elsewhere), so no n×d product is ever formed — mirrors the
    reference's ``TrueObjComputer`` (``nmf.py:71-94``) with ``Wm`` the
    dense-equivalent of the plan's mask. Padding entries carry m = 0 and
    contribute exactly 0.
    """

    def objective(plan, W, T):
        _, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype)
        pred = _predicted_obs(plan.rows, plan.cols, W, T, acc)
        res = plan.x_vals.astype(acc) - pred
        obj = 0.5 * jnp.sum(plan.m_vals.astype(acc) * res * res)
        Wa = W.astype(acc)
        Ta = T.astype(acc)
        obj = obj + 0.5 * reg_w_l2 * jnp.sum(Wa ** 2)
        obj = obj + 0.5 * reg_t_l2 * jnp.sum(Ta ** 2)
        obj = obj + reg_t_l1 * jnp.sum(jnp.abs(Ta))
        obj = obj + reg_w_l1 * jnp.sum(jnp.abs(Wa))
        return obj

    return jax.jit(objective)
