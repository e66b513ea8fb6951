"""Gram-tensor phase-order sweep for the sparse-mask WRRI path.

The O(nnz) interleaved masked sweep (``ops/sweep_masked_sparse.py``)
carries the observed-entry residual and pays, per topic, two O(nnz)
gathers and two O(nnz) segment-sums, k times per phase.

This module is the Gram-tensor reformulation, available under
``update_order='phase'``. In phase order (all T-row updates, then all
W-column updates — the order the dense Gram-blocked sweep uses,
``ops/sweep_xla.py``) the *other* factor is frozen for a whole phase:
the scale transfer is disabled in phase order (see
``SweepConfig.scale_transfer``) and topic resets are not supported here,
so W is constant through the T-phase and T through the W-phase. Every
per-topic masked quantity then factors through two *weighted Gram
tensors* computed once per phase (per Ho's Lemma 6.5, the same identity
the interleaved sweep uses per entry — reference ``nmf.py:702-705``):

    Γ[t, s] = (w_t ⊙ w_s)ᵀ M   ∈ R^d        (T-phase, (k, k, d))
    Θ[t, s] = M (t_t ⊙ t_s)    ∈ R^n        (W-phase, (k, k, n))

With  A = Wᵀ(M ⊙ X)  (k, d)  and  C = (M ⊙ X) Tᵀ  (k, n):

    T-update numerator_t = A[t] − Σ_{s≠t} Γ[t, s] ⊙ T_cur[s]
    T-update denominator = Γ[t, t] = (w_t²)ᵀ M
    W-update numerator_t = C[t] − Σ_{s≠t} Θ[t, s] ⊙ W_cur[:, s]
    W-update denominator = Θ[t, t] = M t_t²

The Gauss-Seidel corrections use the CURRENT (partially updated) factor,
so every update remains an exact coordinate minimization — monotone
descent holds exactly as for the interleaved order; only the cyclic
order differs. The per-topic work is pure dense vector math (k·d or k·n
multiply-adds), and ALL O(nnz) work collapses into two segment-sum
contractions per phase: A and Γ from one pass over the observations
(k + k² values per observation, chunked so the O(nnz·k²) temporaries
stay bounded), C and Θ from another. Memory is O(nnz + k²(n + d)): the
Gram tensors cap the economical k; past the device budget
(:func:`gram_budget_bytes`) Γ/Θ are built and consumed in k-panels. The
objective also factors through the same tensors::

    ‖√M ⊙ (X − WT)‖² = Σ m x² − 2·Σ_t w_tᵀ C[t] + Σ_{t,s} w_tᵀ Θ[t,s] w_s

so a Gram-backed objective evaluation costs one Θ + one C contraction
instead of the O(nnz·k) gather chain in
``make_masked_sparse_objective``.

Reference parity: the reference's masked path is interleaved-only
(``nmf.py:687-746``); phase order is this library's documented
alternative cyclic order (same fixed points, same subproblems — see the
dense phase sweep's rationale in ``ops/sweep_xla.py``). Parity against a
NumPy phase-order masked oracle is pinned at 1e-10 f64 in
``tests/test_masked_gram.py``.
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
from rri_nmf_tpu.ops.sweep_masked_sparse import MaskedCOOPlan
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, resolve_mixed_dtypes

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class MaskedGramPlan:
    """Observed-set plan for the Gram-phase masked sweep: the sorted COO
    observation arrays (``coo``, also the pickle/round-trip source and
    the gather objective's input) and the static ``Σ m x²`` objective
    constant ``sum_mx2``."""
    coo: MaskedCOOPlan
    sum_mx2: jnp.ndarray           # () device scalar: Σ m x²
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.coo, self.sum_mx2), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, shape=aux[0], nnz=aux[1])

    def to_scipy(self):
        return self.coo.to_scipy()


def plan_masked_gram(X, W_mat, dtype):
    """Build a :class:`MaskedGramPlan` from scipy-sparse ``W_mat`` (and a
    dense or scipy-sparse ``X``)."""
    from rri_nmf_tpu.ops.sweep_masked_sparse import masked_coo_host_arrays
    rows_h, cols_h, x_np, m_np, shape, nz = \
        masked_coo_host_arrays(X, W_mat, dtype)
    coo = MaskedCOOPlan(
        rows=jnp.asarray(rows_h), cols=jnp.asarray(cols_h),
        x_vals=jnp.asarray(x_np), m_vals=jnp.asarray(m_np),
        shape=shape, nnz=nz)
    # padding entries carry m = x = 0 → contribute 0 to every sum
    sum_mx2 = jnp.asarray(
        np.float64(m_np).dot(np.float64(x_np) ** 2),
        dtype=jnp.promote_types(dtype, jnp.float32))
    return MaskedGramPlan(coo=coo, sum_mx2=sum_mx2, shape=coo.shape,
                          nnz=nz)


# share of the device memory the full Γ/Θ tensors may take; past it the
# sweep tiles them in k-panels
GRAM_BUDGET_FRACTION = 0.25


def gram_budget_bytes():
    """Γ/Θ budget: :data:`GRAM_BUDGET_FRACTION` of the device memory."""
    from rri_nmf_tpu.ops.capability import memory_budget_bytes
    return memory_budget_bytes(GRAM_BUDGET_FRACTION)


def auto_panel(k, n, d, itemsize, budget=None):
    """Pick the Γ/Θ tiling for a (n, d) masked problem at rank k.

    Returns ``None`` when the full (k², n+d) tensors fit ``budget``
    (default :func:`gram_budget_bytes`, read at call time) — the
    full-tensor path; a panel size ``1 ≤ p < k`` when only (p·k, n+d)
    tiles fit; or ``0`` when even a single panel row exceeds the
    budget (caller declines the Gram path)."""
    if budget is None:
        budget = gram_budget_bytes()
    unit = k * float(n + d) * itemsize
    if k * unit <= budget:
        return None
    return int(min(k - 1, budget // max(unit, 1.0)))


def supports_masked_gram(cfg: SweepConfig) -> bool:
    """Config coverage of the Gram-phase masked sweep: phase order with
    no resets (a mid-phase reset would rewrite a frozen factor and
    invalidate Γ/Θ) and no gradient stores. DP noise and ``inner_reps``
    ARE supported: A/Γ (resp. C/Θ) depend only on the frozen factor, so
    extra Gauss-Seidel passes reuse them exactly."""
    return (cfg.masked and cfg.masked_sparse
            and cfg.update_order == 'phase'
            and cfg.reset_topic_method is None
            and not cfg.store_gradients)


# ---------------------------------------------------------------------------
# segment-sum contractions
# ---------------------------------------------------------------------------

def _seg_gram_t_A(plan, W, acc):
    coo = plan.coo
    n, d = plan.shape
    k = W.shape[1]
    Wa = W.astype(acc)

    def vals(rows, cols, m, x):
        return Wa[rows] * (m.astype(acc) * x.astype(acc))[:, None]

    return _seg_chunked(coo, vals, d, coo.cols, k, acc).T


def _seg_gram_t_panel(plan, W, t0, p, acc):
    coo = plan.coo
    n, d = plan.shape
    k = W.shape[1]
    Wa = W.astype(acc)

    def vals(rows, cols, m, x):
        P = Wa[rows]                                   # (chunk, k)
        KR = (P[:, t0:t0 + p, None] * P[:, None, :]).reshape(-1, p * k)
        return KR * m.astype(acc)[:, None]

    out = _seg_chunked(coo, vals, d, coo.cols, p * k, acc)
    return out.T.reshape(p, k, d)


def _seg_gram_w_C(plan, T, acc):
    coo = plan.coo
    n, d = plan.shape
    k = T.shape[0]
    Ta = T.astype(acc)

    def vals(rows, cols, m, x):
        return Ta[:, cols].T * (m.astype(acc) * x.astype(acc))[:, None]

    return _seg_chunked(coo, vals, n, coo.rows, k, acc).T


def _seg_gram_w_panel(plan, T, t0, p, acc):
    coo = plan.coo
    n, d = plan.shape
    k = T.shape[0]
    Ta = T.astype(acc)

    def vals(rows, cols, m, x):
        P = Ta[:, cols].T                              # (chunk, k)
        KR = (P[:, t0:t0 + p, None] * P[:, None, :]).reshape(-1, p * k)
        return KR * m.astype(acc)[:, None]

    out = _seg_chunked(coo, vals, n, coo.rows, p * k, acc)
    return out.T.reshape(p, k, n)


# observation-chunk size for the segment sums' O(nnz·k²) temporaries
_SEG_CHUNK = 1 << 16


def _seg_chunked(coo, k2_fn, out_dim, seg_ids, width, acc):
    """Segment-sum ``k2_fn(slice) -> (chunk, width)`` over observation
    chunks into ``(out_dim, width)`` — bounds the (nnz, k²) temporary to
    ``_SEG_CHUNK`` rows. nnz_pad is a multiple of ``_PAD_TO``; the loop
    covers full chunks and one remainder slice (padding entries carry
    m = 0 and vanish)."""
    nnz = int(coo.rows.shape[0])
    chunk = min(_SEG_CHUNK, nnz)
    full = nnz // chunk

    def blk(i, out):
        sl = (i * chunk,)
        vals = k2_fn(lax.dynamic_slice(coo.rows, sl, (chunk,)),
                     lax.dynamic_slice(coo.cols, sl, (chunk,)),
                     lax.dynamic_slice(coo.m_vals, sl, (chunk,)),
                     lax.dynamic_slice(coo.x_vals, sl, (chunk,)))
        ids = lax.dynamic_slice(seg_ids, sl, (chunk,))
        return out.at[ids].add(vals)

    out = lax.fori_loop(0, full, blk,
                        jnp.zeros((out_dim, width), acc))
    rem = nnz - full * chunk
    if rem:
        vals = k2_fn(coo.rows[full * chunk:], coo.cols[full * chunk:],
                     coo.m_vals[full * chunk:], coo.x_vals[full * chunk:])
        out = out.at[seg_ids[full * chunk:]].add(vals)
    return out


def _seg_gram_t(plan, W, acc):
    coo = plan.coo
    n, d = plan.shape
    k = W.shape[1]
    Wa = W.astype(acc)

    def vals(rows, cols, m, x):
        P = Wa[rows]                                  # (chunk, k)
        outer = (P[:, :, None] * P[:, None, :]).reshape(-1, k * k)
        a = P * (m.astype(acc) * x.astype(acc))[:, None]
        return jnp.concatenate(
            [a, outer * m.astype(acc)[:, None]], axis=1)

    out = _seg_chunked(coo, vals, d, coo.cols, k + k * k, acc)
    A = out[:, :k].T
    G = out[:, k:].T.reshape(k, k, d)
    return A, G


def _seg_gram_w(plan, T, acc):
    coo = plan.coo
    n, d = plan.shape
    k = T.shape[0]
    Ta = T.astype(acc)

    def vals(rows, cols, m, x):
        P = Ta[:, cols].T                             # (chunk, k)
        outer = (P[:, :, None] * P[:, None, :]).reshape(-1, k * k)
        c = P * (m.astype(acc) * x.astype(acc))[:, None]
        return jnp.concatenate(
            [c, outer * m.astype(acc)[:, None]], axis=1)

    out = _seg_chunked(coo, vals, n, coo.rows, k + k * k, acc)
    C = out[:, :k].T
    H = out[:, k:].T.reshape(k, k, n)
    return C, H


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def make_masked_gram_sweep(cfg: SweepConfig,
                           panel: Optional[int] = None):
    """Build the jitted Gram-phase masked sweep. Same call signature as
    ``make_masked_sparse_sweep``::

        sweep(plan, W, T, key, resets_left, reset_key[, w_row_sum_vec])
            -> (W, T, key, resets_left)

    ``resets_left`` passes through untouched (no resets on this path).

    ``panel``: when set (1 ≤ panel < k), Γ/Θ are built and consumed in
    (panel, k, ·) tiles instead of whole (k², ·) tensors — peak Gram
    memory drops from ``k²(n+d)`` to ``panel·k·max(n, d)`` words, so k
    is no longer capped by the full-tensor budget. Each panel's Gauss-Seidel corrections read the CURRENT
    partially-updated factor, so the updates are bitwise the same
    coordinate minimizations as the full-tensor path (parity pinned in
    tests/test_masked_gram.py). Cost: the mask chunk stream is
    contracted k/panel times per phase (the full path streams it
    once).
    """
    assert supports_masked_gram(cfg), \
        'config not supported by the Gram-phase masked sweep'
    k = cfg.k
    if panel is not None and not (1 <= panel < k):
        raise ValueError('panel must satisfy 1 <= panel < k')
    if panel is not None:
        return _make_panel_sweep(cfg, panel)

    def sweep(plan, W, T, key, resets_left, reset_key, *extras):
        w_row_sum_vec = (extras[0].reshape(-1)
                         if cfg.w_row_sum_is_vector else None)
        dtype, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype,
                                             cfg.matmul_precision)

        # ---- T-phase: W frozen (no scale transfer in phase order, no
        # resets here) → A and Γ exact for the whole phase -------------
        if not cfg.fix_T:
            A, G = _seg_gram_t(plan, W, acc)

            def t_topic(i, carry):
                T, key = carry
                t = i % k
                Gt = lax.dynamic_slice(
                    G, (t, 0, 0), (1, k, G.shape[2]))[0]      # (k, d)
                corr = jnp.sum(Gt * T.astype(acc), axis=0) \
                    - Gt[t] * T[t].astype(acc)
                wR = A[t] - corr
                nw = Gt[t]
                if cfg.dp_sigma is not None:
                    # Gaussian mechanism on the T numerator/denominator
                    # (reference nmf.py:422-435), drawn per topic in
                    # phase order
                    key, k1, k2 = jax.random.split(key, 3)
                    wR = wR + cfg.dp_sigma * jax.random.normal(
                        k1, wR.shape, wR.dtype)
                    nw = jnp.maximum(
                        nw + cfg.dp_sigma * jax.random.normal(
                            k2, nw.shape, wR.dtype), 0.0)
                numer = wR - cfg.reg_t_l1
                denom = nw + cfg.reg_t_l2
                t_new, _nt1 = qf_min_vector_c(
                    -numer, denom, s=cfg.t_update_s, ub=cfg.t_row_sum)
                t_stored = t_new.astype(dtype)
                if cfg.t_row_sum and cfg.project_T_each_iter:
                    t_stored = reproject_row_if_drifted(
                        t_stored, cfg.t_row_sum, dtype)
                return T.at[t].set(t_stored), key

            T, key = lax.fori_loop(0, cfg.inner_reps * k, t_topic,
                                   (T, key))

        # ---- W-phase: T frozen → C and Θ exact ------------------------
        if not cfg.fix_W:
            C, H = _seg_gram_w(plan, T, acc)

            def w_topic(i, carry):
                W, key = carry
                t = i % k
                Ht = lax.dynamic_slice(
                    H, (t, 0, 0), (1, k, H.shape[2]))[0]      # (k, n)
                corr = jnp.sum(Ht * W.T.astype(acc), axis=0) \
                    - Ht[t] * W[:, t].astype(acc)
                Rt = C[t] - corr
                nt = Ht[t]
                numer = Rt - cfg.reg_w_l1
                denom = nt + cfg.reg_w_l2
                ub = (w_row_sum_vec if cfg.w_row_sum_is_vector
                      else cfg.w_row_sum)
                w_new, _nw1 = qf_min_vector_c(-numer, denom, s=None,
                                              ub=ub)
                return W.at[:, t].set(w_new.astype(dtype)), key

            W, key = lax.fori_loop(0, cfg.inner_reps * k, w_topic,
                                   (W, key))

        # per-iteration W row projection (reference nmf.py:481-484)
        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None
                     or cfg.w_row_sum_is_vector)):
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


def _make_panel_sweep(cfg: SweepConfig, panel: int):
    """Panel-tiled Gram-phase sweep body (see make_masked_gram_sweep):
    static python loops over reps and k-panels, a fori_loop inside each
    panel. The contraction tiles Γ[t0:t0+p] depend only on the FROZEN
    factor, so slicing the phase into panels changes nothing about the
    Gauss-Seidel sequence — topic t still reads every other topic's
    current value through its own Γ/Θ row."""
    k = cfg.k

    def sweep(plan, W, T, key, resets_left, reset_key, *extras):
        w_row_sum_vec = (extras[0].reshape(-1)
                         if cfg.w_row_sum_is_vector else None)
        dtype, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype,
                                             cfg.matmul_precision)

        if not cfg.fix_T:
            A = _seg_gram_t_A(plan, W, acc)
            for _rep in range(cfg.inner_reps):
                for t0 in range(0, k, panel):
                    p = min(panel, k - t0)
                    # sequencing barrier: the panel contraction reads
                    # only the FROZEN W, so without a dependency on the
                    # previous panel's topic loop XLA hoists ALL panel
                    # contractions to the front and every Γ panel is
                    # live at once — 18.8 GB at k=256 (52 panels) on
                    # the record shape. Threading (T, key) through the
                    # barrier caps residency at one panel (identity on
                    # values; the bitwise panel-parity tests pin that).
                    (T, key), W_seq = lax.optimization_barrier(
                        ((T, key), W))
                    Gpan = _seg_gram_t_panel(plan, W_seq, t0, p, acc)

                    def t_topic(j, carry, t0=t0, Gpan=Gpan):
                        T, key = carry
                        t = t0 + j
                        Gt = lax.dynamic_slice(
                            Gpan, (j, 0, 0),
                            (1, k, Gpan.shape[2]))[0]      # (k, d)
                        corr = jnp.sum(Gt * T.astype(acc), axis=0) \
                            - Gt[t] * T[t].astype(acc)
                        wR = A[t] - corr
                        nw = Gt[t]
                        if cfg.dp_sigma is not None:
                            key, k1, k2 = jax.random.split(key, 3)
                            wR = wR + cfg.dp_sigma * jax.random.normal(
                                k1, wR.shape, wR.dtype)
                            nw = jnp.maximum(
                                nw + cfg.dp_sigma * jax.random.normal(
                                    k2, nw.shape, wR.dtype), 0.0)
                        numer = wR - cfg.reg_t_l1
                        denom = nw + cfg.reg_t_l2
                        t_new, _nt1 = qf_min_vector_c(
                            -numer, denom, s=cfg.t_update_s,
                            ub=cfg.t_row_sum)
                        t_stored = t_new.astype(dtype)
                        if cfg.t_row_sum and cfg.project_T_each_iter:
                            t_stored = reproject_row_if_drifted(
                                t_stored, cfg.t_row_sum, dtype)
                        return T.at[t].set(t_stored), key

                    T, key = lax.fori_loop(0, p, t_topic, (T, key))

        if not cfg.fix_W:
            C = _seg_gram_w_C(plan, T, acc)
            for _rep in range(cfg.inner_reps):
                for t0 in range(0, k, panel):
                    p = min(panel, k - t0)
                    # same sequencing barrier as the T-phase (Θ panels
                    # read only the frozen T)
                    (W, key), T_seq = lax.optimization_barrier(
                        ((W, key), T))
                    Hpan = _seg_gram_w_panel(plan, T_seq, t0, p, acc)

                    def w_topic(j, carry, t0=t0, Hpan=Hpan):
                        W, key = carry
                        t = t0 + j
                        Ht = lax.dynamic_slice(
                            Hpan, (j, 0, 0),
                            (1, k, Hpan.shape[2]))[0]      # (k, n)
                        corr = jnp.sum(Ht * W.T.astype(acc), axis=0) \
                            - Ht[t] * W[:, t].astype(acc)
                        Rt = C[t] - corr
                        nt = Ht[t]
                        numer = Rt - cfg.reg_w_l1
                        denom = nt + cfg.reg_w_l2
                        ub = (w_row_sum_vec if cfg.w_row_sum_is_vector
                              else cfg.w_row_sum)
                        w_new, _nw1 = qf_min_vector_c(
                            -numer, denom, s=None, ub=ub)
                        return W.at[:, t].set(w_new.astype(dtype)), key

                    W, key = lax.fori_loop(0, p, w_topic, (W, key))

        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None
                     or cfg.w_row_sum_is_vector)):
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


def make_masked_gram_objective(reg_w_l2=0.0, reg_t_l2=0.0,
                               reg_w_l1=0.0, reg_t_l1=0.0,
                               panel=None):
    """Masked objective through the Gram identity::

        ‖√M ⊙ (X − WT)‖² = Σ m x² − 2 Σ_t w_tᵀ C[t]
                           + Σ_{t,s} w_tᵀ Θ[t,s] w_s

    One C + one Θ contraction per evaluation instead of the O(nnz·k) gather stream of
    ``make_masked_sparse_objective``. Exact (same bilinear form); the
    f32 Gram route and the gather route agree to accumulation roundoff.
    ``panel``: accumulate the quadratic form in (panel, k, n) Θ tiles
    (matching the panel sweep's memory ceiling) instead of the whole
    (k², n) tensor.
    """
    def objective(plan, W, T):
        _, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype)
        Wa = W.astype(acc)
        if panel is None:
            C, H = _seg_gram_w(plan, T, acc)
            cross = jnp.sum(C * Wa.T)
            quad = jnp.einsum('tsi,it,is->', H, Wa, Wa)
        else:
            k = T.shape[0]
            C = _seg_gram_w_C(plan, T, acc)
            cross = jnp.sum(C * Wa.T)
            quad = jnp.zeros((), acc)
            for t0 in range(0, k, panel):
                p = min(panel, k - t0)
                # sequencing barrier: each Θ panel reads only the
                # frozen T, so without a dependency on the running
                # accumulator the scheduler hoists every panel live at
                # once (the panel-sweep 18.8 GB failure mode)
                quad, T_seq = lax.optimization_barrier((quad, T))
                Hpan = _seg_gram_w_panel(plan, T_seq, t0, p, acc)
                quad = quad + jnp.einsum(
                    'tsi,it,is->', Hpan, Wa[:, t0:t0 + p], Wa)
        obj = 0.5 * (plan.sum_mx2 - 2.0 * cross + quad)
        Ta = T.astype(acc)
        obj = obj + 0.5 * reg_w_l2 * jnp.sum(Wa ** 2)
        obj = obj + 0.5 * reg_t_l2 * jnp.sum(Ta ** 2)
        obj = obj + reg_t_l1 * jnp.sum(jnp.abs(Ta))
        obj = obj + reg_w_l1 * jnp.sum(jnp.abs(Wa))
        return obj

    return jax.jit(objective)
