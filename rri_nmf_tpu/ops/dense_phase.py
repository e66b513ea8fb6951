"""Dense phase sweep: XLA GEMMs plus a Gauss-Seidel topic loop.

A phase-order sweep touches X through exactly two contractions — ``WᵀX``
before the T-phase and ``T Xᵀ`` before the W-phase — which run as plain
XLA GEMMs (cuBLAS on the GPU). Within a phase the other factor is frozen,
so the k per-topic updates need only its k×k Gram ``G``, the numerator
panel ``N`` and the factor panel ``F`` being updated, laid out ``(k, m)``::

    F[t] <- qf_min(N[t] - Σ_{s≠t} G[t,s] F[s], G[t,t])    for t = 0..k-1

The columns of ``F`` are independent within a phase, so Gauss-Seidel on a
column tile is exactly Gauss-Seidel on the whole panel. Two
implementations of that topic loop exist (:func:`gs_panel`):

- ``'xla'`` — :func:`gs_topics_blocked`, the Gram-blocked loop in plain
  JAX. As XLA ops it is k serial steps per phase, each a few small
  kernels; it is the reference the kernel is tested against and the path
  on every backend but the GPU.
- ``'triton'`` — :func:`gs_kernel`, one Pallas kernel through Triton. Each
  program owns a ``(kp, B)`` column tile in registers (``kp`` = k padded
  to a power of two) and runs the whole topic loop on it, reading rows of
  ``G`` and ``N`` from device memory (they stay in L2). The per-topic
  product is a broadcast multiply and a sum over the topic axis, so
  Triton's ``dot`` and its ≥ 16 shape rule never enter. ``'interpret'``
  runs the same kernel in the Pallas interpreter (tests on the CPU).

The per-topic subproblem is branch-free inside the kernel: both ``qf_min``
curvature branches (positive: ``[numer]₊/denom``; concave: the bounded
vertex, reference ``optimization.py:51-74`` with ``s=None``) are computed
and selected with ``jnp.where``. The TM preset's per-topic simplex
projection couples every column of a row, so a projected T-phase always
takes the XLA loop.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from rri_nmf_tpu.matrixops import (EPS_DIV_BY_ZERO, _proj_simplex_core,
                                   reproject_row_if_drifted)
from rri_nmf_tpu.optimization import qf_min_scalar_c
from rri_nmf_tpu.ops.sweep_xla import _gram_block_size, resolve_mixed_dtypes

GS_IMPLS = ('xla', 'triton', 'interpret')


def supports_dense_phase(cfg) -> bool:
    """Whether :func:`make_dense_phase_sweep` covers this config: unmasked
    phase order with no resets, gradient stores or DP noise."""
    return (not cfg.masked
            and cfg.update_order == 'phase'
            and cfg.reset_topic_method is None
            and not cfg.store_gradients
            and cfg.dp_sigma is None)


def _projected_t(cfg) -> bool:
    """Whether the T-phase carries the per-topic simplex projection."""
    return bool(cfg.project_T_each_iter and cfg.t_row_sum
                and not cfg.fix_T)


def gs_topics_blocked(N, F, G, *, k, B, reg_l1, reg_l2, qf_s, qf_ub,
                      reproject_sum, acc, dtype, reps=1, valid_cols=None,
                      col_mask=None):
    """Gram-blocked sequential topic updates over the rows of F (k, m):
    ``F[t] <- qf_min(N[t] - Σ_{s≠t} G[t,s] F[s], G[t,t])``; exact
    Gauss-Seidel (same math as the dense sweep's blocked phases). Shared by
    the dense and sparse phase sweeps and their shard_map'd mesh forms
    (where N, G arrive already psum'd and the columns of F are local).

    ``reproject_sum``: when set, rows whose sum drifted from it are
    re-projected onto the simplex (the per-iteration T projection).

    ``reps``: extra full GS passes over the k topics; N and G are
    constant through the phase, so each pass is another exact cyclic BCD
    sweep (``SweepConfig.inner_reps``).

    Padded-column handling (mesh sweeps hand over padded rows; without it
    simplex projections LEAK mass into the ghost columns — the Duchi
    threshold spreads the sum-deficit uniformly — and negative L1 grows
    them, polluting the next phase's psum'd Gram):

    - ``valid_cols`` (static int): solve/project only the first
      ``valid_cols`` entries of each row, keep ghosts exactly zero —
      bit-identical to the single-device unpadded solve. Use whenever
      the true column count is device-invariant (tp == 1, which the
      support gates guarantee for every projecting config).
    - ``col_mask`` ((m,) bool array, may be traced): zero ghost entries
      after the qf solve. Exact for projection-free configs only (a
      simplex projection must instead exclude ghosts from its support,
      so combining ``col_mask`` with ``qf_s``/``reproject_sum`` is
      rejected); covers tp > 1 where the valid count varies per rank.
    """
    m = F.shape[1]
    mv = m if valid_cols is None else int(valid_cols)
    assert col_mask is None or (qf_s is None and reproject_sum is None), \
        'col_mask cannot express a padded simplex projection; pass ' \
        'valid_cols (tp == 1) instead'
    diag = jnp.diagonal(G)

    def topic_body(i, carry):
        F, C, F0, D, bs = carry
        t = bs + i
        g_blk = lax.dynamic_slice(G, (t, bs), (1, B))[0]
        corr = (C[i] + jnp.dot(g_blk, D)
                - g_blk[i] * F0[i].astype(acc))
        numer = N[t] - corr - reg_l1
        denom = diag[t] + reg_l2
        x, _ = qf_min_scalar_c(-numer[:mv], denom, s=qf_s, ub=qf_ub)
        if mv != m:
            x = jnp.zeros((m,), x.dtype).at[:mv].set(x)
        elif col_mask is not None:
            x = jnp.where(col_mask, x, 0)
        F = F.at[t].set(x.astype(dtype))
        if reproject_sum is not None:
            # drift check over the (mv,) unpadded row only (padding is
            # exactly zero, so the sum is identical to the full row's)
            F = F.at[t, :mv].set(reproject_row_if_drifted(
                F[t, :mv], reproject_sum, dtype))
        D = D.at[i].set((F[t] - F0[i]).astype(acc))
        return F, C, F0, D, bs

    def block_body(bi, F):
        bs = (bi % (k // B)) * B
        Gblk = lax.dynamic_slice(G, (bs, 0), (B, k))
        C = jnp.dot(Gblk, F, preferred_element_type=acc)
        F0 = lax.dynamic_slice(F, (bs, 0), (B, m))
        D = jnp.zeros((B, m), acc)
        F, C, F0, D, bs = lax.fori_loop(
            0, B, topic_body, (F, C, F0, D, bs), unroll=True)
        return F

    return lax.fori_loop(0, reps * (k // B), block_body, F)


# ---------------------------------------------------------------------------
# the Gauss-Seidel kernel (Pallas through Triton)
# ---------------------------------------------------------------------------

def _next_pow2(x):
    return 1 << max(0, int(x) - 1).bit_length()


def gs_tile(k):
    """``(kp, B, num_warps)`` of the kernel at rank ``k``: ``kp`` is k
    padded to a power of two (at least 16), ``B`` the column-tile width.
    A tile of ``kp·B = 16384`` values over four warps measured fastest
    on an H100 at k = 128 and k = 256 (``PERF.md``)."""
    kp = max(16, _next_pow2(k))
    B = max(16, min(128, 16384 // kp))
    return kp, B, 4


def _gs_kernel(*refs, k, reg_l1, reg_l2, bound, ub_is_vector, reps):
    if ub_is_vector:
        G_ref, N_ref, F_ref, ub_ref, out_ref = refs
    else:
        G_ref, N_ref, F_ref, out_ref = refs
    kp = F_ref.shape[0]
    acc = G_ref.dtype
    F = F_ref[...].astype(acc)                             # (kp, B)
    ub = ub_ref[...] if ub_is_vector else bound
    rows = lax.broadcasted_iota(jnp.int32, (kp, 1), 0)

    def topic(t, F):
        g = G_ref[:, pl.ds(t, 1)]                          # (kp, 1) = G[:, t]
        sel = rows == t
        gtt = jnp.sum(jnp.where(sel, g, 0.0))
        # Σ_{s≠t} G[t,s] F[s]: G is symmetric, so column t is row t
        corr = jnp.sum(jnp.where(sel, 0.0, g) * F, axis=0, keepdims=True)
        numer = N_ref[pl.ds(t, 1), :] - corr - reg_l1       # (1, B)
        denom = gtt + reg_l2
        pos = jnp.maximum(numer, 0.0) / (denom + EPS_DIV_BY_ZERO)
        neg = jnp.where(denom - numer < 0, ub, 0.0)
        return jnp.where(sel, jnp.where(denom > 0, pos, neg), F)

    F = lax.fori_loop(0, reps,
                      lambda r, F: lax.fori_loop(0, k, topic, F), F)
    out_ref[...] = F.astype(out_ref.dtype)


def gs_kernel(N, F, G, *, reg_l1, reg_l2, bound, ub=None, reps=1,
              interpret=False):
    """Gauss-Seidel topic loop on a ``(k, m)`` factor panel ``F`` as one
    Pallas kernel through Triton (see the module docstring).

    ``N`` is the ``(k, m)`` numerator panel, ``G`` the ``(k, k)`` Gram of
    the frozen factor, ``bound`` the static upper bound of the concave
    branch and ``ub`` an optional ``(m,)`` per-column bound replacing it.
    The loop runs in the accumulation dtype (float32 for 16-bit storage)
    and stores ``F.dtype``."""
    k, m = F.shape
    kp, B, num_warps = gs_tile(k)
    mpad = -(-m // B) * B
    acc = resolve_mixed_dtypes(F.dtype, F.dtype)[1]
    Gp = jnp.zeros((kp, kp), acc).at[:k, :k].set(G.astype(acc))
    Np = jnp.zeros((kp, mpad), acc).at[:k, :m].set(N.astype(acc))
    Fp = jnp.zeros((kp, mpad), F.dtype).at[:k, :m].set(F)
    tile = pl.BlockSpec((kp, B), lambda j: (0, j))
    in_specs = [pl.BlockSpec((kp, kp), lambda j: (0, 0)), tile, tile]
    args = [Gp, Np, Fp]
    if ub is not None:
        in_specs.append(pl.BlockSpec((1, B), lambda j: (0, j)))
        args.append(jnp.zeros((1, mpad), acc).at[0, :m].set(
            ub.reshape(-1).astype(acc)))
    out = pl.pallas_call(
        partial(_gs_kernel, k=k, reg_l1=float(reg_l1),
                reg_l2=float(reg_l2), bound=float(bound),
                ub_is_vector=ub is not None, reps=int(reps)),
        grid=(mpad // B,),
        in_specs=in_specs,
        out_specs=tile,
        out_shape=jax.ShapeDtypeStruct((kp, mpad), F.dtype),
        backend='triton',
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name='rri_gs_topics',
    )(*args)
    return out[:k, :m]


def gs_panel(N, F, G, *, impl, k, reg_l1, reg_l2, ub, acc, dtype, reps=1,
             qf_s=None, reproject_sum=None):
    """One phase's topic loop on the ``(k, m)`` panel ``F`` by ``impl``
    (``'xla'``, ``'triton'`` or ``'interpret'``). ``ub`` is the concave
    branch's bound: None, a static float, or an ``(m,)`` array. A
    projected phase (``qf_s``/``reproject_sum``) always runs the XLA
    loop."""
    if impl not in GS_IMPLS:
        raise ValueError('gs impl must be one of %s, got %r'
                         % (GS_IMPLS, impl))
    if impl == 'xla' or qf_s is not None or reproject_sum is not None:
        return gs_topics_blocked(
            N, F, G, k=k, B=_gram_block_size(k), reg_l1=reg_l1,
            reg_l2=reg_l2, qf_s=qf_s, qf_ub=ub,
            reproject_sum=reproject_sum, acc=acc, dtype=dtype, reps=reps)
    vec = ub is not None and not isinstance(ub, (int, float))
    return gs_kernel(N, F, G, reg_l1=reg_l1, reg_l2=reg_l2,
                     bound=float('inf') if (ub is None or vec) else ub,
                     ub=ub if vec else None, reps=reps,
                     interpret=impl == 'interpret')


def phase_bounds(cfg):
    """Static concave-branch bounds ``(t_bound, w_bound)`` of a config
    (None = unbounded; a per-row ``w_row_sum`` vector arrives traced)."""
    t_bound = float(cfg.t_row_sum) if cfg.t_row_sum else None
    w_bound = (float(cfg.w_row_sum)
               if (cfg.w_row_sum is not None
                   and not cfg.w_row_sum_is_vector) else None)
    return t_bound, w_bound


@lru_cache(maxsize=16)
def make_dense_phase_sweep(cfg, gs='xla'):
    """Build the dense phase sweep (XLA GEMMs + the ``gs`` topic loop).
    Same call signature as :func:`rri_nmf_tpu.ops.sweep_xla.make_sweep`
    for supported configs::

        sweep(X, W, T, key, resets_left, reset_key[, w_row_sum_vec])
            -> (W, T, key, resets_left)

    ``X`` may be a :class:`~rri_nmf_tpu.ops.quantized.QuantizedX`: its
    column scale folds into the two GEMMs, so the topic loop never sees
    the storage format.
    """
    assert supports_dense_phase(cfg), \
        'config not supported by the dense phase sweep'
    if gs not in GS_IMPLS:
        raise ValueError('gs must be one of %s, got %r' % (GS_IMPLS, gs))
    k = cfg.k
    t_bound, w_bound = phase_bounds(cfg)
    proj_t = _projected_t(cfg)

    def sweep(X, W, T, key, resets_left, reset_key, *extras):
        from rri_nmf_tpu.ops.quantized import (
            QuantizedX, qx_t_numerator, qx_w_numerator)
        qx = X if isinstance(X, QuantizedX) else None
        w_row_sum_vec = (extras[0].reshape(-1)
                         if cfg.w_row_sum_is_vector else None)
        n = X.shape[0]
        # Mixed storage: the factor dtype follows W/T, not X
        # (resolve_mixed_dtypes has the x_narrow rules)
        dtype, acc, x_narrow = resolve_mixed_dtypes(
            X.dtype, W.dtype, cfg.matmul_precision)

        if not cfg.fix_T:
            G = jnp.dot(W.T, W, preferred_element_type=acc)
            if qx is not None:
                WX = qx_t_numerator(W, qx, acc)               # (k, d)
            else:
                Wx = W.astype(X.dtype) if x_narrow else W
                WX = lax.dot_general(Wx, X, (((0,), (0,)), ((), ())),
                                     preferred_element_type=acc)
            T = gs_panel(WX, T, G, impl=gs, k=k, reg_l1=cfg.reg_t_l1,
                         reg_l2=cfg.reg_t_l2, ub=t_bound, acc=acc,
                         dtype=dtype, reps=cfg.inner_reps,
                         qf_s=cfg.t_row_sum if proj_t else None,
                         reproject_sum=cfg.t_row_sum if proj_t else None)

        if not cfg.fix_W:
            G2 = jnp.dot(T, T.T, preferred_element_type=acc)
            # (k, n) directly — no transpose of the GEMM output needed
            if qx is not None:
                XTt = qx_w_numerator(T, qx, acc)
            else:
                Tx = T.astype(X.dtype) if x_narrow else T
                XTt = lax.dot_general(Tx, X, (((1,), (1,)), ((), ())),
                                      preferred_element_type=acc)
            ub = w_row_sum_vec if cfg.w_row_sum_is_vector else w_bound
            W = gs_panel(XTt, W.T, G2, impl=gs, k=k, reg_l1=cfg.reg_w_l1,
                         reg_l2=cfg.reg_w_l2, ub=ub, acc=acc, dtype=dtype,
                         reps=cfg.inner_reps).T

        # per-iteration W row projection (reference nmf.py:481-484)
        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
            if cfg.w_row_sum_is_vector:
                s_vec = w_row_sum_vec.astype(dtype)
            else:
                s_vec = jnp.full((n,), cfg.w_row_sum, dtype=dtype)
            W = jax.vmap(_proj_simplex_core)(W, s_vec)

        return W, T, key, resets_left

    if cfg.matmul_precision is not None:
        _sweep_body = sweep

        def sweep(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _sweep_body(*args)

    return jax.jit(sweep)
