"""Mesh-sharded Gram-phase masked (WRRI) sweep.

Distribution of :mod:`rri_nmf_tpu.ops.sweep_masked_gram` (see that module
for the Gram-tensor algebra): the Gram path on a ``(dp, 1)`` mesh, in
place of the interleaved O(nnz) mesh sweep
(``parallel/masked_sparse_mesh.py``) and its per-topic
gather/segment-sum streams.

Layout — identical to the interleaved masked mesh sweep:

- observations partitioned by ROW block: device ``i`` owns the entries
  with ``row // n_loc == i``, stored with LOCAL row indices and global
  column indices (mask/value padding entries carry ``m = x = 0`` and
  vanish from every contraction);
- ``W`` row-sharded ``P(dp, None)``, ``T`` replicated; the mesh must be
  ``(n_devices, 1)``.

Communication — ONE psum per T-phase, NOTHING in the W-phase:

- The T-phase tensors ``A = Wᵀ(M⊙X)`` (k, d) and
  ``Γ[t,s] = (w_t ⊙ w_s)ᵀ M`` (k(k+1)/2 unique pairs, d) are
  column-keyed sums over observations, so each device contracts its row
  block against its local W rows and ONE ``psum`` of the stacked
  ``(k + k(k+1)/2, d)`` partials replicates them; the whole T-phase
  Gauss-Seidel loop then runs replicated (pure dense vector math,
  identical on every device — the same pattern as the interleaved mesh
  sweep's T rows, but ONE collective per PHASE instead of one per
  TOPIC).
- The W-phase tensors ``C = (M⊙X)Tᵀ`` and ``Θ[t,s] = M (t_t ⊙ t_s)``
  are row-keyed: fully device-local under row partitioning. The W-phase
  moves ZERO bytes between devices.

So a sweep's collective traffic is ``(k + k(k+1)/2) · d`` accumulator
words, independent of nnz and of n — the Γ/Θ segment sums themselves are
embarrassingly row-parallel. Γ and Θ are symmetric in (t, s), so only
the k(k+1)/2 unique pairs are contracted.

Restrictions beyond the single-device Gram sweep: no per-row
``w_row_sum`` vector (it would need dp-aligned padding), matching the
interleaved masked mesh sweep's contract. Parity with the single-device
Gram sweep is pinned at 1e-12 f64 on the 8-device virtual mesh in
``tests/test_masked_gram_mesh.py``.

Reference anchor: the reference's masked path is a single-process
interleaved loop (``/root/reference/src/rri_nmf/nmf.py:687-746``); it
has no distributed form — this layer is blueprint mandate (SURVEY §2.2),
not reference parity.
"""

from functools import lru_cache
from typing import Optional, Tuple

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

try:
    from jax import shard_map              # jax >= 0.8
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from rri_nmf_tpu.matrixops import (_proj_simplex_core,
    reproject_row_if_drifted)
from rri_nmf_tpu.optimization import qf_min_vector_c
from rri_nmf_tpu.ops.sweep_masked_sparse import _PAD_TO
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, resolve_mixed_dtypes
from rri_nmf_tpu.parallel.masked_sparse_mesh import ShardedMaskedCOO

# observation-chunk size for the segment sums' (chunk, k²) temporaries
_SEG_CHUNK = 1 << 16


@lru_cache(maxsize=32)
def _sym_pairs(k):
    """Static index maps for the symmetric Gram trick: Γ[t, s] = Γ[s, t]
    (and Θ likewise), so only the k(k+1)/2 unique (t ≤ s) Khatri-Rao
    rows are contracted and the full (k, k, ·) tensor is reconstructed
    by a gather. Returns ``(idx_t, idx_s, unpack)`` with
    ``unpack[t·k+s]`` = the pair row of ``(min(t,s), max(t,s))``. NumPy
    constants (NOT jnp): the first call can happen inside a jit trace,
    and a cached device array created there would leak a tracer into
    every later trace."""
    idx_t, idx_s = np.triu_indices(k)
    pair_of = np.zeros((k, k), np.int32)
    pair_of[idx_t, idx_s] = np.arange(idx_t.size, dtype=np.int32)
    pair_of[idx_s, idx_t] = pair_of[idx_t, idx_s]
    return (idx_t.astype(np.int32), idx_s.astype(np.int32),
            pair_of.reshape(-1))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedMaskedGramPlan:
    """Row-block partitioned observed set: ``coo`` is the
    :class:`ShardedMaskedCOO` block grid, ``sum_mx2`` the replicated
    ``Σ m x²`` scalar."""
    coo: ShardedMaskedCOO
    sum_mx2: jnp.ndarray
    shape: Tuple[int, int]
    n_loc: int
    nnz: int

    def tree_flatten(self):
        return (self.coo, self.sum_mx2), (self.shape, self.n_loc, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, shape=aux[0], n_loc=aux[1], nnz=aux[2])


def partition_masked_gram(X, W_mat, mesh, dtype):
    """Host-side: (X, scipy-sparse W_mat) → :class:`ShardedMaskedGramPlan`
    on ``mesh`` (which must be (dp, 1)). Row-block partition identical to
    :func:`rri_nmf_tpu.parallel.masked_sparse_mesh.partition_masked_coo`."""
    from rri_nmf_tpu.ops.sweep_masked_sparse import masked_coo_host_arrays
    dp_size, tp_size = mesh.devices.shape
    assert tp_size == 1, 'masked Gram mesh sweeps are row-partitioned'
    rows_a, cols_a, x_a, m_a, (n, d), nnz = \
        masked_coo_host_arrays(X, W_mat, dtype)
    rows = rows_a[:nnz].astype(np.int64)
    cols = cols_a[:nnz]
    x = x_a[:nnz]
    m = m_a[:nnz]

    n_loc = -(-n // dp_size)
    # rows arrive CSR-sorted → contiguous per-device slices
    blk = rows // n_loc
    counts = np.bincount(blk, minlength=dp_size)
    starts = np.concatenate([[0], np.cumsum(counts)])
    mmax = max(int(counts.max()), 1)
    mmax += (-mmax) % _PAD_TO

    r_b = np.zeros((dp_size, mmax), dtype=np.int32)
    c_b = np.full((dp_size, mmax), max(d - 1, 0), dtype=np.int32)
    x_b = np.zeros((dp_size, mmax), dtype=dtype)
    m_b = np.zeros((dp_size, mmax), dtype=dtype)
    for b in range(dp_size):
        lo, hi = starts[b], starts[b + 1]
        cnt = hi - lo
        r_b[b, :cnt] = (rows[lo:hi] % n_loc).astype(np.int32)
        c_b[b, :cnt] = cols[lo:hi]
        x_b[b, :cnt] = x[lo:hi]
        m_b[b, :cnt] = m[lo:hi]
        if cnt:
            # sorted-pad (see partition_masked_coo): keep the local row
            # stream non-decreasing for sorted-scatter lowerings
            r_b[b, cnt:] = r_b[b, cnt - 1]

    dp_ax, _tp = mesh.axis_names
    s = NamedSharding(mesh, P(dp_ax, None))
    coo = ShardedMaskedCOO(
        jax.device_put(r_b, s), jax.device_put(c_b, s),
        jax.device_put(x_b, s), jax.device_put(m_b, s),
        shape=(n, d), n_loc=n_loc, nnz=int(rows.shape[0]))
    sum_mx2 = jax.device_put(
        jnp.asarray(np.float64(m).dot(np.float64(x) ** 2),
                    dtype=jnp.promote_types(dtype, jnp.float32)),
        NamedSharding(mesh, P()))
    return ShardedMaskedGramPlan(
        coo=coo, sum_mx2=sum_mx2, shape=(n, d), n_loc=n_loc,
        nnz=int(nnz))


def supports_sharded_masked_gram(cfg: SweepConfig, mesh) -> bool:
    from rri_nmf_tpu.ops.sweep_masked_gram import supports_masked_gram
    return (supports_masked_gram(cfg)
            and not cfg.w_row_sum_is_vector
            and mesh.devices.shape[1] == 1)


# ---------------------------------------------------------------------------
# per-device segment sums (local blocks)
# ---------------------------------------------------------------------------

def _seg_local(rows, cols, x, m, P_of, out_dim, width, seg_local, acc):
    """Chunked local segment-sum: ``P_of(slice) -> (chunk, width)``
    contributions summed into ``(out_dim, width)`` over the observation
    ids ``seg_local`` (bounds the temporary to ``_SEG_CHUNK`` rows)."""
    mloc = int(rows.shape[0])
    chunk = min(_SEG_CHUNK, mloc)
    full = mloc // chunk

    def blk(i, out):
        sl = (i * chunk,)
        vals = P_of(lax.dynamic_slice(rows, sl, (chunk,)),
                    lax.dynamic_slice(cols, sl, (chunk,)),
                    lax.dynamic_slice(m, sl, (chunk,)),
                    lax.dynamic_slice(x, sl, (chunk,)))
        ids = lax.dynamic_slice(seg_local, sl, (chunk,))
        return out.at[ids].add(vals)

    out = lax.fori_loop(0, full, blk, jnp.zeros((out_dim, width), acc))
    rem = mloc - full * chunk
    if rem:
        vals = P_of(rows[full * chunk:], cols[full * chunk:],
                    m[full * chunk:], x[full * chunk:])
        out = out.at[seg_local[full * chunk:]].add(vals)
    return out


def _seg_gram_t_local(rows, cols, x, m, W_l, d, acc):
    """Local (A_part, Γp_part): column-keyed sums over this device's
    observations against its local W rows. Returns the stacked
    ``(k + k(k+1)/2, d)`` partial (psum'd by the caller)."""
    k = W_l.shape[1]
    it, is_, _ = _sym_pairs(k)
    it = jnp.asarray(it)
    is_ = jnp.asarray(is_)
    kp = int(it.shape[0])
    Wa = W_l.astype(acc)

    def vals(r, c, mm, xx):
        Prow = Wa[r]                                  # (chunk, k)
        kr = Prow[:, it] * Prow[:, is_]               # (chunk, kp)
        a = Prow * (mm.astype(acc) * xx.astype(acc))[:, None]
        return jnp.concatenate([a, kr * mm.astype(acc)[:, None]], axis=1)

    out = _seg_local(rows, cols, x, m, vals, d, k + kp, cols, acc)
    return out.T                                       # (k + kp, d)


def _seg_gram_w_local(rows, cols, x, m, T, n_loc, acc):
    """Local (C_l, Θp_l): row-keyed sums — fully device-local."""
    k = T.shape[0]
    it, is_, _ = _sym_pairs(k)
    it = jnp.asarray(it)
    is_ = jnp.asarray(is_)
    kp = int(it.shape[0])
    Ta = T.astype(acc)

    def vals(r, c, mm, xx):
        Prow = Ta[:, c].T                             # (chunk, k)
        kr = Prow[:, it] * Prow[:, is_]
        cpart = Prow * (mm.astype(acc) * xx.astype(acc))[:, None]
        return jnp.concatenate(
            [cpart, kr * mm.astype(acc)[:, None]], axis=1)

    out = _seg_local(rows, cols, x, m, vals, n_loc, k + kp, rows, acc)
    return out.T                                       # (k + kp, n_loc)


def _seg_gram_t_A_local(rows, cols, x, m, W_l, d, acc):
    """Local A partial (k, d) alone (panel mode)."""
    Wa = W_l.astype(acc)

    def vals(r, c, mm, xx):
        return Wa[r] * (mm.astype(acc) * xx.astype(acc))[:, None]

    return _seg_local(rows, cols, x, m, vals, d, W_l.shape[1], cols,
                      acc).T


def _seg_gram_t_panel_local(rows, cols, x, m, W_l, d, t0, p, acc):
    """Local Γ[t0:t0+p] partial (p, k, d) — psum'd by the caller."""
    k = W_l.shape[1]
    Wa = W_l.astype(acc)

    def vals(r, c, mm, xx):
        P = Wa[r]
        KR = (P[:, t0:t0 + p, None] * P[:, None, :]).reshape(-1, p * k)
        return KR * mm.astype(acc)[:, None]

    out = _seg_local(rows, cols, x, m, vals, d, p * k, cols, acc)
    return out.T.reshape(p, k, d)


def _seg_gram_w_C_local(rows, cols, x, m, T, n_loc, acc):
    """Local C (k, n_loc) alone — row-keyed, stays local."""
    Ta = T.astype(acc)

    def vals(r, c, mm, xx):
        return Ta[:, c].T * (mm.astype(acc) * xx.astype(acc))[:, None]

    return _seg_local(rows, cols, x, m, vals, n_loc, T.shape[0], rows,
                      acc).T


def _seg_gram_w_panel_local(rows, cols, x, m, T, n_loc, t0, p, acc):
    """Local Θ[t0:t0+p] (p, k, n_loc) — row-keyed, stays local."""
    k = T.shape[0]
    Ta = T.astype(acc)

    def vals(r, c, mm, xx):
        P = Ta[:, c].T
        KR = (P[:, t0:t0 + p, None] * P[:, None, :]).reshape(-1, p * k)
        return KR * mm.astype(acc)[:, None]

    out = _seg_local(rows, cols, x, m, vals, n_loc, p * k, rows, acc)
    return out.T.reshape(p, k, n_loc)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def make_sharded_masked_gram_sweep(cfg: SweepConfig, mesh,
                                   panel: Optional[int] = None):
    """shard_map'd Gram-phase masked sweep. Driver call signature::

        sweep(plan, W, T, key, resets_left, reset_key) ->
            (W, T, key, resets_left)

    Exactly the single-device Gram sweep's Gauss-Seidel updates (same
    topic order, same qf_min subproblems) — parity at f64 roundoff.

    ``panel``: build Γ/Θ in (panel, k, ·) tiles past the full-tensor
    budget, exactly like the single-device panel sweep
    (``ops.sweep_masked_gram._make_panel_sweep``) — each Γ panel costs
    one psum of (panel·k, d) partials (same total bytes per phase as
    the full-tensor psum), Θ panels stay device-local.
    """
    assert supports_sharded_masked_gram(cfg, mesh), \
        'config not supported by the masked Gram mesh sweep'
    k = cfg.k
    if panel is not None and not (1 <= panel < k):
        raise ValueError('panel must satisfy 1 <= panel < k')
    dp_ax, _tp = mesh.axis_names
    dp_size = mesh.devices.shape[0]
    _, _, unpack = _sym_pairs(k)
    unpack_mat = unpack.reshape(k, k)                  # host np, static

    def _local_panel(rows, cols, x, m, W_l, T, key):
        rows = rows[0]
        cols = cols[0]
        x = x[0]
        m = m[0]
        dtype, acc, _ = resolve_mixed_dtypes(W_l.dtype, W_l.dtype,
                                             cfg.matmul_precision)
        n_loc = W_l.shape[0]
        d = T.shape[1]

        if not cfg.fix_T:
            A = _seg_gram_t_A_local(rows, cols, x, m, W_l, d, acc)
            A = lax.psum(A, dp_ax)
            for _rep in range(cfg.inner_reps):
                for t0 in range(0, k, panel):
                    p = min(panel, k - t0)
                    # sequencing barrier (see _make_panel_sweep): the
                    # contraction reads only the frozen W_l, so without
                    # a dependency on the previous panel's topic loop
                    # the scheduler hoists every Γ panel live at once
                    (T, key), W_seq = lax.optimization_barrier(
                        ((T, key), W_l))
                    Gpan = _seg_gram_t_panel_local(
                        rows, cols, x, m, W_seq, d, t0, p, acc)
                    Gpan = lax.psum(Gpan, dp_ax)

                    def t_topic(j, carry, t0=t0, Gpan=Gpan):
                        T, key = carry
                        t = t0 + j
                        Gt = lax.dynamic_slice(
                            Gpan, (j, 0, 0), (1, k, Gpan.shape[2]))[0]
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
            C = _seg_gram_w_C_local(rows, cols, x, m, T, n_loc, acc)
            for _rep in range(cfg.inner_reps):
                for t0 in range(0, k, panel):
                    p = min(panel, k - t0)
                    # same sequencing barrier (Θ panels read only the
                    # frozen T)
                    (W_l, key), T_seq = lax.optimization_barrier(
                        ((W_l, key), T))
                    Hpan = _seg_gram_w_panel_local(
                        rows, cols, x, m, T_seq, n_loc, t0, p, acc)

                    def w_topic(j, carry, t0=t0, Hpan=Hpan):
                        W_l, key = carry
                        t = t0 + j
                        Ht = lax.dynamic_slice(
                            Hpan, (j, 0, 0), (1, k, Hpan.shape[2]))[0]
                        corr = jnp.sum(Ht * W_l.T.astype(acc), axis=0) \
                            - Ht[t] * W_l[:, t].astype(acc)
                        Rt = C[t] - corr
                        nt = Ht[t]
                        numer = Rt - cfg.reg_w_l1
                        denom = nt + cfg.reg_w_l2
                        w_new, _nw1 = qf_min_vector_c(
                            -numer, denom, s=None, ub=cfg.w_row_sum)
                        return W_l.at[:, t].set(w_new.astype(dtype)), key

                    W_l, key = lax.fori_loop(0, p, w_topic, (W_l, key))

        if (cfg.project_W_each_iter and not cfg.fix_W
                and cfg.w_row_sum is not None):
            s_vec = jnp.full((n_loc,), cfg.w_row_sum, dtype=W_l.dtype)
            W_l = jax.vmap(_proj_simplex_core)(W_l, s_vec)

        return W_l, T, key

    def _local(rows, cols, x, m, W_l, T, key):
        rows = rows[0]
        cols = cols[0]
        x = x[0]
        m = m[0]
        dtype, acc, _ = resolve_mixed_dtypes(W_l.dtype, W_l.dtype,
                                             cfg.matmul_precision)
        n_loc = W_l.shape[0]
        d = T.shape[1]
        upk = jnp.asarray(unpack_mat)

        # ---- T-phase: W frozen → local (A, Γ) partials, ONE psum ------
        if not cfg.fix_T:
            part = _seg_gram_t_local(rows, cols, x, m, W_l, d, acc)
            AG = lax.psum(part, dp_ax)
            A = AG[:k]
            Gp = AG[k:]                                # (kp, d)

            def t_topic(i, carry):
                T, key = carry
                t = i % k
                # Γ[t, :] = Gp[unpack[t]]: gather k pair-rows — never
                # materializes the full (k, k, d) tensor
                idx = lax.dynamic_slice(upk, (t, 0), (1, k))[0]
                Gt = Gp[idx]                           # (k, d)
                corr = jnp.sum(Gt * T.astype(acc), axis=0) \
                    - Gt[t] * T[t].astype(acc)
                wR = A[t] - corr
                nw = Gt[t]
                if cfg.dp_sigma is not None:
                    # replicated key → identical draws on every device
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

        # ---- W-phase: T frozen → (C, Θ) row-keyed, fully local --------
        if not cfg.fix_W:
            CH = _seg_gram_w_local(rows, cols, x, m, T, n_loc, acc)
            C = CH[:k]
            Hp = CH[k:]                                # (kp, n_loc)

            def w_topic(i, carry):
                W_l, key = carry
                t = i % k
                idx = lax.dynamic_slice(upk, (t, 0), (1, k))[0]
                Ht = Hp[idx]                           # (k, n_loc)
                corr = jnp.sum(Ht * W_l.T.astype(acc), axis=0) \
                    - Ht[t] * W_l[:, t].astype(acc)
                Rt = C[t] - corr
                nt = Ht[t]
                numer = Rt - cfg.reg_w_l1
                denom = nt + cfg.reg_w_l2
                w_new, _nw1 = qf_min_vector_c(-numer, denom, s=None,
                                              ub=cfg.w_row_sum)
                return W_l.at[:, t].set(w_new.astype(dtype)), key

            W_l, key = lax.fori_loop(0, cfg.inner_reps * k, w_topic,
                                     (W_l, key))

        if (cfg.project_W_each_iter and not cfg.fix_W
                and cfg.w_row_sum is not None):
            # ghost rows (no observations) are projected too but sliced
            # off by the caller before they feed anything
            s_vec = jnp.full((n_loc,), cfg.w_row_sum, dtype=W_l.dtype)
            W_l = jax.vmap(_proj_simplex_core)(W_l, s_vec)

        return W_l, T, key

    def sweep(plan, W, T, key, resets_left, reset_key, *extras):
        n, d = plan.shape
        n_pad = plan.n_loc * dp_size
        if n_pad != n:
            W = jnp.zeros((n_pad, W.shape[1]), W.dtype).at[:n].set(W)
        coo = plan.coo
        W_out, T_out, key = shard_map(
            _local if panel is None else _local_panel, mesh=mesh,
            in_specs=(P(dp_ax, None), P(dp_ax, None), P(dp_ax, None),
                      P(dp_ax, None), P(dp_ax, None), P(None, None),
                      P()),
            out_specs=(P(dp_ax, None), P(None, None), P()),
            check_vma=False)(
            coo.rows, coo.cols, coo.x_vals, coo.m_vals, W, T, key)
        if n_pad != n:
            W_out = W_out[:n]
        return W_out, T_out, key, resets_left

    if cfg.matmul_precision is not None:
        _sweep_body = sweep

        def sweep(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _sweep_body(*args)

    return jax.jit(sweep)


def make_sharded_masked_gram_objective(mesh, reg_w_l2=0.0, reg_t_l2=0.0,
                                       reg_w_l1=0.0, reg_t_l1=0.0,
                                       panel=None):
    """Masked objective over a :class:`ShardedMaskedGramPlan` through the
    Gram identity (one local C/Θ contraction + one scalar psum)::

        ‖√M ⊙ (X − WT)‖² = Σ m x² − 2 Σ_t w_tᵀ C[t]
                           + Σ_{t,s} w_tᵀ Θ[t,s] w_s

    ``panel``: accumulate the quadratic form in (panel, k, n_loc) Θ
    tiles (the mesh analog of the single-device panel objective).
    """
    dp_ax, _tp = mesh.axis_names
    dp_size = mesh.devices.shape[0]

    def _local(rows, cols, x, m, W_l, T):
        _, acc, _ = resolve_mixed_dtypes(W_l.dtype, W_l.dtype)
        k = T.shape[0]
        n_loc = W_l.shape[0]
        Wa = W_l.astype(acc)
        if panel is not None:
            C = _seg_gram_w_C_local(rows[0], cols[0], x[0], m[0],
                                    T, n_loc, acc)
            cross = jnp.sum(C * Wa.T)
            quad = jnp.zeros((), acc)
            for t0 in range(0, k, panel):
                p = min(panel, k - t0)
                # sequencing barrier (see the single-device objective)
                quad, T_seq = lax.optimization_barrier((quad, T))
                Hpan = _seg_gram_w_panel_local(
                    rows[0], cols[0], x[0], m[0], T_seq, n_loc, t0, p,
                    acc)
                quad = quad + jnp.einsum(
                    'tsi,it,is->', Hpan, Wa[:, t0:t0 + p], Wa)
        else:
            CH = _seg_gram_w_local(rows[0], cols[0], x[0], m[0], T,
                                   n_loc, acc)
            C = CH[:k]
            Hp = CH[k:]
            it, is_, _ = _sym_pairs(k)
            cross = jnp.sum(C * Wa.T)
            # Σ_{t,s} w_tᵀ Θ[t,s] w_s from the kp unique pairs:
            # off-diagonal pairs count twice
            pw = jnp.sum(Hp.T * (Wa[:, it] * Wa[:, is_]), axis=0)
            wgt = jnp.where(jnp.asarray(it) == jnp.asarray(is_),
                            1.0, 2.0).astype(acc)
            quad = jnp.sum(pw * wgt)
        part = (-2.0 * cross + quad) * 0.5 \
            + 0.5 * reg_w_l2 * jnp.sum(Wa ** 2) \
            + reg_w_l1 * jnp.sum(jnp.abs(Wa))
        return lax.psum(part, dp_ax).reshape(1)

    def objective(plan, W, T):
        n, d = plan.shape
        n_pad = plan.n_loc * dp_size
        if n_pad != n:
            W = jnp.zeros((n_pad, W.shape[1]), W.dtype).at[:n].set(W)
        sharded = P(dp_ax, None)
        coo = plan.coo
        part = shard_map(
            _local, mesh=mesh,
            in_specs=(sharded, sharded, sharded, sharded, sharded,
                      P(None, None)),
            out_specs=P(None),
            check_vma=False)(
            coo.rows, coo.cols, coo.x_vals, coo.m_vals, W, T)[0]
        _, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype)
        Ta = T.astype(acc)
        return (0.5 * plan.sum_mx2 + part
                + 0.5 * reg_t_l2 * jnp.sum(Ta ** 2)
                + reg_t_l1 * jnp.sum(jnp.abs(Ta)))

    return jax.jit(objective)
