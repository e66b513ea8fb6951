"""Mesh-sharded sparse-mask WRRI sweep: per-device observation blocks.

Distribution of :mod:`rri_nmf_tpu.ops.sweep_masked_sparse` (see that
module for the O(nnz) algebra). The observed set is partitioned by ROW
block — device ``i`` owns the observations with ``row // n_loc == i``,
stored with local row indices, global column indices, and zero padding
(``m = x = 0`` entries vanish from every contraction). ``W`` is
row-sharded ``P(dp, None)``; ``T`` is replicated (the mesh is required to
be ``(n_devices, 1)``: every T-phase quantity is a d-vector).

Communication per topic is exactly one ``psum`` of a ``(2, d)`` stack —
the column-keyed segment sums ``(w²)ᵀM`` and ``wᵀ(M⊙R)`` — so a sweep
moves O(k·d) between devices, independent of nnz. Everything else is local:
the W-phase quantities are row-keyed (device-local under row
partitioning), the residual carry lives with its observations, and the
T-row update is computed replicated from the psum'd numerators (identical
on every device, like the T updates of ``parallel/sparse_mesh.py``).

Padded ghost rows (when ``dp ∤ n``) hold no observations, so their
``nt = 0`` and ``qf_min_vector_c`` keeps them exactly zero; they are
sliced off before the sweep returns.

Restrictions beyond the single-device sweep: ``reset_topic_method`` must
be None (a 'random' reset's W column draw is a global (n,) stream — the
single-device path covers the RS transform preset) and no per-row
``w_row_sum`` vector (it would need dp-aligned padding).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.tree_util import register_pytree_node_class

try:
    from jax import shard_map              # jax >= 0.8
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from rri_nmf_tpu.matrixops import (_proj_simplex_core,
    reproject_row_if_drifted)
from rri_nmf_tpu.optimization import qf_min_vector_c
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, resolve_mixed_dtypes
from rri_nmf_tpu.ops.sweep_masked_sparse import _PAD_TO


@register_pytree_node_class
class ShardedMaskedCOO:
    """A dp-grid of equally-padded observation blocks.

    ``rows`` are LOCAL to each device's row tile; ``cols`` are global
    (T is replicated). All four arrays have shape (dp, m) and are
    sharded ``P(dp, None)``.
    """

    def __init__(self, rows, cols, x_vals, m_vals, shape, n_loc, nnz):
        self.rows = rows
        self.cols = cols
        self.x_vals = x_vals
        self.m_vals = m_vals
        self.shape = tuple(shape)
        self.n_loc = int(n_loc)
        self.nnz = int(nnz)

    def tree_flatten(self):
        return ((self.rows, self.cols, self.x_vals, self.m_vals),
                (self.shape, self.n_loc, self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, shape=aux[0], n_loc=aux[1], nnz=aux[2])


def _host_row_blocks(rows, cols, x, m, n_loc, dp_first, dp_count, d,
                     mmax, dtype):
    """(dp_count, mmax) padded observation blocks for the devices
    ``[dp_first, dp_first + dp_count)``. ``rows`` are GLOBAL CSR-sorted
    row indices covering exactly those devices' row range; local row
    indices come out ``rows % n_loc``. Shared by the single-controller
    partitioners and :func:`parallel.multihost.distribute_masked_coo`
    (which builds only its own process's slab)."""
    blk = rows // n_loc - dp_first
    counts = (np.bincount(blk, minlength=max(dp_count, 1))
              if rows.size else np.zeros(max(dp_count, 1), np.int64))
    starts = np.concatenate([[0], np.cumsum(counts)])
    r_b = np.zeros((dp_count, mmax), dtype=np.int32)
    c_b = np.full((dp_count, mmax), max(d - 1, 0), dtype=np.int32)
    x_b = np.zeros((dp_count, mmax), dtype=dtype)
    m_b = np.zeros((dp_count, mmax), dtype=dtype)
    for b in range(dp_count):
        lo, hi = starts[b], starts[b + 1]
        cnt = hi - lo
        r_b[b, :cnt] = (rows[lo:hi] % n_loc).astype(np.int32)
        c_b[b, :cnt] = cols[lo:hi]
        x_b[b, :cnt] = x[lo:hi]
        m_b[b, :cnt] = m[lo:hi]
        if cnt:
            # sorted-pad: the local row stream must stay non-decreasing
            # (seg_rows passes indices_are_sorted=True; zero-index
            # padding after sorted real rows violates the contract on
            # sorted-scatter lowerings). Padding keeps m = x = 0.
            r_b[b, cnt:] = r_b[b, cnt - 1]
    return r_b, c_b, x_b, m_b


def partition_masked_coo(X, W_mat, mesh, dtype):
    """Host-side: (X, scipy-sparse W_mat) → :class:`ShardedMaskedCOO` on
    ``mesh`` (which must be (dp, 1)). Same value semantics as
    :func:`rri_nmf_tpu.ops.sweep_masked_sparse.plan_masked_coo`."""
    dp_size, tp_size = mesh.devices.shape
    assert tp_size == 1, 'sparse-mask mesh sweeps are row-partitioned'
    # shared host extraction (ops/sweep_masked_sparse.py): explicit-zero
    # elimination, duplicate summing, and the aligned-structure fast
    # path — scipy's O(nnz) pair fancy-indexing costs minutes at 25M
    # observations, exactly the scale this mesh path exists for
    from rri_nmf_tpu.ops.sweep_masked_sparse import masked_coo_host_arrays
    rows_a, cols_a, x_a, m_a, (n, d), nnz = \
        masked_coo_host_arrays(X, W_mat, dtype)
    rows = rows_a[:nnz].astype(np.int64)
    cols = cols_a[:nnz]
    x = x_a[:nnz]
    m = m_a[:nnz]

    n_loc = -(-n // dp_size)
    # rows arrive CSR-sorted, so the block key is non-decreasing —
    # contiguous slices partition the observations per device
    counts = np.bincount(rows // n_loc, minlength=dp_size)
    mmax = max(int(counts.max()), 1)
    mmax += (-mmax) % _PAD_TO
    r_b, c_b, x_b, m_b = _host_row_blocks(
        rows, cols, x, m, n_loc, 0, dp_size, d, mmax, dtype)

    dp, _tp = mesh.axis_names
    s = NamedSharding(mesh, P(dp, None))
    return ShardedMaskedCOO(
        jax.device_put(r_b, s), jax.device_put(c_b, s),
        jax.device_put(x_b, s), jax.device_put(m_b, s),
        shape=(n, d), n_loc=n_loc, nnz=int(rows.shape[0]))


def supports_sharded_masked_sparse(cfg: SweepConfig, mesh) -> bool:
    from rri_nmf_tpu.ops.sweep_masked_sparse import supports_masked_sparse
    return (supports_masked_sparse(cfg)
            and cfg.reset_topic_method is None
            and not cfg.w_row_sum_is_vector
            and mesh.devices.shape[1] == 1)


@lru_cache(maxsize=16)
def make_sharded_masked_sparse_sweep(cfg: SweepConfig, mesh):
    """shard_map'd O(nnz/dp) masked sweep. Driver call signature::

        sweep(plan, W, T, key, resets_left, reset_key) ->
            (W, T, key, resets_left)
    """
    assert supports_sharded_masked_sparse(cfg, mesh), \
        'config not supported by the sparse-mask mesh sweep'
    k = cfg.k
    dp, _tp = mesh.axis_names
    dp_size = mesh.devices.shape[0]

    def _local(rows, cols, x, m, W_l, T, key):
        """Per-device body. ``rows``/``cols``/``x``/``m`` arrive as this
        device's (1, mloc) block; W_l is the (n_loc, k) row tile; T is
        the full replicated (k, d)."""
        rows = rows[0]
        cols = cols[0]
        dtype, acc, _ = resolve_mixed_dtypes(W_l.dtype, W_l.dtype,
                                             cfg.matmul_precision)
        x = x[0].astype(acc)
        m = m[0].astype(acc)
        n_loc = W_l.shape[0]
        d = T.shape[1]

        def seg_cols(data):
            return jax.ops.segment_sum(data, cols, num_segments=d)

        def seg_rows(data):
            return jax.ops.segment_sum(data, rows, num_segments=n_loc,
                                       indices_are_sorted=True)

        # local masked residual carry over this device's observations
        r = m * (x - jnp.sum(W_l.astype(acc)[rows]
                             * T.astype(acc)[:, cols].T, axis=1))

        def topic_body(t, carry):
            W_l, T, r, key = carry

            if not cfg.fix_T:
                w = W_l[:, t]
                wr = w.astype(acc)[rows]
                # ONE psum per topic: both column-keyed partials stacked
                parts = lax.psum(
                    jnp.stack([seg_cols(wr * wr * m),
                               seg_cols(wr * r)]), dp)
                nw = parts[0]
                wR = parts[1] + T[t].astype(acc) * nw

                if cfg.dp_sigma is not None:
                    # replicated key -> identical draws on every device
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
                    W_l = W_l.at[:, t].multiply(nt1.astype(dtype))
                    wr_eff = wr * nt1.astype(acc)
                else:
                    wr_eff = wr
                t_stored = t_new.astype(dtype)
                if cfg.t_row_sum and cfg.project_T_each_iter:
                    # replicated row: same drift reprojection everywhere
                    t_stored = reproject_row_if_drifted(
                        t_stored, cfg.t_row_sum, dtype)
                T = T.at[t].set(t_stored)
                r = r + m * (wr * t_old.astype(acc)[cols]
                             - wr_eff * t_stored.astype(acc)[cols])

            if not cfg.fix_W:
                trow = T[t]
                tc = trow.astype(acc)[cols]
                nt = seg_rows(tc * tc * m)           # row-local: no psum
                w_old = W_l[:, t]
                Rt = seg_rows(r * tc) + w_old.astype(acc) * nt
                numer = Rt - cfg.reg_w_l1
                denom = nt + cfg.reg_w_l2
                w_new, _ = qf_min_vector_c(-numer, denom, s=None,
                                           ub=cfg.w_row_sum)
                W_l = W_l.at[:, t].set(w_new.astype(dtype))
                r = r + m * ((w_old.astype(acc)
                              - w_new.astype(acc))[rows] * tc)

            return W_l, T, r, key

        W_l, T, r, key = lax.fori_loop(0, k, topic_body, (W_l, T, r, key))

        if (cfg.project_W_each_iter and not cfg.fix_W
                and cfg.w_row_sum is not None):
            # row-local Duchi projections; ghost rows (all-zero, no
            # observations) WOULD be pushed to uniform s/k mass by the
            # projection, but they are sliced off by the caller and never
            # feed any contraction (their entries appear in no block)
            s_vec = jnp.full((n_loc,), cfg.w_row_sum, dtype=W_l.dtype)
            W_l = jax.vmap(_proj_simplex_core)(W_l, s_vec)

        return W_l, T, key

    def sweep(plan, W, T, key, resets_left, reset_key, *extras):
        n, d = plan.shape
        n_pad = plan.n_loc * dp_size
        if n_pad != n:
            W = jnp.zeros((n_pad, W.shape[1]), W.dtype).at[:n].set(W)
        W_out, T_out, key = shard_map(
            _local, mesh=mesh,
            in_specs=(P(dp, None), P(dp, None), P(dp, None), P(dp, None),
                      P(dp, None), P(None, None), P()),
            out_specs=(P(dp, None), P(None, None), P()),
            check_vma=False)(
            plan.rows, plan.cols, plan.x_vals, plan.m_vals, W, T, key)
        if n_pad != n:
            W_out = W_out[:n]
        return W_out, T_out, key, resets_left

    if cfg.matmul_precision is not None:
        _sweep_body = sweep

        def sweep(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _sweep_body(*args)

    return jax.jit(sweep)


def make_sharded_masked_sparse_objective(mesh, reg_w_l2=0.0, reg_t_l2=0.0,
                                         reg_w_l1=0.0, reg_t_l1=0.0):
    """``0.5 Σ_obs m·(x − (WT))² + regs`` over a
    :class:`ShardedMaskedCOO`: local partial sums + one psum."""
    dp, _tp = mesh.axis_names
    dp_size = mesh.devices.shape[0]

    def _local(rows, cols, x, m, W_l, T):
        _, acc, _ = resolve_mixed_dtypes(W_l.dtype, W_l.dtype)
        rows = rows[0]
        cols = cols[0]
        x = x[0].astype(acc)
        m = m[0].astype(acc)
        pred = jnp.sum(W_l.astype(acc)[rows] * T.astype(acc)[:, cols].T,
                       axis=1)
        res = x - pred
        part = 0.5 * jnp.sum(m * res * res) \
            + 0.5 * reg_w_l2 * jnp.sum(W_l.astype(acc) ** 2) \
            + reg_w_l1 * jnp.sum(jnp.abs(W_l.astype(acc)))
        return lax.psum(part, dp).reshape(1)

    def objective(plan, W, T):
        n, d = plan.shape
        n_pad = plan.n_loc * dp_size
        if n_pad != n:
            W = jnp.zeros((n_pad, W.shape[1]), W.dtype).at[:n].set(W)
        obj = shard_map(
            _local, mesh=mesh,
            in_specs=(P(dp, None), P(dp, None), P(dp, None), P(dp, None),
                      P(dp, None), P(None, None)),
            out_specs=P(None),
            check_vma=False)(
            plan.rows, plan.cols, plan.x_vals, plan.m_vals, W, T)[0]
        _, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype)
        Ta = T.astype(acc)
        return (obj + 0.5 * reg_t_l2 * jnp.sum(Ta ** 2)
                + reg_t_l1 * jnp.sum(jnp.abs(Ta)))

    return jax.jit(objective)
