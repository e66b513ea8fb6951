"""Mesh-sharded sparse-X RRI sweep: per-device COO blocks + psum.

This is the BASELINE.md #5 path (row-sharded 1M×100k, k=1024): corpora
whose *sparse* form fits the mesh but whose dense form exceeds every
device's memory. The reference has no answer at this scale — its RS estimator
densifies COO input (reference ``sklearn_interface.py:78-83``) and it has
no distributed runtime at all (SURVEY.md §2.2).

Design
------
``X`` is partitioned into a ``(dp, tp)`` grid of COO blocks on the host —
device ``(i, j)`` owns the nonzeros with ``row // n_loc == i`` and
``col // d_loc == j``, stored with *local* indices and zero-padded to the
per-device maximum (padding entries are ``(0, 0, 0.0)`` and vanish from
every contraction and reduction). Factors use the canonical layouts of
:mod:`rri_nmf_tpu.parallel.mesh`: ``W: P(dp, None)``, ``T: P(None, tp)``.

With the phase update order the sweep touches X through exactly two
sparse contractions per sweep, each reducing over exactly one mesh axis:

- ``WᵀX``  (T-phase numerators)  → ``psum`` over ``dp``: one (k, d_loc)
  vector per device pair — the only T-phase communication;
- ``X Tᵀ`` (W-phase numerators)  → ``psum`` over ``tp``;
- Gram matrices ``WᵀW`` / ``TTᵀ`` → one (k, k) psum per phase.

Everything else — the Gram-blocked Gauss-Seidel topic loops
(:func:`rri_nmf_tpu.ops.dense_phase.gs_topics_blocked`), qf_min, row
projections — is local to a device (T updates replicate over ``dp``; W
updates are row-local on ``dp``). Per sweep the wire carries
O(kd/tp + kn/dp + k²) per device, independent of nnz.

T-row sum constraints (``project_T_each_iter`` with ``t_row_sum``) sort a
full T row and therefore need the row local: supported when ``tp == 1``
(pure row sharding — the BASELINE #5 layout). W-row constraints are always
row-local under ``P(dp, None)``.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import sparse as jsparse
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.tree_util import register_pytree_node_class

try:
    from jax import shard_map              # jax >= 0.8
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from rri_nmf_tpu.matrixops import _proj_simplex_core
from rri_nmf_tpu.ops.dense_phase import gs_topics_blocked
from rri_nmf_tpu.ops.sweep_sparse import supports_sparse
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, _gram_block_size


@register_pytree_node_class
class ShardedCOO:
    """A (dp, tp) grid of equally-padded local-index COO blocks.

    ``data``/``rows``/``cols`` have shape (dp, tp, m) and are sharded
    ``P(dp, tp, None)`` — each device holds one (1, 1, m) block with
    indices local to its (n_loc, d_loc) tile. Zero padding entries are
    (0, 0, 0.0): they contribute exactly zero to every contraction.
    """

    def __init__(self, data, rows, cols, shape, n_loc, d_loc):
        self.data = data
        self.rows = rows
        self.cols = cols
        self.shape = tuple(shape)
        self.n_loc = int(n_loc)
        self.d_loc = int(d_loc)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):  # padded size; an upper bound on true nnz
        return int(np.prod(self.data.shape))

    def tree_flatten(self):
        return ((self.data, self.rows, self.cols),
                (self.shape, self.n_loc, self.d_loc))

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, n_loc, d_loc = aux
        return cls(*children, shape=shape, n_loc=n_loc, d_loc=d_loc)


def _block_runs(X, mesh, n_loc, d_loc):
    """Host-side partition core of :func:`partition_coo` and
    :func:`~rri_nmf_tpu.parallel.multihost.distribute_sparse_coo`:
    canonicalize X (CSR — duplicates summed,
    sorted), sort the nonzeros ONCE by (dp, tp) device block, and return
    the contiguous per-block runs.

    Returns ``(shape, starts, r_sorted, c_sorted, v_sorted)`` where
    block ``b``'s nonzeros are the slice ``starts[b]:starts[b+1]`` in
    GLOBAL coordinates (callers localize with ``% n_loc`` / ``% d_loc``).
    """
    import scipy.sparse as sps

    if not sps.issparse(X):
        X = sps.csr_matrix(np.asarray(X))
    coo = X.tocsr().tocoo()   # canonical: sorted, duplicates summed
    dp_size, tp_size = mesh.devices.shape
    blk = (coo.row // n_loc) * tp_size + (coo.col // d_loc)
    order = np.argsort(blk, kind='stable')
    counts = np.bincount(blk[order], minlength=dp_size * tp_size)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return (coo.shape, starts, coo.row[order], coo.col[order],
            coo.data[order])


def _coo_block_arrays(starts, r_s, c_s, v_s, n_loc, d_loc, nblocks, m,
                      dtype):
    """Pack block-sorted global-coordinate runs into zero-padded
    local-index COO arrays of shape ``(nblocks, m)`` (host). Shared by
    :func:`partition_coo` (all blocks) and
    :func:`~rri_nmf_tpu.parallel.multihost.distribute_sparse_coo` (this
    process's blocks, with ``m`` allgathered)."""
    data = np.zeros((nblocks, m), dtype=np.dtype(dtype))
    rows = np.zeros((nblocks, m), dtype=np.int32)
    cols = np.zeros((nblocks, m), dtype=np.int32)
    for b in range(nblocks):
        lo, hi = starts[b], starts[b + 1]
        cnt = hi - lo
        data[b, :cnt] = v_s[lo:hi]
        rows[b, :cnt] = (r_s[lo:hi] % n_loc).astype(np.int32)
        cols[b, :cnt] = (c_s[lo:hi] % d_loc).astype(np.int32)
    return data, rows, cols


def partition_coo(X, mesh, dtype=None):
    """Host-side: scipy sparse / dense array → :class:`ShardedCOO` laid
    out on ``mesh``. Duplicate coordinates are summed (scipy CSR
    canonicalization — the reference's ``coo_matrix`` semantics)."""
    dp_size, tp_size = mesh.devices.shape
    n, d = X.shape
    n_loc = -(-n // dp_size)
    d_loc = -(-d // tp_size)
    (n, d), starts, r_s, c_s, v_s = _block_runs(X, mesh, n_loc, d_loc)
    counts = np.diff(starts)
    m = max(int(counts.max()), 1)

    if dtype is None:
        dtype = v_s.dtype
    data, rows, cols = _coo_block_arrays(
        starts, r_s, c_s, v_s, n_loc, d_loc, dp_size * tp_size, m, dtype)

    dp, tp = mesh.axis_names
    s = NamedSharding(mesh, P(dp, tp, None))
    g = (dp_size, tp_size, m)
    return ShardedCOO(
        jax.device_put(data.reshape(g), s),
        jax.device_put(rows.reshape(g), s),
        jax.device_put(cols.reshape(g), s),
        shape=(n, d), n_loc=n_loc, d_loc=d_loc)


def supports_sharded_sparse(cfg: SweepConfig, mesh) -> bool:
    """T-row sum constraints sort a whole T row → need ``tp == 1``."""
    tp_size = mesh.devices.shape[1]
    return supports_sparse(cfg) and (
        tp_size == 1 or not (cfg.project_T_each_iter and cfg.t_row_sum))


def _local_bcoo(data, rows, cols, n_loc, d_loc):
    indices = jnp.stack([rows, cols], axis=1)
    return jsparse.BCOO((data, indices), shape=(n_loc, d_loc),
                        indices_sorted=False, unique_indices=False)


@lru_cache(maxsize=16)
def make_sharded_sparse_sweep(cfg: SweepConfig, mesh):
    """Build the shard_map'd phase-order sweep over a :class:`ShardedCOO`.

    Same call signature as the other sweeps::

        sweep(Xs, W, T, key, resets_left, reset_key[, w_row_sum_vec])
            -> (W, T, key, resets_left)

    ``W``/``T`` may arrive with any sharding; they are zero-padded to the
    grid multiples and constrained to the canonical layouts inside.
    """
    assert supports_sharded_sparse(cfg, mesh), \
        'config not supported by the sharded sparse sweep'
    k = cfg.k
    B = _gram_block_size(k)
    dp, tp = mesh.axis_names
    dp_size, tp_size = mesh.devices.shape

    def make_local(n_glob, d_glob):
        # built per (n, d) trace: the TRUE global shape drives the exact
        # padded-column handling inside gs_topics_blocked (ghost columns
        # must not receive simplex mass or negative-L1 growth — see its
        # docstring)
        def local_sweep(data, rows, cols, W, T, *extras):
            data = data.reshape(-1)
            rows = rows.reshape(-1)
            cols = cols.reshape(-1)
            n_loc, d_loc = W.shape[0], T.shape[1]
            dtype = W.dtype
            acc = jnp.float32 if dtype in (jnp.bfloat16, jnp.float16) \
                else dtype
            Xb = _local_bcoo(data, rows, cols, n_loc, d_loc)
            w_row_sum_vec = (extras[0].reshape(-1)
                             if cfg.w_row_sum_is_vector else None)
            t_proj = (cfg.t_update_s is not None
                      or (cfg.t_row_sum and cfg.project_T_each_iter))
            # tp == 1 whenever the T projection is on (support gate), so
            # the valid column count is device-invariant there
            t_valid = (d_glob if (t_proj and d_glob != d_loc * tp_size)
                       else None)
            t_mask = None
            if not t_proj and d_glob != d_loc * tp_size:
                t_mask = (jnp.arange(d_loc)
                          + lax.axis_index(tp) * d_loc) < d_glob
            w_mask = None
            if n_glob != n_loc * dp_size:
                w_mask = (jnp.arange(n_loc)
                          + lax.axis_index(dp) * n_loc) < n_glob

            if not cfg.fix_T:
                # accumulate the sparse contraction in ``acc``: with bf16
                # storage the dense operand is cast BEFORE the dot (the
                # single-device _cast_dense rule) — a bf16-resulting dot
                # would accumulate the n_loc-term sums in bf16
                WX = jsparse.bcoo_dot_general(
                    Xb, W.astype(acc),
                    dimension_numbers=(((0,), (0,)), ((), ()))
                    ).T                                    # (k, d_loc)
                WX = lax.psum(WX, dp)
                G = lax.psum(jnp.dot(W.T, W, preferred_element_type=acc),
                             dp)
                T = gs_topics_blocked(
                    WX, T, G, k=k, B=B,
                    reg_l1=cfg.reg_t_l1, reg_l2=cfg.reg_t_l2,
                    qf_s=cfg.t_update_s, qf_ub=cfg.t_row_sum,
                    reproject_sum=(cfg.t_row_sum
                                   if (cfg.t_row_sum and
                                       cfg.project_T_each_iter) else None),
                    acc=acc, dtype=dtype, reps=cfg.inner_reps,
                    valid_cols=t_valid, col_mask=t_mask)

            if not cfg.fix_W:
                XT = jsparse.bcoo_dot_general(
                    Xb, T.T.astype(acc),
                    dimension_numbers=(((1,), (0,)), ((), ()))
                    ).T                                    # (k, n_loc)
                XT = lax.psum(XT, tp)
                G2 = lax.psum(jnp.dot(T, T.T, preferred_element_type=acc),
                              tp)
                ub = (w_row_sum_vec if cfg.w_row_sum_is_vector
                      else cfg.w_row_sum)
                Wt = gs_topics_blocked(
                    XT, W.T, G2, k=k, B=B,
                    reg_l1=cfg.reg_w_l1, reg_l2=cfg.reg_w_l2,
                    qf_s=None, qf_ub=ub, reproject_sum=None,
                    acc=acc, dtype=dtype, reps=cfg.inner_reps,
                    col_mask=w_mask)
                W = Wt.T

            if (cfg.project_W_each_iter and not cfg.fix_W
                    and (cfg.w_row_sum is not None
                         or cfg.w_row_sum_is_vector)):
                if cfg.w_row_sum_is_vector:
                    s_vec = w_row_sum_vec.astype(dtype)
                else:
                    s_vec = jnp.full((n_loc,), cfg.w_row_sum, dtype=dtype)
                W = jax.vmap(_proj_simplex_core)(W, s_vec)
                if w_mask is not None:
                    W = W * w_mask[:, None].astype(dtype)

            return W, T
        return local_sweep

    in_specs = [P(dp, tp, None)] * 3 + [P(dp, None), P(None, tp)]
    if cfg.w_row_sum_is_vector:
        in_specs.append(P(dp))

    def sweep(Xs, W, T, key, resets_left, reset_key, *extras):
        n, d = Xs.shape
        sharded = shard_map(make_local(n, d), mesh=mesh,
                            in_specs=tuple(in_specs),
                            out_specs=(P(dp, None), P(None, tp)),
                            check_vma=False)
        npad = Xs.n_loc * dp_size
        dpad = Xs.d_loc * tp_size
        dtype = W.dtype
        Wp = W if npad == n else \
            jnp.zeros((npad, k), dtype).at[:n].set(W)
        Tp = T if dpad == d else \
            jnp.zeros((k, dpad), dtype).at[:, :d].set(T)
        Wp = lax.with_sharding_constraint(
            Wp, NamedSharding(mesh, P(dp, None)))
        Tp = lax.with_sharding_constraint(
            Tp, NamedSharding(mesh, P(None, tp)))
        ex = ()
        if cfg.w_row_sum_is_vector:
            v = extras[0].reshape(-1)
            vp = v if npad == n else \
                jnp.zeros((npad,), v.dtype).at[:n].set(v)
            ex = (lax.with_sharding_constraint(
                vp, NamedSharding(mesh, P(dp))),)
        Wp, Tp = sharded(Xs.data, Xs.rows, Xs.cols, Wp, Tp, *ex)
        return Wp[:n], Tp[:, :d], key, resets_left

    if cfg.matmul_precision is not None:
        _sweep_body = sweep

        def sweep(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _sweep_body(*args)

    return jax.jit(sweep)


@lru_cache(maxsize=16)
def make_sharded_sparse_objective(mesh, reg_w_l2=0.0, reg_t_l2=0.0,
                                  reg_w_l1=0.0, reg_t_l1=0.0):
    """``0.5||X - WT||² + regs`` over a :class:`ShardedCOO` without
    materializing ``WT`` (same identity as
    :func:`rri_nmf_tpu.ops.sweep_sparse.make_sparse_objective`)::

        ||X - WT||² = ||X||² - 2·Σ_nnz X_ij (W_i·T_j) + tr((WᵀW)(TTᵀ))

    The nnz gathers are block-local by construction; only the two (k, k)
    Grams and three scalars cross the wire.
    """
    dp, tp = mesh.axis_names
    dp_size, tp_size = mesh.devices.shape

    def local_obj(data, rows, cols, W, T):
        data = data.reshape(-1)
        rows = rows.reshape(-1)
        cols = cols.reshape(-1)
        acc = jnp.float32 if W.dtype in (jnp.bfloat16, jnp.float16) \
            else W.dtype
        W = W.astype(acc)
        T = T.astype(acc)
        v = data.astype(acc)
        x2 = lax.psum(jnp.sum(v ** 2), (dp, tp))
        cross = lax.psum(
            jnp.sum(v * jnp.sum(W[rows] * T[:, cols].T, axis=1)), (dp, tp))
        G = lax.psum(W.T @ W, dp)
        G2 = lax.psum(T @ T.T, tp)
        wt2 = jnp.sum(G * G2)
        obj = 0.5 * (x2 - 2.0 * cross + wt2)
        obj = obj + 0.5 * reg_w_l2 * lax.psum(jnp.sum(W ** 2), dp)
        obj = obj + 0.5 * reg_t_l2 * lax.psum(jnp.sum(T ** 2), tp)
        obj = obj + reg_w_l1 * lax.psum(jnp.sum(jnp.abs(W)), dp)
        obj = obj + reg_t_l1 * lax.psum(jnp.sum(jnp.abs(T)), tp)
        return obj

    sharded = shard_map(
        local_obj, mesh=mesh,
        in_specs=(P(dp, tp, None), P(dp, tp, None), P(dp, tp, None),
                  P(dp, None), P(None, tp)),
        out_specs=P(), check_vma=False)

    def objective(Xs, W, T):
        n, d = Xs.shape
        npad = Xs.n_loc * dp_size
        dpad = Xs.d_loc * tp_size
        Wp = W if npad == n else \
            jnp.zeros((npad, W.shape[1]), W.dtype).at[:n].set(W)
        Tp = T if dpad == d else \
            jnp.zeros((T.shape[0], dpad), T.dtype).at[:, :d].set(T)
        Wp = lax.with_sharding_constraint(
            Wp, NamedSharding(mesh, P(dp, None)))
        Tp = lax.with_sharding_constraint(
            Tp, NamedSharding(mesh, P(None, tp)))
        return sharded(Xs.data, Xs.rows, Xs.cols, Wp, Tp)

    return jax.jit(objective)

