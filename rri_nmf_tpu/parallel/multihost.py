"""Multi-host (multi-process) wiring for the mesh-sharded paths.

Everything in :mod:`rri_nmf_tpu.parallel` is GSPMD over a
``jax.sharding.Mesh`` and is already multi-host *correct* — the sweep
bodies never index devices, and every collective is a mesh-axis
``psum``/``all_gather`` that XLA hands to NCCL (NVLink within a host,
the network across hosts). What a single-controller program lacks is the
plumbing: process-group initialization, a mesh over the *global* device
set laid out so the heavy collectives stay within a host, and
per-process data loading (no host can materialize a BASELINE-scale X
alone). This module is that plumbing. (The reference has no distributed runtime at all — SURVEY.md
§2.2; its ``nmf.py:233-235,653-660`` only note what a distributed NMF
*would* send.)

Layout guidance (RRI's traffic): per-sweep wire bytes are O(k·d/tp)
psummed over ``dp``, O(k·n/dp) psummed over ``tp``, and O(k²) Grams over
both. With ``dp`` the outer (cross-host) axis, the cross-host payload
per sweep is the (k, d/tp) T-phase numerator — independent of n, the
axis you scale hosts over — while the n-proportional psum stays within
a host. That is why :func:`make_global_mesh` puts ``dp`` across
processes and ``tp`` within one.

Single-process calls are exact no-ops / equivalents of the local
helpers, so the same driver script runs unchanged from a laptop to a
cluster — only ``initialize_distributed()`` + per-process loading differ.
Validation: beyond the single-process contracts
(tests/test_multihost.py), a REAL 2-process ``jax.distributed`` group
(XLA:CPU gloo collectives on localhost) drives this whole module plus
``nmf(mesh=...)`` end-to-end in tests/test_multiprocess.py — both
processes' gathered results are bitwise identical and match a
single-controller oracle fit.
"""

import logging

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger('rri_nmf_tpu.parallel.multihost')


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None):
    """Join (or create) the JAX process group.

    Thin idempotent wrapper over ``jax.distributed.initialize``: pass the
    coordinator's ``host:port``, the process count and this process's
    rank (nothing is autodetected). Returns
    ``(process_index, process_count)``.

    Safe to call when already initialized (returns the current group) and
    in a plain single-process session (initializes nothing unless
    explicitly given a coordinator).
    """
    already = getattr(jax.distributed, 'is_initialized', None)
    if callable(already) and already():
        return jax.process_index(), jax.process_count()
    if coordinator_address is not None or num_processes is not None:
        kwargs = {}
        if coordinator_address is not None:
            kwargs['coordinator_address'] = coordinator_address
        if num_processes is not None:
            kwargs['num_processes'] = int(num_processes)
        if process_id is not None:
            kwargs['process_id'] = int(process_id)
        if local_device_ids is not None:
            kwargs['local_device_ids'] = local_device_ids
        jax.distributed.initialize(**kwargs)
        logger.info('jax.distributed initialized: process %d/%d',
                    jax.process_index(), jax.process_count())
    return jax.process_index(), jax.process_count()


def make_global_mesh(mesh_shape=None, axis_names=('dp', 'tp'),
                     devices=None):
    """A ``(dp, tp)`` mesh over the GLOBAL device set, process-major.

    Single process: equivalent to :func:`rri_nmf_tpu.parallel.make_mesh`
    (contiguous reshape). Multi-process: ``dp`` spans processes and
    ``tp`` stays within a process, so the n-proportional W-phase psum
    stays within a host and only the (k, d/tp) T-phase numerator crosses
    hosts (see module docstring). ``mesh_shape`` defaults to
    ``(n_processes * per_host // tp, tp)`` with ``tp`` = all devices of
    one process — pass an explicit shape to override.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    n_proc = jax.process_count()
    per_host = n // max(n_proc, 1)
    if mesh_shape is None:
        mesh_shape = (n_proc, per_host) if n_proc > 1 else (
            (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1))
    if n_proc > 1:
        dp, tp = mesh_shape
        if dp % n_proc != 0:
            raise ValueError('dp=%d must be a multiple of the process '
                             'count %d' % (dp, n_proc))
        # process-major: each process's devices fill dp//n_proc
        # consecutive dp rows and tp stays within a process (validated by
        # the 2-process tests, tests/test_multiprocess.py)
        devs = sorted(devices, key=lambda dv: (dv.process_index, dv.id))
        dev_array = np.array(devs).reshape(mesh_shape)
        row_procs = np.vectorize(lambda dv: dv.process_index)(dev_array)
        if not (row_procs == row_procs[:, :1]).all():
            raise ValueError(
                'cannot lay out mesh_shape=%r with tp inside a '
                'process: processes own unequal device counts'
                % (mesh_shape,))
        return Mesh(dev_array.reshape(mesh_shape), axis_names)
    return Mesh(np.asarray(devices[:mesh_shape[0] * mesh_shape[1]])
                .reshape(mesh_shape), axis_names)


def process_row_block(n, mesh):
    """The global ``[start, stop)`` row range of X this process must
    load, under the canonical row-over-``dp`` layout.

    Derived from the dp coordinates this process's devices actually own
    (clamped ceil-chunks, jax's uneven-axis convention) — not an even
    split over the process count: with dp > process_count or n not
    divisible, a naive ``p·ceil(n/r)`` split disagrees with the device
    shards that :func:`distribute_dense`'s
    ``make_array_from_process_local_data`` expects (and its unclamped
    start could even exceed ``n``)."""
    dp_size = mesh.devices.shape[0]
    per = -(-n // dp_size)
    pidx = jax.process_index()
    mine = [i for i in range(dp_size)
            if any(d.process_index == pidx
                   for d in np.atleast_1d(mesh.devices[i]).ravel())]
    if not mine:
        return 0, 0
    lo = min(min(i * per, n) for i in mine)
    hi = max(min((i + 1) * per, n) for i in mine)
    return lo, hi


def distribute_dense(X_local, global_shape, mesh, spec=None):
    """Assemble the global sharded X from this process's row block.

    ``X_local`` is the block returned by loading
    :func:`process_row_block`'s range; every process calls this with its
    own block and receives the same global ``jax.Array`` handle. Single
    process: identical to ``jax.device_put(X_local, sharding)``.
    """
    dp, tp = mesh.axis_names
    sharding = NamedSharding(mesh, P(dp, tp) if spec is None else spec)
    X_local = np.asarray(X_local)
    if jax.process_count() == 1:
        assert X_local.shape == tuple(global_shape)
        return jax.device_put(X_local, sharding)
    return jax.make_array_from_process_local_data(
        sharding, X_local, tuple(global_shape))


def distribute_factors(W_local, T, n, mesh):
    """Place warm-start factors: W rows from per-process blocks (same
    split as :func:`process_row_block`), T replicated (every process
    passes the full T)."""
    dp, _ = mesh.axis_names
    s_W = NamedSharding(mesh, P(dp, None))
    s_T = NamedSharding(mesh, P())
    W_local = np.asarray(W_local)
    if jax.process_count() == 1:
        W_dev = jax.device_put(W_local, s_W)
    else:
        W_dev = jax.make_array_from_process_local_data(
            s_W, W_local, (n, W_local.shape[1]))
    return W_dev, jax.device_put(np.asarray(T), s_T)


def _allgather_np(value):
    """Host-scalar allgather across the process group (identity in a
    single-process run). Returns a (process_count, ...) numpy array."""
    value = np.asarray(value)
    if jax.process_count() == 1:
        return value[None]
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(value))


def _owned_dp_rows(mesh):
    """This process's dp mesh rows, validated contiguous and fully owned
    (tp never spans processes — the :func:`make_global_mesh` layout).
    Returns ``(dp_first, dp_count)``."""
    pidx = jax.process_index()
    dp_size = mesh.devices.shape[0]
    mine = []
    for i in range(dp_size):
        procs = {d.process_index
                 for d in np.atleast_1d(mesh.devices[i]).ravel()}
        if pidx in procs:
            if procs != {pidx}:
                raise ValueError(
                    'mesh dp row %d spans processes %r; row-partitioned '
                    'plans need tp within a process '
                    '(parallel.make_global_mesh)' % (i, sorted(procs)))
            mine.append(i)
    if not mine:
        return 0, 0
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError('this process owns non-contiguous dp rows %r; '
                         'use a process-major device layout '
                         '(parallel.make_global_mesh)' % (mine,))
    return mine[0], len(mine)


def distribute_sparse_coo(X_local, global_shape, mesh, dtype=None):
    """Assemble a mesh-global sparse-X plan
    (:class:`~rri_nmf_tpu.parallel.sparse_mesh.ShardedCOO`) from
    per-process row slabs — the multi-controller form of
    :func:`~rri_nmf_tpu.parallel.sparse_mesh.partition_coo` for UNMASKED
    sparse corpora (the BASELINE #5 topic-modeling scale axis: X's
    sparse form fits the cluster, its dense form fits no device — the
    reference densifies all sparse input, reference
    ``sklearn_interface.py:78-83``, and has no distributed runtime,
    SURVEY.md §2.2).

    ``X_local`` (scipy-sparse or dense) holds THIS process's rows
    (``process_row_block(n, mesh)``'s range). Every process calls this
    with its own slab and receives the same global plan handle, ready to
    pass DIRECTLY as ``nmf()``'s ``X`` with explicit ``W_in``/``T_in``
    (place them with :func:`distribute_factors`; the sharded sparse sweep
    re-pads and re-shards internally).

    Cross-process coordination is one host allgather of the padding
    width; the nonzeros
    themselves never move between hosts. Unlike the masked plans, a
    column (tp) mesh axis IS supported: each process owns whole dp rows
    and partitions its slab over its own tp columns locally.
    """
    import scipy.sparse as sps

    from rri_nmf_tpu.parallel.sparse_mesh import (ShardedCOO,
        _coo_block_arrays)

    n, d = (int(s) for s in global_shape)
    dp_size, tp_size = mesh.devices.shape
    dp_ax, tp_ax = mesh.axis_names
    n_loc = -(-n // dp_size)
    d_loc = -(-d // tp_size)

    dp_first, dp_count = _owned_dp_rows(mesh)
    lo, hi = process_row_block(n, mesh)
    n_sl = int(np.shape(X_local)[0])
    if n_sl != hi - lo:
        raise ValueError(
            'X_local has %d rows but this process owns rows [%d, %d) of '
            'the global (%d, %d) problem (process_row_block(n, mesh))'
            % (n_sl, lo, hi, n, d))
    if int(np.shape(X_local)[1]) != d:
        raise ValueError('X_local has %d columns, global problem has %d'
                         % (np.shape(X_local)[1], d))

    if not sps.issparse(X_local):
        X_local = sps.csr_matrix(np.asarray(X_local))
    coo = X_local.tocsr().tocoo()   # canonical: sorted, duplicates summed
    if dtype is None:
        dtype = coo.data.dtype if np.issubdtype(
            coo.data.dtype, np.floating) else np.float64
    dtype = np.dtype(dtype)

    r_g = coo.row.astype(np.int64) + lo
    c_g = coo.col.astype(np.int64)
    v = coo.data.astype(dtype, copy=False)

    nblocks = max(dp_count, 1) * tp_size
    blk = (r_g // n_loc - dp_first) * tp_size + c_g // d_loc
    order = np.argsort(blk, kind='stable')
    counts = np.bincount(blk[order], minlength=nblocks)
    starts = np.concatenate([[0], np.cumsum(counts)])
    r_s, c_s, v_s = r_g[order], c_g[order], v[order]

    def _glob(local, trailing):
        s3 = NamedSharding(mesh, P(dp_ax, tp_ax,
                                   *([None] * len(trailing))))
        if jax.process_count() == 1:
            return jax.device_put(local, s3)
        return jax.make_array_from_process_local_data(
            s3, local, (dp_size, tp_size) + tuple(trailing))

    m = int(_allgather_np(np.int64(
        counts.max() if counts.size else 0)).max())
    m = max(m, 1)
    data, rows, cols = _coo_block_arrays(
        starts, r_s, c_s, v_s, n_loc, d_loc, nblocks, m, dtype)
    g_loc = (max(dp_count, 1), tp_size, m)
    return ShardedCOO(
        _glob(data.reshape(g_loc), (m,)),
        _glob(rows.reshape(g_loc), (m,)),
        _glob(cols.reshape(g_loc), (m,)),
        shape=(n, d), n_loc=n_loc, d_loc=d_loc)


def distribute_masked_coo(X_local, W_mat_local, global_shape, mesh,
                          dtype=None, gram=False):
    """Assemble a mesh-global masked (WRRI) observation plan from
    per-process row slabs — the multi-controller form of
    :func:`~rri_nmf_tpu.parallel.masked_sparse_mesh.partition_masked_coo`
    / :func:`~rri_nmf_tpu.parallel.masked_gram_mesh.partition_masked_gram`
    (BASELINE #5-class observed sets must never be materialized on one
    host).

    ``X_local`` (dense or scipy-sparse) and scipy-sparse ``W_mat_local``
    hold THIS process's rows (:func:`process_row_block`'s range for
    ``mesh``, which must be (dp, 1)). Every process calls this with its
    own slab and receives the same global plan handle, ready to pass
    DIRECTLY as ``nmf()``'s ``X`` (with ``W_mat=None`` and explicit
    ``W_in``/``T_in`` placed by :func:`distribute_factors`).

    ``gram=False`` returns the interleaved O(nnz) plan
    (:class:`~rri_nmf_tpu.parallel.masked_sparse_mesh.ShardedMaskedCOO`,
    reference update order); ``gram=True`` the Gram-phase plan
    (:class:`~rri_nmf_tpu.parallel.masked_gram_mesh.ShardedMaskedGramPlan`,
    ``update_order='phase'``).

    Cross-process coordination is a handful of host allgathers of
    scalars (padding width, nnz, Σmx²) — the observation data itself
    never moves between hosts.
    """
    import scipy.sparse as sp

    from rri_nmf_tpu.ops.sweep_masked_sparse import (_PAD_TO,
        masked_coo_host_arrays)
    from rri_nmf_tpu.parallel.masked_sparse_mesh import (
        ShardedMaskedCOO, _host_row_blocks)

    n, d = (int(s) for s in global_shape)
    dp_size, tp_size = mesh.devices.shape
    if tp_size != 1:
        raise ValueError('masked mesh plans are row-partitioned; use an '
                         '(n_devices, 1) mesh')
    dp_ax = mesh.axis_names[0]
    n_loc = -(-n // dp_size)
    lo, hi = process_row_block(n, mesh)
    n_sl = int(np.shape(X_local)[0])
    if n_sl != hi - lo:
        raise ValueError(
            'X_local has %d rows but this process owns rows [%d, %d) of '
            'the global (%d, %d) problem (process_row_block)'
            % (n_sl, lo, hi, n, d))
    if not sp.issparse(W_mat_local):
        raise ValueError('W_mat_local must be scipy-sparse (the mask IS '
                         'the observed set)')
    if dtype is None:
        xdt = (X_local.dtype if hasattr(X_local, 'dtype')
               else np.asarray(X_local).dtype)
        dtype = xdt if np.issubdtype(xdt, np.floating) else np.float64
    dtype = np.dtype(dtype)

    rows_sl, cols_sl, x_sl, m_sl, (_n_sl, d_sl), nnz_sl = \
        masked_coo_host_arrays(X_local, W_mat_local, dtype)
    assert d_sl == d, (d_sl, d)
    rows_g = rows_sl[:nnz_sl].astype(np.int64) + lo
    cols = cols_sl[:nnz_sl]
    x = x_sl[:nnz_sl]
    m = m_sl[:nnz_sl]

    dp_first = lo // n_loc
    dp_count = -(-(hi - lo) // n_loc) if hi > lo else 0

    # one global padding width: every device block shares mmax
    local_max = int(np.bincount(rows_g // n_loc - dp_first,
                                minlength=max(dp_count, 1)).max()) \
        if nnz_sl else 0
    mmax = int(_allgather_np(np.int64(local_max)).max())
    mmax = max(mmax, 1)
    mmax += (-mmax) % _PAD_TO
    nnz_glob = int(_allgather_np(np.int64(nnz_sl)).sum())

    r_b, c_b, x_b, m_b = _host_row_blocks(
        rows_g, cols, x, m, n_loc, dp_first, dp_count, d, mmax, dtype)

    s = NamedSharding(mesh, P(dp_ax, None))

    def _glob(local):
        if jax.process_count() == 1:
            return jax.device_put(local, s)
        return jax.make_array_from_process_local_data(
            s, local, (dp_size, mmax))

    coo = ShardedMaskedCOO(
        _glob(r_b), _glob(c_b), _glob(x_b), _glob(m_b),
        shape=(n, d), n_loc=n_loc, nnz=nnz_glob)
    if not gram:
        return coo

    import jax.numpy as jnp

    from rri_nmf_tpu.parallel.masked_gram_mesh import ShardedMaskedGramPlan

    smx2 = float(_allgather_np(
        np.float64(m).dot(np.float64(x) ** 2)).sum())
    sum_mx2 = jax.device_put(
        jnp.asarray(smx2, dtype=jnp.promote_types(dtype, jnp.float32)),
        NamedSharding(mesh, P()))
    return ShardedMaskedGramPlan(
        coo=coo, sum_mx2=sum_mx2, shape=(n, d), n_loc=n_loc, nnz=nnz_glob)
