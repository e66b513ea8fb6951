"""sklearn-style estimators: topic modeling and recommender systems.

Equivalents of the reference's ``sklearn_interface.py``
(/root/reference/src/rri_nmf/sklearn_interface.py):

- :class:`NMF_RS_Estimator` (reference ``sklearn_interface.py:14-182``) —
  recommender-system estimator over ``(i, j, rating)`` triples with masked
  WRRI training, a 5% validation split driving RMSE early stopping, warm
  starts, and clipped-prediction scoring.
- :class:`NMF_TM_Estimator` (reference ``sklearn_interface.py:185-345``) —
  topic-model estimator with optional tfidf/row-normalization
  preprocessing, simplex-constrained fitting, incremental ``one_iter``
  stepping (stepped ≡ batch, pinned by ``tests/test_nmf.py:97-110``), and
  R² scoring.

Constructor args, nmf kwarg presets, and return conventions match the
reference line-for-line so downstream code ports unchanged.
"""

import inspect

import numpy as np
import scipy.sparse as sp

from rri_nmf_tpu.matrixops import normalize, tfidf
from rri_nmf_tpu.nmf import nmf

# nmf() kwargs dropped from the TRANSFORM presets (fix_T sweeps over NEW
# data) so one estimator-level nmf_kwargs dict can serve fit and
# transform: accel='her' requires both factors free (nmf.py:818-824); a
# checkpoint directory belongs to the fit (a transform restoring the
# fit's checkpoint would warm-start from the wrong state/shapes); and
# the factor/structure kwargs define WHAT a transform is — the preset's
# T_in=self.T (the learned topics) and fix_T=True must never be
# overridden by a warm-start T_in/W_in/W_mat meant for fit.
_TRANSFORM_DROPPED_KWARGS = ('accel', 'checkpoint', 'checkpoint_every',
                             'T_in', 'W_in', 'W_mat', 'fix_T', 'fix_W')


def _merged(preset, nmf_kwargs, drop=()):
    """Layer user ``nmf_kwargs`` over an estimator preset.

    User values OVERRIDE preset keys (the reference forwards blindly, so
    overriding a preset key raised ``TypeError: multiple values``; here
    e.g. ``nmf_kwargs=dict(accel='her')`` composes with the RS fit
    preset's ``reset_topic_method=None``)."""
    merged = dict(preset)
    merged.update((k, v) for k, v in nmf_kwargs.items() if k not in drop)
    return merged


class NotFittedError(ValueError, AttributeError):
    """Raised when a fitted-state method runs before ``fit``."""


class _EstimatorBase:
    """The scikit-learn estimator protocol without scikit-learn:
    ``get_params``/``set_params`` over the constructor's arguments, so
    ``sklearn.base.clone`` and grid searches work where scikit-learn is
    installed, and nothing here needs it."""

    @classmethod
    def _param_names(cls):
        sig = inspect.signature(cls.__init__)
        return sorted(p for p in sig.parameters if p != 'self')

    def get_params(self, deep=True):
        return {name: getattr(self, name) for name in self._param_names()}

    def set_params(self, **params):
        valid = set(self._param_names())
        for name, value in params.items():
            if name not in valid:
                raise ValueError('invalid parameter %r for %s; valid: %s'
                                 % (name, type(self).__name__,
                                    sorted(valid)))
            setattr(self, name, value)
        return self

    def __repr__(self):
        return '%s(%s)' % (type(self).__name__, ', '.join(
            '%s=%r' % (k, v) for k, v in self.get_params().items()
            if not isinstance(v, np.ndarray)))


def _check_2d(X, name='X'):
    """Dense finite 2-D array (what ``check_array`` accepted here)."""
    X = np.asarray(X.toarray() if sp.issparse(X) else X)
    if X.ndim != 2:
        raise ValueError('%s must be 2-D, got shape %s' % (name, X.shape))
    if X.dtype.kind not in 'biuf':
        X = X.astype(np.float64)
    if X.dtype.kind == 'f' and not np.all(np.isfinite(X)):
        raise ValueError('%s contains NaN or infinity' % name)
    return X


def _check_X_y(X, y):
    X = _check_2d(X)
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y.ravel()
    if y.ndim != 1 or y.shape[0] != X.shape[0]:
        raise ValueError('y must be 1-D with one entry per row of X; got '
                         'X %s, y %s' % (X.shape, y.shape))
    if y.dtype.kind == 'f' and not np.all(np.isfinite(y)):
        raise ValueError('y contains NaN or infinity')
    return X, y


def _holdout_split(X, y, test_size, seed):
    """Shuffled train/validation split: the same permutation and sizes as
    scikit-learn's ``train_test_split(X, y, test_size=..., random_state=
    seed)`` (test set = the first ``ceil(test_size·n)`` entries of
    ``RandomState(seed).permutation(n)``)."""
    n = X.shape[0]
    n_test = int(np.ceil(test_size * n))
    perm = np.random.RandomState(seed).permutation(n)
    te, tr = perm[:n_test], perm[n_test:]
    return X[tr], X[te], y[tr], y[te]


def _sparse_cross_term(Xc, W, T, row_block=8192):
    """``Σ_nnz X_ij (W_i · T_j)`` over CSR row blocks.

    Walks the CSR ``data``/``indices`` directly — scipy's
    ``X[ii, jj]`` pair fancy-indexing costs minutes at 25M nnz — and
    bounds the dense gather temporaries to one row block's nnz × k
    (an unchunked ``W[ii]`` is nnz × k: ~26 GB host RAM at 25M nnz,
    k=128 — at exactly the corpus scale the sparse scorers exist for).
    """
    indptr, idx, data = Xc.indptr, Xc.indices, Xc.data
    n = Xc.shape[0]
    total = 0.0
    for lo in range(0, n, row_block):
        hi = min(lo + row_block, n)
        p0, p1 = int(indptr[lo]), int(indptr[hi])
        if p0 == p1:
            continue
        rows = np.repeat(np.arange(lo, hi),
                         np.diff(indptr[lo:hi + 1]).astype(np.int64))
        total += float(np.sum(np.asarray(data[p0:p1])
                              * np.einsum('ik,ki->i', W[rows],
                                          T[:, idx[p0:p1]])))
    return total


class NMF_RS_Estimator(_EstimatorBase):
    """Recommender-system NMF estimator (masked WRRI).

    Reference: ``sklearn_interface.py:14-182``.

    Performance note — the Gram-phase recipe. With ``sparse_obs`` fits
    the default preset keeps the reference's interleaved topic order
    (O(nnz) gather/segment-sum streams per topic). When dead-topic
    recovery isn't needed, pass ``nmf_kwargs=dict(update_order='phase')``
    to route the fit through the Gram-phase masked sweep
    (``ops/sweep_masked_gram.py``): all O(nnz) work collapses into two
    segment-sum contractions per phase (optionally add ``inner_reps=3`` —
    the Gram reuse is exact). Same subproblems and descent guarantees;
    only the cyclic update order differs.
    """

    def __init__(self, n, d, k, wr1=0, tr1=0, random_state=0,
                 W=np.array([]), T=np.array([]), max_iter=30, nmf_kwargs={},
                 use_validation_early_stopping=True, sparse_obs='auto'):
        self.n = n
        self.d = d
        self.k = k
        self.max_iter = max_iter
        self.wr1 = wr1
        self.tr1 = tr1
        self.random_state = random_state
        self.min_rating = None
        self.max_rating = None
        self.Xpred = np.array([])
        self.use_validation_early_stopping = use_validation_early_stopping
        self.W = W
        self.T = T
        self.nmf_kwargs = nmf_kwargs
        # 'auto' keeps the observed set as scipy-sparse COO (O(nnz)
        # memory end to end — the sparse-mask WRRI sweep) when the dense
        # (n, d) form would be large; True/False force. The reference
        # ALWAYS densifies (sklearn_interface.py:78-102).
        self.sparse_obs = sparse_obs

    def __getstate__(self):
        """Pickle/joblib support (the sklearn deployment contract): the
        validation early-stop scorer :meth:`fit` creates is a local
        closure over the held-out split and cannot pickle. It is an
        ephemeral fit artifact — every ``fit`` call rebuilds it — so it
        is dropped from the serialized state (``None`` after a load; the
        fitted factors, scores, and ``nmf_outputs`` all persist)."""
        state = dict(self.__dict__)
        if callable(state.get('early_stop')):
            state['early_stop'] = None
        return state

    def sparsify(self):
        self.W = sp.csr_matrix(np.asarray(self.W)) if not sp.issparse(self.W) \
            else self.W.tocsr()
        self.T = sp.csr_matrix(np.asarray(self.T)) if not sp.issparse(self.T) \
            else self.T.tocsr()

    def densify(self):
        if sp.issparse(self.W):
            self.W = self.W.toarray()
        if sp.issparse(self.T):
            self.T = self.T.toarray()

    def _use_sparse_obs(self):
        """Resolve the ``sparse_obs`` mode: explicit bool, or 'auto' =
        sparse once the dense (n, d) float64 form passes ~2 GB (below
        that the dense masked sweep's GEMMs win; above it the
        O(nnz) path is the only one that scales)."""
        if isinstance(self.sparse_obs, (bool, np.bool_)):
            return bool(self.sparse_obs)
        return self.n * self.d * 8 > 2e9

    def _coo_matrices(self, I, J, R):
        """(ratings, binary mask) as CSR from observation triples —
        the O(nnz) stand-in for the reference's dense scatter
        (``sklearn_interface.py:78-102``). Duplicate pairs sum ratings
        (scipy COO semantics, same as the dense scatter); the mask
        stays binary."""
        ratings = sp.coo_matrix((R.astype(np.float64), (I, J)),
                                shape=(self.n, self.d)).tocsr()
        mask = sp.coo_matrix((np.ones(len(I)), (I, J)),
                             shape=(self.n, self.d)).tocsr()
        mask.data[:] = 1.0
        return ratings, mask

    def fit(self, X, y=None):
        """Fit from ``X`` = (n_obs, 2) index pairs, ``y`` = ratings
        (reference ``sklearn_interface.py:59-128``).

        With ``sparse_obs`` resolved True the observed set stays scipy
        COO end to end and the driver runs the O(nnz) sparse-mask WRRI
        sweep — dense (n, d) arrays never exist on host or device."""
        X, y = _check_X_y(X, y)

        self.min_rating = np.min(y)
        self.max_rating = np.max(y)

        use_sparse = self._use_sparse_obs()
        if self.use_validation_early_stopping:
            UItr, UIval, Rtr, Rval = _holdout_split(X, y, 0.05, seed=0)
            if use_sparse:
                Xtr, W_mat_tr = self._coo_matrices(
                    UItr[:, 0], UItr[:, 1], Rtr)
            else:
                from rri_nmf_tpu import native
                # one-pass parallel scatter (C++/OpenMP when built; the
                # reference materializes scipy COO matrices here,
                # sklearn_interface.py:78-83)
                Xtr, W_mat_tr = native.coo_to_dense_mask(
                    UItr[:, 0], UItr[:, 1], Rtr, self.n, self.d)
                Xtr = Xtr.astype(np.float64)
                W_mat_tr = np.asarray(W_mat_tr, dtype=np.float64)

            # gather-based validation RMSE: O(q·k) per early-stop check
            # instead of the reference's full clipped W·T (O(ndk) and an
            # n×d temporary per iteration, sklearn_interface.py:85-93).
            # Zero ratings are dropped to match the reference's
            # ``Xv.nonzero()`` exactly. Marked ``device_ok``: the driver
            # hands over the DEVICE factors and only the scalar score
            # crosses the host link (with the device-side early-stop
            # snapshots this makes RS early stopping transfer-free).
            _vnz = np.asarray(Rval) != 0
            Iv = UIval[_vnz, 0].astype(int)
            Jv = UIval[_vnz, 1].astype(int)
            Rv = np.asarray(Rval, dtype=np.float64)[_vnz]
            _dev = {}

            def RMSE_val(X_ignored, W, T):
                import jax.numpy as jnp
                if not _dev:   # lazy: device copies of the val triples
                    _dev['I'] = jnp.asarray(Iv)
                    _dev['J'] = jnp.asarray(Jv)
                    _dev['R'] = jnp.asarray(Rv)
                W = jnp.asarray(W)
                T = jnp.asarray(T)
                pred = jnp.clip(
                    jnp.sum(W[_dev['I']] * T[:, _dev['J']].T, axis=1),
                    self.min_rating, self.max_rating)
                return float(jnp.sqrt(jnp.mean(
                    (pred - _dev['R'].astype(pred.dtype)) ** 2)))

            RMSE_val.device_ok = True
            self.early_stop = RMSE_val
        else:
            self.early_stop = False
            if use_sparse:
                Xtr, W_mat_tr = self._coo_matrices(X[:, 0], X[:, 1], y)
            else:
                from rri_nmf_tpu import native
                Xtr, W_mat_tr = native.coo_to_dense_mask(
                    X[:, 0], X[:, 1], y, self.n, self.d)
                Xtr = Xtr.astype(np.float64)
                W_mat_tr = np.asarray(W_mat_tr, dtype=np.float64)

        W_in = self.W if np.asarray(self.W).size > 0 else []
        T_in = self.T if np.asarray(self.T).size > 0 else []

        soln = nmf(Xtr, self.k, **_merged(
            dict(max_iter=self.max_iter, max_time=7200,
                 compute_obj_each_iter=True, reset_topic_method=None,
                 early_stop=self.early_stop, project_T_each_iter=False,
                 t_row_sum=1.0, project_W_each_iter=False, w_row_sum=None,
                 W_mat=W_mat_tr, W_in=W_in, T_in=T_in,
                 reg_w_l1=self.wr1, reg_t_l1=self.tr1,
                 random_state=self.random_state),
            self.nmf_kwargs))
        self.W = soln.pop('W')
        self.T = soln.pop('T')
        self.nmf_outputs = soln
        return self

    def fit_from_Xtr(self, Xtr):
        """Construct (X, y) COO triples from a matrix and fit
        (reference ``sklearn_interface.py:130-142``)."""
        Xtr = Xtr.tocsr() if sp.issparse(Xtr) else sp.csr_matrix(Xtr)
        NZ = Xtr.nonzero()
        X = np.hstack((NZ[0].reshape((-1, 1)), NZ[1].reshape((-1, 1))))
        y = np.asarray(Xtr[NZ[0], NZ[1]]).ravel()
        return self.fit(X, y)

    def transform(self, Xnew):
        """Express ``Xnew`` in terms of the learned topics: a few fixed-T
        masked sweeps (reference ``sklearn_interface.py:144-156``).

        The indicator mask is ALWAYS built scipy-sparse — for dense
        ``Xnew`` too — so the driver runs the O(nnz) sparse-mask sweep
        and only the observed entries ever cross the host→device link.
        A dense-mask form would upload a full (rows, d) X + mask per
        call; observed sets are ~1-5% dense in recommender serving, so
        the sparse route moves ~50x fewer bytes and runs the O(nnz)
        sweep."""
        if sp.issparse(Xnew):
            W_mat_tr = Xnew.tocsr().copy()
            W_mat_tr.eliminate_zeros()   # match dense nonzero() semantics
            W_mat_tr.data = np.ones_like(W_mat_tr.data)
        else:
            W_mat_tr = sp.csr_matrix(np.asarray(Xnew) != 0).astype(
                np.result_type(np.asarray(Xnew).dtype, np.float32))

        soln = nmf(Xnew, self.k, **_merged(
            dict(max_iter=4, max_time=7200,
                 project_W_each_iter=False, project_T_each_iter=False,
                 W_mat=W_mat_tr, T_in=self.T, fix_T=True,
                 reg_w_l1=self.wr1, reg_t_l1=self.tr1, t_row_sum=1.0,
                 w_row_sum=None, reset_topic_method='random',
                 random_state=self.random_state),
            self.nmf_kwargs, drop=_TRANSFORM_DROPPED_KWARGS))
        return soln['W']

    def make_Xpred(self):
        """Materialize and cache the full clipped (n, d) prediction
        matrix. Optional: :meth:`predict`/:meth:`score` gather per-pair
        scores directly and only consult this cache when it exists —
        call it explicitly when many full-matrix lookups are coming and
        n*d comfortably fits in host memory."""
        if self.Xpred.size == 0:
            self.Xpred = np.clip(np.dot(self.W, self.T),
                                 a_min=self.min_rating,
                                 a_max=self.max_rating)

    def predict(self, X):
        """Predicted ratings for (i, j) index pairs: ``clip((W·T)_ij)``.

        Per-pair row/column gathers — O(q·k) for q pairs — instead of
        the reference's full (n, d) ``Xpred`` materialization on every
        call (reference ``sklearn_interface.py:158-170``; O(n·d·k)
        flops and an n·d temporary, prohibitive at serving scale). A
        cache built by :meth:`make_Xpred` is used when present.
        """
        if np.asarray(self.W).size == 0 or np.asarray(self.T).size == 0:
            raise NotFittedError('%s is not fitted yet; call fit first'
                                 % type(self).__name__)
        X = _check_2d(X)
        I = X[:, 0].astype(int)
        J = X[:, 1].astype(int)
        if self.Xpred.size > 0:
            return self.Xpred[I, J]
        Wq = self.W[I]
        Tq = self.T[:, J]
        Wq = Wq.toarray() if sp.issparse(Wq) else np.asarray(Wq)
        Tq = Tq.toarray() if sp.issparse(Tq) else np.asarray(Tq)
        return np.clip(np.einsum('qk,kq->q', Wq, Tq),
                       self.min_rating, self.max_rating)

    def score(self, X, y=np.array([])):
        """RMSE of predictions (reference ``sklearn_interface.py:172-182``)."""
        if sp.issparse(X):
            X = X.toarray()
        if np.asarray(y).size > 0:
            yh = self.predict(X)
            return np.sqrt(np.mean((y - yh) ** 2))
        I, J = X.nonzero()
        yh = self.predict(np.stack([I, J], axis=1))
        return np.sqrt(np.mean((X[I, J] - yh) ** 2))


class NMF_TM_Estimator(_EstimatorBase):
    """Topic-modeling NMF estimator (simplex-constrained RRI).

    Reference: ``sklearn_interface.py:185-345``. Parameters
    -----------------------------------------------------
    n, d, k : problem dimensions (documents × dictionary, k topics)
    wr1, wr2, tr1, tr2 : L1/L2 regularization for W and T
    handle_tfidf / handle_normalization : preprocessing switches
    W, T : optional warm-start factors
    nmf_kwargs : extra kwargs forwarded to :func:`rri_nmf_tpu.nmf.nmf`;
        on key collision they OVERRIDE the estimator preset (so e.g.
        ``dict(accel='her')`` or ``dict(mesh=...)`` layer onto the
        presets). Fit-only kwargs (``accel``, ``checkpoint``,
        ``checkpoint_every``) are dropped from the fixed-T ``transform``
        presets.

    Performance note — the fast-TM recipe. The default preset keeps the
    reference's exact semantics (interleaved topic order + budgeted
    ``'max_resid_document'`` resets), whose cost is inherent to the
    ordering (k per-topic GEMVs). When dead-topic recovery isn't needed,
    pass ``nmf_kwargs=dict(update_order='phase', reset_topic_method=None)``
    (optionally ``inner_reps=3``) for the phase-order sweep (two X GEMMs
    per sweep) with unchanged descent guarantees and fixed points (only
    the cyclic update order differs). See README "The fast-TM recipe".

    When X must be stored in 2 bytes/entry, add ``x_dtype='int16'`` to
    the fast-TM kwargs: X stays a per-column int16 code (2 bytes/entry
    like bf16, ~70× less quantization noise — ``ops/quantized.py``) and
    the fit converges to ~the storage noise floor instead of bf16's.
    """

    def __init__(self, n, d, k, wr1=0, wr2=0, tr1=0, tr2=0, random_state=0,
                 handle_tfidf=False, handle_normalization=False, max_iter=300,
                 W=np.array([]), T=np.array([]), nmf_kwargs={},
                 do_final_project_W=True):
        self.n = n
        self.d = d
        self.k = k
        self.wr1 = wr1
        self.wr2 = wr2
        self.tr1 = tr1
        self.tr2 = tr2
        self.random_state = random_state
        self.handle_tfidf = handle_tfidf
        self.handle_normalization = handle_normalization
        self.max_iter = max_iter
        self.W = W
        self.T = T
        self.nmf_kwargs = nmf_kwargs
        self.do_final_project_W = do_final_project_W

    def sparsify(self):
        self.W = sp.csr_matrix(np.asarray(self.W)) if not sp.issparse(self.W) \
            else self.W.tocsr()
        self.T = sp.csr_matrix(np.asarray(self.T)) if not sp.issparse(self.T) \
            else self.T.tocsr()

    def densify(self):
        if sp.issparse(self.W):
            self.W = self.W.toarray()
        if sp.issparse(self.T):
            self.T = self.T.toarray()

    def _preprocess(self, X):
        _sparse = sp.issparse(X)
        if self.handle_tfidf:
            X, idf = tfidf(X, return_idf=True)
            self.idf = np.asarray(idf)
            if not _sparse:
                X = np.asarray(X)
        if self.handle_normalization:
            X = normalize(X)
            if not _sparse:
                X = np.asarray(X)
        return X

    def fit_transform(self, X, y=None):
        """Fit on an (n, d) matrix; returns W
        (reference ``sklearn_interface.py:247-282``)."""
        if sp.issparse(X):
            assert (X.data >= 0).all(), 'X must be non-negative'
        else:
            assert np.all(np.asarray(X) >= 0), 'X must be non-negative'

        W_in = self.W if np.asarray(self.W).size > 0 else []
        T_in = self.T if np.asarray(self.T).size > 0 else []
        X = self._preprocess(X)

        soln = nmf(X, self.k, **_merged(
            dict(max_iter=self.max_iter, max_time=7200,
                 project_W_each_iter=False, w_row_sum=1.0,
                 project_T_each_iter=True, t_row_sum=1.0,
                 do_final_project_W=self.do_final_project_W,
                 W_in=W_in, T_in=T_in,
                 reg_w_l1=self.wr1, reg_w_l2=self.wr2, reg_t_l1=self.tr1,
                 reg_t_l2=self.tr2,
                 random_state=self.random_state),
            self.nmf_kwargs))
        self.W = soln.pop('W')
        self.T = soln.pop('T')
        self.nmf_outputs = soln
        return self.W

    def one_iter(self, X):
        """Advance the fit by exactly one iteration; stepped fits compose
        exactly with batch fits (reference ``sklearn_interface.py:284-314``;
        the equivalence is pinned by ``tests/test_nmf.py:97-110``)."""
        W_in = self.W if np.asarray(self.W).size > 0 else []
        T_in = self.T if np.asarray(self.T).size > 0 else []
        X = self._preprocess(X)

        soln = nmf(X, self.k, **_merged(
            dict(max_iter=1, max_time=240,
                 project_W_each_iter=False, w_row_sum=1.0,
                 project_T_each_iter=True, t_row_sum=1.0,
                 do_final_project_W=self.do_final_project_W,
                 W_in=W_in, T_in=T_in,
                 reg_w_l1=self.wr1, reg_w_l2=self.wr2, reg_t_l1=self.tr1,
                 reg_t_l2=self.tr2, random_state=self.random_state),
            self.nmf_kwargs))
        self.W = soln.pop('W')
        self.T = soln.pop('T')
        self.nmf_outputs = soln
        return self

    def fit(self, X, y=None):
        self.fit_transform(X, y)
        return self

    def transform(self, Xnew):
        """Express ``Xnew`` in terms of the learned topics: a few fixed-T
        sweeps (reference ``sklearn_interface.py:320-334``). SciPy-sparse
        input stays sparse through the idf multiply and normalization;
        the driver decides whether the fixed-T sweep runs on the BCOO
        path or densifies."""
        if self.handle_tfidf:
            if sp.issparse(Xnew):
                Xnew = Xnew.multiply(
                    np.asarray(self.idf).reshape(1, -1)).tocsr()
            else:
                Xnew = np.asarray(Xnew) * self.idf
        if self.handle_normalization:
            Xnew = normalize(Xnew)
            if not sp.issparse(Xnew):
                Xnew = np.asarray(Xnew)

        soln = nmf(Xnew, self.k, **_merged(
            dict(max_iter=4, max_time=7200,
                 project_W_each_iter=False, w_row_sum=1.0,
                 t_row_sum=1.0, T_in=self.T,
                 do_final_project_W=self.do_final_project_W,
                 fix_T=True, reg_w_l1=self.wr1, reg_w_l2=self.wr2,
                 reg_t_l1=self.tr1, reg_t_l2=self.tr2,
                 random_state=self.random_state),
            self.nmf_kwargs, drop=_TRANSFORM_DROPPED_KWARGS))
        return soln['W']

    def constrained_transform(self, X):
        return self.transform(X)

    def score(self, X, y=None):
        """R² of reconstructing new X (reference
        ``sklearn_interface.py:339-345``). Sparse input is scored without
        densifying X: ``SST = Σx² − n·Σμ_j²`` and the cross term uses the
        nonzero pattern only."""
        if sp.issparse(X):
            X = X.tocsr()
            n = X.shape[0]
            mu = np.asarray(X.mean(axis=0)).ravel()
            sumsq = float(X.multiply(X).sum())
            SST = sumsq - n * float((mu ** 2).sum())
            W = np.asarray(self.transform(X))
            T = np.asarray(self.T)
            # ||X - WT||² = Σx² − 2·Σ X⊙(WT) + ||WT||²; the middle term
            # touches only the nonzeros (chunked: _sparse_cross_term),
            # the last is k×k Gram work
            cross = _sparse_cross_term(X, W, T)
            wtw = W.T @ W
            ttt = T @ T.T
            SSE = sumsq - 2 * cross + float(np.sum(wtw * ttt))
            return 1 - SSE / SST
        X = np.asarray(X)
        SST = ((X - np.mean(X, axis=0)) ** 2).sum()
        W = self.transform(X)
        SSE = ((X - np.dot(W, self.T)) ** 2).sum()
        return 1 - SSE / SST

    def score_all(self, X, X_counts=None, top_n=10):
        """Score the fit with a battery of metrics — the reference's
        README TODO ("Add a score method to the estimator that uses a
        bunch of scores", reference ``README.md:14``), implemented here.

        Returns a dict with R², relative Frobenius reconstruction error,
        and (when raw term counts ``X_counts`` are given) mean UMass topic
        coherence of the learned topics.

        SciPy-sparse input stays sparse end to end (like :meth:`score`):
        both reconstruction metrics come from the identity
        ``||X - WT||² = Σx² − 2·Σ_nnz X_ij(W_i·T_j) + tr((WᵀW)(TTᵀ))``
        — O(nnz·k + (n+d)k²), no densify at exactly the corpus scale
        this method exists for.
        """
        from rri_nmf_tpu.metrics import (
            frobenius_relative_error, r2_reconstruction, umass_coherence)
        out = {}
        if sp.issparse(X):
            X = X.tocsr()
            n = X.shape[0]
            W = np.asarray(self.transform(X))
            T = np.asarray(self.T)
            sumsq = float(X.multiply(X).sum())
            cross = _sparse_cross_term(X, W, T)
            SSE = sumsq - 2 * cross + float(np.sum((W.T @ W) * (T @ T.T)))
            mu = np.asarray(X.mean(axis=0)).ravel()
            SST = sumsq - n * float((mu ** 2).sum())
            out['r2'] = 1 - SSE / SST
            out['rel_frobenius_error'] = float(
                np.sqrt(max(SSE, 0.0) / sumsq))
        else:
            X = np.asarray(X)
            W = self.transform(X)
            out['r2'] = r2_reconstruction(X, W, self.T)
            out['rel_frobenius_error'] = frobenius_relative_error(
                X, W, self.T)
        if X_counts is not None:
            out['umass_coherence'] = umass_coherence(X_counts, self.T,
                                                     top_n=top_n)
        return out
