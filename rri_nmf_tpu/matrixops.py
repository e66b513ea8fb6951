"""Leaf-layer array math: simplex projections, normalization, tfidf, helpers.

Equivalents of the reference's ``matrixops.py``
(/root/reference/src/rri_nmf/matrixops.py). Everything here is pure
``jax.numpy`` and jit-/vmap-safe; the sort-based Duchi simplex projection
(reference ``matrixops.py:5-69``) becomes ``jnp.sort`` + ``cumsum`` which XLA
lowers to an efficient on-device bitonic sort, and the row-wise matrix
projection (reference ``matrixops.py:72-100``, a Python loop) becomes a
``vmap`` so all rows project in one fused kernel.

Functions accept NumPy or JAX arrays (SciPy sparse inputs are densified —
the device compute path is dense) and return JAX arrays.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Added to denominators to avoid division by zero; same constant as the
# reference (``nmf.py:52``, ``optimization.py:5``): np.spacing(10).
EPS_DIV_BY_ZERO = float(np.spacing(10))


def _densify(X):
    """Convert SciPy sparse input to dense (host-side only)."""
    if hasattr(X, 'toarray'):  # scipy.sparse matrix
        return X.toarray()
    return X


@partial(jax.jit, static_argnames=())
def _proj_simplex_core(v, s):
    """Jittable Duchi et al. (ICML'08) projection of a vector onto
    ``{x : x >= 0, sum(x) = s}``.

    Matches the reference algorithm (``matrixops.py:53-65``) including the
    exact already-on-simplex shortcut (``matrixops.py:53-55``): if ``v`` is
    feasible it is returned bit-for-bit unchanged.
    """
    n = v.shape[0]
    on_simplex = jnp.logical_and(jnp.sum(v) == s, jnp.all(v >= 0))
    u = jnp.sort(v)[::-1]
    cssv = jnp.cumsum(u)
    ar = jnp.arange(1, n + 1, dtype=v.dtype)
    cond = u * ar > (cssv - s)
    # last index where cond holds; cond[0] is always True since s > 0
    rho = jnp.max(jnp.where(cond, jnp.arange(n), -1))
    theta = (cssv[rho] - s) / (rho + 1.0)
    w = jnp.clip(v - theta, 0.0, None)
    return jnp.where(on_simplex, v, w)


def reproject_row_if_drifted(row, target_sum, dtype, extra_pred=None):
    """Shared drifted-row reprojection used by every sweep (reference
    ``nmf.py:758-761``, threshold 1e-15): returns ``row`` projected onto
    the ``target_sum`` simplex when its sum has drifted, unchanged
    otherwise. The ``lax.cond`` carries ONLY the row — never the
    enclosing factor matrix, whose branch-tuple copies XLA would
    materialize on every call.
    ``extra_pred`` conjoins an additional guard (e.g. topic aliveness in
    the reset check — a dead row must not be projected to uniform)."""
    from jax import lax
    pred = jnp.abs(jnp.sum(row) - target_sum) > 1e-15
    if extra_pred is not None:
        pred = jnp.logical_and(extra_pred, pred)
    return lax.cond(
        pred,
        lambda: _proj_simplex_core(
            row, jnp.asarray(target_sum, dtype=dtype)).astype(dtype),
        lambda: row)


def euclidean_proj_simplex(v_in, s=1.0):
    """Euclidean projection onto the positive simplex of radius ``s``.

    Solves ``min_w 0.5||w - v||^2  s.t. sum(w) = s, w >= 0`` via the
    O(n log n) sort-based algorithm of Duchi et al., mirroring the reference
    (``matrixops.py:5-69``). Sparse inputs are densified; the result has the
    input's shape.
    """
    assert s > 0, 'Radius s must be strictly positive (%s <= 0)' % s
    v_in = _densify(v_in)
    shape = np.shape(v_in)
    v = jnp.asarray(v_in).reshape(-1)
    w = _proj_simplex_core(v, jnp.asarray(s, dtype=v.dtype))
    return w.reshape(shape)


def proj_mat_to_simplex(W, s=1.0, axis=1):
    """Project vectors of ``W`` along ``axis`` onto simplices of radius ``s``.

    Reference: ``matrixops.py:72-100`` (a per-row Python loop); here a single
    ``vmap`` over rows so the whole matrix projects in one fused device
    kernel. ``s`` may be a scalar or a per-vector array.
    """
    W = jnp.asarray(_densify(W))
    if axis == 0:
        return proj_mat_to_simplex(W.T, s, axis=1).T
    if axis != 1:
        raise ValueError('axis must be 0 or 1')
    n = W.shape[0]
    if np.isscalar(s) or np.ndim(s) == 0:
        s_vec = jnp.full((n,), s, dtype=W.dtype)
    else:
        s_arr = jnp.asarray(s).reshape(-1)
        assert s_arr.size == n, (
            'proj_mat_to_simplex: expected s to have size {n} but s has '
            'size {s}'.format(n=n, s=s_arr.size))
        s_vec = s_arr.astype(W.dtype)
    return jax.vmap(_proj_simplex_core)(W, s_vec)


def normalize(X, dim=1, zero_sum_fix=True):
    """Normalize ``X`` so vectors along ``dim`` sum to 1.

    ``dim=1`` normalizes rows (default), ``dim=0`` columns. With
    ``zero_sum_fix`` (default), vectors whose sum is below ``1e-10`` are
    replaced by the uniform distribution — reference ``matrixops.py:124-163``.

    SciPy sparse inputs stay sparse (host path, feeding
    ``nmf(sparse=True)``); the zero-sum fix is skipped there — filling a
    zero row with the uniform distribution would densify it — and all-zero
    vectors remain zero.
    """
    if hasattr(X, 'tocsr') and hasattr(X, 'multiply'):  # scipy sparse
        import scipy.sparse as sp
        X = X.tocsr() if dim == 1 else X.tocsc()
        sums = np.asarray(X.sum(axis=dim)).ravel() + np.spacing(1)
        inv = 1.0 / sums
        if dim == 1:
            return sp.diags(inv) @ X
        return X @ sp.diags(inv)
    X = jnp.asarray(_densify(X))
    if X.dtype not in (jnp.float32, jnp.float64, jnp.bfloat16, jnp.float16):
        X = X.astype(jnp.result_type(float))
    if dim == 1:
        xs = jnp.sum(X, axis=1) + np.spacing(1)
        Xn = X / xs[:, None]
        if zero_sum_fix:
            uniform = 1.0 / X.shape[1]
            Xn = jnp.where((xs < 1e-10)[:, None], uniform, Xn)
        return Xn
    elif dim == 0:
        xs = jnp.sum(X, axis=0) + np.spacing(1)
        Xn = X / xs[None, :]
        if zero_sum_fix:
            uniform = 1.0 / X.shape[0]
            Xn = jnp.where((xs < 1e-10)[None, :], uniform, Xn)
        return Xn
    else:
        raise ValueError('Unknown dim=%r' % (dim,))


def normalize_l2(X, dim=1):
    """Normalize vectors of ``X`` along ``dim`` to unit l2 norm
    (reference ``matrixops.py:103-121``)."""
    X = jnp.asarray(_densify(X))
    if dim == 1:
        xs = 1.0 / jnp.sqrt(jnp.sum(X ** 2, axis=1) + 1e-10)
        return X * xs[:, None]
    elif dim == 0:
        return normalize_l2(X.T, 1).T
    else:
        raise ValueError('dim must be 0 or 1')


def tfidf(X, return_idf=False):
    """Transform an n-docs × d-features count matrix to TF-IDF.

    ``idf = log(n / df)`` with the reference's epsilon regularization
    (``matrixops.py:166-179``). SciPy sparse inputs stay sparse, like the
    reference's sparse branch (``matrixops.py:173-175``).
    """
    if hasattr(X, 'tocsr') and hasattr(X, 'multiply'):  # scipy sparse
        Xc = X.tocsc()
        n, d = Xc.shape
        df = np.asarray((Xc > 0).sum(axis=0)).ravel()
        idf = np.log(n / (df + np.spacing(1)))
        rtvx = Xc.multiply(idf[None, :]).tocsr()
        if return_idf:
            return rtvx, idf
        return rtvx
    if isinstance(X, np.ndarray) and X.ndim == 2:
        # host path: document frequencies via the native (C++/OpenMP)
        # kernel — same counts, computed before the matrix ships to device
        from rri_nmf_tpu import native
        n = X.shape[0]
        df = np.asarray(native.column_df(X), dtype=np.float64)
        idf = jnp.asarray(np.log(n / (df + np.spacing(1))))
        rtvx = jnp.asarray(X) * idf
        if return_idf:
            return rtvx, idf
        return rtvx
    X = jnp.asarray(_densify(X))
    n, d = X.shape
    df = jnp.sum(X > 0, axis=0)
    idf = jnp.log(n / (df + np.spacing(1)))
    rtvx = X * idf
    if return_idf:
        return rtvx, idf
    return rtvx


def labels_to_mat(y):
    """(n,) label vector → (n,k) one-hot rows; or row-normalize an existing
    (n,k) soft-label matrix (reference ``matrixops.py:182-200``)."""
    y = np.asarray(_densify(y))
    if y.size == y.shape[0]:
        # covers (n,) AND (n,1): ravel before the fancy index — an (n,1)
        # index column would broadcast against arange(n) into an (n,n)
        # index set and silently return all-ones rows
        y = y.reshape(-1)
        k = len(np.unique(y))
        W = np.zeros((y.size, k))
        W[np.arange(y.size), y.astype(int)] = 1
        return jnp.asarray(W)
    if abs(y.sum() - y.shape[0]) < 1e-5:  # already normalized
        return jnp.asarray(y)
    k = len(np.unique(y))
    if y.shape[1] == k:
        return normalize(y)
    raise ValueError(
        'labels_to_mat: number of columns of y = {0} doesnt match number of '
        'unique elements {1}'.format(y.shape[1], k))


def harden_distributions(W):
    """Argmax-harden each row's distribution to a one-hot row
    (reference ``matrixops.py:203-209``)."""
    W = jnp.asarray(_densify(W))
    I = jnp.argmax(W, axis=1)
    return jax.nn.one_hot(I, W.shape[1], dtype=W.dtype)


def col_vector(x):
    """Reshape (n,) → (n,1) (reference ``matrixops.py:212-214``)."""
    return jnp.asarray(x).reshape(-1, 1)


def stack_matrices(L, dict_key=None, transform=None, dim='tall'):
    """Stack a list of matrices (or dicts of matrices) vertically or
    horizontally (reference ``matrixops.py:217-267``). Host-side helper used
    by ``store_gradients`` output assembly."""
    assert isinstance(L[0], (np.ndarray, jnp.ndarray)) or (
        isinstance(L[0], dict) and dict_key), (
        'if L is a list of arrays no dict_key is needed; if L is a list of '
        'dicts, dict_key must be the key of the matrices to stack.')
    if dim == 'tall':
        stack_op = np.vstack
    elif dim == 'fat':
        stack_op = np.hstack
    else:
        raise AssertionError('dim must be "tall" or "fat".')

    mats = []
    for E in L:
        if dict_key:
            try:
                M = E[dict_key]
            except TypeError:
                M = getattr(E, dict_key)
        else:
            M = E
        M = np.asarray(M)
        if transform:
            M = transform(M)
        mats.append(M)
    return stack_op(mats)
