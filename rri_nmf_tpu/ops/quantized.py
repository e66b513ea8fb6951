"""Column-scaled int16 storage of X: 2 bytes/entry at ~70x less
quantization noise than bfloat16.

Motivation: when X must be stored in 2 bytes/entry (a dense X too large
for the device in float32), ``bfloat16`` storage quantizes X at RMS
``2^-9/sqrt(3) ~ 1.1e-3`` relative, and exact RRI converges to about the
storage noise — so bf16 caps the reachable relative Frobenius error near
1e-3, above the 1e-4 target.
A per-column linear int16 code ``X ~ q * s[None, :]`` with
``s_j = colmax_j / 32767`` stores the same 2 bytes/entry at RMS
relative noise ~2e-5 for concentrated nonnegative data, putting the
one-chip floor BELOW 1e-4.

Device mapping: ``q`` converts int16 -> f32 exactly; the two sweep GEMMs
run as mixed ``f32 x (int16->f32)`` dots whose operand upcast XLA may
fuse into the GEMM (same pattern as the bf16 mixed-storage path,
``ops/dense_phase.py``). The per-column scale folds OUTSIDE the GEMMs:

- T-phase numerator:  ``Wᵀ X_real = (Wᵀ q) ⊙ sᵀ``      (O(kd) postscale)
- W-phase numerator:  ``X_real Tᵀ = q (T ⊙ sᵀ)ᵀ``      (O(kd) prescale)
- residuals/objective: blockwise ``q_blk.astype(acc) * s``

so quantized storage costs the same GEMM passes as an f32-precision
mixed-bf16 sweep. No reference counterpart (the reference is dense f64
NumPy, ``/root/reference/src/rri_nmf/nmf.py``); this is the library's
own beyond-memory scale axis (SURVEY §5.7).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@jax.tree_util.register_pytree_node_class
class QuantizedX:
    """Column-scaled int16 code of a nonnegative dense matrix.

    ``q`` — (n, d) int16 in [0, 32767]; ``s`` — (d,) float scale;
    the represented matrix is ``q * s[None, :]``. ``dtype`` reports the
    REAL (dequantized) dtype so shared dtype-resolution logic
    (``ops.sweep_xla.resolve_mixed_dtypes``) sees a wide X.
    """

    __slots__ = ('q', 's')

    def __init__(self, q, s):
        self.q = q
        self.s = s

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return 2

    @property
    def dtype(self):
        return self.s.dtype

    def tree_flatten(self):
        return (self.q, self.s), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def __repr__(self):
        return 'QuantizedX(shape=%r, dtype=%r)' % (
            tuple(self.shape), str(self.dtype))


@partial(jax.jit, static_argnames=('dtype',))
def _quantize(X, dtype):
    Xw = X.astype(dtype)
    s = jnp.max(Xw, axis=0) / dtype.type(32767)
    s = jnp.where(s > 0, s, dtype.type(1))
    q = jnp.clip(jnp.round(Xw / s), 0, 32767).astype(jnp.int16)
    return QuantizedX(q, s)


def quantize_x(X, dtype=None):
    """Encode a nonnegative dense X (device or host array) as
    :class:`QuantizedX`. ``dtype`` sets the scale/dequantized dtype
    (default: X's floating dtype, or the default float for ints).

    Negative entries are rejected (the code is nonnegative — the NMF
    input contract; clipping silently would fit a different problem,
    and the driver's ``x_dtype='int16'`` host path raises the same
    way). Under a jit trace the check cannot run (value-dependent);
    callers quantizing traced values keep the clip-at-0 semantics."""
    X = jnp.asarray(X)
    if dtype is None:
        dtype = X.dtype if jnp.issubdtype(X.dtype, jnp.floating) \
            else jnp.dtype(jnp.result_type(float))
    if not isinstance(X, jax.core.Tracer) and X.size \
            and float(jnp.min(X)) < 0:
        raise ValueError('quantize_x encodes nonnegative X only (NMF '
                         'input contract); found negative entries — '
                         'shift/clip explicitly first')
    return _quantize(X, jnp.dtype(dtype))


def dequantize_x(qx):
    """Materialize the full dequantized matrix (small inputs/tests only —
    this is exactly the allocation quantized storage exists to avoid)."""
    return qx.q.astype(qx.dtype) * qx.s[None, :]


# ---------------------------------------------------------------------------
# fused-upcast contractions (the only ways sweeps touch X)
# ---------------------------------------------------------------------------

def _hi():
    return lax.Precision.HIGHEST


def qx_t_numerator(W, qx, acc):
    """``Wᵀ X_real`` as one mixed GEMM + O(kd) column postscale:
    ``(Wᵀ q) ⊙ sᵀ`` -> (k, d) in ``acc``."""
    Wq = lax.dot_general(W, qx.q.astype(W.dtype),
                         (((0,), (0,)), ((), ())),
                         preferred_element_type=acc,
                         precision=_hi())                 # (k, d)
    return Wq * qx.s.astype(acc)[None, :]


def qx_w_numerator(T, qx, acc):
    """``X_real Tᵀ`` transposed to (k, n): prescale T's columns then one
    mixed GEMM — ``(T ⊙ sᵀ) qᵀ``."""
    Ts = T * qx.s.astype(T.dtype)[None, :]
    return lax.dot_general(Ts, qx.q.astype(T.dtype),
                           (((1,), (1,)), ((), ())),
                           preferred_element_type=acc,
                           precision=_hi())               # (k, n)


def qx_row_block(qx, off, rows, acc):
    """Dequantized (rows, d) row block starting at ``off`` (traced)."""
    qb = lax.dynamic_slice(qx.q, (off, 0), (rows, qx.q.shape[1]))
    return qb.astype(acc) * qx.s.astype(acc)[None, :]


def qx_col_block(qx, off, cols, acc):
    """Dequantized (n, cols) column block starting at ``off`` (traced)."""
    qb = lax.dynamic_slice(qx.q, (0, off), (qx.q.shape[0], cols))
    sb = lax.dynamic_slice(qx.s, (off,), (cols,))
    return qb.astype(acc) * sb.astype(acc)[None, :]


def qx_mean(qx):
    """Mean of the dequantized matrix without materializing it:
    ``mean_j(s_j * mean_i(q_ij))``."""
    colmeans = jnp.mean(qx.q.astype(qx.dtype), axis=0)
    return jnp.mean(colmeans * qx.s)


def qx_rmul(qx, Omega, acc):
    """``X_real @ Omega`` -> (n, p): prescale Omega's rows by ``s`` then
    one mixed GEMM against ``q`` (scale folds outside the X pass)."""
    Os = Omega * qx.s.astype(Omega.dtype)[:, None]
    return lax.dot_general(qx.q.astype(Omega.dtype), Os,
                           (((1,), (0,)), ((), ())),
                           preferred_element_type=acc,
                           precision=_hi())


def qx_lmul_t(qx, Q, acc):
    """``X_realᵀ @ Q`` -> (d, p): one mixed GEMM + row postscale."""
    QtX = lax.dot_general(qx.q.astype(Q.dtype), Q,
                          (((0,), (0,)), ((), ())),
                          preferred_element_type=acc,
                          precision=_hi())                # (d, p)
    return QtX * qx.s.astype(acc)[:, None]
