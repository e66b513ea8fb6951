"""Per-topic quadratic subproblem solver and stopping conditions.

Equivalent of the reference's ``optimization.py``
(/root/reference/src/rri_nmf/optimization.py). The core is ``qf_min``:
the closed-form solution of

    min_{0 <= x <= ub, sum(x) = s}  w^T x + 0.5 x^T diag(c) x

used for every T-row and W-column update of the RRI sweep
(reference ``optimization.py:12-88``; called at ``nmf.py:447,469``).

Two layers:

- :func:`qf_min` — public, host-friendly API with the reference's exact
  signature, semantics, and return contract ``(x, pre-scale l1 norm)``.
- :func:`qf_min_scalar_c` / :func:`qf_min_vector_c` — jit-internal variants
  where the ``s``/``ub`` *structure* (None-ness, scalar vs vector) is static
  and only the data is traced, so the sweep kernels stay fully compiled with
  ``lax.cond`` for the data-dependent curvature sign.

Semantics preserved from the reference, branch by branch
(``optimization.py:42-88``):

- bound normalization: if ``s`` is truthy, ``ub = min(ub, s)`` (or ``s`` if
  ``ub`` is falsy);
- scalar ``c > 0``: ``x = [-w]_+ / (c + eps)``; the returned norm is the
  *pre-projection* l1 norm; simplex-project only when ``s`` is given; ``ub``
  is NOT enforced on this branch (the caller's outer projection handles it);
- scalar ``c <= 0`` (concave/linear): vertex solution — with ``s`` the whole
  mass goes to ``argmin(w)``; without ``s``, coordinates with ``w + c < 0``
  saturate at ``ub``; returned norm is 1.0;
- vector ``c`` (masked WRRI path, Ho's Lemma 6.5): elementwise
  ``[-w]_+ / c`` on the ``c > 0`` coordinates, clip to ``ub``, then *rescale*
  (not project) to sum ``s``.

Deviations from the reference (deliberate fixes, flagged in SURVEY.md §7):

- the vector-``c`` rescale guards against ``x.sum() == 0`` (reference NaNs,
  ``optimization.py:86``);
- the scalar ``c <= 0`` vertex solution generalizes to any ``s`` (reference
  raises NotImplementedError for ``s != 1.0``, ``optimization.py:72-73``);
- inside jit, unbounded configurations produce ``inf`` instead of raising
  (the ``nmf()`` driver pre-validates all standard configurations and
  returns the reference's sentinel solutions, ``nmf.py:292-315``). The host
  ``qf_min`` still raises ``ValueError`` like the reference.

The reference's exploratory solvers (``kkt_qf_min``, ``optimize_scipy``,
``optimization.py:110-282`` — never called by the reference library or its
tests) are rebuilt here as working host-side utilities and double as test
oracles for :func:`qf_min`.
"""

import jax.numpy as jnp
import numpy as np
from jax import lax

from rri_nmf_tpu.matrixops import EPS_DIV_BY_ZERO, _proj_simplex_core

constraint_violation_tolerance = 1e-13


def _normalize_ub(s, ub):
    """Reference ``optimization.py:43-49``: reconcile sum and upper bounds.

    ``s`` and ``ub`` here are static Python numbers (or None); truthiness
    (not None-ness) gates, exactly like the reference.
    """
    if s:
        if ub:
            return min(ub, s)
        return s  # since x >= 0
    return ub


def qf_min_scalar_c(w, c, s, ub):
    """Jit-internal qf_min for scalar curvature ``c`` (traced scalar).

    ``s`` and ``ub`` must be static (Python float / None), except ``ub`` may
    be a traced array for per-row bounds; the curvature sign branch is a
    ``lax.cond`` so only the taken branch executes at runtime.

    Returns ``(x, nx)`` with the reference's norm contract
    (``optimization.py:51-74``).
    """
    dtype = w.dtype
    ub_is_static = ub is None or np.isscalar(ub)
    if ub_is_static:
        ub_eff = _normalize_ub(s, ub)
    else:
        ub_eff = ub.reshape(-1)  # traced per-coordinate bound
        if s:
            ub_eff = jnp.minimum(ub_eff, s)

    def _positive(_):
        x = jnp.maximum(-w, 0.0) / (c + EPS_DIV_BY_ZERO)
        nx = jnp.sum(x)
        if s is not None:
            x = _proj_simplex_core(x, jnp.asarray(s, dtype=dtype))
        return x, nx

    def _nonpositive(_):
        if s is None:
            if ub_eff is None:
                # reference raises (optimization.py:67,105-107); under jit we
                # surface the unboundedness as inf.
                bound = jnp.asarray(jnp.inf, dtype=dtype)
            else:
                bound = jnp.asarray(ub_eff, dtype=dtype)
            x = jnp.where(w + c < 0, bound, jnp.zeros_like(w))
        else:
            # vertex of the simplex: all mass on the least-cost coordinate
            # (reference optimization.py:68-70, generalized beyond s == 1.0)
            i = jnp.argmin(w)
            x = jnp.zeros_like(w).at[i].set(jnp.asarray(s, dtype=dtype))
        return x, jnp.asarray(1.0, dtype=dtype)

    return lax.cond(c > 0, _positive, _nonpositive, None)


def qf_min_vector_c(w, c, s, ub):
    """Jit-internal qf_min for per-coordinate curvature ``c`` (WRRI path).

    Reference ``optimization.py:75-88``: solve on the ``c > 0`` coordinates,
    clip to ``ub``, rescale (not project) to sum ``s``. ``s`` static;
    ``ub`` static or traced array.
    """
    ub_is_static = ub is None or np.isscalar(ub)
    if ub_is_static:
        ub_eff = _normalize_ub(s, ub)
    else:
        ub_eff = ub.reshape(-1)
        if s:
            ub_eff = jnp.minimum(ub_eff, s)

    denom_safe = jnp.where(c > 0, c, 1.0) + EPS_DIV_BY_ZERO
    x = jnp.where(c > 0, jnp.maximum(-w, 0.0) / denom_safe, 0.0)
    if ub_eff is not None:
        x = jnp.minimum(x, ub_eff)
    nx = jnp.sum(x)
    if s is not None:
        # guarded rescale: the reference divides by x.sum() unguarded and can
        # NaN when the row dies (optimization.py:86); keep x = 0 instead.
        x = jnp.where(nx > 0, s * x / jnp.where(nx > 0, nx, 1.0), x)
    return x, nx


def qf_min(w, c, s=1.0, ub=1.0, x0=None):
    """Minimize ``w^T x + 0.5 x^T diag(c) x`` over ``{0 <= x <= ub, sum x = s}``.

    Public host API with the reference's exact signature and return contract
    (``optimization.py:12-88``): returns ``(x, nx)`` where ``nx`` is the l1
    norm of ``x`` *before* the final projection/rescale — the caller uses it
    for the RRI scale-invariance transfer (reference ``nmf.py:447-452``).

    Raises ``ValueError`` for unbounded configurations, like the reference.

    Parity quirk kept deliberately: the scalar-``c > 0`` branch never
    applies ``ub`` (reference ``optimization.py:53-59`` — with ``s`` the
    result is the Duchi simplex projection, without ``s`` the raw
    per-coordinate minimizer); only the vector-``c`` branch clips to
    ``ub``. The driver always passes ``ub == s`` on the scalar path, so
    the bound can never bind there. A concave objective with a sum
    constraint and a BINDING bound (``ub < s``) raises
    ``NotImplementedError`` instead of returning the reference's
    infeasible all-mass vertex.
    """
    w = jnp.asarray(w)
    d = w.size
    # per-coordinate ub is supported (the solvers take traced arrays);
    # Python truthiness on an ndarray would raise, so every gate below
    # uses explicit None/size checks
    _ub_vec = ub is not None and not np.isscalar(ub)
    ub_full = (np.broadcast_to(np.asarray(ub, dtype=float).reshape(-1),
                               (d,))
               if _ub_vec else None)
    if s:
        if ub is not None:
            cap = (float(np.sum(np.minimum(ub_full, s))) if _ub_vec
                   else d * min(float(ub), s))
            assert cap >= s, ('Impossible to satisfy sum and upper '
                              'bound constraints.')
        # _normalize_ub applied inside the branch helpers

    if np.isscalar(c) or np.ndim(c) == 0:
        c = float(c)
        if c <= 0 and s is None and ub is None:
            raise ValueError(
                'Minimum objective is unbounded. w={w}, c={c}, s={s}, ub={ub}'
                .format(w=w, c=c, s=s, ub=ub))
        if c <= 0 and s is not None and ub is not None:
            # the concave-branch vertex puts all mass s on one coordinate;
            # when an upper bound binds (some ub_i < s) that vertex can be
            # infeasible and the true optimum mixes coordinates — refuse
            # rather than return a constraint-violating answer (the
            # reference raises for EVERY concave sum-constrained case,
            # optimization.py:67-70; this keeps its generalization only
            # where the vertex solution is exact)
            ub_min = float(np.min(ub_full)) if _ub_vec else float(ub)
            if ub_min < s:
                raise NotImplementedError(
                    'qf_min: concave objective with a sum constraint and '
                    'binding upper bounds (ub < s) is not supported')
        ub_arg = ub if (ub is None or np.isscalar(ub)) else jnp.asarray(ub)
        x, nx = qf_min_scalar_c(w, jnp.asarray(c, dtype=w.dtype), s, ub_arg)
        return x, nx
    elif np.shape(w) == np.shape(c):
        c = jnp.asarray(c)
        if bool(jnp.any(c < 0)) and (s is None and ub is None):
            raise ValueError(
                'Minimum objective is unbounded. w={w}, c={c}, s={s}, ub={ub}'
                .format(w=w, c=c, s=s, ub=ub))
        ub_arg = ub if (ub is None or np.isscalar(ub)) else jnp.asarray(ub)
        return qf_min_vector_c(w, c, s, ub_arg)
    else:
        raise ValueError('c must be a scalar or have the shape of w')


def kkt_qf_min(w, d, s=1.0, ub=1.0):
    """Active-set KKT solver for ``min wᵀx + xᵀdiag(d)x`` on
    ``{0 <= x <= ub, Σx = s}`` with per-coordinate curvature.

    Host-side counterpart of the reference's exploratory ``kkt_qf_min``
    (``optimization.py:110-150``; never called by the reference library or
    tests — provided for inventory parity and as an oracle for
    :func:`qf_min`). Re-derivation, not a translation: grow the support set
    S greedily; on S the stationarity system ``2 d x + w + λ = 0``,
    ``Σx = s`` has the closed form ``λ = -(s + Σ w_i/(2 d_i)) / Σ 1/(2 d_i)``
    and ``x_i = -(w_i + λ)/(2 d_i)``; clip to the box, add coordinates whose
    KKT multiplier is violated, repeat.

    Requires positive curvature (convex case). Returns the optimal x.

    Method: stationarity + complementary slackness give
    ``x_i(λ) = clip(-(w_i + λ) / (2 d_i), 0, ub)`` for the multiplier λ of
    the sum constraint; ``Σ x_i(λ)`` is continuous, piecewise-linear, and
    non-increasing in λ, so the KKT system reduces to a 1-D monotone root
    find — solved exactly on the breakpoint grid.
    """
    w = np.asarray(w, dtype=float)
    d = np.asarray(d, dtype=float)
    if np.ndim(d) == 0:
        d = np.full_like(w, float(d))
    assert np.all(d > 0), 'kkt_qf_min requires positive curvature'
    assert w.size * ub >= s - 1e-15, 'infeasible: n*ub < s'

    def x_of(lam):
        return np.clip(-(w + lam) / (2.0 * d), 0.0, ub)

    # breakpoints where coordinates hit the box faces
    bps = np.unique(np.concatenate([-w, -w - 2.0 * d * ub]))
    sums = np.array([x_of(b).sum() for b in bps])  # non-increasing in λ
    # locate the segment [bps[j-1], bps[j]] containing the root
    j = int(np.searchsorted(-sums, -s, side='left'))
    if j == 0:
        lam = bps[0]
    elif j >= len(bps):
        lam = bps[-1]
    else:
        lo, hi = bps[j - 1], bps[j]
        slo, shi = sums[j - 1], sums[j]
        lam = lo if slo == shi else lo + (slo - s) * (hi - lo) / (slo - shi)
    x = x_of(lam)
    # linear-segment interpolation is exact; tiny float residue rescales on
    # the interior coordinates
    interior = (x > 0) & (x < ub)
    resid = s - x.sum()
    if abs(resid) > 1e-12 and interior.any():
        x[interior] += resid / interior.sum()
        x = np.clip(x, 0.0, ub)
    return x


def optimize_scipy(w, c, s, ub, x0=None):
    """SLSQP + COBYLA cross-check solver for the qf_min QP.

    Counterpart of the reference's dead ``optimize_scipy``
    (``optimization.py:232-282``) with its missing-return bug fixed:
    returns ``(x, ||x||_1)`` like :func:`qf_min`. Used as a test oracle.
    """
    from scipy.optimize import minimize
    w = np.asarray(w, dtype=float)
    c = np.asarray(c, dtype=float)
    if np.ndim(c) == 0:
        c = np.full_like(w, float(c))
    bounds = [(0.0, ub)] * w.size

    def f(x):
        return float(np.sum(w * x) + 0.5 * np.sum(c * x * x))

    def jac(x):
        return w + c * x

    constraints = []
    if s:
        constraints = [{'type': 'eq', 'fun': lambda x: np.sum(x) - s,
                        'jac': lambda x: np.ones_like(x)}]

    if x0 is None:
        x0 = np.zeros_like(w)
        pos = c > 0
        x0[pos] = np.maximum(-w[pos], 0) / (c[pos] + EPS_DIV_BY_ZERO)
        if s:
            if x0.sum() > EPS_DIV_BY_ZERO:
                x0 = s * x0 / x0.sum()
            else:
                x0[np.argmin(w + c)] = min(ub, s) if ub else s

    res = minimize(f, x0, bounds=bounds, jac=jac, method='SLSQP',
                   constraints=constraints, options={'maxiter': 200})
    cv = abs(np.sum(res.x) - s) if s else 0.0
    cv += float(np.clip(-res.x, 0, None).sum())
    if cv > 1e-8:
        raise ValueError('solver violated constraints by %g' % cv)
    x = np.clip(res.x, 0.0, None)
    return x, float(np.sum(np.abs(x)))


def projected_gradient_norm(grad, vec, lb=0.0, ub=np.inf,
                            zero=EPS_DIV_BY_ZERO):
    """Squared Frobenius norm of the projected gradient (CJ Lin's
    projected-gradient stopping criterion for NMF).

    Reference ``nmf.py:882-911`` (and ``_projected_gradient`` at
    ``nmf.py:612-630``): coordinates strictly inside the box contribute
    their gradient; at the lower bound only negative components count, at
    the upper bound only positive ones. The reference computed this but
    commented its output out of the result dict (``nmf.py:556``); here it
    is a supported utility (e.g. as an alternative stopping criterion).
    Fully vectorized and jittable.
    """
    grad = jnp.asarray(grad)
    vec = jnp.asarray(vec)
    lo = lb + zero
    hi = ub - zero
    interior = jnp.logical_and(vec > lo, vec < hi)
    gpe = jnp.where(interior, grad,
                    jnp.where(vec <= lo, jnp.minimum(grad, 0.0),
                              jnp.maximum(grad, 0.0)))
    return jnp.sum(gpe * gpe)


def universal_stopping_condition(obj_history, eps_stop=1e-4):
    """Stop when the last objective change is <= ``eps_stop`` × the first
    change (reference ``optimization.py:284-291``; used at ``nmf.py:510``)."""
    if len(obj_history) < 2:
        return False  # don't stop
    d1 = abs(obj_history[0] - obj_history[1])
    de = abs(obj_history[-1] - obj_history[-2])
    return de <= eps_stop * d1


def first_last_stopping_condition(obj_history, eps_stop=1e-4):
    """Stop when the objective has shrunk to ``eps_stop`` × its initial value
    (reference ``optimization.py:294-297``; imported by the reference driver
    but unused there — kept for API parity)."""
    if len(obj_history) < 2:
        return False
    return obj_history[-1] <= obj_history[0] * eps_stop
