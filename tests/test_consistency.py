"""Cross-path consistency tests the reference never had (SURVEY.md §4):

- masked path with an all-ones mask must track the unweighted path's
  objective trajectory (same fixed-point family; per-topic subproblems agree
  since a ones-mask vector denominator equals the scalar denominator);
- row-weighted fit with unit weights equals the unweighted fit;
- the incremental masked residual must not drift from the definitional
  residual; DP noise with huge epsilon (≈ no noise) behaves like no DP.
"""

import numpy as np

from rri_nmf_tpu.nmf import nmf


def _problem(n=30, d=20, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) +
                  0.01 * rng.rand(n, d))


def test_all_ones_mask_equals_unweighted_updates():
    """A W_mat of all ones and the unweighted path solve the same per-topic
    subproblems; with identical inits the factors must match closely.

    (The masked path's vector denominator is then constant = the scalar
    denominator, and qf_min's vector branch with s=None, ub=None reduces to
    the scalar branch's division.)
    """
    X = _problem()
    n, d = X.shape
    common = dict(k=4, max_iter=8, random_state=0, reset_topic_method=None,
                  compute_obj_each_iter=True, project_T_each_iter=False,
                  project_W_each_iter=False, w_row_sum=None, t_row_sum=None,
                  early_stop=False)
    s_unw = nmf(X, **common)
    s_msk = nmf(X, W_mat=np.ones_like(X), **common)
    assert np.allclose(s_unw['W'], s_msk['W'], atol=1e-8)
    assert np.allclose(s_unw['T'], s_msk['T'], atol=1e-8)
    assert np.allclose(s_unw['obj_history'], s_msk['obj_history'], atol=1e-8)


def test_unit_w_row_matches_unweighted_factor_quality():
    """w_row of all ones must give the same solution as no weighting, up to
    the reference's extra post-solve W re-fit (nmf.py:531-539)."""
    X = _problem()
    base = nmf(X, k=3, max_iter=6, random_state=0, w_row_sum=1.0,
               project_W_each_iter=True, compute_obj_each_iter=True,
               early_stop=False)
    weighted = nmf(X, k=3, max_iter=6, random_state=0, w_row_sum=1.0,
                   w_row=np.ones((X.shape[0], 1)),
                   project_W_each_iter=True, compute_obj_each_iter=True,
                   early_stop=False)
    # trajectories agree over the shared iterations
    m = min(len(base['obj_history']), 6)
    assert np.allclose(base['obj_history'][:m],
                       weighted['obj_history'][:m], rtol=1e-10)
    assert np.allclose(base['T'], weighted['T'], atol=1e-8)


def _proj_simplex_np(v, s):
    """Duchi sort-based simplex projection (oracle copy)."""
    u = np.sort(v)[::-1]
    css = np.cumsum(u)
    rho = np.nonzero(u * np.arange(1, v.size + 1) > (css - s))[0][-1]
    theta = (css[rho] - s) / (rho + 1.0)
    return np.clip(v - theta, 0, None)


def _qf_vector_np(numer, denom, s, ub):
    """qf_min's vector branch (optimization.qf_min_vector_c semantics):
    solve on the denom > 0 coordinates, clip to ub, rescale (not
    project) to sum s; the returned norm is taken AFTER the clip and
    BEFORE the rescale."""
    eps = np.spacing(10)
    x = np.where(denom > 0,
                 np.maximum(numer, 0) / (np.where(denom > 0, denom, 1.0)
                                         + eps), 0.0)
    ub_eff = ub if s is None or ub is None else min(ub, s)
    if ub_eff is not None:
        x = np.minimum(x, ub_eff)
    nx = x.sum()
    if s is not None and nx > 0:
        x = s * x / nx
    return x, nx


def _numpy_masked_sweep(X, M, W, T, t_row_sum=1.0, *, reg_t_l1=0.0,
                        reg_t_l2=0.0, reg_w_l1=0.0, reg_w_l2=0.0,
                        project_T_each_iter=False, w_row_sum=None,
                        fix_T=False, fix_W=False):
    """Definitional WRRI sweep: the per-topic residual is recomputed from
    scratch (reference nmf.py:687-714,735-746 semantics), NOT maintained
    incrementally. Oracle for the jitted kernel's rank-one bookkeeping,
    covering regularizers, the sum-to-s T-subproblem (rescale + drift
    reprojection), W upper bounds, and the fixed-factor inference paths
    (``fix_T`` = the RS estimator's transform; the whole T branch incl.
    scale transfer is skipped, reference nmf.py:417,460)."""
    k = W.shape[1]
    scale_transfer = (abs(reg_t_l1) + abs(reg_t_l2) + abs(reg_w_l1) +
                      abs(reg_w_l2)) == 0
    s_t = t_row_sum if project_T_each_iter else None
    for t in range(k):
        if not fix_T:
            w = W[:, t].copy()
            Wz = W.copy()
            Wz[:, t] = 0
            Rt = M * (X - Wz @ T)
            wR = w @ Rt
            nw = (w * w) @ M
            x, nt1 = _qf_vector_np(wR - reg_t_l1, nw + reg_t_l2,
                                   s_t, t_row_sum)
            if scale_transfer:
                W[:, t] *= nt1
            T[t, :] = x
            if t_row_sum and project_T_each_iter and \
                    abs(T[t].sum() - t_row_sum) > 1e-15:
                T[t, :] = _proj_simplex_np(T[t], t_row_sum)
        if not fix_W:
            Wz = W.copy()
            Wz[:, t] = 0
            Rt = M * (X - Wz @ T)
            Rw = Rt @ T[t]
            nt = M @ (T[t] ** 2)
            W[:, t], _ = _qf_vector_np(Rw - reg_w_l1, nt + reg_w_l2,
                                       None, w_row_sum)
    return W, T


def test_masked_incremental_residual_matches_definitional_sweep():
    """The jitted masked sweep maintains R = X - WT by rank-one updates; it
    must match a from-scratch residual recomputation sweep-for-sweep (this
    is exactly the O(ndk) vs O(ndk^2) redesign, SURVEY.md §3.2)."""
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
    import jax
    import jax.numpy as jnp

    X = _problem(seed=1)
    M = (np.random.RandomState(2).rand(*X.shape) < 0.6).astype(float)
    rng = np.random.RandomState(3)
    W = np.abs(rng.rand(X.shape[0], 3))
    T = np.abs(rng.rand(3, X.shape[1]))

    cfg = SweepConfig(k=3, masked=True, reset_topic_method=None,
                      t_row_sum=1.0)
    sweep = make_sweep(cfg)
    Wj, Tj = jnp.asarray(W), jnp.asarray(T)
    key = jax.random.PRNGKey(0)
    resets = jnp.asarray(0, jnp.int32)
    Wn, Tn = W.copy(), T.copy()
    for it in range(5):
        Wj, Tj, key, resets = sweep(jnp.asarray(X), Wj, Tj, key, resets,
                                    key, jnp.asarray(M))
        Wn, Tn = _numpy_masked_sweep(X, M, Wn, Tn)
        assert np.allclose(np.array(Wj), Wn, atol=1e-10), 'sweep %d' % it
        assert np.allclose(np.array(Tj), Tn, atol=1e-10), 'sweep %d' % it


def test_masked_sweep_matches_oracle_randomized():
    """Randomized differential fuzz of the MASKED sweep against the
    definitional oracle: random shapes, mask densities, and config draws
    over the reg (incl. negative L1) / sum-to-s projection / upper-bound
    cross-product at f64 roundoff parity. The dense randomized oracle
    (test_dense_oracle) never exercises the vector qf branch, the masked
    rank-2 residual bookkeeping, or reg x mask interactions — the class
    where both round-3 review bugs (phantom mass on padded/unobserved
    coordinates) lived."""
    for seed in range(8):
        masked_oracle_draw(seed)


def masked_oracle_draw(seed):
    """One masked differential draw (factored out so soak runs can sweep
    arbitrary seed ranges — the in-suite test runs seeds 0..7)."""
    import jax
    import jax.numpy as jnp

    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep

    rng = np.random.RandomState(300 + seed)
    n = int(rng.randint(20, 60))
    d = int(rng.randint(15, 50))
    k = int(rng.randint(2, 6))
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < rng.choice([0.3, 0.6, 0.9])).astype(float)
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))

    kw = {'t_row_sum': float(rng.choice([1.0, 2.0, 5.0]))
          if rng.rand() < 0.8 else None}
    if kw['t_row_sum'] and rng.rand() < 0.5:
        kw['project_T_each_iter'] = True
    if rng.rand() < 0.4:
        kw['w_row_sum'] = float(rng.choice([1.0, 3.0]))
    for r in ('reg_w_l1', 'reg_w_l2', 'reg_t_l1', 'reg_t_l2'):
        if rng.rand() < 0.4:
            kw[r] = float(rng.choice([0.01, 0.1]))
    # negative L1 promotes mass onto unobserved coordinates when the
    # matching L2 keeps the denominator positive — the sign class the
    # masked phantom-mass kernel bugs lived in
    if rng.rand() < 0.3:
        kw['reg_t_l1'] = -0.02
        kw['reg_t_l2'] = max(kw.get('reg_t_l2', 0.0), 0.05)
    # fixed-factor inference paths (fix_T = the RS estimator's transform)
    # — drawn LAST so earlier seeds' configs are unchanged
    _r = rng.rand()
    kw['fix_T'] = bool(_r < 0.25)
    kw['fix_W'] = bool(0.25 <= _r < 0.4)

    cfg = SweepConfig(
        k=k, masked=True, reset_topic_method=None,
        t_row_sum=kw.get('t_row_sum'),
        w_row_sum=kw.get('w_row_sum'),
        project_T_each_iter=kw.get('project_T_each_iter', False),
        fix_T=kw['fix_T'], fix_W=kw['fix_W'],
        reg_w_l1=kw.get('reg_w_l1', 0.0),
        reg_w_l2=kw.get('reg_w_l2', 0.0),
        reg_t_l1=kw.get('reg_t_l1', 0.0),
        reg_t_l2=kw.get('reg_t_l2', 0.0))
    sweep = make_sweep(cfg)
    key = jax.random.PRNGKey(0)
    resets = jnp.asarray(0, jnp.int32)
    Wj, Tj = jnp.asarray(W0), jnp.asarray(T0)
    Wn, Tn = W0.copy(), T0.copy()
    for it in range(3):
        Wj, Tj, key, resets = sweep(jnp.asarray(X), Wj, Tj, key,
                                    resets, key, jnp.asarray(M))
        Wn, Tn = _numpy_masked_sweep(
            X, M, Wn, Tn, kw.get('t_row_sum'),
            reg_t_l1=kw.get('reg_t_l1', 0.0),
            reg_t_l2=kw.get('reg_t_l2', 0.0),
            reg_w_l1=kw.get('reg_w_l1', 0.0),
            reg_w_l2=kw.get('reg_w_l2', 0.0),
            project_T_each_iter=kw.get('project_T_each_iter', False),
            w_row_sum=kw.get('w_row_sum'),
            fix_T=kw['fix_T'], fix_W=kw['fix_W'])
        assert np.allclose(np.array(Wj), Wn, atol=1e-10), \
            (seed, kw, it)
        assert np.allclose(np.array(Tj), Tn, atol=1e-10), \
            (seed, kw, it)


def test_dp_noise_large_eps_close_to_clean():
    """With epsilon huge the Gaussian mechanism's sigma ~ 0 and the fit
    matches the noiseless one (reference nmf.py:422-435)."""
    X = _problem()
    clean = nmf(X, k=3, max_iter=5, random_state=0, early_stop=False,
                compute_obj_each_iter=True)
    dp = nmf(X, k=3, max_iter=5, random_state=0, early_stop=False,
             compute_obj_each_iter=True,
             eps_gauss_t=1e12, delta_gauss_t=0.5)
    assert np.allclose(clean['T'], dp['T'], atol=1e-5)


def test_dp_noise_actually_perturbs():
    X = _problem()
    clean = nmf(X, k=3, max_iter=3, random_state=0, early_stop=False)
    dp = nmf(X, k=3, max_iter=3, random_state=0, early_stop=False,
             eps_gauss_t=1e3, delta_gauss_t=1e-3)
    assert not np.allclose(clean['T'], dp['T'], atol=1e-8)


def test_store_gradients_match_manual_computation():
    """Stored T-update numerators must equal the Gauss-Seidel-consistent
    values (reference nmf.py:653-660,677-686): recompute iteration 0's
    first-topic gradient from the initial factors."""
    X = _problem()
    from rri_nmf_tpu.initialization import initialize_nmf
    W0, T0 = initialize_nmf(X, 3, 'nndsvd', random_state=0)
    soln = nmf(X, k=3, max_iter=2, random_state=0, early_stop=False,
               store_gradients=True, W_in=np.maximum(W0, 0),
               T_in=np.maximum(T0, 0), reset_topic_method=None)
    numer = soln['numer_W'][0]
    assert numer.shape == (3, X.shape[1])
    w = np.maximum(W0, 0)[:, 0]
    wX = w @ X
    wW = w @ np.maximum(W0, 0)
    wW[0] = 0
    expected_first = wX - wW @ np.maximum(T0, 0)
    assert np.allclose(numer[0], expected_first, atol=1e-10)
    # row-subset capture
    soln_sub = nmf(X, k=3, max_iter=1, random_state=0, early_stop=False,
                   store_gradients=True, ind_rows_to_store=[0, 1, 2, 3],
                   W_in=np.maximum(W0, 0), T_in=np.maximum(T0, 0),
                   reset_topic_method=None)
    ws = np.maximum(W0, 0)[:4, 0]
    wXs = ws @ X[:4]
    wWs = ws @ np.maximum(W0, 0)[:4]
    wWs[0] = 0
    assert np.allclose(soln_sub['numer_W'][0][0],
                       wXs - wWs @ np.maximum(T0, 0), atol=1e-10)


def test_topic_reset_budget_respected():
    """Resets decrement the finite budget and stop at zero (reference
    nmf.py:192-193,765-769). Two dead warm-start topics force exactly two
    reset attempts on the first sweep."""
    rng = np.random.RandomState(0)
    k = 4
    X = np.abs(rng.rand(20, k) @ rng.rand(k, 15))
    W0 = np.abs(rng.rand(20, k))
    T0 = np.abs(rng.rand(k, 15))
    W0[:, 2] = 0.0
    T0[2] = 0.0
    W0[:, 3] = 0.0
    T0[3] = 0.0

    kw = dict(max_iter=3, random_state=0, early_stop=False,
              reset_topic_method='max_resid_document',
              compute_obj_each_iter=True)

    # ample budget: both dead topics are revived, exactly 2 resets consumed
    full = nmf(X, k=k, n_resets=5, W_in=W0.copy(), T_in=T0.copy(), **kw)
    assert full['n_resets_remaining'] == 3
    assert np.all(full['T'].sum(axis=1) > 1e-10)  # every topic alive

    # budget of 1: the first dead topic consumes it, the second stays dead
    capped = nmf(X, k=k, n_resets=1, W_in=W0.copy(), T_in=T0.copy(), **kw)
    assert capped['n_resets_remaining'] == 0
    dead_rows = np.sum(capped['T'].sum(axis=1) <= 1e-10)
    assert dead_rows == 1

    # budget of 0: nothing is reset, both topics stay dead
    none = nmf(X, k=k, n_resets=0, W_in=W0.copy(), T_in=T0.copy(), **kw)
    assert none['n_resets_remaining'] == 0
    assert np.sum(none['T'].sum(axis=1) <= 1e-10) == 2
    assert np.all(np.isfinite(none['W'])) and np.all(np.isfinite(none['T']))


def test_fix_reset_seed_deterministic():
    """fix_reset_seed makes 'random' resets reproducible across runs
    (reference nmf.py:233-235,780)."""
    rng = np.random.RandomState(0)
    X = np.outer(np.abs(rng.rand(20)), np.abs(rng.rand(15)))
    kw = dict(k=4, max_iter=6, random_state=0, reset_topic_method='random',
              fix_reset_seed=True, early_stop=False)
    s1 = nmf(X, **kw)
    s2 = nmf(X, **kw)
    assert np.allclose(s1['W'], s2['W'])
    assert np.allclose(s1['T'], s2['T'])


def test_reset_conds_carry_row_col_payloads_only():
    """Structural pin of the small-payload reset-check design: in a dense
    sweep with topic resets + per-iteration T projection, every lax.cond
    in the traced program returns only vectors (a T row, a W column, a
    key) — never a factor matrix. Carrying (W, T) through branch tuples
    makes XLA materialize fresh copies of both factors per topic even on
    the never-taken branch."""
    import jax
    import jax.numpy as jnp
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep

    n, d, k = 40, 30, 4
    cfg = SweepConfig(k=k, reset_topic_method='max_resid_document',
                      project_T_each_iter=True, t_row_sum=1.0)
    sweep = make_sweep(cfg)
    rng = np.random.RandomState(0)
    args = (jnp.asarray(rng.rand(n, d)), jnp.asarray(rng.rand(n, k)),
            jnp.asarray(rng.rand(k, d)), jax.random.PRNGKey(0),
            jnp.asarray(3, jnp.int32), jax.random.PRNGKey(1))
    jaxpr = jax.make_jaxpr(sweep)(*args)

    cond_out_sizes = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == 'cond':
                cond_out_sizes.append(
                    [int(np.prod(ov.aval.shape)) for ov in eqn.outvars])
            for v in eqn.params.values():
                if hasattr(v, 'jaxpr'):
                    walk(v.jaxpr)
                elif isinstance(v, (list, tuple)):
                    for b in v:
                        if hasattr(b, 'jaxpr'):
                            walk(b.jaxpr)

    walk(jaxpr.jaxpr)
    assert cond_out_sizes, 'expected reset-check conds in the sweep'
    for sizes in cond_out_sizes:
        assert max(sizes) <= max(n, d), \
            'a cond carries a matrix-sized payload: %r' % (sizes,)


def test_masked_reset_conds_carry_one_residual_rebuild_only():
    """Masked-config counterpart of the payload pin: the masked XLA sweep
    with resets traces conds whose outputs are vectors, EXCEPT the reset
    residual rebuilds — each reset site conds over the (n, d) masked
    residual carry by design (the rebuild is O(nd) when taken and the
    carry must flow either way). Anything else matrix-sized is a
    regression to whole-factor branch tuples."""
    import jax
    import jax.numpy as jnp
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep

    n, d, k = 40, 30, 4
    cfg = SweepConfig(k=k, masked=True,
                      reset_topic_method='max_resid_document')
    sweep = make_sweep(cfg)
    rng = np.random.RandomState(0)
    M = (rng.rand(n, d) < 0.3).astype(float)
    args = (jnp.asarray(rng.rand(n, d)), jnp.asarray(rng.rand(n, k)),
            jnp.asarray(rng.rand(k, d)), jax.random.PRNGKey(0),
            jnp.asarray(3, jnp.int32), jax.random.PRNGKey(1),
            jnp.asarray(M))
    jaxpr = jax.make_jaxpr(sweep)(*args)

    cond_out_sizes = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == 'cond':
                cond_out_sizes.append(
                    [int(np.prod(ov.aval.shape)) for ov in eqn.outvars])
            for v in eqn.params.values():
                if hasattr(v, 'jaxpr'):
                    walk(v.jaxpr)
                elif isinstance(v, (list, tuple)):
                    for b in v:
                        if hasattr(b, 'jaxpr'):
                            walk(b.jaxpr)

    walk(jaxpr.jaxpr)
    assert cond_out_sizes, 'expected reset-check conds in the sweep'
    matrix_conds = [s for s in cond_out_sizes if max(s) > max(n, d)]
    # T-check and W-check each rebuild R once: exactly their two conds
    # may carry the (n, d) residual, nothing else
    assert len(matrix_conds) <= 2, \
        'extra matrix-sized cond payloads: %r' % (matrix_conds,)
    for sizes in matrix_conds:
        assert all(sz in (n * d, 1) or sz <= max(n, d) for sz in sizes), \
            'unexpected cond payload (factor matrix?): %r' % (sizes,)
