"""Seeded configuration fuzzing of the driver.

Samples random valid combinations of the nmf() options and checks the
universal invariants: finite factors, non-negativity, monotone objective
when no resets fire, feasibility when projecting. Catches option
interactions no targeted test covers.
"""

import numpy as np
import pytest

from rri_nmf_tpu.nmf import nmf


def _sample_config(rng):
    cfg = {'k': int(rng.choice([2, 4, 7]))}
    masked = rng.rand() < 0.4
    if masked:
        cfg['reset_topic_method'] = None
        cfg['t_row_sum'] = float(rng.choice([1.0, 5.0]))
        cfg['project_T_each_iter'] = False
    else:
        cfg['reset_topic_method'] = str(rng.choice(
            ['max_resid_document', 'random'])) if rng.rand() < 0.5 else None
        if rng.rand() < 0.5:
            cfg['project_T_each_iter'] = True
            cfg['t_row_sum'] = 1.0
        if rng.rand() < 0.5:
            cfg['project_W_each_iter'] = True
            cfg['w_row_sum'] = 1.0
        if rng.rand() < 0.3:
            cfg['update_order'] = 'phase'
    # regularizers (non-negative to keep objectives bounded without
    # projection; the sign-flip guards have their own tests)
    for r in ('reg_w_l1', 'reg_w_l2', 'reg_t_l1', 'reg_t_l2'):
        if rng.rand() < 0.3:
            cfg[r] = float(rng.choice([0.01, 0.1]))
    if rng.rand() < 0.3:
        cfg['fix_reset_seed'] = True
    if rng.rand() < 0.2:
        cfg['sweeps_per_dispatch'] = 3
    if rng.rand() < 0.4:
        cfg['init'] = str(rng.choice(
            ['nndsvd', 'nndsvda', 'nndsvd_lrc', 'random', 'smart_random']))
    # inner_reps: phase order only, unmasked, no resets, no DP
    if (not masked and cfg.get('update_order') == 'phase'
            and cfg.get('reset_topic_method') is None
            and rng.rand() < 0.5):
        cfg['inner_reps'] = int(rng.choice([2, 3]))
    # HER extrapolation: dense or masked, no resets (restart sweeps may
    # tick the objective up, so the monotone invariant is relaxed)
    if cfg.get('reset_topic_method') is None and rng.rand() < 0.4:
        cfg['accel'] = 'her'
    # row weighting engages the sqrt(w_row) pre-scale + recursive fixed-T
    # W re-fit (reference nmf.py:335-344,531-539); drawn LAST so earlier
    # seeds' configs are unchanged. The appended re-fit history tracks a
    # DIFFERENT objective (unscaled X), so monotone checks don't apply.
    cfg['_draw_w_row'] = (not masked and rng.rand() < 0.15)
    # float32 (the GPU's production dtype; everything above runs f64) —
    # also drawn last. Consumers must widen their tolerances.
    cfg['_draw_f32'] = rng.rand() < 0.15
    return cfg, masked


def invariant_draw(seed):
    """One randomized invariant draw (finiteness, non-negativity,
    monotone descent / boundedness, feasibility). Callable standalone
    for soak ranges (benchmarks/soak_fuzz.py)."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(20, 60))
    d = int(rng.randint(15, 50))
    cfg, masked = _sample_config(rng)
    k = cfg.pop('k')
    w_row_drawn = cfg.pop('_draw_w_row', False)
    f32 = cfg.pop('_draw_f32', False)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    kw = dict(max_iter=6, random_state=seed, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0)
    if masked:
        kw['W_mat'] = (rng.rand(n, d) < 0.6).astype(float)
    if w_row_drawn:
        kw['w_row'] = rng.rand(n) * 0.9 + 0.1
    if f32:
        kw['dtype'] = 'float32'
    kw.update(cfg)
    # roundoff scales: per-sweep rounding is ~eps * obj; f32 needs the
    # invariants widened accordingly
    neg_tol, feas_tol = (1e-5, 1e-5) if f32 else (1e-12, 1e-8)

    soln = nmf(X, k, **kw)
    W, T = soln['W'], soln['T']
    assert np.all(np.isfinite(W)), cfg
    assert np.all(np.isfinite(T)), cfg
    assert W.min() >= -neg_tol and T.min() >= -neg_tol, cfg
    oh = np.asarray(soln['obj_history'], dtype=float)
    assert np.all(np.isfinite(oh)), cfg
    if w_row_drawn:
        # obj_history splices the recursive W re-fit's history, which
        # tracks a DIFFERENT objective (unscaled X, reference
        # nmf.py:531-539) — only finiteness/non-negativity apply
        return
    tol = (1e-6 if f32 else 1e-10) * max(1.0, abs(oh[0]))
    if cfg.get('accel') == 'her':
        # extrapolated sweeps may jump to a worse basin (the accepted
        # sequence is only monotone-ish), but the RETURNED solution is
        # the best accepted iterate (Ang & Gillis's "output the lowest
        # error"), which can be no worse than the first sweep — a plain
        # BCD descent step (found by soak seeds 13/26)
        final = soln['obj_calculator'].true_objective()
        assert final <= oh[0] + tol, (cfg, final, oh)
    elif cfg.get('reset_topic_method') is None:
        if cfg.get('project_W_each_iter'):
            # the reference's per-iteration W-row simplex projection
            # (reference nmf.py:481-484) is constraint ENFORCEMENT, not
            # a descent step: the W subproblems are solved per-column
            # box-constrained, and the row projection can raise the
            # objective in either update order (soak seeds 23/42/81/108;
            # probed: the interleaved reference order upticks on the
            # same data). Assert boundedness, not monotonicity.
            assert oh[-1] <= 10 * abs(oh[0]) + tol, (cfg, oh)
        else:
            # without reset heuristics / W reprojection every step is a
            # descent step
            assert np.all(np.diff(oh) <= tol), (cfg, oh)
    # a topic reset in the LAST sweep leaves that T row unprojected until
    # the (never-run) next T update — reference-exact behavior
    # (reference nmf.py:770-776 sets the raw residual row)
    resets_fired = (cfg.get('reset_topic_method') is not None
                    and soln['n_resets_remaining'] < 23)
    t_proj_active = (cfg.get('project_T_each_iter') and cfg.get('t_row_sum')
                     and not (cfg.get('reg_w_l1') or cfg.get('reg_t_l1')))
    # (L1 regularization auto-disables T projection, reference nmf.py:280-285)
    if t_proj_active and not resets_fired:
        assert np.allclose(T.sum(1), cfg['t_row_sum'], atol=feas_tol), cfg
    if cfg.get('project_W_each_iter') and cfg.get('w_row_sum'):
        assert np.allclose(W.sum(1), cfg['w_row_sum'], atol=feas_tol), cfg


@pytest.mark.parametrize('seed', range(12))
def test_random_config_invariants(seed):
    invariant_draw(seed)


def estimator_draw(seed):
    """One randomized estimator-surface draw: construct a TM or RS
    estimator with random constructor args and `nmf_kwargs` overrides
    (incl. layering `accel='her'` / phase order onto the presets —
    ROUND3 item 30's override semantics), fit, transform/predict,
    score, then pickle round-trip and require identical predictions
    from the restored estimator. Exercises the preset-merge logic, the
    fit-only-kwarg dropping in transform presets, the early-stop
    closure drop in RS.__getstate__, and TrueObjComputer's lazy
    rebuild after unpickling."""
    import pickle

    from rri_nmf_tpu.sklearn_interface import (NMF_RS_Estimator,
                                               NMF_TM_Estimator)

    rng = np.random.RandomState(17000 + seed)
    if rng.rand() < 0.5:
        # ---- topic-model estimator ----
        n = int(rng.randint(40, 90))
        d = int(rng.randint(30, 70))
        k = int(rng.choice([3, 5]))
        X = ((rng.rand(n, d) > 0.6) * rng.randint(1, 5, (n, d))
             ).astype(float) + 0.01
        nk = {'compute_obj_each_iter': True}
        if rng.rand() < 0.4:
            nk['update_order'] = 'phase'
        if rng.rand() < 0.3:
            nk['accel'] = 'her'
            nk['reset_topic_method'] = None
        M = NMF_TM_Estimator(
            n, d, k, wr1=float(rng.choice([0, 0.01])),
            tr2=float(rng.choice([0, 0.01])), random_state=seed,
            handle_tfidf=bool(rng.rand() < 0.5),
            handle_normalization=bool(rng.rand() < 0.5),
            max_iter=5, nmf_kwargs=nk).fit(X)
        assert np.all(np.isfinite(np.asarray(M.W))), seed
        assert np.allclose(np.asarray(M.W).sum(1), 1.0, atol=1e-8), seed
        Xnew = ((rng.rand(20, d) > 0.6) * rng.randint(1, 5, (20, d))
                ).astype(float) + 0.01
        Wnew = np.asarray(M.transform(Xnew))
        assert np.all(np.isfinite(Wnew)), seed
        s = M.score(Xnew)
        assert np.isfinite(s), seed
        M2 = pickle.loads(pickle.dumps(M))
        np.testing.assert_allclose(np.asarray(M2.transform(Xnew)), Wnew,
                                   atol=1e-12, err_msg=str(seed))
        assert np.isclose(M2.score(Xnew), s), seed
    else:
        # ---- recommender estimator ----
        n = int(rng.randint(40, 80))
        d = int(rng.randint(30, 60))
        k = int(rng.choice([3, 5]))
        dense = np.abs(rng.rand(n, k) @ rng.rand(k, d)) + 0.5
        mask = rng.rand(n, d) < 0.3
        Xtr = np.where(mask, np.clip(np.round(dense * 2), 1, 5), 0.0)
        nk = {}
        if rng.rand() < 0.3:
            nk['accel'] = 'her'
        R = NMF_RS_Estimator(
            n, d, k, wr1=float(rng.choice([0, 0.01])), random_state=seed,
            max_iter=6, nmf_kwargs=nk,
            use_validation_early_stopping=bool(rng.rand() < 0.5))
        R = R.fit_from_Xtr(Xtr)
        pairs = np.transpose(np.nonzero(Xtr))[:50]
        pred = np.asarray(R.predict(pairs))
        assert np.all(np.isfinite(pred)), seed
        rmse = R.score(pairs, Xtr[pairs[:, 0], pairs[:, 1]])
        assert np.isfinite(rmse), seed
        R2 = pickle.loads(pickle.dumps(R))
        np.testing.assert_allclose(np.asarray(R2.predict(pairs)), pred,
                                   atol=1e-12, err_msg=str(seed))


@pytest.mark.parametrize('seed', range(4))
def test_random_estimator_surface(seed):
    estimator_draw(seed)


def invariant_midsize_draw(seed):
    """Soak-only midsize invariant draw: n in [150,400), d in [100,300),
    k in {16, 32, 37} — drives the Gram-blocked phase sweeps through
    their real block regimes at the driver level (k=32 -> B=16 multi-
    block, k=37 prime -> B=1 degenerate; the suite's fuzz k<=7 always
    fits one block) plus masked/projection/reg interactions at shapes
    the in-suite fuzz never reaches. Not parametrized in-suite (each
    draw compiles a fresh shape); run via benchmarks/soak_fuzz.py."""
    rng = np.random.RandomState(15000 + seed)
    n = int(rng.randint(150, 400))
    d = int(rng.randint(100, 300))
    k = int(rng.choice([16, 32, 37]))
    masked = rng.rand() < 0.35
    cfg = {}
    if masked:
        cfg['reset_topic_method'] = None
        cfg['t_row_sum'] = 1.0
        cfg['project_T_each_iter'] = False
    else:
        if rng.rand() < 0.4:
            cfg['reset_topic_method'] = 'max_resid_document'
        else:
            cfg['reset_topic_method'] = None
        if rng.rand() < 0.5:
            cfg['project_T_each_iter'] = True
            cfg['t_row_sum'] = 1.0
        if rng.rand() < 0.4:
            cfg['update_order'] = 'phase'
    for r in ('reg_w_l1', 'reg_w_l2', 'reg_t_l1', 'reg_t_l2'):
        if rng.rand() < 0.25:
            cfg[r] = 0.05
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    kw = dict(max_iter=3, random_state=seed, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0)
    if masked:
        kw['W_mat'] = (rng.rand(n, d) < 0.5).astype(float)
    kw.update(cfg)

    soln = nmf(X, k, **kw)
    W, T = np.asarray(soln['W']), np.asarray(soln['T'])
    assert np.all(np.isfinite(W)) and np.all(np.isfinite(T)), cfg
    assert W.min() >= -1e-12 and T.min() >= -1e-12, cfg
    oh = np.asarray(soln['obj_history'], dtype=float)
    assert np.all(np.isfinite(oh)), cfg
    tol = 1e-10 * max(1.0, abs(oh[0]))
    if cfg.get('reset_topic_method') is None:
        assert np.all(np.diff(oh) <= tol), (cfg, oh)
    t_proj_active = (cfg.get('project_T_each_iter')
                     and not (cfg.get('reg_w_l1') or cfg.get('reg_t_l1')))
    if t_proj_active and cfg.get('reset_topic_method') is None:
        assert np.allclose(T.sum(1), 1.0, atol=1e-8), cfg


def mesh_parity_draw(seed):
    """One randomized mesh-parity draw: a driver-level fit with a random
    supported config on a random mesh shape must match the single-device
    fit (driver routing + shard_map kernels + padding/ghost-column
    handling all under test). Callable standalone for soak runs."""
    from rri_nmf_tpu.parallel import make_mesh

    rng = np.random.RandomState(7000 + seed)
    n = int(rng.randint(20, 60))
    d = int(rng.randint(15, 50))
    cfg, masked = _sample_config(rng)
    k = cfg.pop('k')
    cfg.pop('sweeps_per_dispatch', None)   # covered by its own tests
    w_row_drawn = cfg.pop('_draw_w_row', False)
    cfg.pop('_draw_f32', None)   # f32 mesh parity needs looser tolerances
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    kw = dict(max_iter=4, random_state=seed, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0)
    if masked:
        kw['W_mat'] = (rng.rand(n, d) < 0.6).astype(float)
    if w_row_drawn:
        kw['w_row'] = rng.rand(n) * 0.9 + 0.1
    kw.update(cfg)

    mesh_shape = [(8, 1), (4, 2), (2, 4)][int(rng.randint(3))]
    single = nmf(X, k, **kw)
    sharded = nmf(X, k, mesh=make_mesh(8, mesh_shape=mesh_shape), **kw)
    np.testing.assert_allclose(sharded['W'], single['W'], atol=1e-8,
                               err_msg=str((cfg, mesh_shape)))
    np.testing.assert_allclose(sharded['T'], single['T'], atol=1e-8,
                               err_msg=str((cfg, mesh_shape)))
    np.testing.assert_allclose(sharded['obj_history'],
                               single['obj_history'], rtol=1e-8,
                               err_msg=str((cfg, mesh_shape)))


@pytest.mark.parametrize('seed', range(2))
def test_random_config_mesh_parity(seed):
    mesh_parity_draw(seed)


def sparse_parity_draw(seed):
    """One randomized sparse-vs-dense differential draw: a driver fit on
    scipy-sparse X (BCOO sweep, optionally mesh-sharded) must match the dense fit on the same matrix —
    same math, different X representation, so only contraction-order
    roundoff may differ. Samples the sparse-viable config space (phase
    order, no resets/mask/w_row — the driver enforces it) crossed with
    projections, regularizers, inits, inner_reps, and grouped dispatch.
    Callable standalone for soak ranges (benchmarks/soak_fuzz.py)."""
    import scipy.sparse

    from rri_nmf_tpu.parallel import make_mesh

    rng = np.random.RandomState(11000 + seed)
    n = int(rng.randint(40, 100))
    d = int(rng.randint(30, 80))
    k = int(rng.choice([2, 4, 7]))
    density = 0.15 + 0.25 * rng.rand()
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d))
    X[rng.rand(n, d) >= density] = 0.0

    cfg = {}
    if rng.rand() < 0.5:
        cfg['project_T_each_iter'] = True
        cfg['t_row_sum'] = 1.0
    if rng.rand() < 0.5:
        cfg['project_W_each_iter'] = True
        cfg['w_row_sum'] = 1.0
    for r in ('reg_w_l1', 'reg_w_l2', 'reg_t_l1', 'reg_t_l2'):
        if rng.rand() < 0.3:
            cfg[r] = float(rng.choice([0.01, 0.1]))
    if rng.rand() < 0.4:
        cfg['inner_reps'] = int(rng.choice([2, 3]))
    if rng.rand() < 0.3:
        cfg['sweeps_per_dispatch'] = 3
    if rng.rand() < 0.4:
        # nndsvd-family inits run randomized_svd, which takes the
        # sparse matrix directly — bit-different from the dense input only
        # at matmul roundoff, absorbed by the 1e-8 parity tolerance
        cfg['init'] = str(rng.choice(
            ['random', 'smart_random', 'nndsvd', 'nndsvda']))
    # the third draw once named a removed kernel mode; it now runs the
    # forced sparse sweep with the kernel's topic loop in interpret mode
    # (the draws stay, so every seed keeps its config)
    _m = int(rng.randint(3))
    mode = ['auto', True, True][_m]
    mesh = None
    if mode is True and rng.rand() < 0.35:
        # tp > 1 composes with sparse mode only without the T-row simplex
        # projection (the row must be device-local to sort)
        shapes = [(8, 1)] if cfg.get('project_T_each_iter') \
            else [(8, 1), (4, 2)]
        mesh = make_mesh(8, mesh_shape=shapes[int(rng.randint(len(shapes)))])
    if _m == 2 and mesh is None:
        rng.rand()
    # multi-controller plan entry (single-process here): route the mesh
    # fit through a distribute_sparse_coo plan passed directly as X —
    # also drawn after everything else for seed stability
    plan_input = mesh is not None and rng.rand() < 0.5

    kw = dict(max_iter=5, random_state=seed, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0,
              reset_topic_method=None, update_order='phase')
    kw.update(cfg)
    if plan_input:
        # plan inputs carry no host X to initialize from: explicit warm
        # starts on BOTH fits keep the differential exact
        kw['W_in'] = np.abs(rng.rand(n, k))
        kw['T_in'] = np.abs(rng.rand(k, d))
    dense = nmf(X, k, **kw)
    if plan_input:
        from rri_nmf_tpu.parallel import distribute_sparse_coo
        plan = distribute_sparse_coo(
            scipy.sparse.csr_matrix(X), (n, d), mesh,
            dtype=np.asarray(X).dtype)
        sp = nmf(plan, k, mesh=mesh, **kw)
    else:
        sp = nmf(scipy.sparse.csr_matrix(X), k, sparse=mode, mesh=mesh,
                 use_pallas='interpret' if _m == 2 else None, **kw)
    ctx = str((cfg, mode, mesh is not None and mesh.devices.shape))
    np.testing.assert_allclose(sp['W'], dense['W'], atol=1e-8, err_msg=ctx)
    np.testing.assert_allclose(sp['T'], dense['T'], atol=1e-8, err_msg=ctx)
    np.testing.assert_allclose(sp['obj_history'], dense['obj_history'],
                               rtol=1e-7, err_msg=ctx)
    oh = np.asarray(sp['obj_history'], dtype=float)
    assert np.all(np.diff(oh) <= 1e-10 * max(1.0, abs(oh[0]))) \
        or cfg.get('project_W_each_iter'), ctx


@pytest.mark.parametrize('seed', range(3))
def test_random_config_sparse_parity(seed):
    sparse_parity_draw(seed)


def resume_parity_draw(seed, tmpdir):
    """One randomized checkpoint draw: fit partway writing checkpoints,
    resume from disk, and require the resumed run to reproduce the
    straight run exactly — over the same config space as the invariant
    fuzz (masked, projections, regs, resets, inner_reps, HER, inits).
    Callable standalone for soak ranges."""
    rng = np.random.RandomState(9000 + seed)
    n = int(rng.randint(20, 60))
    d = int(rng.randint(15, 50))
    cfg, masked = _sample_config(rng)
    k = cfg.pop('k')
    cfg.pop('sweeps_per_dispatch', None)   # grouped ckpt has its own tests
    w_row_drawn = cfg.pop('_draw_w_row', False)
    f32 = cfg.pop('_draw_f32', False)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    kw = dict(random_state=seed, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0)
    if masked:
        kw['W_mat'] = (rng.rand(n, d) < 0.6).astype(float)
    if w_row_drawn:
        kw['w_row'] = rng.rand(n) * 0.9 + 0.1
    if f32:
        # the resume contract is bitwise regardless of dtype (restore is
        # exact and the replay is the same program)
        kw['dtype'] = 'float32'
    kw.update(cfg)

    straight = nmf(X, k, max_iter=6, **kw)
    ckdir = str(tmpdir) + '/ck%d' % seed
    nmf(X, k, max_iter=4, checkpoint=ckdir, checkpoint_every=2, **kw)
    resumed = nmf(X, k, max_iter=6, checkpoint=ckdir, checkpoint_every=2,
                  **kw)
    np.testing.assert_allclose(resumed['W'], straight['W'], atol=1e-12,
                               err_msg=str(cfg))
    np.testing.assert_allclose(resumed['T'], straight['T'], atol=1e-12,
                               err_msg=str(cfg))
    # equal lengths: the resumed run must also STOP where the straight run
    # stopped (the seed-76 overshoot fix), not just land on matching factors
    assert len(resumed['obj_history']) == len(straight['obj_history']), cfg
    np.testing.assert_allclose(resumed['obj_history'][-2:],
                               straight['obj_history'][-2:], rtol=1e-12,
                               err_msg=str(cfg))


@pytest.mark.parametrize('seed', range(2))
def test_random_config_resume_parity(seed, tmp_path):
    resume_parity_draw(seed, tmp_path)


def test_resume_stops_where_straight_stopped(tmp_path):
    """Soak find (resume seed 76): the fit reaches an EXACTLY flat
    objective, so the straight run breaks on the universal stopping
    condition at the end of iteration 4 — and the resumed run must not
    sweep once more before noticing (at the tie-degenerate fixed point,
    duplicate uniform topics, one extra sweep hops to an equal-objective
    solution with a different active topic). Pins the on-restore
    stopping-condition check in the driver."""
    resume_parity_draw(76, tmp_path)


def stepped_parity_draw(seed):
    """One randomized warm-start stepping draw: a fit split into random
    chunks, each warm-started from the previous chunk's factors via
    ``W_in``/``T_in``, must reproduce the straight run exactly — the
    documented ``one_iter`` composition contract (reference
    ``sklearn_interface.py:284-314``), here over the fuzz config space.
    This exercises the warm-start validation/projection path, which the
    resume fuzz never touches (checkpoint restore places device state
    directly). Stateful features whose state does NOT thread through a
    bare warm start are excluded: topic resets (budget + reset RNG
    restart per call), HER (momentum restarts), w_row (each chunk would
    splice its own recursive re-fit). Callable standalone for soak
    ranges (benchmarks/soak_fuzz.py)."""
    rng = np.random.RandomState(13000 + seed)
    n = int(rng.randint(20, 60))
    d = int(rng.randint(15, 50))
    cfg, masked = _sample_config(rng)
    k = cfg.pop('k')
    cfg.pop('_draw_w_row', None)
    cfg.pop('_draw_f32', None)   # entry-reprojection chaos swamps f32
    cfg['reset_topic_method'] = None
    cfg.pop('fix_reset_seed', None)
    cfg.pop('accel', None)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    kw = dict(random_state=seed, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0)
    if masked:
        kw['W_mat'] = (rng.rand(n, d) < 0.6).astype(float)
    kw.update(cfg)

    straight = nmf(X, k, max_iter=6, **kw)
    if len(straight['obj_history']) < 6:
        # the straight run stopped on the universal condition (with
        # eps_stop=0 that means an EXACTLY flat objective). Chunked
        # warm-start fits restart obj_history per call — same as the
        # reference's one_iter — so they legitimately keep sweeping past
        # the flat point, and at a tie-degenerate fixed point one more
        # sweep can hop between equal-objective solutions (see
        # test_resume_stops_where_straight_stopped). No parity contract
        # to assert on this draw.
        return
    chunks = [[2, 4], [3, 3], [1, 2, 3], [2, 2, 2]][int(rng.randint(4))]
    W_in, T_in = [], []
    for c in chunks:
        soln = nmf(X, k, max_iter=c, W_in=W_in, T_in=T_in, **kw)
        W_in, T_in = soln['W'], soln['T']
    ctx = str((cfg, chunks))
    try:
        np.testing.assert_allclose(W_in, straight['W'], atol=1e-12,
                                   err_msg=ctx)
        np.testing.assert_allclose(T_in, straight['T'], atol=1e-12,
                                   err_msg=ctx)
    except AssertionError:
        # With project_W_each_iter the warm-start ENTRY re-projection is
        # not bit-identity: chunk-end W rows sum to s ± 1 ulp (the
        # in-sweep projection's own rounding), so the Duchi theta at
        # re-entry nudges every entry by ~5e-17 — reference-inherited
        # (the reference also projects W_in at entry). Generic draws stay
        # under the 1e-12 atol anyway (measured ~1e-15 after 5 sweeps);
        # on near-degenerate problems the one-ulp nudge amplifies
        # chaotically into a DIFFERENT BASIN (soak stepped seed 76:
        # entry nudge 5.6e-17 -> topic hop). Downgrade ONLY that
        # diagnosed signature (per-iteration W projection on). The
        # basin gap has no tight bound on unconverged toy fits — soak
        # samples measured 6e-5, 2.7e-3 (chunked BETTER), 3.0e-3, and
        # 2.2e-2 relative — so the fallback asserts only what chaos
        # preserves: feasibility, finiteness, non-negativity, and a
        # gross objective screen (25%; catastrophic state loss, e.g. a
        # dropped factor, lands far past it). A SYSTEMATIC warm-start
        # bug in the pW path would also break the stable majority of
        # pW draws, which stay on the strict 1e-12 branch.
        if not cfg.get('project_W_each_iter'):
            raise
        W_c, T_c = np.asarray(W_in), np.asarray(T_in)
        assert np.all(np.isfinite(W_c)) and np.all(np.isfinite(T_c)), ctx
        assert W_c.min() >= -1e-12 and T_c.min() >= -1e-12, ctx
        assert np.allclose(W_c.sum(1), cfg['w_row_sum'], atol=1e-8), ctx
        ob_s = straight['obj_calculator'].true_objective()
        ob_c = soln['obj_calculator'].true_objective()
        assert abs(ob_s - ob_c) <= 0.25 * abs(ob_s), (ctx, ob_s, ob_c)


@pytest.mark.parametrize('seed', range(2))
def test_random_config_stepped_parity(seed):
    stepped_parity_draw(seed)
