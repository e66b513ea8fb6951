"""Benchmark harness for the five BASELINE.md configs.

Usage::

    python benchmarks/run_baselines.py --configs cpu_parity,recsys_masked
    python benchmarks/run_baselines.py --configs all --out results.json

Datasets: the build environment has zero egress, so 20 Newsgroups and
MovieLens are replaced by synthetic generators matched in shape, sparsity,
and value distribution (documented per config in the output). The NumPy
baseline is a faithful reimplementation of the reference's per-topic update
loop (``bench.numpy_reference_sweep`` for dense; a definitional masked
sweep here for WRRI) — the reference publishes no numbers of its own
(BASELINE.md), so beating its implementation wall-clock is the bar.

Each config emits a JSON record with timings, quality metrics, and the
config provenance.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EPS = float(np.spacing(10))


def _dense_phase_sweep(cfg):
    """The dense phase sweep with the Gauss-Seidel topic loop ``nmf()``
    picks on this backend (the Triton kernel on a GPU, the XLA loop
    elsewhere)."""
    from rri_nmf_tpu.ops.capability import gs_impl
    from rri_nmf_tpu.ops.dense_phase import make_dense_phase_sweep
    return make_dense_phase_sweep(cfg, gs_impl(None))


def _synth_lowrank(n, d, k, seed=0, noise=0.01, dtype=np.float64):
    rng = np.random.RandomState(seed)
    W = np.abs(rng.rand(n, k))
    T = np.abs(rng.rand(k, d))
    return (W @ T + noise * np.abs(rng.rand(n, d))).astype(dtype)


def _synth_text(n_docs, n_words, n_topics, seed=0, doc_len=120):
    """Synthetic topic-model corpus: Zipfian topic-word distributions,
    Dirichlet doc-topic mixtures, multinomial counts (20NG stand-in)."""
    rng = np.random.RandomState(seed)
    word_rank = np.arange(1, n_words + 1, dtype=float)
    topics = np.zeros((n_topics, n_words))
    for t in range(n_topics):
        perm = rng.permutation(n_words)
        topics[t, perm] = 1.0 / word_rank          # permuted Zipf
        topics[t] /= topics[t].sum()
    theta = rng.dirichlet(np.full(n_topics, 0.1), size=n_docs)
    X = np.zeros((n_docs, n_words))
    probs = theta @ topics
    for i in range(n_docs):
        X[i] = rng.multinomial(doc_len, probs[i])
    return X


def _synth_ratings(n_users, n_items, n_obs, k, seed=0):
    """MovieLens-like: low-rank preference structure, 1-5 integer ratings."""
    rng = np.random.RandomState(seed)
    U = rng.rand(n_users, k)
    V = rng.rand(k, n_items)
    scores = U @ V
    scores = 1 + 4 * (scores - scores.min()) / (scores.max() - scores.min())
    I = rng.randint(0, n_users, n_obs)
    J = rng.randint(0, n_items, n_obs)
    X = np.zeros((n_users, n_items))
    X[I, J] = np.clip(np.round(scores[I, J] + 0.5 * rng.randn(n_obs)), 1, 5)
    return X


def _numpy_masked_sweep(X, M, W, T, t_row_sum=1.0):
    """Reference-semantics WRRI sweep (per-topic full residual GEMM — the
    O(ndk^2) path, reference nmf.py:687-714,735-746)."""
    k = W.shape[1]
    for t in range(k):
        w = W[:, t].copy()
        Wz = W.copy(); Wz[:, t] = 0
        Rt = M * (X - Wz @ T)
        wR = w @ Rt
        nw = (w * w) @ M
        x = np.where(nw > 0, np.maximum(wR, 0) / (nw + EPS), 0.0)
        if t_row_sum is not None:
            x = np.minimum(x, t_row_sum)
        W[:, t] *= x.sum()
        T[t, :] = x
        Wz = W.copy(); Wz[:, t] = 0
        Rt = M * (X - Wz @ T)
        Rw = Rt @ T[t]
        nt = M @ (T[t] ** 2)
        W[:, t] = np.where(nt > 0, np.maximum(Rw, 0) / (nt + EPS), 0.0)
    return W, T


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def cfg_cpu_parity():
    """BASELINE #1: synthetic dense 2k×1k, k=20 — parity vs sklearn NMF
    AND vs the reference's own NumPy loop (round-3 VERDICT item 4: all
    three wall-clocks to the same error level, plus the per-sweep
    decomposition explaining each gap)."""
    from sklearn.decomposition import NMF as SkNMF
    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.metrics import frobenius_relative_error
    from bench import numpy_reference_sweep

    X = _synth_lowrank(2000, 1000, 20, noise=0.05)
    k = 20

    t0 = time.perf_counter()
    sk = SkNMF(n_components=k, init='nndsvd', max_iter=200, tol=1e-6,
               random_state=0).fit(X)
    sk_time = time.perf_counter() - t0
    sk_err = frobenius_relative_error(X, sk.transform(X), sk.components_)

    # wall-clock to reach sklearn's error level (the BASELINE metric is
    # "wall-clock to a fixed relative Frobenius error"); RRI converges past
    # sklearn's CD given iterations, so run warm-started blocks until we
    # cross sk_err (obj tracking off during timing — its 2x penalty,
    # reference nmf.py:143-146, would distort the comparison)
    def ours_to_err(**kw):
        # warm the jit cache first: the reference loop pays no compile,
        # so including ours in the timed wall would measure XLA's
        # compiler, not the solver (compile is once per config ever)
        nmf(X, k, max_iter=1, random_state=0, early_stop=False,
            reset_topic_method=None, **kw)
        our_time = 0.0
        iters = 0
        W_in, T_in = [], []
        our_err = np.inf
        while our_err > sk_err and iters < 1000:
            t0 = time.perf_counter()
            soln = nmf(X, k, max_iter=100, random_state=0,
                       early_stop=False, reset_topic_method=None,
                       W_in=W_in, T_in=T_in, **kw)
            our_time += time.perf_counter() - t0
            iters += 100
            W_in, T_in = soln['W'], soln['T']
            our_err = frobenius_relative_error(X, W_in, T_in)
        return {'rel_frob_err': our_err, 'seconds': our_time,
                'iters': iters,
                'seconds_per_sweep': our_time / max(iters, 1)}

    ours_ref_order = ours_to_err()                  # reference semantics
    # phase order + accelerated-HALS inner passes: same exact-BCD
    # fixed points, fewer outer sweeps, GEMM-batched contractions
    ours_fast = ours_to_err(update_order='phase', inner_reps=3)

    # the reference's own per-topic NumPy loop to the same error
    from rri_nmf_tpu.initialization import initialize_nmf
    Wr, Tr = (np.asarray(a, np.float64)
              for a in initialize_nmf(X, k, 'nndsvd', random_state=0))
    xnorm = np.linalg.norm(X)
    ref_time = 0.0
    ref_iters = 0
    ref_err = np.inf
    while ref_err > sk_err and ref_iters < 1000:
        t0 = time.perf_counter()
        for _ in range(100):
            Wr, Tr = numpy_reference_sweep(X, Wr, Tr)
        ref_time += time.perf_counter() - t0
        ref_iters += 100
        ref_err = float(np.linalg.norm(X - Wr @ Tr) / xnorm)

    chk = nmf(X, k, max_iter=15, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None)
    mono_checked = bool(np.all(np.diff(chk['obj_history']) <= 0))

    return {
        'config': 'cpu_parity_2kx1k_k20',
        'sklearn_nmf': {'rel_frob_err': sk_err, 'seconds': sk_time,
                        'iters': 200,
                        'seconds_per_sweep': sk_time / 200},
        'reference_numpy': {'rel_frob_err': ref_err, 'seconds': ref_time,
                            'iters': ref_iters,
                            'seconds_per_sweep': ref_time / max(ref_iters,
                                                                1)},
        'rri_nmf_tpu': ours_ref_order,
        'rri_nmf_tpu_phase_reps3': ours_fast,
        'monotone': mono_checked,
        'parity': bool(ours_ref_order['rel_frob_err'] <= sk_err),
        'beats_reference': bool(
            ours_fast['seconds'] < ref_time
            and ours_ref_order['seconds'] < ref_time),
    }


def cfg_topic_modeling(n_docs=2000, n_words=5000, k=50):
    """BASELINE #2 (scaled synthetic 20NG stand-in): reconstruction +
    UMass coherence."""
    from rri_nmf_tpu.matrixops import normalize, tfidf
    from rri_nmf_tpu.metrics import frobenius_relative_error, umass_coherence
    from rri_nmf_tpu.sklearn_interface import NMF_TM_Estimator

    counts = _synth_text(n_docs, n_words, 30)
    X = np.asarray(normalize(tfidf(counts)))
    t0 = time.perf_counter()
    M = NMF_TM_Estimator(n_docs, n_words, k, random_state=0,
                         max_iter=30).fit(X)
    fit_time = time.perf_counter() - t0
    return {
        'config': 'topic_modeling_synth20ng_%dx%d_k%d' % (n_docs, n_words, k),
        'note': 'synthetic Zipf/Dirichlet corpus (no egress for 20NG)',
        'seconds': fit_time,
        'rel_frob_err': frobenius_relative_error(X, M.W, M.T),
        'umass_coherence': umass_coherence(counts, M.T, top_n=8),
    }


def cfg_recsys_masked(n_users=1500, n_items=1000, n_obs=120000, k=40,
                      baseline_sweeps=2):
    """BASELINE #3 (scaled MovieLens stand-in): masked WRRI + masked-SVD
    init; RMSE + wall-clock vs the reference's O(ndk^2) loop."""
    from rri_nmf_tpu.initialization import masked_svd_init
    from rri_nmf_tpu.metrics import rmse_observed
    from rri_nmf_tpu.nmf import nmf

    X = _synth_ratings(n_users, n_items, n_obs, 8)
    M = (X > 0).astype(float)

    t0 = time.perf_counter()
    W0, T0 = masked_svd_init(X, M, k, random_state=0, n_iter=4)
    init_time = time.perf_counter() - t0

    # per-sweep time by differencing a long and a short run with identical
    # one-time costs (host->device transfer of X/M and jit compile of the
    # same grouped-dispatch program) so neither pollutes the sweep rate
    n_short, n_long = 4, 20
    common = dict(W_mat=M, W_in=W0, T_in=T0, random_state=0,
                  reset_topic_method=None, t_row_sum=float(X.max()),
                  early_stop=False, sweeps_per_dispatch=n_short)
    t0 = time.perf_counter()
    nmf(X, k, max_iter=n_short, **common)          # compile + warm
    t_short_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    nmf(X, k, max_iter=n_short, **common)
    t_short = time.perf_counter() - t0
    t0 = time.perf_counter()
    soln = nmf(X, k, max_iter=n_long, **common)
    t_long = time.perf_counter() - t0
    fit_time = t_long
    per_sweep = (t_long - t_short) / (n_long - n_short)
    rmse = rmse_observed(X, soln['W'], soln['T'], 1, 5)
    mono = nmf(X, k, W_mat=M, W_in=W0, T_in=T0, max_iter=8, random_state=0,
               reset_topic_method=None, t_row_sum=float(X.max()),
               compute_obj_each_iter=True, early_stop=False)

    # reference-semantics numpy loop, per-sweep time (extrapolate to 20)
    Wb, Tb = W0.copy().astype(float), T0.copy().astype(float)
    t0 = time.perf_counter()
    for _ in range(baseline_sweeps):
        Wb, Tb = _numpy_masked_sweep(X, M, Wb, Tb, t_row_sum=float(X.max()))
    ref_per_sweep = (time.perf_counter() - t0) / baseline_sweeps

    return {
        'config': 'recsys_masked_%dx%d_%dobs_k%d' % (n_users, n_items,
                                                     n_obs, k),
        'note': 'synthetic MovieLens stand-in (no egress); masked-SVD init',
        'masked_svd_init_seconds': init_time,
        'fit_seconds_%d_sweeps_incl_transfer' % n_long: fit_time,
        'cold_start_seconds': t_short_cold,
        'per_sweep_seconds': per_sweep,
        'reference_numpy_per_sweep_seconds': ref_per_sweep,
        'speedup_per_sweep': ref_per_sweep / per_sweep,
        'train_rmse': rmse,
        'monotone': bool(np.all(np.diff(mono['obj_history']) <= 1e-9)),
    }


def cfg_north_star(n=32768, d=16384, k=256, tol=1e-4,
                   max_sweeps=3000, inner_reps=4, kernel='dense_phase'):
    """The north-star criterion at single-chip scale: wall-clock to
    ``tol`` relative Frobenius error on a dense rank-k matrix (the
    BASELINE target is 100k×50k k=256; see cfg_north_star_full for the
    true shape). Phase update order (exact BCD, monotone).

    Measurement integrity: the GPU's DEFAULT f32 matmul runs in TF32
    (~2⁻¹¹ relative noise) — it floors both the SOLVER's reachable error
    and the error MEASUREMENT above 1e-4. This run uses matmul_precision='float32'
    throughout, evaluates the residual per-row in f32, and accumulates the
    per-block partial sums in float64 on the host, so the reported error is
    trustworthy to well below 1e-4."""
    import jax
    import jax.numpy as jnp
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
    from rri_nmf_tpu.utils.profiling import SweepTimer
    from bench import bench_numpy

    # inner_reps: extra exact cyclic-BCD passes per phase (accelerated
    # HALS)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      matmul_precision='float32', inner_reps=inner_reps)
    if kernel == 'dense_phase':
        sweep = _dense_phase_sweep(cfg)
    else:
        sweep = make_sweep(cfg)
    reset_key = jax.random.PRNGKey(0)
    BLOCK = 10
    B = min(4096, n)
    nb = n // B

    @jax.jit
    def gen(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        Wg = jax.random.uniform(k1, (n, k), jnp.float32)
        Tg = jax.random.uniform(k2, (k, d), jnp.float32)
        with jax.default_matmul_precision('float32'):
            X = Wg @ Tg                   # exactly rank k: tol reachable
        xsq = jnp.zeros((nb,), jnp.float32)

        def xb(i, xsq):
            Xb = jax.lax.dynamic_slice(X, (i * B, 0), (B, d))
            return xsq.at[i].set(jnp.sum(jnp.sum(Xb * Xb, axis=1)))
        xsq = jax.lax.fori_loop(0, nb, xb, xsq)
        return X, xsq

    @jax.jit
    def run_block(X, W, T, key, resets):
        def body(i, c):
            W, T, key, resets = c
            return sweep(X, W, T, key, resets, reset_key)
        W, T, key, resets = jax.lax.fori_loop(0, BLOCK, body,
                                              (W, T, key, resets))
        # per-block residual partial sums: per-row f32 sums (d terms each),
        # block totals returned for float64 host accumulation
        def err_blk(i, parts):
            Xb = jax.lax.dynamic_slice(X, (i * B, 0), (B, d))
            Wb = jax.lax.dynamic_slice(W, (i * B, 0), (B, k))
            with jax.default_matmul_precision('float32'):
                Rb = Xb - Wb @ T
            return parts.at[i].set(jnp.sum(jnp.sum(Rb * Rb, axis=1)))
        parts = jax.lax.fori_loop(0, nb, err_blk,
                                  jnp.zeros((nb,), jnp.float32))
        return W, T, key, resets, parts

    X, xsq = gen(jax.random.PRNGKey(0))
    xnorm = float(np.sqrt(np.sum(np.asarray(xsq, dtype=np.float64))))
    # NNDSVD init on device (the reference's default init too,
    # initialization.py:73-77 there) — random init stalls near 4e-3 on
    # this problem class regardless of solver
    from rri_nmf_tpu.initialization import initialize_nmf
    with jax.default_matmul_precision('float32'):
        W0, T0 = initialize_nmf(X, k, 'nndsvd', random_state=0,
                                svd_backend='jax')
    W0 = jnp.asarray(W0, jnp.float32)
    T0 = jnp.asarray(T0, jnp.float32)
    key = jax.random.PRNGKey(1)
    resets = jnp.asarray(0, jnp.int32)
    # compile
    Wc, Tc, kc, rc, parts = run_block(X, W0, T0, key, resets)
    float(parts[0])

    W, T = W0, T0
    timer = SweepTimer()
    sweeps = 0
    rel = np.inf
    best = np.inf
    best_at = 0
    while rel > tol and sweeps < max_sweeps:
        W, T, key, resets, parts = run_block(X, W, T, key, resets)
        rel = float(np.sqrt(np.sum(np.asarray(parts, np.float64)))) / xnorm
        timer.mark()
        sweeps += BLOCK
        if rel < best * 0.99:
            best, best_at = rel, sweeps
        elif sweeps - best_at >= 300:
            break                          # converged plateau
    wall = timer.marks[-1]

    np_per_sweep = bench_numpy(min(n, 2048), d, k) * (n / min(n, 2048))
    return {
        'config': 'north_star_scaled_%dx%d_k%d' % (n, d, k),
        'note': ('one-device scaled version of the 100kx50k target; '
                 'matmul_precision=float32 (the default f32 dot runs in '
                 'TF32, which floors rel err above 1e-4); residual '
                 'accumulated per-row f32 + host float64; %s kernel, '
                 'inner_reps=%d (accelerated-HALS inner passes)'
                 % (kernel, inner_reps)),
        'reached_rel_frob_err': rel,
        'reached_target': bool(rel <= tol),
        'target': tol,
        'sweeps': sweeps,
        'wall_clock_seconds': wall,
        'seconds_per_sweep': wall / max(sweeps, 1),
        'reference_numpy_estimated_seconds': np_per_sweep * sweeps,
        'speedup_to_target': np_per_sweep * sweeps / wall,
    }


def cfg_north_star_full(n=100000, d=50000, k=256, max_sweeps=400):
    """BASELINE #4 at the TRUE shape (100k×50k k=256) on one device: X
    held in bfloat16 (10 GB, half the f32 form), factors f32,
    f32 accumulation. bf16 storage quantizes X itself (~2⁻⁹ relative), so
    1e-4 is not information-theoretically reachable here; the run reports
    wall-clock to the measured bf16 floor. The error is evaluated in f32
    against the bf16-stored X with float64 host accumulation."""
    import jax
    import jax.numpy as jnp
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
    from rri_nmf_tpu.utils.profiling import SweepTimer
    from bench import bench_numpy

    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase')
    # bf16 storage: the topic loop runs in f32 and stores bf16
    sweep = _dense_phase_sweep(cfg)
    reset_key = jax.random.PRNGKey(0)
    BLOCK = 10
    B = 2500
    nb = n // B

    @jax.jit
    def gen(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        Wg = jax.random.uniform(k1, (n, k), jnp.float32)
        Tg = jax.random.uniform(k2, (k, d), jnp.float32)
        X = jnp.zeros((n, d), jnp.bfloat16)

        def xb(i, X):
            Wb = jax.lax.dynamic_slice(Wg, (i * B, 0), (B, k))
            return jax.lax.dynamic_update_slice(
                X, (Wb @ Tg).astype(jnp.bfloat16), (i * B, 0))
        X = jax.lax.fori_loop(0, nb, xb, X)
        # mixed storage (round 3): X stays bf16 (10 GB residency), the
        # factors are genuinely f32 (the round-2 version quantized them to
        # bf16 too, sending the GS kernels down the narrow-scratch path)
        W0 = jax.random.uniform(k3, (n, k), jnp.float32)
        T0 = jax.random.uniform(k4, (k, d), jnp.float32)
        xsq = jnp.zeros((nb,), jnp.float32)

        def xq(i, xsq):
            Xb = jax.lax.dynamic_slice(X, (i * B, 0), (B, d)).astype(
                jnp.float32)
            return xsq.at[i].set(jnp.sum(jnp.sum(Xb * Xb, axis=1)))
        xsq = jax.lax.fori_loop(0, nb, xq, xsq)
        return X, W0, T0, xsq

    @jax.jit
    def run_block(X, W, T, key, resets):
        def body(i, c):
            W, T, key, resets = c
            return sweep(X, W, T, key, resets, reset_key)
        W, T, key, resets = jax.lax.fori_loop(0, BLOCK, body,
                                              (W, T, key, resets))

        def err_blk(i, parts):
            Xb = jax.lax.dynamic_slice(X, (i * B, 0), (B, d)).astype(
                jnp.float32)
            Wb = jax.lax.dynamic_slice(W, (i * B, 0), (B, k)).astype(
                jnp.float32)
            Rb = Xb - Wb @ T.astype(jnp.float32)
            return parts.at[i].set(jnp.sum(jnp.sum(Rb * Rb, axis=1)))
        parts = jax.lax.fori_loop(0, nb, err_blk,
                                  jnp.zeros((nb,), jnp.float32))
        return W, T, key, resets, parts

    X, W0, T0, xsq = gen(jax.random.PRNGKey(0))
    xnorm = float(np.sqrt(np.sum(np.asarray(xsq, dtype=np.float64))))
    key = jax.random.PRNGKey(1)
    resets = jnp.asarray(0, jnp.int32)
    Wc, Tc, kc, rc, parts = run_block(X, W0, T0, key, resets)
    float(parts[0])

    W, T = W0, T0
    timer = SweepTimer()
    sweeps = 0
    rel = np.inf
    best = np.inf
    best_at = 0
    while sweeps < max_sweeps:
        W, T, key, resets, parts = run_block(X, W, T, key, resets)
        rel = float(np.sqrt(np.sum(np.asarray(parts, np.float64)))) / xnorm
        timer.mark()
        sweeps += BLOCK
        if rel < best * 0.99:
            best, best_at = rel, sweeps
        elif sweeps - best_at >= 100:
            break
    wall = timer.marks[-1]

    np_per_sweep = bench_numpy(2048, 8192, k) * (n / 2048.0) * (d / 8192.0)
    return {
        'config': 'north_star_full_%dx%d_k%d_bf16' % (n, d, k),
        'note': ('TRUE BASELINE #4 shape on one chip: bf16 X storage '
                 '(10 GB; f32 would not fit), f32 factors/accumulation. '
                 'bf16 X quantization bounds reachable rel err near 2e-3.'),
        'reached_rel_frob_err': rel,
        'sweeps': sweeps,
        'wall_clock_seconds': wall,
        'seconds_per_sweep': wall / max(sweeps, 1),
        'reference_numpy_estimated_seconds': np_per_sweep * sweeps,
        'speedup_at_equal_sweeps': np_per_sweep * sweeps / wall,
    }


def cfg_dense_sweep():
    """BASELINE #4: the dense sweep on one GPU — delegates to
    bench.py's measurement (GFLOP/s + speedup vs NumPy reference)."""
    import importlib
    bench = importlib.import_module('bench')
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main()
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec['config'] = 'dense_sweep_one_gpu'
    return rec


def cfg_sparse(n=50000, d=30000, density=0.005, k=128, sweeps=8):
    """Sparse-X path at 50k×30k 0.5% k=128: measures the driver's two sparse modes —
    sparse='auto' (on-device densify when the dense form fits device
    memory → the dense phase sweep) and sparse=True (pure BCOO, O(nnz)
    memory)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    import scipy.sparse as sp
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
    from rri_nmf_tpu.ops.capability import gs_impl
    from rri_nmf_tpu.ops.sweep_sparse import make_sparse_sweep, to_bcoo

    rng = np.random.RandomState(0)
    nnz = int(n * d * density)
    flat = rng.choice(n * d, nnz, replace=False)
    flat.sort()
    vals = rng.rand(nnz).astype(np.float32)
    Xs = sp.coo_matrix((vals, ((flat // d).astype(np.int64),
                               (flat % d).astype(np.int64))),
                       shape=(n, d)).tocsr()
    W = jnp.asarray(np.abs(rng.rand(n, k)).astype(np.float32))
    T = jnp.asarray(np.abs(rng.rand(k, d)).astype(np.float32))
    Xsp = to_bcoo(Xs, jnp.float32)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase')
    key = jax.random.PRNGKey(0)
    rl = jnp.asarray(0, jnp.int32)

    def timed_sweeps(sweep, Xop):
        @jax.jit
        def f(Xop, W, T):
            def body(i, carry):
                W, T, k2, r2 = carry
                return sweep(Xop, W, T, k2, r2, k2)
            out = lax.fori_loop(0, sweeps, body, (W, T, key, rl))
            return out[0]
        s0 = float(jnp.sum(f(Xop, W, T)))
        assert np.isfinite(s0)
        t0 = time.perf_counter()
        float(jnp.sum(f(Xop, W, T)))
        return (time.perf_counter() - t0) / sweeps

    rec = {'config': 'sparse_%dx%d_%.1fpct_k%d' % (n, d, density * 100, k)}

    # pure-sparse (beyond-memory mode)
    rec['pure_bcoo_seconds_per_sweep'] = timed_sweeps(
        make_sparse_sweep(cfg, gs=gs_impl(None)), Xsp)

    # densified-on-device (the sparse='auto' policy when dense fits)
    @jax.jit
    def _densify(bc):
        return jnp.zeros(bc.shape, bc.data.dtype).at[
            bc.indices[:, 0], bc.indices[:, 1]].add(bc.data)
    t0 = time.perf_counter()
    Xd = _densify(Xsp)
    float(jnp.sum(Xd[0]))
    rec['densify_once_seconds_incl_compile'] = time.perf_counter() - t0
    rec['densified_hybrid_seconds_per_sweep'] = timed_sweeps(
        _dense_phase_sweep(cfg), Xd)
    rec['note'] = ('sparse=auto transfers the compressed form and '
                   'densifies on device when the dense form fits; '
                   'sparse=True keeps O(nnz) memory (scatter-bound '
                   'contractions)')
    return rec


def cfg_sharded(n_devices=8):
    """BASELINE #5: row/column-sharded sweep over a device mesh. On this
    build host several devices are unavailable; runs on a virtual CPU
    mesh to validate the GSPMD path and reports per-step timings + parity
    with the single-device sweep."""
    import jax
    if len(jax.devices()) < n_devices:
        return {'config': 'sharded_mesh', 'skipped':
                'only %d devices visible (need %d); run under '
                'XLA_FLAGS=--xla_force_host_platform_device_count=8 '
                'JAX_PLATFORMS=cpu or on a multi-GPU host'
                % (len(jax.devices()), n_devices)}

    import jax.numpy as jnp
    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
    from rri_nmf_tpu.parallel import (
        make_mesh, make_sharded_training_step, shard_problem)

    n, d, k = 2048, 1024, 32
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(n, d)).astype(np.float32)
    W0 = np.abs(rng.rand(n, k)).astype(np.float32)
    T0 = np.abs(rng.rand(k, d)).astype(np.float32)

    cfg = SweepConfig(k=k, reset_topic_method=None)
    mesh = make_mesh(n_devices)
    step = make_sharded_training_step(cfg, mesh, with_objective=False)
    Xs, Ws, Ts = shard_problem(mesh, X, W0, T0)
    key = jax.random.PRNGKey(0)
    resets = jnp.asarray(0, jnp.int32)

    W1, T1, k1, r1 = step(Xs, Ws, Ts, key, resets, key)
    jax.block_until_ready((W1, T1))
    t0 = time.perf_counter()
    for _ in range(5):
        W1, T1, k1, r1 = step(Xs, W1, T1, k1, r1, key)
    jax.block_until_ready((W1, T1))
    per_step = (time.perf_counter() - t0) / 5

    sweep = make_sweep(cfg)
    Wd1, Td1, _, _ = sweep(jnp.asarray(X), jnp.asarray(W0),
                           jnp.asarray(T0), key, resets, key)
    Ws1, Ts1, _, _ = step(Xs, Ws, Ts, key, resets, key)
    parity = bool(np.allclose(np.array(Ws1), np.array(Wd1), atol=1e-5))

    return {
        'config': 'sharded_mesh_%dx%d' % mesh.devices.shape,
        'note': 'virtual CPU mesh (no multi-chip hardware on build host)',
        'per_step_seconds': per_step,
        'parity_with_single_device': parity,
    }


ALL = {
    'cpu_parity': cfg_cpu_parity,
    'topic_modeling': cfg_topic_modeling,
    'recsys_masked': cfg_recsys_masked,
    # full MovieLens-1M shape (6040 users x 3706 items, 1M observed), the
    # BASELINE #3 scale — run this one on the GPU
    'recsys_full': lambda: cfg_recsys_masked(
        n_users=6040, n_items=3706, n_obs=1000000, k=40, baseline_sweeps=1),
    'dense_sweep': cfg_dense_sweep,
    'sparse': cfg_sparse,
    'north_star': cfg_north_star,
    'north_star_full': cfg_north_star_full,
    'sharded': cfg_sharded,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--configs', default='all')
    ap.add_argument('--out', default=None)
    ap.add_argument('--platform', default=None,
                    help="force a JAX platform (e.g. 'cpu')")
    ap.add_argument('--x64', action='store_true',
                    help='enable float64 (CPU parity runs)')
    args = ap.parse_args()
    import jax
    if args.platform:
        jax.config.update('jax_platforms', args.platform)
    if args.x64:
        jax.config.update('jax_enable_x64', True)
    names = list(ALL) if args.configs == 'all' else args.configs.split(',')
    results = []
    for name in names:
        print('== %s ==' % name, file=sys.stderr, flush=True)
        try:
            rec = ALL[name]()
        except Exception as e:
            rec = {'config': name, 'error': repr(e)}
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))


if __name__ == '__main__':
    main()
