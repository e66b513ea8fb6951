#!/usr/bin/env python3
"""Run the library's main paths once on a GPU and check each against a
plain reference.

    python chip_smoke.py               # one GPU: phases 1-5, then the
                                       # tests marked ``gpu``
    python chip_smoke.py --no-timing   # the same without the kernel-vs-XLA
                                       # timing (a compile-and-check run)
    python chip_smoke.py --four        # four GPUs: the mesh phases only
    python chip_smoke.py --rehearse    # tiny shapes on the CPU, the
                                       # Gauss-Seidel kernel interpreted

Phases (one GPU), all data drawn on the device from ``--seed``:

1. dense phase fit, 16384x8192 k=128: ``nmf(update_order='phase',
   reset_topic_method=None)``; the Triton Gauss-Seidel kernel against the
   XLA loop; one sweep against a float64 NumPy phase-order oracle; then
   seconds per sweep of the kernel and XLA routes at 16384x8192 k=128 and
   32768x16384 k=256;
2. topic-model estimator on a Zipf TF-IDF corpus shaped like 20
   Newsgroups (11314x26214, k=50): default preset and the fast-TM recipe;
3. recommender estimator on a Zipf-skewed MovieLens-1M shape (6040x3706,
   1M ratings, k=40): the dense-mask, O(nnz) sparse-mask and Gram-phase
   routes;
4. sparse corpus, 50000x30000 at 0.5% nonzeros, k=128, BCOO against the
   densified sweep;
5. int16 X storage against the float32 fit.

Every phase states its precision and tolerance. A failed check raises, and
the script exits non-zero; it never catches a phase's failure. The last
line of a passing run is one JSON object naming the device. Without a GPU
(and without ``--rehearse``) the script exits non-zero before any phase.
One process owns the card.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--four', action='store_true',
                    help='run the mesh phases on four GPUs, and nothing '
                         'else')
    ap.add_argument('--no-timing', action='store_true',
                    help='skip the kernel-vs-XLA timing')
    ap.add_argument('--rehearse', action='store_true',
                    help='tiny shapes on the CPU backend (checks control '
                         'flow; prints no result line)')
    return ap.parse_args()


ARGS = _args()
if ARGS.rehearse:
    os.environ['JAX_PLATFORMS'] = 'cpu'
    if ARGS.four:
        os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                                   ' --xla_force_host_platform_device_count'
                                   '=4').strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

CACHE_DIR = (os.environ.get('JAX_COMPILATION_CACHE_DIR')
             or str(ROOT / '.cache' / 'jax_compile'))
jax.config.update('jax_compilation_cache_dir', CACHE_DIR)

from rri_nmf_tpu.nmf import nmf  # noqa: E402
from rri_nmf_tpu.sklearn_interface import (NMF_RS_Estimator,  # noqa: E402
                                           NMF_TM_Estimator)
from rri_nmf_tpu.matrixops import normalize, tfidf  # noqa: E402
from rri_nmf_tpu.ops.capability import gs_impl  # noqa: E402
from rri_nmf_tpu.ops.dense_phase import (gs_kernel, gs_topics_blocked,  # noqa
                                         make_dense_phase_sweep)
from rri_nmf_tpu.ops.sweep_xla import (SweepConfig, _gram_block_size,  # noqa
                                      make_sweep)

# full sizes, and the rehearsal's
FULL = dict(dense=(16384, 8192, 128),
            timing=[(16384, 8192, 128), (32768, 16384, 256)],
            tm=(11314, 26214, 50, 512), tm_doc_len=160,
            rs=(6040, 3706, 40, 1000209, 512),
            sparse=(50000, 30000, 128, 0.005),
            four_dense=(32768, 8192, 128))
TINY = dict(dense=(96, 64, 8), timing=[(96, 64, 8), (128, 96, 16)],
            tm=(300, 400, 6, 32), tm_doc_len=30,
            rs=(120, 90, 5, 3000, 32),
            sparse=(300, 200, 8, 0.03),
            four_dense=(128, 64, 8))
S = TINY if ARGS.rehearse else FULL
TIMING_REPS = 7


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def log(*a):
    print(*a, flush=True)


def rel_err(a, b):
    """max |a - b| / max |b|, in float64 on the host."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def check(name, value, tol, precision):
    ok = bool(np.isfinite(value)) and value <= tol
    log('  %-46s %.3e  (tol %.1e, %s) %s'
        % (name, value, tol, precision, 'ok' if ok else 'FAILED'))
    if not ok:
        raise AssertionError('%s = %r exceeds %r' % (name, value, tol))


def require(name, cond, detail=''):
    log('  %-46s %s %s' % (name, 'ok' if cond else 'FAILED', detail))
    if not cond:
        raise AssertionError('%s failed %s' % (name, detail))


def max_rel_rise(obj):
    obj = np.asarray(obj, np.float64)
    if obj.size < 2:
        return 0.0
    return float(np.max(np.diff(obj) / np.abs(obj[:-1])))


def memory_report(name, fn, *args):
    """Compile ``fn`` for ``args``, print its memory analysis, and return
    the compiled callable."""
    fn = fn if hasattr(fn, 'lower') else jax.jit(fn)
    compiled = fn.lower(*args).compile()
    ma = compiled.memory_analysis()
    if ma is None:
        log('  memory_analysis[%s]: not reported' % name)
    else:
        log('  memory_analysis[%s]: args %.1f MiB, out %.1f MiB, temp '
            '%.1f MiB, code %.1f MiB' % (
                name, ma.argument_size_in_bytes / 2**20,
                ma.output_size_in_bytes / 2**20,
                ma.temp_size_in_bytes / 2**20,
                ma.generated_code_size_in_bytes / 2**20))
    return compiled


def median_seconds(fn, *args):
    """Median wall time of ``fn(*args)`` over TIMING_REPS runs after one
    warm-up, each ended by ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def one_sweep(sweep, X, W, T, *extras):
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T, _, _ = sweep(X, W, T, key, r, key, *extras)
    return W, T


def masked_compare(Xc, name, Wa, Ta, Wb, Tb, I, J, pred_tol, what):
    """Compare two masked fits on the observed entries (I, J) of ``Xc``:
    the masked objective to ``pred_tol / 10`` and the predictions to
    ``pred_tol``, both relative. The masked objective pins W T on the
    observed entries only: users and items with few ratings leave their
    factor entries ill-determined (a one-rating user's w is a rating over
    a small t), so masked fits are not compared factor by factor."""
    x = np.asarray(Xc[I, J], np.float64).ravel()
    pa = np.einsum('qk,kq->q', np.asarray(Wa, np.float64)[I],
                   np.asarray(Ta, np.float64)[:, J])
    pb = np.einsum('qk,kq->q', np.asarray(Wb, np.float64)[I],
                   np.asarray(Tb, np.float64)[:, J])
    oa, ob = np.sum((x - pa) ** 2), np.sum((x - pb) ** 2)
    check(name + ', objective', abs(oa - ob) / ob, pred_tol / 10, what)
    check(name + ', predictions',
          float(np.linalg.norm(pa - pb) / np.linalg.norm(pb)), pred_tol,
          what)


def tests_module(name):
    """A plain NumPy oracle kept with the test suite."""
    sys.path.insert(0, str(ROOT / 'tests'))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def lowrank_x(key, n, d, k, noise=0.05):
    """Nonnegative rank-k X plus uniform noise, drawn on the device."""
    ka, kb, kn = jax.random.split(key, 3)
    A = jax.random.uniform(ka, (n, k), jnp.float32)
    B = jax.random.uniform(kb, (k, d), jnp.float32)
    with jax.default_matmul_precision('highest'):
        return A @ B / k + noise * jax.random.uniform(kn, (n, d),
                                                      jnp.float32)


def start_factors(key, n, d, k, t_row_sum=None):
    kw, kt = jax.random.split(key)
    W = jax.random.uniform(kw, (n, k), jnp.float32)
    T = jax.random.uniform(kt, (k, d), jnp.float32)
    if t_row_sum:
        T = t_row_sum * T / jnp.sum(T, axis=1, keepdims=True)
    return W, T


def zipf_ids(key, shape, m, a):
    """Ids in [0, m) with P(rank r) ∝ r^-a, ranks scrambled over the ids;
    drawn on the device."""
    ku, kp = jax.random.split(key)
    p = jnp.arange(1, m + 1, dtype=jnp.float32) ** (-a)
    cdf = jnp.cumsum(p) / jnp.sum(p)
    r = jnp.minimum(jnp.searchsorted(cdf, jax.random.uniform(ku, shape)),
                    m - 1)
    return jax.random.permutation(kp, m)[r]


def unique_pairs(draw, need, n_cols):
    """First ``need`` distinct (row, col) pairs from repeated draws of
    ``draw(i) -> (rows, cols)`` device arrays."""
    got = np.empty(0, np.int64)
    for i in range(8):
        r, c = draw(i)
        flat = np.asarray(r, np.int64) * n_cols + np.asarray(c, np.int64)
        flat = np.concatenate([got, flat])
        _, first = np.unique(flat, return_index=True)
        got = flat[np.sort(first)]
        if got.size >= need:
            got = got[:need]
            return got // n_cols, got % n_cols
    raise RuntimeError('drew only %d distinct pairs of %d' % (got.size,
                                                              need))


# ---------------------------------------------------------------------------
# plain references
# ---------------------------------------------------------------------------

EPS = float(np.spacing(10))


def numpy_gs(N, F, G):
    """The Gauss-Seidel topic loop in float64 NumPy, on ``(k, m)`` panels:
    ``F[t] <- max(N[t] - Σ_{s≠t} G[t,s] F[s], 0) / (G[t,t] + eps)``."""
    N, G = np.asarray(N, np.float64), np.asarray(G, np.float64)
    F = np.array(F, np.float64)
    for t in range(F.shape[0]):
        corr = G[t] @ F - G[t, t] * F[t]
        F[t] = np.maximum(N[t] - corr, 0.0) / (G[t, t] + EPS)
    return F


def numpy_phase_sweep(X, W, T):
    """One phase-order sweep in float64 NumPy: the T-phase on (WᵀW, WᵀX),
    then the W-phase on (TTᵀ, TXᵀ)."""
    X = np.asarray(X, np.float64)
    W = np.asarray(W, np.float64)
    T = numpy_gs(W.T @ X, T, W.T @ W)
    W = numpy_gs(T @ X.T, W.T, T @ T.T).T
    return W, T


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_dense(key, gs):
    n, d, k = S['dense']
    log('\n[1] dense phase fit %dx%d k=%d (float32; GS route %r)'
        % (n, d, k, gs))
    X = lowrank_x(key, n, d, k)
    t0 = time.perf_counter()
    out = nmf(X, k, update_order='phase', reset_topic_method=None,
              dtype=jnp.float32, max_iter=5, eps_stop=0.0,
              early_stop=False, compute_obj_each_iter=True,
              random_state=ARGS.seed)
    log('  nmf(): %d sweeps in %.2f s (compile included)'
        % (len(out['obj_history']), time.perf_counter() - t0))
    obj = out['obj_history']
    log('  objective: %s' % ', '.join('%.6e' % o for o in obj))
    require('W, T finite', bool(np.all(np.isfinite(out['W']))
                                and np.all(np.isfinite(out['T']))))
    check('objective rise, largest relative', max(max_rel_rise(obj), 0.0),
          1e-5, 'default precision')

    # the kernel against the XLA loop on the T-phase's inputs
    W, T = jnp.asarray(out['W']), jnp.asarray(out['T'])
    with jax.default_matmul_precision('highest'):
        G = W.T @ W
        N = W.T @ X
        ref = jax.jit(lambda N, F, G: gs_topics_blocked(
            N, F, G, k=k, B=1, reg_l1=0.0, reg_l2=0.0, qf_s=None,
            qf_ub=None, reproject_sum=None, acc=jnp.float32,
            dtype=jnp.float32))(N, T, G)
        got = jax.jit(lambda N, F, G: gs_kernel(
            N, F, G, reg_l1=0.0, reg_l2=0.0, bound=float('inf'),
            interpret=gs == 'interpret'))(N, T, G)
    # both are float32 loops over k topics that sum in different orders;
    # the fitted W's Gram is far from diagonal, which amplifies rounding
    check('GS kernel vs XLA GS loop (k=%d, d=%d)' % (k, d),
          rel_err(got, ref), 5e-5, "float32, 'highest'")
    exact = numpy_gs(N, T, G)
    log('  against the float64 loop on the same inputs: kernel %.3e, XLA '
        'loop %.3e' % (rel_err(got, exact), rel_err(ref, exact)))
    check('GS kernel vs float64 loop', rel_err(got, exact), 5e-5,
          "float32, 'highest'")

    # one sweep of the default path against the float64 oracle
    key_w = jax.random.fold_in(key, 1)
    W0, T0 = start_factors(key_w, n, d, k)
    Wr, Tr = numpy_phase_sweep(X, W0, T0)
    for prec, tol in ((None, None), ('highest', 1e-4)):
        cfg = SweepConfig(k=k, update_order='phase',
                          reset_topic_method=None, matmul_precision=prec)
        sweep = make_dense_phase_sweep(cfg, gs)
        if prec is None:
            sweep = memory_report('dense phase sweep', sweep, X, W0, T0,
                                  jax.random.PRNGKey(0),
                                  jnp.asarray(0, jnp.int32),
                                  jax.random.PRNGKey(0))
        W1, T1 = one_sweep(sweep, X, W0, T0)
        eW, eT = rel_err(W1, Wr), rel_err(T1, Tr)
        if tol is None:
            log('  sweep vs float64 oracle, default precision (TF32 on '
                'the GPU): W %.3e, T %.3e (reported, not asserted)'
                % (eW, eT))
        else:
            check('sweep vs float64 oracle, W', eW, tol, "'highest'")
            check('sweep vs float64 oracle, T', eT, tol, "'highest'")
    return X, out


def timing(gs):
    """Seconds per sweep of the dense phase sweep with the kernel and with
    the XLA loop, the plain XLA phase sweep, and per nmf() sweep."""
    log('\n[1t] seconds per sweep, median of %d after warm-up '
        '(float32, default precision)%s' % (
            TIMING_REPS, '; CPU rehearsal, not device times'
            if ARGS.rehearse else ''))
    for (n, d, k) in S['timing']:
        key = jax.random.PRNGKey(ARGS.seed + k)
        X = lowrank_x(key, n, d, k)
        W0, T0 = start_factors(jax.random.fold_in(key, 1), n, d, k)
        cfg = SweepConfig(k=k, update_order='phase', reset_topic_method=None)
        args = (X, W0, T0, jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32),
                jax.random.PRNGKey(0))
        r = {
            'dense_phase_kernel': median_seconds(
                make_dense_phase_sweep(cfg, gs), *args),
            'dense_phase_xla_loop': median_seconds(
                make_dense_phase_sweep(cfg, 'xla'), *args),
            'make_sweep_xla': median_seconds(make_sweep(cfg), *args),
        }
        with jax.default_matmul_precision('highest'):
            G = W0.T @ W0
            N = W0.T @ X
        r['gs_loop_kernel'] = median_seconds(jax.jit(
            lambda N, F, G: gs_kernel(N, F, G, reg_l1=0.0, reg_l2=0.0,
                                      bound=float('inf'),
                                      interpret=gs == 'interpret')),
            N, T0, G)
        r['gs_loop_xla'] = median_seconds(jax.jit(
            lambda N, F, G: gs_topics_blocked(
                N, F, G, k=k, B=_gram_block_size(k), reg_l1=0.0,
                reg_l2=0.0,
                qf_s=None, qf_ub=None, reproject_sum=None,
                acc=jnp.float32, dtype=jnp.float32)), N, T0, G)
        # seconds per nmf() sweep: (wall of 25 sweeps - wall of 5) / 20,
        # each wall the median of three calls after a warm-up call
        for name, up in (('nmf_kernel',
                          'interpret' if gs == 'interpret' else None),
                         ('nmf_xla', False)):
            walls = {5: [], 25: []}
            for iters in (5, 5, 25, 5, 25, 5, 25):
                t0 = time.perf_counter()
                nmf(X, k, update_order='phase', reset_topic_method=None,
                    dtype=jnp.float32, max_iter=iters, eps_stop=0.0,
                    early_stop=False, init='random',
                    random_state=ARGS.seed, use_pallas=up)
                walls[iters].append(time.perf_counter() - t0)
            r[name] = (np.median(walls[25]) - np.median(walls[5][1:])) / 20
        if k == S['dense'][2] and (n, d) == S['dense'][:2]:
            tm = SweepConfig(k=k, update_order='phase',
                             reset_topic_method=None,
                             project_T_each_iter=True, t_row_sum=1.0,
                             w_row_sum=1.0)
            T1 = T0 / jnp.sum(T0, axis=1, keepdims=True)
            targs = (X, W0, T1) + args[3:]
            r['tm_preset_kernel'] = median_seconds(
                make_dense_phase_sweep(tm, gs), *targs)
            r['tm_preset_xla'] = median_seconds(make_sweep(tm), *targs)
        log('  %dx%d k=%d: %s' % (n, d, k, ', '.join(
            '%s %.6f' % kv for kv in r.items())))
        del X


def tm_corpus(key, n, d, doc_len, n_topics=20):
    """Zipf word counts with topic structure: each document draws its
    words from one of ``n_topics`` scrambled Zipf vocabularies (70%) or
    the shared one (30%). Drawn on the device; CSR on the host."""
    kz, kt, ks, kp, kl = jax.random.split(key, 5)
    topic = jax.random.randint(kt, (n,), 0, n_topics)
    ranks = zipf_ids(kz, (n, doc_len), d, 1.07)
    perms = jax.vmap(lambda kk: jax.random.permutation(kk, d))(
        jax.random.split(kp, n_topics))
    own = jax.random.uniform(ks, (n, doc_len)) < 0.7
    words = jnp.where(own, perms[topic[:, None], ranks], ranks)
    length = jnp.clip(jnp.exp(jnp.log(doc_len / 2.0) + 0.6 *
                              jax.random.normal(kl, (n,))), 10, doc_len)
    keep = np.asarray(jnp.arange(doc_len)[None, :] < length[:, None])
    rows = np.repeat(np.arange(n), doc_len)[keep.ravel()]
    cols = np.asarray(words).ravel()[keep.ravel()]
    return sp.coo_matrix((np.ones(rows.size), (rows, cols)),
                         shape=(n, d)).tocsr()


def phase_tm(key, gs):
    n, d, k, n_new = S['tm']
    log('\n[2] topic-model estimator, Zipf TF-IDF corpus %dx%d k=%d '
        '(float32, default precision)' % (n, d, k))
    C = tm_corpus(key, n + n_new, d, S['tm_doc_len'])
    Ctr, Cnew = C[:n], C[n:]
    log('  corpus: %d nonzeros (%.3f%%)' % (Ctr.nnz,
                                             100.0 * Ctr.nnz / (n * d)))
    tol_simplex = 1e-5
    fits = (('default preset', 3, dict(compute_obj_each_iter=True,
                                       dtype=jnp.float32)),
            ('fast-TM recipe', 10, dict(update_order='phase',
                                        reset_topic_method=None,
                                        inner_reps=3,
                                        compute_obj_each_iter=True,
                                        dtype=jnp.float32)))
    for name, iters, kw in fits:
        est = NMF_TM_Estimator(n, d, k, max_iter=iters, handle_tfidf=True,
                               handle_normalization=True,
                               random_state=ARGS.seed, nmf_kwargs=kw)
        t0 = time.perf_counter()
        est.fit(Ctr)
        obj = est.nmf_outputs['obj_history']
        log('  %s: %d sweeps in %.2f s; objective %s' % (
            name, len(obj), time.perf_counter() - t0,
            ', '.join('%.6e' % o for o in obj)))
        W, T = np.asarray(est.W, np.float64), np.asarray(est.T, np.float64)
        check('%s: T rows off the simplex' % name,
              float(max(np.abs(T.sum(1) - 1).max(), -T.min(), 0)),
              tol_simplex, 'float32')
        check('%s: W rows off the simplex' % name,
              float(max(np.abs(W.sum(1) - 1).max(), -W.min(), 0)),
              tol_simplex, 'float32')
        check('%s: objective rise, largest relative' % name,
              max(max_rel_rise(obj), 0.0), 1e-5, 'default precision')
        Wn = np.asarray(est.transform(Cnew), np.float64)
        require('%s: transform of %d documents' % (name, n_new),
                Wn.shape == (n_new, k) and bool(np.isfinite(Wn).all())
                and float(np.abs(Wn.sum(1) - 1).max()) <= tol_simplex)

    # the W-phase kernel + projected XLA T-phase against the XLA sweep
    cfg = SweepConfig(k=k, update_order='phase', reset_topic_method=None,
                      project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0, matmul_precision='highest')
    X = jnp.asarray(normalize(tfidf(Ctr)).toarray(), jnp.float32)
    W0, T0 = jnp.asarray(est.W, jnp.float32), jnp.asarray(est.T, jnp.float32)
    sweep = memory_report('TM fast-recipe sweep',
                          make_dense_phase_sweep(cfg, gs), X, W0, T0,
                          jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32),
                          jax.random.PRNGKey(0))
    Wa, Ta = one_sweep(sweep, X, W0, T0)
    Wb, Tb = one_sweep(make_sweep(cfg), X, W0, T0)
    check('projected phase sweep vs XLA sweep, W', rel_err(Wa, Wb), 1e-4,
          "float32, 'highest'")
    check('projected phase sweep vs XLA sweep, T', rel_err(Ta, Tb), 1e-4,
          "float32, 'highest'")


def rs_data(key, n, d, n_ratings, n_new):
    """MovieLens-1M-shaped ratings: Zipf user activity and item
    popularity, 1-5 stars from a rank-8 taste model plus noise."""
    ku, ki, kU, kV, ke, kn = jax.random.split(key, 6)
    U = jax.random.uniform(kU, (n + n_new, 8))
    V = jax.random.uniform(kV, (d, 8))

    def draw(i, users=n):
        m = int(n_ratings * 1.5)
        return (zipf_ids(jax.random.fold_in(ku, i), (m,), users, 0.5),
                zipf_ids(jax.random.fold_in(ki, i), (m,), d, 0.9))

    I, J = unique_pairs(draw, n_ratings, d)
    n_new_ratings = max(n_new * 40, 1)
    In, Jn = unique_pairs(lambda i: (
        jax.random.randint(jax.random.fold_in(kn, i), (2 * n_new_ratings,),
                           0, n_new),
        zipf_ids(jax.random.fold_in(ki, 100 + i), (2 * n_new_ratings,), d,
                 0.9)), n_new_ratings, d)

    def stars(I, J, kk):
        s = jnp.sum(U[I] * V[J], axis=1) / 8.0
        r = jnp.round(1.0 + 10.0 * s + 0.5 * jax.random.normal(kk, s.shape))
        return np.asarray(jnp.clip(r, 1, 5), np.float64)

    R = stars(jnp.asarray(I), jnp.asarray(J), ke)
    Rn = stars(jnp.asarray(In + n), jnp.asarray(Jn),
               jax.random.fold_in(ke, 1))
    return I, J, R, In, Jn, Rn


def phase_rs(key, gs):
    n, d, k, n_ratings, n_new = S['rs']
    log('\n[3] recommender estimator, MovieLens-1M shape %dx%d, %d '
        'ratings, k=%d (float32, default precision)'
        % (n, d, n_ratings, k))
    I, J, R, In, Jn, Rn = rs_data(key, n, d, n_ratings, n_new)
    perm = np.random.RandomState(ARGS.seed).permutation(n_ratings)
    te, tr = perm[:n_ratings // 20], perm[n_ratings // 20:]
    Xtr = np.stack([I[tr], J[tr]], 1)
    naive = float(np.sqrt(np.mean((R[te] - R[tr].mean()) ** 2)))
    log('  naive mean predictor RMSE %.4f' % naive)
    rmse = {}
    routes = (('dense mask', dict(sparse_obs=False), {}),
              ('O(nnz) sparse mask', dict(sparse_obs=True), {}),
              ('Gram phase', dict(sparse_obs=True),
               dict(update_order='phase')))
    for name, ekw, nkw in routes:
        est = NMF_RS_Estimator(n, d, k, max_iter=10, random_state=ARGS.seed,
                               use_validation_early_stopping=False,
                               nmf_kwargs=dict(dtype=jnp.float32, **nkw),
                               **ekw)
        t0 = time.perf_counter()
        est.fit(Xtr, R[tr])
        rmse[name] = float(np.sqrt(np.mean(
            (est.predict(np.stack([I[te], J[te]], 1)) - R[te]) ** 2)))
        log('  %s fit: %d sweeps in %.2f s, test RMSE %.4f' % (
            name, len(est.nmf_outputs['obj_history']),
            time.perf_counter() - t0, rmse[name]))
        require('%s: RMSE finite and below the naive mean' % name,
                np.isfinite(rmse[name]) and rmse[name] < naive)
        if name == 'dense mask':
            Xnew = sp.csr_matrix((Rn, (In, Jn)), shape=(n_new, d))
            Wn = np.asarray(est.transform(Xnew))
            require('transform of %d new users' % n_new,
                    Wn.shape == (n_new, k) and bool(np.isfinite(Wn).all())
                    and float(Wn.min()) >= 0)
            pn = est.predict(np.stack([I[te][:5], J[te][:5]], 1))
            require('predict', pn.shape == (5,)
                    and bool(np.all((pn >= 1) & (pn <= 5))))
    check('O(nnz) vs dense-mask fit, test RMSE',
          abs(rmse['O(nnz) sparse mask'] - rmse['dense mask'])
          / rmse['dense mask'], 2e-2,
          'float32, same update order, default precision')
    # phase order is another algorithm: its fit may differ, but must not
    # be worse than the interleaved one's
    check('Gram-phase fit RMSE over dense-mask fit RMSE - 1',
          rmse['Gram phase'] / rmse['dense mask'] - 1.0, 2e-2,
          'float32, phase vs interleaved order')

    # sweeps against references, one sweep from one start at 'highest'
    from rri_nmf_tpu.ops.sweep_masked_gram import (make_masked_gram_sweep,
                                                   plan_masked_gram)
    from rri_nmf_tpu.ops.sweep_masked_sparse import (
        make_masked_sparse_sweep, plan_masked_coo)
    Xc = sp.csr_matrix((R, (I, J)), shape=(n, d))
    Mc = sp.csr_matrix((np.ones_like(R), (I, J)), shape=(n, d))
    Xd = jnp.asarray(Xc.toarray(), jnp.float32)
    Md = jnp.asarray(Mc.toarray(), jnp.float32)
    W0, T0 = start_factors(jax.random.fold_in(key, 7), n, d, k,
                           t_row_sum=1.0)
    base = dict(k=k, masked=True, reset_topic_method=None, t_row_sum=1.0,
                matmul_precision='highest')
    rows = min(512, n // 2)
    Is, Js = I[I < rows], J[I < rows]
    # the interleaved routes carry an incremental float32 residual
    # through 2k rank-one updates per sweep; its rounding reaches 2e-4 to
    # 2e-3 of the predictions of ill-determined rows (a TF32 rounding
    # there moved the fit's RMSE by 20%); the Gram-phase route recomputes
    # its contractions each phase
    carry_tol = 1e-2
    dense_i = make_sweep(SweepConfig(**base))
    oracle = tests_module('test_consistency')._numpy_masked_sweep
    Wr, Tr = oracle(np.asarray(Xd[:rows], np.float64),
                    np.asarray(Md[:rows], np.float64),
                    np.array(W0[:rows], np.float64),
                    np.array(T0, np.float64), t_row_sum=1.0)
    Ws, Ts = one_sweep(dense_i, Xd[:rows], W0[:rows], T0, Md[:rows])
    compare = partial(masked_compare, Xc)
    compare('masked sweep vs NumPy oracle (%d rows)' % rows, Ws, Ts, Wr,
            Tr, Is, Js, carry_tol, "float32 vs float64, 'highest'")

    Wd, Td = one_sweep(dense_i, Xd, W0, T0, Md)
    coo = plan_masked_coo(Xc, Mc, np.float32)
    sparse_i = memory_report(
        'O(nnz) masked sweep', make_masked_sparse_sweep(
            SweepConfig(masked_sparse=True, **base)), coo, W0, T0,
        jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32),
        jax.random.PRNGKey(0))
    Wo, To = one_sweep(sparse_i, coo, W0, T0)
    compare('O(nnz) vs dense-mask sweep', Wo, To, Wd, Td, I, J, carry_tol,
            "float32, 'highest'")
    phase = dict(base, update_order='phase', masked_sparse=True)
    plan = plan_masked_gram(Xc, Mc, np.float32)
    gram = memory_report('Gram-phase masked sweep',
                         make_masked_gram_sweep(SweepConfig(**phase)), plan,
                         W0, T0, jax.random.PRNGKey(0),
                         jnp.asarray(0, jnp.int32), jax.random.PRNGKey(0))
    Wg, Tg = one_sweep(gram, plan, W0, T0)
    require('Gram-phase sweep finite', bool(jnp.all(jnp.isfinite(Wg))
                                            & jnp.all(jnp.isfinite(Tg))))
    # the Gram-phase route against the NumPy phase-order masked oracle
    phase_oracle = tests_module('test_masked_gram')._numpy_masked_phase_sweep
    Wr, Tr = phase_oracle(np.asarray(Xd[:rows], np.float64),
                          np.asarray(Md[:rows], np.float64),
                          np.array(W0[:rows], np.float64),
                          np.array(T0, np.float64), t_row_sum=1.0)
    Wg, Tg = one_sweep(make_masked_gram_sweep(SweepConfig(**phase)),
                       plan_masked_gram(Xc[:rows], Mc[:rows], np.float32),
                       W0[:rows], T0)
    compare('Gram-phase sweep vs NumPy oracle (%d rows)' % rows, Wg, Tg,
            Wr, Tr, Is, Js, 1e-3, "float32 vs float64, 'highest'")
    if not ARGS.no_timing:
        dcfg = SweepConfig(k=k, masked=True, reset_topic_method=None,
                           t_row_sum=1.0)
        gcfg = SweepConfig(k=k, masked=True, masked_sparse=True,
                           update_order='phase', reset_topic_method=None,
                           t_row_sum=1.0)
        key0, r0 = jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32)
        log('  seconds per sweep (float32, default precision): dense-mask '
            'interleaved %.6f, Gram phase %.6f' % (
                median_seconds(make_sweep(dcfg), Xd, W0, T0, key0, r0,
                               key0, Md),
                median_seconds(make_masked_gram_sweep(gcfg), plan, W0, T0,
                               key0, r0, key0)))


def sparse_corpus(key, n, d, density):
    nnz = int(n * d * density)
    kr, kc, kv = jax.random.split(key, 3)
    I, J = unique_pairs(lambda i: (
        jax.random.randint(jax.random.fold_in(kr, i), (int(nnz * 1.3),), 0,
                           n),
        zipf_ids(jax.random.fold_in(kc, i), (int(nnz * 1.3),), d, 0.8)),
        nnz, d)
    v = np.asarray(jax.random.uniform(kv, (nnz,), jnp.float32, 0.1, 1.0))
    return sp.csr_matrix((v, (I, J)), shape=(n, d))


def phase_sparse(key, gs):
    from rri_nmf_tpu.ops.sweep_sparse import make_sparse_sweep, to_bcoo
    n, d, k, density = S['sparse']
    log('\n[4] sparse corpus %dx%d at %.2f%% nonzeros, k=%d (float32)'
        % (n, d, 100 * density, k))
    Xc = sparse_corpus(key, n, d, density)
    t0 = time.perf_counter()
    out = nmf(Xc, k, sparse=True, update_order='phase',
              reset_topic_method=None, dtype=jnp.float32, max_iter=3,
              eps_stop=0.0, early_stop=False, compute_obj_each_iter=True,
              random_state=ARGS.seed)
    obj = out['obj_history']
    log('  nmf(sparse=True): %d sweeps in %.2f s; objective %s' % (
        len(obj), time.perf_counter() - t0,
        ', '.join('%.6e' % o for o in obj)))
    require('W, T finite', bool(np.all(np.isfinite(out['W']))
                                and np.all(np.isfinite(out['T']))))
    check('objective rise, largest relative', max(max_rel_rise(obj), 0.0),
          1e-5, 'default precision')
    cfg = SweepConfig(k=k, update_order='phase', reset_topic_method=None,
                      matmul_precision='highest')
    Xb = to_bcoo(Xc, jnp.float32)
    W0, T0 = start_factors(jax.random.fold_in(key, 3), n, d, k)
    sweep = memory_report('BCOO phase sweep', make_sparse_sweep(cfg, gs=gs),
                          Xb, W0, T0, jax.random.PRNGKey(0),
                          jnp.asarray(0, jnp.int32), jax.random.PRNGKey(0))
    Ws, Ts = one_sweep(sweep, Xb, W0, T0)
    Wd, Td = one_sweep(make_dense_phase_sweep(cfg, gs), Xb.todense(), W0,
                       T0)
    check('BCOO vs densified sweep, W', rel_err(Ws, Wd), 1e-4,
          "float32, 'highest'")
    check('BCOO vs densified sweep, T', rel_err(Ts, Td), 1e-4,
          "float32, 'highest'")


def phase_int16(X):
    from rri_nmf_tpu.ops.quantized import dequantize_x, quantize_x
    n, d = X.shape
    k = S['dense'][2]
    log('\n[5] int16 X storage %dx%d k=%d against float32 storage '
        "(both 'highest')" % (n, d, k))
    qx = quantize_x(X)
    with jax.default_matmul_precision('highest'):
        floor = float(jnp.linalg.norm(dequantize_x(qx) - X)
                      / jnp.linalg.norm(X))
    log('  storage noise floor ||X - dequant(quant(X))|| / ||X|| = %.3e'
        % floor)
    W0, T0 = start_factors(jax.random.PRNGKey(ARGS.seed + 5), n, d, k)
    kw = dict(update_order='phase', reset_topic_method=None,
              dtype=jnp.float32, max_iter=5, eps_stop=0.0, early_stop=False,
              W_in=np.asarray(W0), T_in=np.asarray(T0),
              matmul_precision='highest')
    err = {}
    for name, Xin in (('int16', qx), ('float32', X)):
        out = nmf(Xin, k, **kw)
        W, T = jnp.asarray(out['W']), jnp.asarray(out['T'])
        with jax.default_matmul_precision('highest'):
            err[name] = float(jnp.linalg.norm(X - W @ T)
                              / jnp.linalg.norm(X))
        log('  %s fit: relative residual %.6e' % (name, err[name]))
    check('|residual(int16) - residual(float32)|',
          abs(err['int16'] - err['float32']), floor,
          "the storage noise floor, 'highest'")


def run_gpu_tests():
    """The suite's tests marked ``gpu``, in this process (it owns the
    card)."""
    import pytest
    log('\n[6] tests marked gpu')
    os.environ['RRI_NMF_TESTS_ON_DEVICE'] = '1'
    rc = pytest.main(['-q', '-m', 'gpu', '-p', 'no:cacheprovider',
                      '-p', 'no:xdist', '-p', 'no:randomly',
                      str(ROOT / 'tests' / 'test_dense_phase.py')])
    require('pytest -m gpu', rc == 0, '(exit %s)' % rc)


# ---------------------------------------------------------------------------
# four GPUs: the mesh phases
# ---------------------------------------------------------------------------

def four(gs):
    from rri_nmf_tpu.parallel import make_mesh
    require('four devices', len(jax.devices()) == 4,
            '(%d)' % len(jax.devices()))
    mesh = make_mesh(4, mesh_shape=(4, 1))
    key = jax.random.PRNGKey(ARGS.seed)
    hi = dict(matmul_precision='highest', eps_stop=0.0, early_stop=False,
              dtype=jnp.float32)
    # three sweeps of Gauss-Seidel through Grams summed in another order
    # (psum over the mesh) amplify float32 rounding: 5.6e-5 on W measured
    # for the dense fit on four H100s
    tol = 1e-3

    n, d, k = S['four_dense']
    log('\n[m1] dense phase fit %dx%d k=%d on a (4, 1) mesh vs one device'
        % (n, d, k))
    X = lowrank_x(key, n, d, k)
    W0, T0 = start_factors(jax.random.fold_in(key, 1), n, d, k)
    kw = dict(update_order='phase', reset_topic_method=None, max_iter=3,
              W_in=np.asarray(W0), T_in=np.asarray(T0), **hi)
    a = nmf(X, k, **kw)
    b = nmf(X, k, mesh=mesh, **kw)
    check('mesh vs one device, W', rel_err(b['W'], a['W']), tol,
          "float32, 'highest'")
    check('mesh vs one device, T', rel_err(b['T'], a['T']), tol,
          "float32, 'highest'")

    n, d, k, n_ratings, _ = S['rs']
    log('\n[m2] Gram-phase masked WRRI %dx%d, %d ratings, k=%d on a (4, 1) '
        'mesh vs one device' % (n, d, n_ratings, k))
    I, J, R, _, _, _ = rs_data(jax.random.fold_in(key, 2), n, d, n_ratings,
                               1)
    Xc = sp.csr_matrix((R, (I, J)), shape=(n, d))
    Mc = sp.csr_matrix((np.ones_like(R), (I, J)), shape=(n, d))
    W0, T0 = start_factors(jax.random.fold_in(key, 3), n, d, k,
                           t_row_sum=1.0)
    kw = dict(W_mat=Mc, update_order='phase', reset_topic_method=None,
              t_row_sum=1.0, max_iter=3, W_in=np.asarray(W0),
              T_in=np.asarray(T0), **hi)
    a = nmf(Xc, k, **kw)
    b = nmf(Xc, k, mesh=mesh, **kw)
    # three sweeps through psum-ordered sums: the observed predictions of
    # ill-determined users moved by 2e-4 and 3e-3 in two runs on four
    # H100s (objective: 8e-7 and 5e-5)
    masked_compare(Xc, 'mesh vs one device', b['W'], b['T'], a['W'],
                   a['T'], I, J, 1e-2, "float32, 'highest'")

    n, d, k, density = S['sparse']
    log('\n[m3] sparse BCOO corpus %dx%d, k=%d on a (4, 1) mesh vs one '
        'device' % (n, d, k))
    Xc = sparse_corpus(jax.random.fold_in(key, 4), n, d, density)
    W0, T0 = start_factors(jax.random.fold_in(key, 5), n, d, k)
    kw = dict(sparse=True, update_order='phase', reset_topic_method=None,
              max_iter=3, W_in=np.asarray(W0), T_in=np.asarray(T0), **hi)
    a = nmf(Xc, k, **kw)
    b = nmf(Xc, k, mesh=mesh, **kw)
    check('mesh vs one device, W', rel_err(b['W'], a['W']), tol,
          "float32, 'highest'")
    check('mesh vs one device, T', rel_err(b['T'], a['T']), tol,
          "float32, 'highest'")


# ---------------------------------------------------------------------------

def card():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return 'nvidia-smi unavailable (%s)' % e


def main():
    dev = jax.devices()[0]
    if dev.platform != 'gpu' and not ARGS.rehearse:
        print('chip_smoke: no GPU (JAX backend %r); nothing was run'
              % dev.platform, file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    log(card() if not ARGS.rehearse else 'rehearsal on the CPU backend')
    log('jax %s, devices %s' % (jax.__version__, jax.devices()))
    log('compile cache: %s' % CACHE_DIR)
    gs = gs_impl(None) if not ARGS.rehearse else 'interpret'
    log('Gauss-Seidel route: %s' % gs)
    if ARGS.four:
        four(gs)
    else:
        key = jax.random.PRNGKey(ARGS.seed)
        X, _ = phase_dense(jax.random.fold_in(key, 1), gs)
        if not ARGS.no_timing:
            timing(gs)
        phase_int16(X)
        del X
        phase_tm(jax.random.fold_in(key, 2), gs)
        phase_rs(jax.random.fold_in(key, 3), gs)
        phase_sparse(jax.random.fold_in(key, 4), gs)
        if not ARGS.rehearse:
            run_gpu_tests()
    stats = dev.memory_stats() or {}
    log('\npeak_bytes_in_use %s; wall %.1f s' % (
        stats.get('peak_bytes_in_use', 'not reported'),
        time.perf_counter() - t_start))
    if ARGS.rehearse:
        log('rehearsal passed')
        return 0
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
