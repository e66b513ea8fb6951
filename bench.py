"""Benchmark: dense RRI sweep throughput on one chip vs the NumPy reference.

Prints ONE JSON line::

    {"metric": "rri_sweep_gflops_per_chip", "value": <GFLOP/s>,
     "unit": "GFLOP/s", "vs_baseline": <speedup over NumPy reference>}

Metric definition (BASELINE.md): RRI sweep GFLOP/s/chip. One unweighted
Gauss-Seidel sweep over all k topics costs ~4ndk FLOPs (the reference's cost
model, SURVEY.md §3.1: per topic two O(nd) contractions for the T-row and
W-column updates, plus O(nk + kd) corrections).

``vs_baseline`` is wall-clock speedup over a faithful NumPy/BLAS
implementation of the reference's per-topic update loop
(reference ``nmf.py:415-478,633-747``) running the same math on this host —
the reference publishes no numbers of its own (BASELINE.md), so its own
implementation is the baseline to beat.

Measurement notes: problem data is drawn on the device; each timed
call ends in ``block_until_ready``; the reported time is the median of
five repeats of one compiled program. The script refuses to run without
a GPU (exit code 1): a CPU number is never reported as a device rate.

Run: ``python bench.py`` (one GPU). The compile cache lives where
``JAX_COMPILATION_CACHE_DIR`` says, else in ``.cache/jax_compile``.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

EPS = float(np.spacing(10))


def numpy_reference_sweep(X, W, T):
    """One unweighted RRI sweep exactly as the reference computes it
    (per-topic GEMVs, Gauss-Seidel, scale transfer; no projections/regs)."""
    k = W.shape[1]
    for t in range(k):
        w = W[:, t]
        wX = w @ X
        wW = w @ W
        wW[t] = 0.0
        wR = wX - wW @ T
        nw = w @ w
        t_new = np.maximum(wR, 0.0) / (nw + EPS)
        W[:, t] *= t_new.sum()          # scale-invariance transfer
        T[t, :] = t_new
        trow = T[t, :]
        Xt = X @ trow
        Tt = T @ trow
        Tt[t] = 0.0
        Rt = Xt - W @ Tt
        nt = trow @ trow
        W[:, t] = np.maximum(Rt, 0.0) / (nt + EPS)
    return W, T


def bench_jax(n, d, k, n_timed=40, update_order='interleaved',
              kernel='xla', trace_dir=None):
    """Seconds per sweep: ``n_timed`` sweeps as one jitted fori_loop, the
    median of five timed calls after a warm-up call.

    ``kernel='triton'`` times the dense phase sweep with the Triton
    Gauss-Seidel kernel (``ops/dense_phase.py``) instead of the XLA
    Gram-blocked sweep.
    """
    import jax
    import jax.numpy as jnp

    from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep

    cfg = SweepConfig(k=k, reset_topic_method=None,
                      update_order=update_order)
    if kernel == 'triton':
        from rri_nmf_tpu.ops.dense_phase import make_dense_phase_sweep
        sweep = make_dense_phase_sweep(cfg, 'triton')
    else:
        sweep = make_sweep(cfg)
    reset_key = jax.random.PRNGKey(0)

    @jax.jit
    def run_n(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        X = jax.random.uniform(k1, (n, d), jnp.float32)
        W = jax.random.uniform(k2, (n, k), jnp.float32)
        T = jax.random.uniform(k3, (k, d), jnp.float32)
        resets = jnp.asarray(0, dtype=jnp.int32)

        def body(i, carry):
            W, T, key, resets = carry
            return sweep(X, W, T, key, resets, reset_key)

        W, T, k4, resets = jax.lax.fori_loop(0, n_timed, body,
                                             (W, T, k4, resets))
        return jnp.sum(W) + jnp.sum(T)

    sync = jax.block_until_ready(run_n(jax.random.PRNGKey(0)))  # compile
    assert np.isfinite(float(sync))
    if trace_dir:
        from rri_nmf_tpu.utils.profiling import TraceAnnotation, trace
        ctx = trace(trace_dir)
    else:
        ctx = contextlib.nullcontext()
    dts = []
    with ctx:
        if trace_dir:
            ann = TraceAnnotation('timed_%s_%s_sweeps' %
                                  (update_order, kernel))
            ann.__enter__()
        for rep in range(5):
            t0 = time.perf_counter()
            sync = jax.block_until_ready(run_n(jax.random.PRNGKey(1 + rep)))
            dts.append((time.perf_counter() - t0) / n_timed)
            assert np.isfinite(float(sync))
        if trace_dir:
            ann.__exit__(None, None, None)
    return float(np.median(dts))


def bench_numpy(n, d, k, n_timed=2):
    rng = np.random.RandomState(0)
    X = rng.rand(n, d).astype(np.float32)
    W0 = rng.rand(n, k).astype(np.float32)
    T0 = rng.rand(k, d).astype(np.float32)
    W, T = W0.copy(), T0.copy()
    numpy_reference_sweep(X, W, T)  # warmup (BLAS thread spin-up)
    W, T = W0.copy(), T0.copy()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        W, T = numpy_reference_sweep(X, W, T)
    return (time.perf_counter() - t0) / n_timed


def baseline_seconds(n, d, k, nb, reps=3):
    """NumPy baseline seconds per sweep at ``n`` rows: the median of
    ``reps`` sweeps at ``nb`` rows, scaled by ``n / nb`` (the sweep is
    linear in n)."""
    return float(np.median([bench_numpy(nb, d, k) for _ in range(reps)])
                 ) * (n / nb)


def card():
    """The GPU's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return 'nvidia-smi unavailable (%s)' % e


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--trace', default=None, metavar='LOGDIR',
                    help='capture a jax.profiler trace of the timed sweeps '
                         '(TensorBoard/Perfetto-loadable)')
    args = ap.parse_args()

    import jax
    jax.config.update('jax_compilation_cache_dir', os.environ.get(
        'JAX_COMPILATION_CACHE_DIR') or str(
            Path(__file__).resolve().parent / '.cache' / 'jax_compile'))
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print('bench.py: no GPU (JAX backend %r); nothing was measured'
              % dev.platform, file=sys.stderr)
        sys.exit(1)

    # phase update order: every update is still an exact rank-one
    # coordinate minimization with monotone descent (ops/sweep_xla.py,
    # tests/test_phase_order.py). Both implementations are timed and the
    # faster is reported: the XLA Gram-blocked sweep and the dense phase
    # sweep with the Triton Gauss-Seidel kernel (ops/dense_phase.py).
    n, d, k = 16384, 8192, 128
    dt_xla = bench_jax(n, d, k, update_order='phase', trace_dir=args.trace)
    dt_gs = bench_jax(n, d, k, update_order='phase', kernel='triton',
                      trace_dir=args.trace)
    jax_dt = min(dt_xla, dt_gs)
    kernel_used = 'triton' if dt_gs < dt_xla else 'xla'
    jax_dt_ref_order = bench_jax(n, d, k, n_timed=8,
                                 update_order='interleaved')

    flops = 4.0 * n * d * k

    # NumPy baseline: same math on this host (the reference's interleaved
    # order). Cap the row count to keep the baseline run short; sweep cost
    # is linear in n (two O(nd) GEMVs per topic dominate), so extrapolate —
    # this favors the baseline if anything (smaller problems are more
    # cache-friendly).
    nb = min(n, 4096)
    np_dt = baseline_seconds(n, d, k, nb)

    print(json.dumps({
        'metric': 'rri_sweep_gflops_per_chip',
        'value': round(flops / jax_dt / 1e9, 2),
        'unit': 'GFLOP/s',
        'vs_baseline': round(np_dt / jax_dt, 2),
        'config': '%dx%d k=%d f32' % (n, d, k),
        'matmul_precision': 'default (TF32 on the GPU)',
        'card': card(),
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
        'kernel': kernel_used,
        'update_order': 'phase (exact BCD, monotone; sklearn-CD ordering)',
        'gflops_reference_interleaved_order': round(
            flops / jax_dt_ref_order / 1e9, 2),
        'vs_baseline_reference_order': round(np_dt / jax_dt_ref_order, 2),
    }))


if __name__ == '__main__':
    main()
