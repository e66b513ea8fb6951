"""The dense phase sweep (``ops/dense_phase.py``: XLA GEMMs + the
Gauss-Seidel topic loop) vs the XLA Gram-blocked phase sweep
(``make_sweep``), with the loop as the Triton kernel in the Pallas
interpreter (f64 on the CPU) and as the XLA loop; plus the kernel on its
own against the XLA loop across k, tile padding, regularizers, bounds,
inner reps and 16-bit storage, the routing rules, and the kernel's
lowering for CUDA (which needs no card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rri_nmf_tpu.ops.dense_phase import (
    gs_kernel, gs_tile, gs_topics_blocked, make_dense_phase_sweep,
    supports_dense_phase,
)
from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep


def _problem(n, d, k, seed=0):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, W0, T0


def _run(sweep, X, W, T, iters=3, extras=()):
    key = jax.random.PRNGKey(0)
    resets = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W), jnp.asarray(T)
    for _ in range(iters):
        W, T, key, resets = sweep(jnp.asarray(X), W, T, key, resets, key,
                                  *extras)
    return np.array(W), np.array(T)


GS = pytest.mark.parametrize('gs', ['interpret', 'xla'])


@GS
@pytest.mark.parametrize('shape', [(40, 30, 3),     # heavy padding
                                   (300, 1100, 5),  # multi-block d
                                   (600, 130, 16)])  # multi-block n
def test_dense_pallas_matches_xla(shape, gs):
    n, d, k = shape
    X, W0, T0 = _problem(n, d, k)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase')
    assert supports_dense_phase(cfg)
    Wx, Tx = _run(make_sweep(cfg), X, W0, T0)
    Wp, Tp = _run(make_dense_phase_sweep(cfg, gs),
                  X, W0, T0)
    assert np.allclose(Tx, Tp, atol=1e-9), np.abs(Tx - Tp).max()
    assert np.allclose(Wx, Wp, atol=1e-9), np.abs(Wx - Wp).max()


@GS
def test_dense_pallas_regularized_and_negative_l1(gs):
    """Regularizers flow into the in-kernel subproblem; negative L1 grows
    padded columns, which must not leak into the W-phase Gram."""
    n, d, k = 70, 50, 4
    X, W0, T0 = _problem(n, d, k, seed=2)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      reg_t_l1=-0.05, reg_w_l2=0.1, t_row_sum=1.0)
    Wx, Tx = _run(make_sweep(cfg), X, W0, T0)
    Wp, Tp = _run(make_dense_phase_sweep(cfg, gs),
                  X, W0, T0)
    assert np.allclose(Tx, Tp, atol=1e-9)
    assert np.allclose(Wx, Wp, atol=1e-9)


@GS
def test_dense_pallas_dead_topic_vertex_branch(gs):
    """A dead warm-start topic exercises the concave (denom == 0) qf
    branch in-kernel; values must match the XLA lax.cond branch."""
    n, d, k = 50, 40, 4
    X, W0, T0 = _problem(n, d, k, seed=3)
    W0[:, 2] = 0.0
    T0[2] = 0.0
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      t_row_sum=1.0, w_row_sum=1.0)
    Wx, Tx = _run(make_sweep(cfg), X, W0, T0, iters=2)
    Wp, Tp = _run(make_dense_phase_sweep(cfg, gs),
                  X, W0, T0, iters=2)
    assert np.allclose(Tx, Tp, atol=1e-9)
    assert np.allclose(Wx, Wp, atol=1e-9)


@GS
def test_dense_pallas_fix_T_and_project_W(gs):
    """fix_T (transform path) runs only the W kernel; project_W_each_iter
    runs as the XLA tail."""
    n, d, k = 60, 45, 4
    X, W0, T0 = _problem(n, d, k, seed=4)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      fix_T=True, project_W_each_iter=True, w_row_sum=1.0)
    Wx, _ = _run(make_sweep(cfg), X, W0, T0)
    Wp, _ = _run(make_dense_phase_sweep(cfg, gs),
                 X, W0, T0)
    assert np.allclose(Wx, Wp, atol=1e-9)
    assert np.max(np.abs(Wp.sum(axis=1) - 1.0)) < 1e-12


@GS
def test_dense_pallas_vector_w_bound(gs):
    """Per-row W upper bounds (vector w_row_sum) stream into the W kernel."""
    n, d, k = 45, 35, 3
    X, W0, T0 = _problem(n, d, k, seed=5)
    wrs = np.abs(np.random.RandomState(6).rand(n)) + 0.5
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      w_row_sum_is_vector=True, project_W_each_iter=True)
    extras = (jnp.asarray(wrs),)
    Wx, Tx = _run(make_sweep(cfg), X, W0, T0, extras=extras)
    Wp, Tp = _run(make_dense_phase_sweep(cfg, gs),
                  X, W0, T0, extras=extras)
    assert np.allclose(Tx, Tp, atol=1e-9)
    assert np.allclose(Wx, Wp, atol=1e-9)


@pytest.mark.parametrize('shape', [(60, 40, 8),     # heavy padding
                                   (50, 1100, 5),   # d beyond one block
                                   (40, 37, 5)])
@GS
def test_tm_proj_kernel_matches_xla(shape, gs):
    """The dense phase sweep's projected T-phase (the XLA loop with
    per-topic Duchi projections, whatever ``gs`` says) equals the XLA
    phase sweep on the full TM preset (project_T_each_iter + t_row_sum +
    w_row_sum)."""
    n, d, k = shape
    X, W0, T0 = _problem(n, d, k, seed=8)
    T0 = T0 / T0.sum(axis=1, keepdims=True)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0, project_W_each_iter=True)
    assert supports_dense_phase(cfg)
    Wx, Tx = _run(make_sweep(cfg), X, W0, T0)
    Wp, Tp = _run(make_dense_phase_sweep(cfg, gs),
                  X, W0, T0)
    assert np.allclose(Tx, Tp, atol=1e-11), np.abs(Tx - Tp).max()
    assert np.allclose(Wx, Wp, atol=1e-11), np.abs(Wx - Wp).max()
    assert np.max(np.abs(Tp.sum(axis=1) - 1.0)) < 1e-12


@GS
def test_tm_proj_kernel_mass_spreading_respects_padding(gs):
    """When the numerator row is mostly non-positive the projection must
    SPREAD mass (negative threshold) over the real columns."""
    n, d, k = 50, 30, 4
    X, W0, T0 = _problem(n, d, k, seed=9)
    X = 1e-3 * X          # tiny data + large L1 => mostly-negative numer
    T0 = T0 / T0.sum(axis=1, keepdims=True)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0,
                      reg_t_l1=0.5)
    Wx, Tx = _run(make_sweep(cfg), X, W0, T0, iters=2)
    Wp, Tp = _run(make_dense_phase_sweep(cfg, gs),
                  X, W0, T0, iters=2)
    assert np.allclose(Tx, Tp, atol=1e-11), np.abs(Tx - Tp).max()
    assert np.allclose(Wx, Wp, atol=1e-11)
    # mass stayed on the d real columns
    assert np.max(np.abs(Tp.sum(axis=1) - 1.0)) < 1e-12


@GS
def test_tm_proj_kernel_dead_topic_vertex_branch(gs):
    """denom == 0 (dead W column, no L2) takes the concave vertex branch:
    all mass on the first least-cost coordinate, same as the XLA path."""
    n, d, k = 50, 40, 4
    X, W0, T0 = _problem(n, d, k, seed=10)
    W0[:, 1] = 0.0
    T0 = T0 / T0.sum(axis=1, keepdims=True)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0)
    Wx, Tx = _run(make_sweep(cfg), X, W0, T0, iters=2)
    Wp, Tp = _run(make_dense_phase_sweep(cfg, gs),
                  X, W0, T0, iters=2)
    assert np.allclose(Tx, Tp, atol=1e-11)
    assert np.allclose(Wx, Wp, atol=1e-11)


@GS
def test_tm_proj_kernel_inner_reps(gs):
    """inner_reps > 1 re-runs the projected topic loop; each pass is
    exact cyclic BCD, matching the XLA blocked path."""
    n, d, k = 60, 45, 6
    X, W0, T0 = _problem(n, d, k, seed=11)
    T0 = T0 / T0.sum(axis=1, keepdims=True)
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0,
                      inner_reps=3)
    Wx, Tx = _run(make_sweep(cfg), X, W0, T0, iters=2)
    Wp, Tp = _run(make_dense_phase_sweep(cfg, gs),
                  X, W0, T0, iters=2)
    assert np.allclose(Tx, Tp, atol=1e-11)
    assert np.allclose(Wx, Wp, atol=1e-11)


def test_tm_preset_driver_monotone():
    """End-to-end nmf() on the TM preset through the dense phase sweep
    (kernel W-phase, projected XLA T-phase) stays monotone and matches
    the XLA path."""
    from rri_nmf_tpu.nmf import nmf
    X, _, _ = _problem(70, 50, 5, seed=12)
    kw = dict(k=5, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase', project_T_each_iter=True,
              t_row_sum=1.0, w_row_sum=1.0)
    pa = nmf(X, use_pallas='interpret', **kw)
    xl = nmf(X, use_pallas=False, **kw)
    assert np.all(np.diff(pa['obj_history']) <= 1e-12)
    assert np.allclose(pa['W'], xl['W'], atol=1e-9)
    assert np.allclose(pa['T'], xl['T'], atol=1e-9)


def test_dense_pallas_driver_auto_monotone():
    """End-to-end: the nmf() driver on the dense phase sweep with the
    kernel (forced via use_pallas='interpret') keeps the objective
    monotone and matches the XLA path."""
    from rri_nmf_tpu.nmf import nmf
    X, _, _ = _problem(80, 60, 5, seed=7)
    kw = dict(k=5, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase')
    pa = nmf(X, use_pallas='interpret', **kw)
    xl = nmf(X, use_pallas=False, **kw)
    assert np.all(np.diff(pa['obj_history']) <= 0)
    assert np.allclose(pa['W'], xl['W'], atol=1e-9)
    assert np.allclose(pa['T'], xl['T'], atol=1e-9)


# ---------------------------------------------------------------------------
# the kernel on its own
# ---------------------------------------------------------------------------

def _gs_inputs(k, m, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    A = rng.rand(3 * k, k)
    G = A.T @ A / (3 * k)
    N = rng.rand(k, m) - 0.2
    F = rng.rand(k, m)
    return jnp.asarray(N), jnp.asarray(F, dtype), jnp.asarray(G)


def _gs_xla(N, F, G, reg_l1=0.0, reg_l2=0.0, ub=None, reps=1):
    k = F.shape[0]
    acc = jnp.promote_types(F.dtype, jnp.float32)
    return gs_topics_blocked(
        N.astype(acc), F, G.astype(acc), k=k, B=1, reg_l1=reg_l1,
        reg_l2=reg_l2, qf_s=None, qf_ub=ub, reproject_sum=None, acc=acc,
        dtype=F.dtype, reps=reps)


@pytest.mark.parametrize('k,m', [(1, 5), (3, 17), (16, 64), (20, 130),
                                 (33, 300), (128, 40)])
def test_gs_kernel_matches_xla_loop(k, m):
    """k and m off every power of two: topic and column padding."""
    N, F, G = _gs_inputs(k, m, seed=k)
    got = gs_kernel(N, F, G, reg_l1=0.0, reg_l2=0.0, bound=float('inf'),
                    interpret=True)
    assert got.shape == (k, m)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(_gs_xla(N, F, G)), atol=1e-12)


@pytest.mark.parametrize('reg_l1,reg_l2,bound', [
    (0.05, 0.0, float('inf')), (-0.05, 0.2, float('inf')),
    (0.0, 0.3, 0.5), (0.1, 0.1, 2.0)])
def test_gs_kernel_regularizers_and_bound(reg_l1, reg_l2, bound):
    N, F, G = _gs_inputs(12, 50, seed=3)
    got = gs_kernel(N, F, G, reg_l1=reg_l1, reg_l2=reg_l2, bound=bound,
                    interpret=True)
    ref = _gs_xla(N, F, G, reg_l1, reg_l2,
                  None if bound == float('inf') else bound)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-12)


def test_gs_kernel_concave_branch_takes_bound():
    """A zero Gram diagonal (dead topic) with negative numerators takes
    the concave branch: the bound where denom - numer < 0, else 0."""
    N, F, G = _gs_inputs(6, 40, seed=4)
    G = G.at[2, :].set(0.0).at[:, 2].set(0.0)
    got = gs_kernel(N, F, G, reg_l1=-0.5, reg_l2=0.0, bound=3.0,
                    interpret=True)
    ref = _gs_xla(N, F, G, -0.5, 0.0, 3.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-12)
    assert np.all(np.asarray(got)[2] == 3.0)


def test_gs_kernel_vector_bound():
    N, F, G = _gs_inputs(5, 70, seed=5)
    G = G.at[1, :].set(0.0).at[:, 1].set(0.0)
    ub = jnp.asarray(np.random.RandomState(6).rand(70) + 0.5)
    got = gs_kernel(N, F, G, reg_l1=-0.2, reg_l2=0.0, bound=float('inf'),
                    ub=ub, interpret=True)
    ref = _gs_xla(N, F, G, -0.2, 0.0, ub)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-12)


@pytest.mark.parametrize('reps', [2, 3])
def test_gs_kernel_inner_reps(reps):
    N, F, G = _gs_inputs(9, 45, seed=7)
    got = gs_kernel(N, F, G, reg_l1=0.0, reg_l2=0.0, bound=float('inf'),
                    reps=reps, interpret=True)
    ref = _gs_xla(N, F, G, reps=reps)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-12)


@pytest.mark.parametrize('dtype', [jnp.bfloat16, jnp.float16])
def test_gs_kernel_16bit_storage(dtype):
    """16-bit factor storage: the loop runs in f32 and stores the narrow
    dtype once; within 16-bit rounding of the f64 loop."""
    N, F, G = _gs_inputs(8, 64, seed=8)
    F16 = F.astype(dtype)
    got = gs_kernel(N, F16, G, reg_l1=0.0, reg_l2=0.0,
                    bound=float('inf'), interpret=True)
    assert got.dtype == dtype
    ref = np.asarray(_gs_xla(N, F16.astype(jnp.float64), G))
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize('k', [4, 50, 128, 256])
def test_gs_kernel_lowers_for_cuda(k):
    """The kernel lowers to Triton IR for CUDA at f32 (what the GPU
    compiles) — checked without a card through cross-platform
    lowering."""
    N, F, G = _gs_inputs(k, 300, seed=9, dtype=np.float32)
    N, G = N.astype(jnp.float32), G.astype(jnp.float32)
    ub = jnp.ones((300,), jnp.float32)
    for kw in (dict(), dict(ub=ub, reps=2)):
        low = jax.jit(lambda N, F, G: gs_kernel(
            N, F, G, reg_l1=0.01, reg_l2=0.0, bound=1.0, **kw)).trace(
            N, F, G).lower(lowering_platforms=('cuda',))
        assert 'triton' in low.as_text()


# ---------------------------------------------------------------------------
# routing (ops/capability.py)
# ---------------------------------------------------------------------------

def test_gs_impl_routing_on_cpu(monkeypatch):
    """Auto picks the kernel only on a GPU; the CPU runs the XLA loop and
    never interpret mode; an explicit 'interpret' works; True without a
    GPU is an error, not a silent fallback."""
    from rri_nmf_tpu.ops import capability
    assert capability.gs_impl(None) == 'xla'
    assert capability.gs_impl(False) == 'xla'
    assert capability.gs_impl('interpret') == 'interpret'
    with pytest.raises(ValueError, match='needs a GPU'):
        capability.gs_impl(True)
    with pytest.raises(ValueError):
        capability.gs_impl('triton')
    monkeypatch.setattr(capability, 'on_gpu', lambda: True)
    assert capability.gs_impl(None) == 'triton'
    assert capability.gs_impl(True) == 'triton'
    assert capability.gs_impl('interpret') == 'interpret'


def test_driver_routes_by_gs_impl(monkeypatch):
    """nmf() builds the dense phase sweep with the kernel exactly when
    gs_impl says so, and make_sweep otherwise."""
    from rri_nmf_tpu import nmf as nmf_mod
    from rri_nmf_tpu.ops import capability, dense_phase
    seen = []
    real = dense_phase.make_dense_phase_sweep

    def spy(cfg, gs='xla'):
        seen.append(gs)
        return real(cfg, 'xla')

    monkeypatch.setattr(dense_phase, 'make_dense_phase_sweep', spy)
    X, _, _ = _problem(30, 20, 3, seed=1)
    kw = dict(k=3, max_iter=2, random_state=0, reset_topic_method=None,
              update_order='phase')
    nmf_mod.nmf(X, **kw)
    assert seen == []                      # CPU auto: make_sweep
    monkeypatch.setattr(capability, 'on_gpu', lambda: True)
    nmf_mod.nmf(X, **kw)
    assert seen == ['triton']              # GPU auto: the kernel
    nmf_mod.nmf(X, use_pallas=False, **kw)
    assert seen == ['triton']


def test_int16_routes_on_cpu_without_interpret(monkeypatch):
    """int16 X storage runs the dense phase sweep with the XLA loop on the
    CPU (never the interpreter)."""
    from rri_nmf_tpu import nmf as nmf_mod
    from rri_nmf_tpu.ops import dense_phase
    seen = []
    real = dense_phase.make_dense_phase_sweep

    def spy(cfg, gs='xla'):
        seen.append(gs)
        return real(cfg, gs)

    monkeypatch.setattr(dense_phase, 'make_dense_phase_sweep', spy)
    X, _, _ = _problem(40, 30, 3, seed=2)
    out = nmf_mod.nmf(X, 3, x_dtype='int16', max_iter=2, random_state=0,
                      reset_topic_method=None, update_order='phase')
    assert seen == ['xla']
    assert np.all(np.isfinite(out['W']))


# ---------------------------------------------------------------------------
# on the card (``gpu`` marker; ``chip_smoke.py`` runs these there)
# ---------------------------------------------------------------------------

def _gs_inputs_f32(k, m, seed):
    """Float32 inputs with a diagonally dominant Gram, so the comparison
    measures the two loops' rounding rather than the conditioning."""
    N, F, G = _gs_inputs(k, m, seed=seed, dtype=np.float32)
    G = G + 0.5 * jnp.eye(k)
    return N.astype(jnp.float32), F, G.astype(jnp.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.gpu
@pytest.mark.parametrize('k,m', [(4, 300), (50, 1000), (128, 8192),
                                 (256, 4096)])
def test_gs_kernel_compiled_matches_xla_loop(gpu, k, m):
    """The kernel as Triton compiles it against the XLA loop, float32 at
    'highest': the two differ only in summation order (1e-5 relative)."""
    N, F, G = _gs_inputs_f32(k, m, seed=k)
    with jax.default_matmul_precision('highest'):
        got = gs_kernel(N, F, G, reg_l1=0.01, reg_l2=0.0, bound=1.0)
        ref = _gs_xla(N, F, G, 0.01, 0.0, 1.0)
    assert got.shape == (k, m)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.gpu
def test_gs_kernel_compiled_vector_bound_reps_and_bf16(gpu):
    N, F, G = _gs_inputs_f32(20, 700, seed=3)
    ub = jnp.asarray(np.random.RandomState(4).rand(700) + 0.5, jnp.float32)
    with jax.default_matmul_precision('highest'):
        got = gs_kernel(N, F, G, reg_l1=-0.1, reg_l2=0.2,
                        bound=float('inf'), ub=ub, reps=2)
        ref = _gs_xla(N, F, G, -0.1, 0.2, ub, reps=2)
        assert _rel(got, ref) <= 1e-5
        Fb = F.astype(jnp.bfloat16)
        got = gs_kernel(N, Fb, G, reg_l1=0.0, reg_l2=0.0,
                        bound=float('inf'))
        ref = _gs_xla(N, Fb, G)
    assert got.dtype == jnp.bfloat16
    assert _rel(got, ref) <= 1e-2        # one bf16 rounding of the store


@pytest.mark.gpu
def test_nmf_auto_runs_kernel_on_gpu(gpu):
    """On a GPU the default nmf() phase fit takes the kernel, and agrees
    with the XLA loop at 'highest'."""
    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.ops import capability
    assert capability.gs_impl(None) == 'triton'
    X, W0, T0 = _problem(300, 200, 8, seed=5)
    kw = dict(k=8, max_iter=4, W_in=W0, T_in=T0, reset_topic_method=None,
              update_order='phase', dtype=jnp.float32,
              matmul_precision='highest', early_stop=False)
    a = nmf(X.astype(np.float32), **kw)
    b = nmf(X.astype(np.float32), use_pallas=False, **kw)
    assert _rel(a['W'], b['W']) <= 1e-4
    assert _rel(a['T'], b['T']) <= 1e-4


def test_sparse_auto_densifies_only_on_gpu(monkeypatch, caplog):
    """sparse='auto' densifies a corpus on the device only where the
    capability module reports a GPU; the CPU keeps it BCOO."""
    import logging

    import scipy.sparse as sp

    from rri_nmf_tpu import nmf as nmf_mod
    from rri_nmf_tpu.ops import capability
    X, _, _ = _problem(40, 30, 3, seed=3)
    Xs = sp.csr_matrix(np.where(np.random.RandomState(0).rand(40, 30)
                                < 0.3, X, 0.0))
    kw = dict(max_iter=2, random_state=0, reset_topic_method=None,
              update_order='phase', use_pallas=False)
    with caplog.at_level(logging.INFO, logger='rri_nmf_tpu'):
        a = nmf_mod.nmf(Xs, 3, **kw)
        assert 'densifying on device' not in caplog.text
        monkeypatch.setattr(capability, 'on_gpu', lambda: True)
        b = nmf_mod.nmf(Xs, 3, **kw)
        assert 'densifying on device' in caplog.text
    np.testing.assert_allclose(a['W'], b['W'], atol=1e-9)
