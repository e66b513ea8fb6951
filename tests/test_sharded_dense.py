"""Mesh-sharded dense phase sweep (parallel/sharded_dense.py).

Parity pins: the shard_map'd sweep (psum'd Grams/numerators + per-device
Gauss-Seidel loops — the Triton kernel in interpret mode and the XLA
loop — on the virtual CPU mesh) must reproduce the single-device dense
phase sweep and the XLA GSPMD mesh path exactly — the per-device topic
subproblems are bitwise the global ones (T columns / W rows are
independent within a phase)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rri_nmf_tpu.nmf import nmf
from rri_nmf_tpu.ops.dense_phase import (make_dense_phase_sweep,
                                         supports_dense_phase)
from rri_nmf_tpu.ops.sweep_xla import SweepConfig
from rri_nmf_tpu.parallel.mesh import make_mesh
from rri_nmf_tpu.parallel.sharded_dense import make_sharded_dense_sweep

GS = pytest.mark.parametrize('gs', ['interpret', 'xla'])


def _problem(n=100, d=80, k=6, seed=0):
    rng = np.random.RandomState(seed)
    return (np.abs(rng.rand(n, d)), np.abs(rng.rand(n, k)),
            np.abs(rng.rand(k, d)))


def _run(sweep, X, W, T):
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W1, T1, _, _ = sweep(jnp.asarray(X), jnp.asarray(W), jnp.asarray(T),
                         key, r, key)
    return np.array(W1), np.array(T1)


@GS
@pytest.mark.parametrize('mesh_shape', [(8, 1), (4, 2)])
def test_sharded_dense_matches_single_chip(mesh_shape, gs):
    X, W0, T0 = _problem()
    cfg = SweepConfig(k=6, reset_topic_method=None, update_order='phase',
                      reg_t_l2=0.02, reg_w_l1=0.01)
    assert supports_dense_phase(cfg)
    mesh = make_mesh(8, mesh_shape=mesh_shape)
    a = make_dense_phase_sweep(cfg, gs)
    b = make_sharded_dense_sweep(cfg, mesh, gs=gs)
    Wa, Ta = _run(a, X, W0, T0)
    Wb, Tb = _run(b, X, W0, T0)
    assert np.allclose(Wa, Wb, atol=1e-11)
    assert np.allclose(Ta, Tb, atol=1e-11)


@GS
def test_sharded_dense_inner_reps_parity(gs):
    X, W0, T0 = _problem(seed=1)
    cfg = SweepConfig(k=6, reset_topic_method=None, update_order='phase',
                      inner_reps=3)
    mesh = make_mesh(8, mesh_shape=(4, 2))
    a = make_dense_phase_sweep(cfg, gs)
    b = make_sharded_dense_sweep(cfg, mesh, gs=gs)
    Wa, Ta = _run(a, X, W0, T0)
    Wb, Tb = _run(b, X, W0, T0)
    assert np.allclose(Wa, Wb, atol=1e-11)
    assert np.allclose(Ta, Tb, atol=1e-11)


@GS
def test_sharded_dense_w_row_sum_vector(gs):
    """Per-row W bound vector: sharded over dp, padded rows inert."""
    X, W0, T0 = _problem(seed=2)
    ub = 0.5 + np.random.RandomState(3).rand(100)
    cfg = SweepConfig(k=6, reset_topic_method=None, update_order='phase',
                      w_row_sum=None, w_row_sum_is_vector=True,
                      project_W_each_iter=True)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    a = make_dense_phase_sweep(cfg, gs)
    b = make_sharded_dense_sweep(cfg, mesh, gs=gs)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Wa, Ta, _, _ = a(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                     key, r, key, jnp.asarray(ub))
    Wb, Tb, _, _ = b(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                     key, r, key, jnp.asarray(ub))
    assert np.allclose(np.array(Wa), np.array(Wb), atol=1e-11)
    assert np.allclose(np.array(Ta), np.array(Tb), atol=1e-11)


def test_driver_mesh_dense_pallas_parity():
    """nmf(mesh=..., use_pallas='interpret') on a dense phase-order config
    routes to the sharded dense phase sweep and matches both the
    single-device run and the XLA GSPMD mesh path."""
    X, _, _ = _problem(n=96, d=64, seed=4)
    kw = dict(k=5, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              compute_obj_each_iter=True, eps_stop=0)
    mesh = make_mesh(8, mesh_shape=(4, 2))
    single = nmf(X, use_pallas='interpret', **kw)
    sharded = nmf(X, mesh=mesh, use_pallas='interpret', **kw)
    gspmd = nmf(X, mesh=mesh, use_pallas=False, **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['T'], sharded['T'], atol=1e-11)
    assert np.allclose(sharded['obj_history'], gspmd['obj_history'],
                       atol=1e-9)


def test_driver_mesh_dense_pallas_tm_preset():
    """TM-style config (w_row_sum + per-iteration W projection) through
    the driver on the mesh."""
    X, _, _ = _problem(n=80, d=60, seed=5)
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              w_row_sum=1.0, project_W_each_iter=True, eps_stop=0)
    mesh = make_mesh(8, mesh_shape=(4, 2))
    single = nmf(X, use_pallas='interpret', **kw)
    sharded = nmf(X, mesh=mesh, use_pallas='interpret', **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['T'], sharded['T'], atol=1e-11)


@GS
@pytest.mark.parametrize('mesh_shape', [(8, 1), (2, 4)])
def test_sharded_tm_projection_matches_single_chip(mesh_shape, gs):
    """Per-topic T simplex projection on the mesh: the projected loop on
    tp-gathered whole rows must reproduce the single-device projected
    phase exactly (same projections on the same rows)."""
    X, W0, T0 = _problem(n=96, d=72, k=5, seed=6)
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0)
    mesh = make_mesh(8, mesh_shape=mesh_shape)
    a = make_dense_phase_sweep(cfg, gs)
    b = make_sharded_dense_sweep(cfg, mesh, gs=gs)
    Wa, Ta = _run(a, X, W0, T0)
    Wb, Tb = _run(b, X, W0, T0)
    assert np.allclose(Wa, Wb, atol=1e-11)
    assert np.allclose(Ta, Tb, atol=1e-11)
    assert np.allclose(Tb.sum(axis=1), 1.0, atol=1e-6)


def test_driver_mesh_tm_full_preset_projected():
    """The estimator's full TM preset (both simplex constraints) through
    the driver on the mesh routes to the sharded dense phase sweep and
    matches the single-device run AND the XLA GSPMD mesh path."""
    X, _, _ = _problem(n=64, d=48, seed=7)
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              project_T_each_iter=True, t_row_sum=1.0,
              w_row_sum=1.0, project_W_each_iter=True, eps_stop=0,
              inner_reps=2)
    mesh = make_mesh(8, mesh_shape=(2, 4))
    single = nmf(X, use_pallas='interpret', **kw)
    sharded = nmf(X, mesh=mesh, use_pallas='interpret', **kw)
    gspmd = nmf(X, mesh=mesh, use_pallas=False, **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-11)
    assert np.allclose(single['T'], sharded['T'], atol=1e-11)
    assert np.allclose(sharded['W'], gspmd['W'], atol=1e-6)
    assert np.allclose(sharded['T'], gspmd['T'], atol=1e-6)


@GS
def test_sharded_dense_negative_l1_padding_no_ghost_mass(gs):
    """Negative reg_t_l1 with d off the tp quantum: ghost T columns grown
    by the topic loop must be zeroed before the W-phase Gram — parity vs
    make_sweep."""
    from rri_nmf_tpu.ops.sweep_xla import make_sweep
    X, W0, T0 = _problem(n=61, d=51, k=4)   # pads to (64, 52) on (4, 2)
    cfg = SweepConfig(k=4, reset_topic_method=None, update_order='phase',
                      reg_t_l1=-0.05, reg_t_l2=0.5,
                      reg_w_l1=-0.02, reg_w_l2=0.5)
    mesh = make_mesh(8, mesh_shape=(4, 2))
    a = make_sweep(cfg)
    b = make_sharded_dense_sweep(cfg, mesh, gs=gs)
    Wa, Ta = _run(a, X, W0, T0)
    Wb, Tb = _run(b, X, W0, T0)
    assert np.allclose(Wa, Wb, atol=1e-10), np.abs(Wa - Wb).max()
    assert np.allclose(Ta, Tb, atol=1e-10)


@pytest.mark.parametrize('k,d', [(768, 6000), (5, 7)])
def test_sharded_tm_gate_budgets_gathered_width(k, d):
    """The sharded dense phase sweep covers the projected TM preset at any
    panel width: the projected T-phase is the XLA loop on gathered rows,
    with no on-chip panel budget to decline."""
    import dataclasses
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0)
    for shape in [(1, 8), (8, 1)]:
        mesh = make_mesh(8, mesh_shape=shape)
        assert supports_dense_phase(dataclasses.replace(cfg, mesh=mesh))
    if k * d < 1000:
        X, W0, T0 = _problem(n=24, d=d, k=k, seed=9)
        mesh = make_mesh(8, mesh_shape=(1, 8))
        a = make_dense_phase_sweep(cfg, 'xla')
        b = make_sharded_dense_sweep(cfg, mesh, gs='xla')
        Wa, Ta = _run(a, X, W0, T0)
        Wb, Tb = _run(b, X, W0, T0)
        assert np.allclose(Ta, Tb, atol=1e-11)
        assert np.allclose(Wa, Wb, atol=1e-11)
