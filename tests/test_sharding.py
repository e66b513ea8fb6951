"""GSPMD sharding tests on the 8-virtual-device CPU mesh (SURVEY.md §4:
"multi-chip tests (GSPMD sharded vs single-chip bitwise/tolerance parity)
runnable on CPU via device mesh emulation")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep
from rri_nmf_tpu.parallel import (
    make_mesh, make_sharded_training_step, shard_problem,
)


def _problem(n=64, d=32, k=6, seed=0):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, d))
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, W0, T0


requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason='needs 8 virtual devices')


@requires_8_devices
def test_sharded_equals_single_device_tm():
    """Sharded (4x2 dp,tp) sweep+objective == single-device to ~1e-12."""
    X, W0, T0 = _problem()
    cfg = SweepConfig(k=6, project_T_each_iter=True,
                      project_W_each_iter=True,
                      t_row_sum=1.0, w_row_sum=1.0)
    mesh = make_mesh(8)
    step = make_sharded_training_step(cfg, mesh)
    Xs, Ws, Ts = shard_problem(mesh, X, W0, T0)
    key = jax.random.PRNGKey(0)
    rk = jax.random.PRNGKey(0)
    resets = jnp.asarray(23, jnp.int32)

    W1, T1, key1, r1, obj1 = step(Xs, Ws, Ts, key, resets, rk)
    W2, T2, _, _, obj2 = step(Xs, W1, T1, key1, r1, rk)
    assert float(obj2) <= float(obj1)

    sweep = make_sweep(cfg)
    Wd, Td, kd, rd = sweep(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                           key, resets, rk)
    Wd2, Td2, _, _ = sweep(jnp.asarray(X), Wd, Td, kd, rd, rk)
    assert np.allclose(np.array(W2), np.array(Wd2), atol=1e-12)
    assert np.allclose(np.array(T2), np.array(Td2), atol=1e-12)


@requires_8_devices
def test_sharded_equals_single_device_masked():
    """Masked WRRI sweep parity under sharding (mask shards like X)."""
    X, W0, T0 = _problem(seed=3)
    M = (np.random.RandomState(1).rand(*X.shape) < 0.5).astype(float)
    cfg = SweepConfig(k=6, masked=True, reset_topic_method=None,
                      t_row_sum=1.0)
    mesh = make_mesh(8)
    step = make_sharded_training_step(cfg, mesh)
    Xs, Ws, Ts, Ms = shard_problem(mesh, X, W0, T0, W_mat=M)
    key = jax.random.PRNGKey(0)
    rk = jax.random.PRNGKey(0)
    resets = jnp.asarray(23, jnp.int32)
    W1, T1, _, _, obj1 = step(Xs, Ws, Ts, key, resets, rk, Ms)

    sweep = make_sweep(cfg)
    Wd, Td, _, _ = sweep(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                         key, resets, rk, jnp.asarray(M))
    assert np.allclose(np.array(W1), np.array(Wd), atol=1e-11)
    assert np.allclose(np.array(T1), np.array(Td), atol=1e-11)


@requires_8_devices
def test_row_only_mesh():
    """Pure dp sharding (tp=1): the common topic-modeling layout (n >> d)."""
    X, W0, T0 = _problem(n=80)
    cfg = SweepConfig(k=6, reset_topic_method=None)
    mesh = make_mesh(8, mesh_shape=(8, 1))
    step = make_sharded_training_step(cfg, mesh)
    Xs, Ws, Ts = shard_problem(mesh, X, W0, T0)
    key = jax.random.PRNGKey(0)
    W1, T1, _, _, obj = step(Xs, Ws, Ts, key, jnp.asarray(0, jnp.int32), key)
    assert np.isfinite(float(obj))
    sweep = make_sweep(cfg)
    Wd, Td, _, _ = sweep(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0),
                         key, jnp.asarray(0, jnp.int32), key)
    assert np.allclose(np.array(W1), np.array(Wd), atol=1e-12)


def _gspmd_masked_sweep(cfg, mesh):
    """The masked XLA sweep under GSPMD: inputs placed on the canonical
    mesh layouts (parallel.mesh.problem_shardings), XLA partitions the
    program and inserts the collectives."""
    from rri_nmf_tpu.parallel.mesh import problem_shardings
    s_X, s_W, s_T, s_M = problem_shardings(mesh, masked=True)
    sweep = make_sweep(cfg)

    def run(X, W, T, key, r, rk, M):
        return sweep(jax.device_put(X, s_X), jax.device_put(W, s_W),
                     jax.device_put(T, s_T), key, r, rk,
                     jax.device_put(M, s_M))
    return run


@requires_8_devices
def test_sharded_pallas_masked_sweep():
    """GSPMD masked sweep on the (4, 2) mesh == single-device XLA sweep."""
    n, d, k = 96, 72, 4
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < 0.5).astype(float)
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    cfg = SweepConfig(k=k, masked=True, reset_topic_method=None,
                      t_row_sum=1.0)
    sharded = _gspmd_masked_sweep(cfg, make_mesh(8))
    single = make_sweep(cfg)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Ws, Ts = jnp.asarray(W0), jnp.asarray(T0)
    Wd, Td = jnp.asarray(W0), jnp.asarray(T0)
    for _ in range(3):
        Ws, Ts, _, _ = sharded(jnp.asarray(X), Ws, Ts, key, r, key,
                               jnp.asarray(M))
        Wd, Td, _, _ = single(jnp.asarray(X), Wd, Td, key, r, key,
                              jnp.asarray(M))
    assert np.allclose(np.array(Ws), np.array(Wd), atol=1e-9)
    assert np.allclose(np.array(Ts), np.array(Td), atol=1e-9)


@requires_8_devices
def test_sharded_pallas_fix_t_masked_inference():
    """The fix_T masked sweep — the RS transform preset minus its resets
    — under GSPMD matches the single-device XLA sweep (reference
    sklearn_interface.py:144-156)."""
    n, d, k = 96, 72, 4
    rng = np.random.RandomState(3)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < 0.5).astype(float)
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    T0 /= T0.sum(axis=1, keepdims=True)
    cfg = SweepConfig(k=k, masked=True, fix_T=True,
                      reset_topic_method=None, t_row_sum=1.0,
                      w_row_sum=2.0)
    sharded = _gspmd_masked_sweep(cfg, make_mesh(8))
    single = make_sweep(cfg)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Ws = Wd = jnp.asarray(W0)
    Ts = Td = jnp.asarray(T0)
    for _ in range(3):
        Ws, Ts, _, _ = sharded(jnp.asarray(X), Ws, Ts, key, r, key,
                               jnp.asarray(M))
        Wd, Td, _, _ = single(jnp.asarray(X), Wd, Td, key, r, key,
                              jnp.asarray(M))
    np.testing.assert_allclose(np.array(Ts), np.array(Td), atol=1e-12)
    np.testing.assert_allclose(np.array(Ws), np.array(Wd), atol=1e-9)


@requires_8_devices
def test_nmf_driver_mesh_fix_t_transform():
    """Driver-level: the masked fix_T transform on a mesh rides the
    W-only sharded kernel and matches the single-device result."""
    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import make_mesh
    rng = np.random.RandomState(4)
    X = np.abs(rng.rand(80, 3) @ rng.rand(3, 60) + 0.01 * rng.rand(80, 60))
    M = (rng.rand(80, 60) < 0.5).astype(float)
    T_in = np.abs(rng.rand(3, 60))
    T_in /= T_in.sum(axis=1, keepdims=True)
    kw = dict(k=3, W_mat=M, T_in=T_in, fix_T=True, max_iter=4,
              random_state=0, early_stop=False, reset_topic_method=None,
              t_row_sum=1.0)
    a = nmf(X, **kw)
    b = nmf(X, mesh=make_mesh(8), use_pallas='interpret', **kw)
    assert np.allclose(a['W'], b['W'], atol=1e-9)
    np.testing.assert_array_equal(np.asarray(a['T']), np.asarray(b['T']))


@requires_8_devices
def test_nmf_driver_mesh_pallas_masked():
    """nmf(mesh=..., use_pallas=...) routes masked fits through the
    shard_map'd fused kernels and matches the XLA path."""
    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import make_mesh
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(80, 3) @ rng.rand(3, 60) + 0.01 * rng.rand(80, 60))
    M = (rng.rand(80, 60) < 0.5).astype(float)
    kw = dict(k=3, W_mat=M, max_iter=5, random_state=0, early_stop=False,
              reset_topic_method=None, t_row_sum=1.0)
    a = nmf(X, **kw)
    b = nmf(X, mesh=make_mesh(8), use_pallas='interpret', **kw)
    c = nmf(X, mesh=make_mesh(8), use_pallas='interpret',
            sweeps_per_dispatch=2, **kw)
    assert np.allclose(a['W'], b['W'], atol=1e-9)
    assert np.allclose(b['W'], c['W'], atol=1e-12)


@requires_8_devices
def test_nmf_driver_mesh_param():
    """The top-level nmf(mesh=...) runs the whole fit sharded and matches
    the single-device fit to 1e-12."""
    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import make_mesh
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(64, 3) @ rng.rand(3, 40) + 0.01 * rng.rand(64, 40))
    kw = dict(k=3, max_iter=5, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              project_T_each_iter=True, project_W_each_iter=True,
              t_row_sum=1.0, w_row_sum=1.0)
    single = nmf(X, **kw)
    sharded = nmf(X, mesh=make_mesh(8), **kw)
    assert np.allclose(single['W'], sharded['W'], atol=1e-12)
    assert np.allclose(single['T'], sharded['T'], atol=1e-12)
    assert np.allclose(single['obj_history'], sharded['obj_history'])


@requires_8_devices
def test_driver_dryrun_entrypoints():
    """The driver-facing entry points execute."""
    import sys
    sys.path.insert(0, '/root/repo')
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)
    fn, args = __graft_entry__.entry()
    out = fn(*args)
    assert np.all(np.isfinite(np.array(out[0])))


def test_sharded_resets_match_single_device():
    """Topic resets under a mesh run as a shard_map (per-device blockwise
    argmax + scalar all_gathers — no n×d temp, no gathers) and must match
    the single-device blockwise reset exactly (VERDICT r1 item 5; reference
    semantics nmf.py:770-776)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import make_mesh

    rng = np.random.RandomState(0)
    k = 4
    X = np.abs(rng.rand(64, k) @ rng.rand(k, 40))
    W0 = np.abs(rng.rand(64, k))
    T0 = np.abs(rng.rand(k, 40))
    # two dead topics force resets mid-sweep
    for t in (1, 3):
        W0[:, t] = 0.0
        T0[t] = 0.0
    kw = dict(k=k, max_iter=5, random_state=0, early_stop=False,
              compute_obj_each_iter=True, n_resets=5,
              reset_topic_method='max_resid_document')
    single = nmf(X, W_in=W0.copy(), T_in=T0.copy(), **kw)
    shard = nmf(X, W_in=W0.copy(), T_in=T0.copy(), mesh=make_mesh(8), **kw)
    assert single['n_resets_remaining'] == shard['n_resets_remaining'] == 3
    assert np.allclose(single['W'], shard['W'], atol=1e-11)
    assert np.allclose(single['T'], shard['T'], atol=1e-11)
    assert np.all(np.diff(shard['obj_history']) <= 0)


def test_sharded_resets_interleaved_order():
    """Same under the interleaved (reference-default) order, where resets
    can fire in both the T- and W-checks."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import make_mesh

    rng = np.random.RandomState(2)
    k = 3
    X = np.abs(rng.rand(48, k) @ rng.rand(k, 32))
    W0 = np.abs(rng.rand(48, k))
    T0 = np.abs(rng.rand(k, 32))
    W0[:, 0] = 0.0
    T0[0] = 0.0
    kw = dict(k=k, max_iter=4, random_state=0, early_stop=False,
              n_resets=23, update_order='interleaved',
              reset_topic_method='max_resid_document')
    single = nmf(X, W_in=W0.copy(), T_in=T0.copy(), **kw)
    shard = nmf(X, W_in=W0.copy(), T_in=T0.copy(), mesh=make_mesh(8), **kw)
    assert single['n_resets_remaining'] == shard['n_resets_remaining']
    assert np.allclose(single['W'], shard['W'], atol=1e-11)
    assert np.allclose(single['T'], shard['T'], atol=1e-11)


@requires_8_devices
def test_unaligned_shapes_fall_back_to_axiswise_sharding(caplog):
    """Dense mesh fits with shapes off the mesh quanta shard only the
    divisible axes (replicating the rest) and run the GSPMD sweep —
    previously device_put raised on divisibility. Results match the
    single-device run."""
    import logging

    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import make_mesh

    rng = np.random.RandomState(0)
    mesh = make_mesh(8)                      # (4, 2)
    # n=50 not divisible by 4; d=39 not divisible by 2 -> replicated
    X = np.abs(rng.rand(50, 39))
    kw = dict(k=4, max_iter=5, random_state=0, early_stop=False,
              compute_obj_each_iter=True)
    a = nmf(X, **kw)
    with caplog.at_level(logging.WARNING, logger='rri_nmf_tpu.nmf'):
        b = nmf(X, mesh=mesh, **kw)
    assert any('mesh quanta' in r.message for r in caplog.records)
    assert np.allclose(a['W'], b['W'], atol=1e-11)
    assert np.allclose(a['obj_history'], b['obj_history'], atol=1e-11)

    # one axis divisible (rows): still sharded along it, same results
    X2 = np.abs(rng.rand(48, 39))
    a2 = nmf(X2, **kw)
    b2 = nmf(X2, mesh=mesh, **kw)
    assert np.allclose(a2['W'], b2['W'], atol=1e-11)

    # masked exercises the Wm extras placement
    M = (rng.rand(50, 39) < 0.7).astype(float)
    kwm = dict(k=4, max_iter=4, random_state=0, early_stop=False,
               reset_topic_method=None)
    am = nmf(X, W_mat=M, **kwm)
    bm = nmf(X, W_mat=M, mesh=mesh, **kwm)
    assert np.allclose(am['W'], bm['W'], atol=1e-11)

    # vector w_row_sum exercises the bound-vector placement: on an
    # unaligned row axis it must be handed over replicated
    wrs = 1.0 + 0.5 * rng.rand(50)
    kwv = dict(k=4, max_iter=4, random_state=0, early_stop=False,
               reset_topic_method=None, w_row_sum=wrs,
               project_W_each_iter=True)
    av = nmf(X, **kwv)
    bv = nmf(X, mesh=mesh, **kwv)
    assert np.allclose(av['W'], bv['W'], atol=1e-11)
    assert np.allclose(bv['W'].sum(1), wrs, atol=1e-8)


@requires_8_devices
def test_sharded_pallas_negative_l1_padding_no_phantom_mass():
    """The GSPMD masked sweep under negative L1 on a tiny problem whose
    per-device tiles are one or two rows: tight parity with the
    single-device XLA sweep."""
    n, d, k = 8, 6, 3
    rng = np.random.RandomState(1)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d))
    M = np.ones((n, d))
    W0 = np.abs(rng.rand(n, k)) + 0.1
    T0 = np.abs(rng.rand(k, d)) + 0.1
    cfg = SweepConfig(k=k, masked=True, reset_topic_method=None,
                      reg_t_l1=-0.1, reg_t_l2=0.5,
                      reg_w_l1=-0.05, reg_w_l2=0.5)
    sharded = _gspmd_masked_sweep(cfg, make_mesh(8))
    single = make_sweep(cfg)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    Ws, Ts, _, _ = sharded(jnp.asarray(X), jnp.asarray(W0),
                           jnp.asarray(T0), key, r, key, jnp.asarray(M))
    Wd, Td, _, _ = single(jnp.asarray(X), jnp.asarray(W0),
                          jnp.asarray(T0), key, r, key, jnp.asarray(M))
    assert np.allclose(np.array(Ws), np.array(Wd), atol=1e-9), \
        np.abs(np.array(Ws) - np.array(Wd)).max()
    assert np.allclose(np.array(Ts), np.array(Td), atol=1e-9)


@requires_8_devices
def test_sharded_masked_skips_repad_when_aligned():
    """Structural pin of the aligned-shape fast path of the sharded dense
    phase sweep: when (n, d) already sit on the mesh the sweep must not
    trace the O(nd) zero-pad (a dynamic_update_slice writing a full
    padded X copy per sweep); off-mesh shapes must (that's the pad doing
    its job)."""
    from rri_nmf_tpu.parallel.sharded_dense import make_sharded_dense_sweep

    k = 3
    mesh = make_mesh(8)                       # (4, 2) dp x tp
    dp, tp = mesh.devices.shape
    n_al, d_al = 16 * dp, 16 * tp
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase')
    sweep = make_sharded_dense_sweep(cfg, mesh, gs='xla')

    def matrix_dus_shapes(n, d, n_pad, d_pad):
        args = (jax.ShapeDtypeStruct((n, d), jnp.float32),
                jax.ShapeDtypeStruct((n, k), jnp.float32),
                jax.ShapeDtypeStruct((k, d), jnp.float32),
                jax.ShapeDtypeStruct((2,), jnp.uint32),
                jax.ShapeDtypeStruct((), jnp.int32),
                jax.ShapeDtypeStruct((2,), jnp.uint32))
        jaxpr = jax.make_jaxpr(sweep)(*args)
        found = []

        def walk(jx):
            for eqn in jx.eqns:
                if eqn.primitive.name in ('scatter',
                                          'dynamic_update_slice'):
                    for ov in eqn.outvars:
                        if tuple(ov.aval.shape) == (n_pad, d_pad):
                            found.append(tuple(ov.aval.shape))
                for v in eqn.params.values():
                    if hasattr(v, 'jaxpr'):
                        walk(v.jaxpr)
                    elif isinstance(v, (list, tuple)):
                        for b in v:
                            if hasattr(b, 'jaxpr'):
                                walk(b.jaxpr)

        walk(jaxpr.jaxpr)
        return found

    # aligned: no global-matrix-sized pad writes anywhere in the trace
    assert matrix_dus_shapes(n_al, d_al, n_al, d_al) == []
    # off the mesh: the X pad must appear, writing (n_al, d_al)
    off = matrix_dus_shapes(n_al - 1, d_al - 1, n_al, d_al)
    assert (n_al, d_al) in off


def test_sharded_resets_multiblock_per_device():
    """Same contract as test_sharded_resets_match_single_device but with
    n_loc > 4096 so each device's blockwise residual scan actually runs
    MULTIPLE blocks (clamped overlapping final block included: 4608 rows
    per device = 4096 + clamped [512, 4608)). Pins block indexing and the
    cross-device argmax combine at the multi-block regime no other
    mesh test reaches."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import make_mesh

    rng = np.random.RandomState(1)
    k, n, d = 3, 8 * 4608, 16
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d)) + 0.01
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    W0[:, 1] = 0.0
    T0[1] = 0.0   # dead topic forces one reset
    kw = dict(k=k, max_iter=2, random_state=1, early_stop=False,
              compute_obj_each_iter=True, n_resets=5,
              reset_topic_method='max_resid_document')
    single = nmf(X, W_in=W0.copy(), T_in=T0.copy(), **kw)
    shard = nmf(X, W_in=W0.copy(), T_in=T0.copy(),
                mesh=make_mesh(8, mesh_shape=(8, 1)), **kw)
    assert single['n_resets_remaining'] == shard['n_resets_remaining'] == 4
    assert np.allclose(single['W'], shard['W'], atol=1e-11)
    assert np.allclose(single['T'], shard['T'], atol=1e-11)


@requires_8_devices
def test_distributed_blockwise_objective_parity():
    """The mesh residual objective (ops/accel.make_residual_obj,
    distributed=True) runs blockwise inside a shard_map — per-device
    temps stay at block size instead of an X-sized f32 tile. Parity vs the
    single-device blockwise form must be exact summation-order-level
    f64: dense, masked, quantized int16 X, and the one-piece fallback
    for shapes that do not tile the mesh."""
    import dataclasses

    from rri_nmf_tpu.ops.accel import make_residual_obj
    from rri_nmf_tpu.ops.quantized import quantize_x

    rng = np.random.RandomState(3)
    mesh = make_mesh(8, mesh_shape=(4, 2))
    n, d, k = 64, 48, 5
    X = rng.rand(n, d)
    W = rng.rand(n, k)
    T = rng.rand(k, d)
    M = (rng.rand(n, d) < 0.6).astype(np.float64)

    cfg1 = SweepConfig(k=k, reset_topic_method=None, update_order='phase',
                       reg_w_l2=0.01, reg_t_l1=0.005)
    cfgm = dataclasses.replace(cfg1, mesh=mesh)
    ref = make_residual_obj(cfg1, distributed=False)
    dist = make_residual_obj(cfgm, distributed=True)

    v0 = float(ref(jnp.asarray(X), jnp.asarray(W), jnp.asarray(T)))
    v1 = float(jax.jit(dist)(jnp.asarray(X), jnp.asarray(W),
                             jnp.asarray(T)))
    assert abs(v1 - v0) < 1e-12 * abs(v0)

    qx = quantize_x(jnp.asarray(X))
    vq_ref = float(ref(qx, jnp.asarray(W), jnp.asarray(T)))
    vq = float(jax.jit(dist)(qx, jnp.asarray(W), jnp.asarray(T)))
    assert abs(vq - vq_ref) < 1e-12 * abs(vq_ref)

    refm = make_residual_obj(dataclasses.replace(cfg1, masked=True),
                             distributed=False)
    distm = make_residual_obj(dataclasses.replace(cfgm, masked=True),
                              distributed=True)
    v3 = float(refm(jnp.asarray(X), jnp.asarray(W), jnp.asarray(T),
                    jnp.asarray(M)))
    v4 = float(jax.jit(distm)(jnp.asarray(X), jnp.asarray(W),
                              jnp.asarray(T), jnp.asarray(M)))
    assert abs(v4 - v3) < 1e-12 * abs(v3)

    # shapes that do not tile the (4, 2) mesh take the one-piece form
    n2, d2 = 63, 47
    X2, W2, T2 = rng.rand(n2, d2), rng.rand(n2, k), rng.rand(k, d2)
    v5 = float(ref(jnp.asarray(X2), jnp.asarray(W2), jnp.asarray(T2)))
    v6 = float(jax.jit(dist)(jnp.asarray(X2), jnp.asarray(W2),
                             jnp.asarray(T2)))
    assert abs(v6 - v5) < 1e-11 * abs(v5)
