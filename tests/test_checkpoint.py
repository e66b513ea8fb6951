"""Checkpoint / resume tests (new subsystem per SURVEY.md §5.4; the
reference has in-memory warm start only)."""

import numpy as np

from rri_nmf_tpu.nmf import nmf


def _problem(n=25, d=18, k=3, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))


def test_checkpoint_roundtrip(tmp_path):
    from rri_nmf_tpu.checkpoint import NMFCheckpointer, NMFState
    import jax
    ckpt = NMFCheckpointer(tmp_path / 'ck', keep=2)
    state = NMFState(W=np.ones((4, 2)), T=np.full((2, 3), 0.5),
                     iteration=7, obj_history=[3.0, 2.0, 1.5],
                     key=jax.random.PRNGKey(42), resets_left=11,
                     random_state=42)
    ckpt.save(7, state, wait=True)
    assert ckpt.latest_step() == 7
    back = ckpt.restore()
    assert back.iteration == 7
    assert back.resets_left == 11
    assert back.random_state == 42
    assert np.allclose(back.W, state.W)
    assert np.allclose(back.T, state.T)
    assert np.allclose(back.obj_history, [3.0, 2.0, 1.5])
    ckpt.close()


def test_nmf_resume_equals_straight_run(tmp_path):
    """A run checkpointed at iter 4 and resumed must finish with the same
    factors as an uninterrupted run (the file-based analog of the
    stepped ≡ batch contract, tests/test_nmf.py:97-110)."""
    X = _problem()
    kw = dict(k=3, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              eps_stop=0.0)

    straight = nmf(X, **kw)

    ck_dir = str(tmp_path / 'run')
    # phase 1: run 4 iterations, checkpointing every 2
    nmf(X, max_iter=4, checkpoint=ck_dir, checkpoint_every=2,
        **{k: v for k, v in kw.items() if k != 'max_iter'})
    # phase 2: resume from the checkpoint and complete to 8
    resumed = nmf(X, checkpoint=ck_dir, checkpoint_every=100, **kw)

    assert np.allclose(resumed['W'], straight['W'], atol=1e-12)
    assert np.allclose(resumed['T'], straight['T'], atol=1e-12)
    assert np.allclose(resumed['obj_history'], straight['obj_history'],
                       atol=1e-10)


def test_mixed_x_dtype_resume_equals_straight(tmp_path):
    """Checkpoint/resume under mixed storage (x_dtype bf16, f32
    factors): the resumed run equals the straight run exactly — the
    checkpoint holds f32 factors and X re-quantizes identically."""
    X = _problem()
    kw = dict(k=3, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              eps_stop=0.0, dtype='float32', x_dtype='bfloat16',
              update_order='phase')
    straight = nmf(X, **kw)
    ck_dir = str(tmp_path / 'run_mixed')
    nmf(X, max_iter=4, checkpoint=ck_dir, checkpoint_every=2,
        **{k: v for k, v in kw.items() if k != 'max_iter'})
    resumed = nmf(X, checkpoint=ck_dir, checkpoint_every=100, **kw)
    assert resumed['W'].dtype == np.float32
    assert np.allclose(resumed['W'], straight['W'], atol=1e-12)
    assert np.allclose(resumed['T'], straight['T'], atol=1e-12)


def test_her_resume_equals_straight(tmp_path):
    """HER extrapolation state (Wy, Ty, beta, e) rides the checkpoint, so
    a resumed accel='her' run continues the momentum sequence exactly —
    resumed ≡ straight, not a momentum restart."""
    X = _problem()
    kw = dict(k=3, max_iter=10, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              eps_stop=0.0, accel='her', update_order='phase')
    straight = nmf(X, **kw)
    ck_dir = str(tmp_path / 'her')
    nmf(X, max_iter=5, checkpoint=ck_dir, checkpoint_every=5,
        **{k: v for k, v in kw.items() if k != 'max_iter'})
    resumed = nmf(X, checkpoint=ck_dir, checkpoint_every=100, **kw)
    assert np.allclose(resumed['W'], straight['W'], atol=1e-12)
    assert np.allclose(resumed['T'], straight['T'], atol=1e-12)


def test_her_mesh_resume_equals_straight(tmp_path):
    """The HER momentum state (her_Wy/her_Ty) saves and restores as
    mesh-sharded arrays: a sharded accel='her' run resumed on a (4, 2)
    mesh equals the uninterrupted sharded run."""
    import jax

    if len(jax.devices()) < 8:
        import pytest
        pytest.skip('needs 8 virtual devices')
    from rri_nmf_tpu.parallel import make_mesh

    X = _problem(n=24, d=16)
    mesh = make_mesh(8)
    kw = dict(k=3, max_iter=10, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              eps_stop=0.0, accel='her', update_order='phase', mesh=mesh)
    straight = nmf(X, **kw)
    ck_dir = str(tmp_path / 'her_mesh')
    nmf(X, max_iter=5, checkpoint=ck_dir, checkpoint_every=5,
        **{k: v for k, v in kw.items() if k != 'max_iter'})
    resumed = nmf(X, checkpoint=ck_dir, checkpoint_every=100, **kw)
    assert np.allclose(resumed['W'], straight['W'], atol=1e-12)
    assert np.allclose(resumed['T'], straight['T'], atol=1e-12)


def test_her_resume_from_plain_checkpoint_warns(tmp_path, caplog):
    """Resuming accel='her' from a checkpoint written WITHOUT it cannot
    recover momentum — it must warn and restart the sequence."""
    import logging
    X = _problem()
    kw = dict(k=3, random_state=0, early_stop=False,
              reset_topic_method=None, eps_stop=0.0, update_order='phase')
    ck_dir = str(tmp_path / 'plain')
    nmf(X, max_iter=4, checkpoint=ck_dir, checkpoint_every=2, **kw)
    with caplog.at_level(logging.WARNING, logger='rri_nmf_tpu.nmf'):
        resumed = nmf(X, max_iter=8, accel='her', checkpoint=ck_dir,
                      checkpoint_every=100, **kw)
    assert any('no extrapolation state' in r.message
               for r in caplog.records)
    assert np.isfinite(resumed['W']).all()


def test_grouped_checkpoint_marks_untracked_objective(tmp_path, caplog):
    """Grouped-dispatch checkpoints carry obj_tracked=False; resuming one
    with objective-based stopping warns instead of silently trusting an
    empty history (VERDICT r1 weak #3)."""
    import logging
    from rri_nmf_tpu.checkpoint import NMFCheckpointer

    X = _problem()
    ck_dir = str(tmp_path / 'grp')
    # grouped run (no objective tracking possible)
    nmf(X, 3, max_iter=4, random_state=0, sweeps_per_dispatch=2,
        reset_topic_method=None, checkpoint=ck_dir, checkpoint_every=2)
    state = NMFCheckpointer(ck_dir).restore()
    assert state.obj_tracked is False
    assert state.obj_history == []

    with caplog.at_level(logging.WARNING, logger='rri_nmf_tpu.nmf'):
        resumed = nmf(X, 3, max_iter=6, random_state=0,
                      compute_obj_each_iter=True, reset_topic_method=None,
                      checkpoint=ck_dir, checkpoint_every=100)
    assert any('without objective tracking' in r.message
               for r in caplog.records)
    # history only covers the resumed iterations
    assert len(resumed['obj_history']) == 2

    # per-iteration checkpoints with tracking record obj_tracked=True
    ck2 = str(tmp_path / 'tracked')
    nmf(X, 3, max_iter=2, random_state=0, compute_obj_each_iter=True,
        reset_topic_method=None, checkpoint=ck2, checkpoint_every=1)
    st2 = NMFCheckpointer(ck2).restore()
    assert st2.obj_tracked is True
    assert len(st2.obj_history) == 2


def test_mesh_checkpoint_resume_equals_straight(tmp_path):
    """Mesh checkpointing: a sharded fit saves its factors, restores them
    straight onto the mesh layouts (each device takes its own slice), and
    the resumed run equals an uninterrupted sharded run on a (4, 2)
    mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rri_nmf_tpu.checkpoint import NMFCheckpointer
    from rri_nmf_tpu.parallel.mesh import make_mesh, problem_shardings

    X = _problem(n=40, d=24, k=3, seed=1)
    mesh = make_mesh(8, mesh_shape=(4, 2))
    kw = dict(k=3, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase', eps_stop=0.0, mesh=mesh)

    straight = nmf(X, **kw)

    ck_dir = str(tmp_path / 'mesh_run')
    nmf(X, checkpoint=ck_dir, checkpoint_every=2,
        **{k: v for k, v in kw.items() if k != 'max_iter'}, max_iter=4)

    # the checkpoint restores W directly as a mesh-sharded jax.Array
    s_W = problem_shardings(mesh)[1]
    state = NMFCheckpointer(ck_dir).restore(shardings={'W': s_W})
    assert isinstance(state.W, jax.Array)
    assert state.W.sharding == s_W
    # the saved step holds the whole (gathered) factor
    assert NMFCheckpointer(ck_dir).steps() == [2, 4]
    assert state.W.shape == (40, 3) and state.iteration == 4

    resumed = nmf(X, checkpoint=ck_dir, checkpoint_every=100, **kw)
    assert np.allclose(resumed['W'], straight['W'], atol=1e-12)
    assert np.allclose(resumed['T'], straight['T'], atol=1e-12)
    assert np.allclose(resumed['obj_history'], straight['obj_history'],
                       atol=1e-10)


def test_mesh_checkpoint_cross_layout_resume(tmp_path):
    """A checkpoint written by a single-device run resumes onto a mesh
    (and vice versa): restore reshards from storage to the run layout."""
    from rri_nmf_tpu.parallel.mesh import make_mesh

    X = _problem(n=32, d=20, k=3, seed=2)
    base = dict(k=3, max_iter=6, random_state=0, early_stop=False,
                compute_obj_each_iter=True, reset_topic_method=None,
                update_order='phase', eps_stop=0.0)
    mesh = make_mesh(8, mesh_shape=(8, 1))

    straight = nmf(X, **base)

    ck_dir = str(tmp_path / 'xlay')
    nmf(X, checkpoint=ck_dir, checkpoint_every=3,
        **{k: v for k, v in base.items() if k != 'max_iter'}, max_iter=3)
    resumed_mesh = nmf(X, checkpoint=ck_dir, checkpoint_every=100,
                       mesh=mesh, **base)
    assert np.allclose(resumed_mesh['W'], straight['W'], atol=1e-11)
    assert np.allclose(resumed_mesh['T'], straight['T'], atol=1e-11)
