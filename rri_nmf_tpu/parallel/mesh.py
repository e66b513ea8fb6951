"""Device-mesh sharding of the RRI/WRRI sweep (GSPMD / pjit).

The reference has **no** distributed runtime at all (SURVEY.md §2.2: no
MPI/NCCL/sockets; only vestigial hooks at reference ``nmf.py:233-235`` and
``nmf.py:653-660`` noting what a distributed NMF *would* send). This module
is the multi-device scale path specified by the north star:

- ``X`` is sharded over a 2-D mesh ``('dp', 'tp')`` — rows over ``dp``
  (documents; the large axis for topic modeling) and columns over ``tp``
  (features).
- ``W`` (n×k) shards its rows over ``dp`` and replicates over ``tp``;
- ``T`` (k×d) shards its columns over ``tp`` and replicates over ``dp``.

With those layouts every per-topic contraction in the sweep reduces over
exactly one mesh axis and GSPMD auto-inserts the collective:

- ``W^T X``   (the T-phase GEMM)  → ``psum`` over ``dp``;
- ``X @ T[t]`` (the W-phase GEMV) → ``psum`` over ``tp``;
- ``||W[:,t]||²`` → ``psum`` over ``dp``; ``||T[t]||²`` → over ``tp``;
- masked reductions ``(w²)ᵀM`` / ``M t²`` → over ``dp`` / ``tp``;
- W-row simplex projections are row-local (no communication);
- T-row simplex projections sort along the ``tp``-sharded axis — T rows are
  small (k×d with small k), XLA gathers them; acceptable because T is tiny
  relative to X.

Nothing in the sweep kernel itself knows about devices: the same
``make_sweep`` computation is ``jax.jit``-ed with ``in_shardings`` /
``out_shardings`` here, and XLA partitions it. Deterministic topic resets
use one shared PRNG key, so all shards agree (the ``fix_reset_seed``
machinery of reference ``nmf.py:233-235,780`` generalized).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rri_nmf_tpu.ops.sweep_xla import SweepConfig, make_sweep


def make_mesh(n_devices=None, mesh_shape=None, axis_names=('dp', 'tp'),
              devices=None):
    """Create a 2-D device mesh.

    ``mesh_shape`` defaults to (n_devices, 1) — pure row sharding — unless
    n_devices is divisible by 2, in which case (n_devices//2, 2) exercises
    both axes. Pass an explicit ``mesh_shape`` for production layouts. The
    mesh follows the algorithm, not the wiring: NVLink joins every GPU of
    a host to every other at the same rate, so rows over ``dp`` — a
    ``(n_devices, 1)`` mesh — is the layout for large-n problems (its only
    per-phase traffic is the (k, d) T-phase numerator psum and two k×k
    Grams).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if mesh_shape is None:
        if n_devices % 2 == 0 and n_devices > 1:
            mesh_shape = (n_devices // 2, 2)
        else:
            mesh_shape = (n_devices, 1)
    dev_array = np.asarray(devices).reshape(mesh_shape)
    return Mesh(dev_array, axis_names)


def problem_shardings(mesh, masked=False, w_row_sum_is_vector=False):
    """(X, W, T[, W_mat][, w_row_sum_vec]) shardings for the sweep inputs."""
    dp, tp = mesh.axis_names
    s_X = NamedSharding(mesh, P(dp, tp))
    s_W = NamedSharding(mesh, P(dp, None))
    s_T = NamedSharding(mesh, P(None, tp))
    out = [s_X, s_W, s_T]
    if masked:
        out.append(s_X)                       # W_mat shards like X
    if w_row_sum_is_vector:
        out.append(NamedSharding(mesh, P(dp, None)))
    return tuple(out)


def shard_problem(mesh, X, W, T, W_mat=None, w_row_sum_vec=None):
    """device_put the factorization state onto the mesh with the canonical
    layouts. Returns jax arrays in the same order as given."""
    shardings = problem_shardings(
        mesh, masked=W_mat is not None,
        w_row_sum_is_vector=w_row_sum_vec is not None)
    arrays = [jnp.asarray(X), jnp.asarray(W), jnp.asarray(T)]
    if W_mat is not None:
        arrays.append(jnp.asarray(W_mat))
    if w_row_sum_vec is not None:
        arrays.append(jnp.asarray(w_row_sum_vec))
    return tuple(jax.device_put(a, s) for a, s in zip(arrays, shardings))


def make_sharded_training_step(cfg: SweepConfig, mesh: Mesh,
                               with_objective=True):
    """Compile one full training step (sweep + objective) over the mesh.

    Returns ``step(X, W, T, key, resets_left, reset_key, *extras)
    -> (W, T, key, resets_left[, obj])``. The sweep body is the exact
    single-chip computation from :func:`rri_nmf_tpu.ops.make_sweep`;
    GSPMD partitions it according to the input shardings.
    """
    import dataclasses
    dp, tp = mesh.axis_names
    if cfg.mesh is not None and cfg.mesh is not mesh:
        # a silently-kept foreign cfg.mesh would run the reset shard_map
        # over one mesh while the jit shardings use another
        raise ValueError('cfg.mesh differs from the mesh argument; pass '
                         'a cfg without a mesh (it is filled in here) or '
                         'the same mesh object')
    if cfg.mesh is None:
        # make the reset path mesh-aware (shard_map blockwise argmax)
        cfg = dataclasses.replace(cfg, mesh=mesh)
    sweep = make_sweep(cfg)
    # mesh-blockwise residual objective (ops/accel.py): shard_map'd
    # local row blocks + psum, so per-device temps stay at block size —
    # the one-piece GSPMD residual costs an X-sized f32 temp per device;
    # falls back to one-piece
    # automatically when the global shape does not tile the mesh
    from rri_nmf_tpu.ops.accel import make_residual_obj
    obj_fn = make_residual_obj(cfg, distributed=True)

    replicated = NamedSharding(mesh, P())
    in_data = problem_shardings(
        mesh, masked=cfg.masked,
        w_row_sum_is_vector=cfg.w_row_sum_is_vector)
    s_X, s_W, s_T = in_data[0], in_data[1], in_data[2]
    in_shardings = (s_X, s_W, s_T, replicated, replicated, replicated) \
        + in_data[3:]

    # gradient stores stay distributed: numer_store is (k, d) — column-
    # aligned with T — and replicating it would force a cross-mesh
    # gather of k·d accumulators every step; the masked denom_store is
    # (k, d) too, the unmasked one is (k, 1) (can't split over tp)
    grad_shardings = ()
    if cfg.store_gradients:
        s_grad = NamedSharding(mesh, P(None, tp))
        grad_shardings = (s_grad, s_grad if cfg.masked else replicated)

    if with_objective:
        def step(X, W, T, key, resets_left, reset_key, *extras):
            out = sweep(X, W, T, key, resets_left, reset_key, *extras)
            W2, T2 = out[0], out[1]
            obj_extras = extras[:1] if cfg.masked else ()
            obj = obj_fn(X, W2, T2, *obj_extras)
            return out + (obj,)
        out_shardings = (s_W, s_T, replicated, replicated) \
            + grad_shardings + (replicated,)
    else:
        step = lambda X, W, T, key, resets_left, reset_key, *extras: \
            sweep(X, W, T, key, resets_left, reset_key, *extras)
        out_shardings = (s_W, s_T, replicated, replicated) + grad_shardings

    return jax.jit(step, in_shardings=in_shardings,
                   out_shardings=out_shardings)
