"""Multi-device dense phase sweep: per-device Gauss-Seidel loops + psum.

Carries the single-device dense phase sweep (:mod:`rri_nmf_tpu.ops
.dense_phase`: XLA GEMMs for the X contractions + the Gauss-Seidel topic
loop, Triton kernel or XLA) to a ``(dp, tp)`` mesh with ``shard_map``.
Communication per sweep is four psums of SMALL operands — nothing
proportional to X moves:

- T-phase: ``G = WᵀW`` (k×k, psum over ``dp``) and the numerator panel
  ``WᵀX`` (k × d/tp local columns, partial over ``dp`` rows → psum over
  ``dp``). T columns are independent within the phase, so each device's
  topic loop on its local ``(k, d_loc)`` T tile IS the global
  Gauss-Seidel update restricted to its columns — bitwise the same
  subproblems. The TM preset's per-topic simplex projection breaks that
  column independence (one threshold per whole row): for those configs
  the numerator + factor panels are all_gathered over ``tp`` (raising the
  T-phase wire term from ``k·d/tp`` to ``2·k·d`` per device) and the
  projected XLA loop runs replicated per tp rank on whole rows; each
  device keeps its local columns.
- W-phase: ``G₂ = TTᵀ`` (k×k, psum over ``tp``) and ``T X_locᵀ``
  (k × n/dp, psum over ``tp``); W rows are independent, same argument.

Per-device wire traffic per sweep: ``k·d/tp + k·n/dp + 2k²`` floats —
the same collective pattern as the sharded sparse path
(:mod:`rri_nmf_tpu.parallel.sparse_mesh`). The reference has no
distributed runtime at all (SURVEY.md §2.2; vestigial hooks at reference
``nmf.py:233-235,653-660``).

Layouts (matching :mod:`rri_nmf_tpu.parallel.mesh`):
``X: P(dp, tp)``; ``W: P(dp, None)``; ``T: P(None, tp)``. Global shapes
are zero-padded to ``(dp, tp)`` multiples once per sweep; padded
rows/columns are sliced away on return.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

try:
    from jax import shard_map              # jax >= 0.8
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from rri_nmf_tpu.matrixops import _proj_simplex_core
from rri_nmf_tpu.ops.dense_phase import (_projected_t, gs_panel,
                                         gs_topics_blocked, phase_bounds,
                                         supports_dense_phase)
from rri_nmf_tpu.ops.sweep_xla import _gram_block_size, resolve_mixed_dtypes


def _round_up(x, m):
    return (x + m - 1) // m * m


@lru_cache(maxsize=16)
def make_sharded_dense_sweep(cfg, mesh, gs='xla'):
    """Build the mesh-sharded dense phase sweep; ``gs`` as in
    :func:`rri_nmf_tpu.ops.dense_phase.make_dense_phase_sweep`.

    Same call signature as the single-device sweeps::

        sweep(X, W, T, key, resets_left, reset_key[, w_row_sum_vec])
            -> (W, T, key, resets_left)
    """
    assert supports_dense_phase(cfg), \
        'config not supported by the sharded dense phase sweep'
    k = cfg.k
    dp, tp = mesh.axis_names
    dp_size, tp_size = mesh.devices.shape
    t_bound, w_bound = phase_bounds(cfg)
    proj_t = _projected_t(cfg)

    def make_local_sweep(d_glob):
        # ``d_glob`` is the TRUE (unpadded) global column count — the
        # projected T-phase must mask the global padding out of its
        # simplex thresholds, so the shard_map body is built per shape.
        def local_sweep(X, W, T, ub_vec):
            # per-device code on local tiles: X (n_loc, d_loc), W
            # (n_loc, k), T (k, d_loc); ub_vec (n_loc,) or None
            from rri_nmf_tpu.ops.quantized import (
                QuantizedX, qx_t_numerator, qx_w_numerator)
            qx = X if isinstance(X, QuantizedX) else None
            n_loc, d_loc = X.shape
            # factor dtype follows W (mixed storage: x_dtype='bfloat16'
            # keeps X narrow while the factor tiles stay f32; see
            # sweep_xla.resolve_mixed_dtypes for the x_narrow rules)
            dtype, acc_dt, x_narrow = resolve_mixed_dtypes(
                X.dtype, W.dtype, cfg.matmul_precision)

            # ---------------- T-phase ----------------------------------
            if not cfg.fix_T:
                G = lax.psum(
                    jnp.dot(W.T, W, preferred_element_type=acc_dt), dp)
                if qx is not None:
                    # scale folding commutes with the dp psum (the
                    # column scale is dp-invariant)
                    WX = lax.psum(qx_t_numerator(W, qx, acc_dt), dp)
                else:
                    Wx = W.astype(X.dtype) if x_narrow else W
                    WX = lax.psum(
                        lax.dot_general(Wx, X, (((0,), (0,)), ((), ())),
                                        preferred_element_type=acc_dt), dp)
                if proj_t:
                    # the per-topic simplex threshold couples ALL d
                    # columns, so the projected loop needs whole rows:
                    # gather the numerator + factor panels over ``tp``
                    # (2·k·d floats per device per sweep, vs k·d/tp
                    # unprojected), run the loop replicated per tp rank
                    # with the global padding masked out, keep the local
                    # columns
                    WXg = lax.all_gather(WX, tp, axis=1, tiled=True)
                    Tg = lax.all_gather(T, tp, axis=1, tiled=True)
                    Tg = gs_topics_blocked(
                        WXg, Tg, G, k=k, B=_gram_block_size(k),
                        reg_l1=cfg.reg_t_l1, reg_l2=cfg.reg_t_l2,
                        qf_s=cfg.t_row_sum, qf_ub=t_bound,
                        reproject_sum=cfg.t_row_sum, acc=acc_dt,
                        dtype=dtype, reps=cfg.inner_reps,
                        valid_cols=(d_glob if d_glob < Tg.shape[1]
                                    else None))
                    T = lax.dynamic_slice_in_dim(
                        Tg, lax.axis_index(tp) * d_loc, d_loc, axis=1)
                else:
                    T = gs_panel(WX, T, G, impl=gs, k=k,
                                 reg_l1=cfg.reg_t_l1, reg_l2=cfg.reg_t_l2,
                                 ub=t_bound, acc=acc_dt, dtype=dtype,
                                 reps=cfg.inner_reps)
                    if d_glob < d_loc * tp_size:
                        # zero the global zero-padding's ghost columns
                        # before the W-phase Gram: a negative reg_t_l1
                        # grows them (numer = -reg_l1 > 0 on pads) and
                        # they would flow into psum(T @ T.T)
                        col_ok = (lax.axis_index(tp) * d_loc
                                  + jnp.arange(d_loc)) < d_glob
                        T = jnp.where(col_ok[None, :], T, 0)

            # ---------------- W-phase ----------------------------------
            if not cfg.fix_W:
                G2 = lax.psum(
                    jnp.dot(T, T.T, preferred_element_type=acc_dt), tp)
                if qx is not None:
                    XTt = lax.psum(qx_w_numerator(T, qx, acc_dt), tp)
                else:
                    Tx = T.astype(X.dtype) if x_narrow else T
                    XTt = lax.psum(
                        lax.dot_general(Tx, X, (((1,), (1,)), ((), ())),
                                        preferred_element_type=acc_dt), tp)
                ub = ub_vec if cfg.w_row_sum_is_vector else w_bound
                W = gs_panel(XTt, W.T, G2, impl=gs, k=k,
                             reg_l1=cfg.reg_w_l1, reg_l2=cfg.reg_w_l2,
                             ub=ub, acc=acc_dt, dtype=dtype,
                             reps=cfg.inner_reps).T

            # per-iteration W row projection: rows are dp-local, no
            # communication. Padded rows project to garbage but are
            # sliced away by the caller.
            if (cfg.project_W_each_iter and not cfg.fix_W
                    and (cfg.w_row_sum is not None
                         or cfg.w_row_sum_is_vector)):
                if cfg.w_row_sum_is_vector:
                    s_vec = ub_vec.astype(dtype)
                else:
                    s_vec = jnp.full((n_loc,), cfg.w_row_sum, dtype=dtype)
                W = jax.vmap(_proj_simplex_core)(W, s_vec)
            return W, T
        return local_sweep

    ub_spec = P(dp) if cfg.w_row_sum_is_vector else P()

    def sweep(X, W, T, key, resets_left, reset_key, *extras):
        from rri_nmf_tpu.ops.quantized import QuantizedX
        qx = X if isinstance(X, QuantizedX) else None
        n, d = X.shape
        dtype = W.dtype   # factor dtype (mixed storage: X may be narrower)
        npad = _round_up(n, dp_size)
        dpad = _round_up(d, tp_size)
        x_spec = QuantizedX(P(dp, tp), P(tp)) if qx is not None \
            else P(dp, tp)
        # shapes are static under jit: the shard_map body is rebuilt per
        # (n, d) trace, carrying the true d into the projected loop
        sharded = shard_map(
            make_local_sweep(d), mesh=mesh,
            in_specs=(x_spec, P(dp, None), P(None, tp), ub_spec),
            out_specs=(P(dp, None), P(None, tp)),
            check_vma=False)  # pallas outputs carry no varying-axis info

        # skip the O(nd) repad when the shapes already sit on the mesh
        # (matching make_sharded_sparse_sweep). Shapes off the mesh pay
        # this X-sized pad on EVERY sweep (the jitted sweep is pure; X
        # cannot be cached across calls) — pre-pad the input to avoid it.
        if qx is not None:
            # pad the code with zeros and the scale with ones (pad
            # columns dequantize to exact zeros either way)
            Xp = qx if (npad == n and dpad == d) else QuantizedX(
                jnp.zeros((npad, dpad), qx.q.dtype).at[:n, :d].set(qx.q),
                jnp.ones((dpad,), qx.s.dtype).at[:d].set(qx.s))
        else:
            Xp = X if (npad == n and dpad == d) else \
                jnp.zeros((npad, dpad), X.dtype).at[:n, :d].set(X)
        Wp = W if npad == n else \
            jnp.zeros((npad, k), dtype).at[:n].set(W)
        Tp = T if dpad == d else \
            jnp.zeros((k, dpad), dtype).at[:, :d].set(T)
        if cfg.w_row_sum_is_vector:
            v = extras[0].reshape(-1).astype(dtype)
            ub = v if npad == n else jnp.zeros((npad,), dtype).at[:n].set(v)
        else:
            ub = jnp.zeros((), dtype)

        if qx is not None:
            Xp = QuantizedX(
                lax.with_sharding_constraint(
                    Xp.q, NamedSharding(mesh, P(dp, tp))),
                lax.with_sharding_constraint(
                    Xp.s, NamedSharding(mesh, P(tp))))
        else:
            Xp = lax.with_sharding_constraint(
                Xp, NamedSharding(mesh, P(dp, tp)))
        Wp = lax.with_sharding_constraint(
            Wp, NamedSharding(mesh, P(dp, None)))
        Tp = lax.with_sharding_constraint(
            Tp, NamedSharding(mesh, P(None, tp)))
        if cfg.w_row_sum_is_vector:
            ub = lax.with_sharding_constraint(
                ub, NamedSharding(mesh, P(dp)))

        Wp, Tp = sharded(Xp, Wp, Tp, ub)
        return Wp[:n], Tp[:, :d], key, resets_left

    if cfg.matmul_precision is not None:
        _sweep_body = sweep

        def sweep(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _sweep_body(*args)

    return jax.jit(sweep)
