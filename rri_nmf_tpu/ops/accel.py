"""Extrapolated sweeps: HER (heuristic extrapolation with restarts).

RRI/HALS is an exact cyclic block-coordinate descent; its linear
convergence rate degrades badly on ill-conditioned data — e.g. the
U[0,1]-factor north-star class, where the mean-dominated spectrum stalls
plain sweeps around 2e-3 relative error for thousands of sweeps in ANY
precision (the reference algorithm in float64 NumPy plateaus
identically). The reference has no
answer (its only iteration scheme is the plain sweep,
``/root/reference/src/rri_nmf/nmf.py:415-478``).

HER (Ang & Gillis, "Accelerating nonnegative matrix factorization
algorithms using extrapolation", Neural Computation 2019) wraps any
alternating update with momentum on the iterate sequence:

- sweep from the *extrapolated* point ``(Wy, Ty)`` to get ``(W1, T1)``;
- check the true objective; if it did not increase, extrapolate
  ``Wy = [W1 + beta (W1 - W)]_+`` (same for T) and grow ``beta``
  geometrically; on an increase, restart — drop the momentum
  (``Wy = W1``) and halve ``beta``.

The accepted iterates ``(W1, T1)`` are ordinary exact-BCD outputs (the
extrapolated point only serves as the linearization point), so
feasibility of the accepted sequence is preserved; monotonicity is
enforced by the restart test itself, up to the one checked objective.
The accepted sequence is still only monotone-ish: a sweep from an
extrapolated point can land in (and then converge inside) a WORSE basin
of the nonconvex landscape — observed on small simplex-projected
problems (tests/test_fuzz.py). Following the paper's prescription to
output the solution with the lowest error, the step also carries the
best accepted iterate ``(Wb, Tb, eb)`` (two elementwise ``where``s per
sweep, O(nk + kd)); the driver returns it when it beats the final one.

The objective check uses an explicit blockwise residual, NOT the Gram
identity ``||X||² - 2<WᵀX,T> + <G,G²>``: near the 1e-4 target the three
~``||X||²``-sized Gram terms cancel to below f32 noise, while residual
entries are differences whose squares sum forward-stable.

Driver entry: ``nmf(..., accel='her')`` — dense or masked (WRRI) configs
without resets/gradient stores/DP (the north-star and recommender fit
classes; both masked sweeps rebuild their residual carry from (X, W, T)
each sweep, so extrapolated starting points are exact). Composes with
``mesh``: the extrapolation/restart ops are elementwise (GSPMD keeps the
factor shardings) and the objective check runs as a distributed residual
(see :func:`make_residual_obj`).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax import lax


def supports_her(cfg) -> bool:
    """HER wraps any sweep whose per-sweep state is just (W, T): no
    resets, gradient stores, or DP noise. Masked (WRRI) configs qualify —
    both masked sweeps rebuild their residual carry from (X, W, T) at
    sweep start, so sweeping from the extrapolated point is exact."""
    return (cfg.reset_topic_method is None
            and not cfg.masked_sparse  # residual obj streams dense X
            and not cfg.store_gradients
            and cfg.dp_sigma is None)


@lru_cache(maxsize=32)
def make_residual_obj(cfg, block_rows=4096, distributed=None):
    """Jitted ``0.5||X - WT||² + regs`` via blockwise explicit residual
    (forward-stable at 1e-4-scale errors; see module docstring).

    When ``distributed`` (default: ``cfg.mesh is not None``) a GLOBAL
    blockwise ``dynamic_slice`` scan would GATHER a row-sharded ``X``
    (the same reasoning as the sharded reset path,
    :class:`~rri_nmf_tpu.ops.sweep_xla.SweepConfig`), so the mesh form
    runs the blockwise scan INSIDE a ``shard_map`` over each device's
    local tile (+ one scalar psum): per-device temps stay at block size.
    An X-sized f32 tile per device is not "a fraction of X" at scale —
    at 1M×100k on four devices the one-piece form's residual temp is
    twice the device's bf16 X tile. The one-piece GSPMD
    form remains the fallback when the global shape does not tile the
    mesh, and for UNALIGNED meshes (the driver passes
    ``distributed=True`` with ``cfg.mesh is None`` there — X is still
    axis-sharded, and a shard_map cannot be built without the mesh)."""
    if distributed is None:
        distributed = cfg.mesh is not None

    def obj(X, W, T, *extras):
        from rri_nmf_tpu.ops.quantized import (
            QuantizedX, qx_col_block, qx_row_block)
        qx = X if isinstance(X, QuantizedX) else None
        # masked (WRRI) form: 0.5 Σ M ⊙ (X - WT)² — the mask/weight
        # matrix rides as the first extra, exactly as the sweep takes it
        M = extras[0] if cfg.masked else None
        n, d = X.shape
        k = W.shape[1]
        # accumulate in the PROMOTED dtype: X may be stored narrower
        # than the factors (x_dtype='float32' under f64 factors, bf16
        # mixed storage) and an X-dtype accumulator would silently
        # drop the tracked objective to storage precision — objective
        # -based stopping then fires on storage noise
        from rri_nmf_tpu.ops.sweep_xla import resolve_mixed_dtypes
        acc = resolve_mixed_dtypes(X.dtype, W.dtype)[1]

        def _sq(Xb, Wb, Mb, rw=None):
            Rb = Xb.astype(acc) - jnp.dot(Wb, T,
                                          preferred_element_type=acc)
            Rb = Rb * Rb
            if Mb is not None:
                Rb = Mb.astype(acc) * Rb
            rows = jnp.sum(Rb, axis=1)
            if rw is not None:
                rows = rows * rw
            return jnp.sum(rows)

        if distributed:
            mesh = cfg.mesh
            can_map = mesh is not None
            if can_map:
                dp_n, tp_n = mesh.devices.shape
                can_map = (n % dp_n == 0 and d % tp_n == 0)
            if can_map:
                # blockwise on each device's LOCAL tile: slices never
                # cross shard boundaries (no gather) and the transient
                # f32 residual stays at block size per device
                from jax.sharding import PartitionSpec as P
                try:
                    from jax import shard_map      # jax >= 0.8
                except ImportError:
                    from jax.experimental.shard_map import shard_map
                dp_ax, tp_ax = mesh.axis_names

                def _local(Xl, Wl, Tl, Ml=None):
                    qxl = Xl if isinstance(Xl, QuantizedX) else None
                    n_loc = Wl.shape[0]
                    d_loc = Tl.shape[1]
                    B = int(min(block_rows, n_loc))
                    nb = -(-n_loc // B)

                    def blk(i, s):
                        off = jnp.minimum(i * B, n_loc - B)
                        if qxl is not None:
                            Xb = qx_row_block(qxl, off, B, acc)
                        else:
                            Xb = lax.dynamic_slice(
                                Xl, (off, 0), (B, d_loc))
                        Wb = lax.dynamic_slice(Wl, (off, 0), (B, k))
                        Rb = Xb.astype(acc) - jnp.dot(
                            Wb, Tl, preferred_element_type=acc)
                        Rb = Rb * Rb
                        if Ml is not None:
                            Rb = lax.dynamic_slice(
                                Ml, (off, 0), (B, d_loc)).astype(acc) * Rb
                        rows = jnp.sum(Rb, axis=1)
                        if n_loc % B:
                            rows = rows * ((off + jnp.arange(B))
                                           >= i * B).astype(acc)
                        return s + jnp.sum(rows)

                    s = lax.fori_loop(0, nb, blk, jnp.zeros((), acc))
                    return lax.psum(lax.psum(s, dp_ax), tp_ax)

                x_spec = QuantizedX(P(dp_ax, tp_ax), P(tp_ax)) \
                    if qx is not None else P(dp_ax, tp_ax)
                base = (x_spec, P(dp_ax, None), P(None, tp_ax))
                # check_vma=False: the fori carry starts replicated and
                # becomes device-varying inside the loop (same waiver as
                # parallel/sharded_dense.py)
                if M is not None:
                    s = shard_map(
                        _local, mesh=mesh,
                        in_specs=base + (P(dp_ax, tp_ax),),
                        out_specs=P(), check_vma=False)(
                            qx if qx is not None else X, W, T, M)
                else:
                    s = shard_map(
                        _local, mesh=mesh, in_specs=base,
                        out_specs=P(), check_vma=False)(
                            qx if qx is not None else X, W, T)
            else:
                if qx is not None:
                    from rri_nmf_tpu.ops.quantized import dequantize_x
                    X = dequantize_x(qx)  # per-device tiles under GSPMD
                s = _sq(X, W, M)
        elif cfg.update_order == 'phase' and not cfg.masked:
            # COLUMN blocks for the unmasked phase-order composition:
            # the hybrid dense phase sweep this objective shares a jitted
            # program with (HER multi) holds X in the column-major
            # ({0,1}) layout its two GEMMs prefer, and a ROW-blockwise
            # scan next to it made XLA materialize a second, transposed
            # full copy of X (measured: +9.3 GB HLO temp at 100k×50k
            # bf16 — an instant OOM at exactly the beyond-HBM scale the
            # blockwise form exists for). Column slices are contiguous
            # in that layout; the (n, B) f32 block is sized to ~512 MB.
            B = int(min(d, max(128, (1 << 27) // max(n, 1) // 128 * 128)))
            nb = -(-d // B)
            Wa = W.astype(acc)

            def cblk(j, s):
                off = jnp.minimum(j * B, d - B)
                if qx is not None:
                    Xb = qx_col_block(qx, off, B, acc)
                else:
                    Xb = lax.dynamic_slice(X, (0, off), (n, B))
                Tb = lax.dynamic_slice(T, (0, off), (k, B))
                Rb = Xb.astype(acc) - jnp.dot(Wa, Tb,
                                              preferred_element_type=acc)
                cols = jnp.sum(Rb * Rb, axis=0)
                if d % B:
                    cols = cols * ((off + jnp.arange(B)) >= j * B
                                   ).astype(acc)
                return s + jnp.sum(cols)

            s = lax.fori_loop(0, nb, cblk, jnp.zeros((), acc))
        else:
            B = min(block_rows, n)
            # ceil-div blocks with a CLAMPED final offset + row-validity
            # mask instead of a static remainder slice: XLA lowers a
            # static tail slice `X[nb*B:]` of a loop-consumed X by
            # materializing a transposed full copy of X (same hazard as
            # the column case above).
            nb = -(-n // B)

            def blk(i, s):
                off = jnp.minimum(i * B, n - B)
                if qx is not None:
                    Xb = qx_row_block(qx, off, B, acc)
                else:
                    Xb = lax.dynamic_slice(X, (off, 0), (B, d))
                Wb = lax.dynamic_slice(W, (off, 0), (B, k))
                Mb = lax.dynamic_slice(M, (off, 0), (B, d)) \
                    if M is not None else None
                # rows already covered by the previous block (the final
                # block overlaps when B does not divide n) get weight 0
                rw = None
                if n % B:
                    rw = ((off + jnp.arange(B)) >= i * B).astype(acc)
                return s + _sq(Xb, Wb, Mb, rw)

            s = lax.fori_loop(0, nb, blk, jnp.zeros((), acc))
        o = 0.5 * s
        Wa = W.astype(acc)
        Ta = T.astype(acc)
        if cfg.reg_w_l2:
            o = o + 0.5 * cfg.reg_w_l2 * jnp.sum(Wa * Wa)
        if cfg.reg_t_l2:
            o = o + 0.5 * cfg.reg_t_l2 * jnp.sum(Ta * Ta)
        if cfg.reg_w_l1:
            o = o + cfg.reg_w_l1 * jnp.sum(jnp.abs(Wa))
        if cfg.reg_t_l1:
            o = o + cfg.reg_t_l1 * jnp.sum(jnp.abs(Ta))
        return o

    if cfg.matmul_precision is not None:
        _obj_body = obj

        def obj(*args):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return _obj_body(*args)

    return obj


def _her_body(sweep_fn, obj_fn, gamma, beta_max):
    """One HER step: sweep from the extrapolated point, objective check,
    extrapolate or restart, track the best accepted iterate. State:
    (W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev)."""

    def step(X, W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, key, resets_left,
             reset_key, *extras):
        W1, T1, key, resets_left = sweep_fn(
            X, Wy, Ty, key, resets_left, reset_key, *extras)
        e = obj_fn(X, W1, T1, *extras)
        # lowest-objective accepted iterate (module docstring)
        better = e < eb
        Wb = jnp.where(better, W1, Wb)
        Tb = jnp.where(better, T1, Tb)
        eb = jnp.where(better, e, eb).astype(eb.dtype)
        ok = e <= e_prev
        b = jnp.where(ok, jnp.minimum(beta * gamma, beta_max),
                      beta * 0.5).astype(beta.dtype)
        bcast = b.astype(W1.dtype)
        Wy = jnp.where(ok, jnp.maximum(W1 + bcast * (W1 - W), 0), W1)
        Ty = jnp.where(ok, jnp.maximum(T1 + bcast * (T1 - T), 0), T1)
        return (W1, T1, Wy, Ty, Wb, Tb, eb, b, e.astype(e_prev.dtype),
                key, resets_left)

    return step


@lru_cache(maxsize=32)
def make_her_step(sweep_fn, obj_fn, gamma=1.05, beta_max=0.9999):
    """Jitted single HER step (per-iteration driver loop)."""
    return jax.jit(_her_body(sweep_fn, obj_fn, gamma, beta_max))


@lru_cache(maxsize=32)
def make_her_multi(sweep_fn, obj_fn, nsweeps, gamma=1.05, beta_max=0.9999):
    """Jitted ``nsweeps`` HER steps in one dispatch (grouped fast path):
    extrapolation and the objective-based restart run per sweep inside
    the fori_loop."""
    step = _her_body(sweep_fn, obj_fn, gamma, beta_max)

    def multi(X, W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, key, resets_left,
              reset_key, *extras):
        def body(i, c):
            W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, key, resets_left = c
            return step(X, W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, key,
                        resets_left, reset_key, *extras)
        return lax.fori_loop(
            0, nsweeps, body,
            (W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, key, resets_left))

    return jax.jit(multi)
