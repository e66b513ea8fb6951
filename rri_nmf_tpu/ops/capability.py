"""What the device can run, decided in one place.

Every routing choice that depends on the backend reads it here:

- :func:`gs_impl` — which Gauss-Seidel topic loop the phase sweeps run
  (``ops/dense_phase.py``): the Triton kernel on a GPU, the XLA loop on
  every other backend, the Pallas interpreter only when a caller asks;
- :func:`memory_budget_bytes` — memory budgets as a share of what the
  device reports (the host's RAM on the CPU backend).
"""

import os

import jax


def on_gpu() -> bool:
    return jax.default_backend() == 'gpu'


def gs_impl(use_pallas=None) -> str:
    """Topic-loop implementation for ``nmf(use_pallas=...)``.

    ``None`` (auto): ``'triton'`` on a GPU, ``'xla'`` elsewhere.
    ``False``: ``'xla'``. ``True``: ``'triton'``, which needs a GPU.
    ``'interpret'``: the kernel in the Pallas interpreter (tests). A
    kernel that fails to compile raises; nothing falls back."""
    if use_pallas is None:
        return 'triton' if on_gpu() else 'xla'
    if isinstance(use_pallas, str):
        if use_pallas != 'interpret':
            raise ValueError("use_pallas must be None, a bool or "
                             "'interpret'; got %r" % (use_pallas,))
        return 'interpret'
    if not use_pallas:
        return 'xla'
    if not on_gpu():
        raise ValueError(
            'use_pallas=True runs the Triton kernel, which needs a GPU '
            '(backend is %r); pass use_pallas=\'interpret\' to run it in '
            'the Pallas interpreter' % jax.default_backend())
    return 'triton'


def device_bytes_limit(device=None) -> int:
    """Bytes the device lets this process allocate
    (``memory_stats()['bytes_limit']``). An accelerator that reports no
    limit is an error: no budget is guessed."""
    device = device if device is not None else jax.local_devices()[0]
    if device.platform == 'cpu':
        return os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')
    stats = device.memory_stats() or {}
    if 'bytes_limit' not in stats:
        raise RuntimeError('device %s reports no memory limit '
                           '(memory_stats: %s)' % (device, sorted(stats)))
    return int(stats['bytes_limit'])


def memory_budget_bytes(fraction, device=None) -> float:
    """``fraction`` of :func:`device_bytes_limit`."""
    return float(fraction) * device_bytes_limit(device)
