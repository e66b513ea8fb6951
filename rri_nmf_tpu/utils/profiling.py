"""Tracing / profiling hooks (SURVEY.md §5.1).

The reference's instrumentation is wall-clock ``time.time()`` per iteration
plus a cumulative ``iter_cputime`` list (reference ``nmf.py:349,409,492``)
and DEBUG-level objective-delta logging (``nmf.py:563-609``). The rebuild
keeps the ``iter_cputime`` output contract in ``nmf()`` and adds real
device-side profiling:

- :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable XLA trace (op-level timings, memory traffic,
  fusion decisions) for any code region;
- :class:`TraceAnnotation` — named regions inside a trace (one per sweep /
  per phase shows up on the device timeline);
- :class:`SweepTimer` — host-side per-iteration timer that waits for the
  device (``jax.block_until_ready``) before reading the clock.
"""

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir, create_perfetto_link=False):
    """Profile a region: ``with trace('/tmp/prof'): run_sweeps()``.

    View with TensorBoard's profile plugin or Perfetto.
    """
    jax.profiler.start_trace(str(logdir),
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class TraceAnnotation(jax.profiler.TraceAnnotation):
    """Named region on the profiler timeline: ``with TraceAnnotation('sweep3'):``"""


class SweepTimer:
    """Per-iteration wall-clock timer.

    Produces a list shaped like the reference's ``iter_cputime``
    (cumulative seconds since construction, ``nmf.py:349,492,516``).

    Synchronization is ONLY performed when :meth:`mark` receives device
    arrays — a bare ``mark()`` records the host clock as-is, which under
    asynchronous dispatch measures the enqueue, not the execution. Pass
    the iteration's output arrays unless something else already waited
    for them.
    """

    def __init__(self):
        self.start = time.perf_counter()
        self.marks = []

    def mark(self, *sync_arrays):
        """Record an iteration boundary; pass device arrays to wait for.
        Without them the timestamp is dispatch-time, not execution-time —
        see the class docstring."""
        if sync_arrays:
            jax.block_until_ready(sync_arrays)
        self.marks.append(time.perf_counter() - self.start)
        return self.marks[-1]

    def deltas(self):
        prev = [0.0] + self.marks[:-1]
        return [m - p for m, p in zip(self.marks, prev)]
