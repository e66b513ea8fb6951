"""Checkpoint / resume for long (sharded) NMF runs.

The reference has no file checkpointing at all — resume is purely in-memory
via ``W_in``/``T_in`` warm starts and estimator-held factors (reference
``nmf.py:852-859``, ``sklearn_interface.py:104-112,253-261``, and the
``one_iter`` stepping contract pinned by ``tests/test_nmf.py:97-110``).
Those are preserved exactly in :func:`rri_nmf_tpu.nmf.nmf`. This module
adds what SURVEY.md §5.4 specifies: checkpointing of the full training
state — (W, T, iteration, objective history, PRNG key, reset budget) — so
multi-device runs recover from preemption by restart-from-checkpoint
(SURVEY.md §5.3).

Each saved step is one NumPy ``.npz`` file, written under a temporary
name and renamed into place, so a reader never sees a partial step.
Sharded factors are gathered to the host on save (process 0 writes) and
laid back onto the mesh on restore via the provided shardings.
"""

import dataclasses
import json
import os
import re
from typing import Any, Optional

import jax
import numpy as np


@dataclasses.dataclass
class NMFState:
    """The complete resumable state of an ``nmf()`` run.

    ``obj_tracked`` records whether the run that WROTE the checkpoint was
    tracking the objective (``compute_obj_each_iter``). Grouped-dispatch
    runs never track it, so their checkpoints carry an empty history by
    construction, not by loss — a resume that wants objective-based
    stopping can then be warned instead of silently trusting an empty
    list.
    """
    W: Any
    T: Any
    iteration: int
    obj_history: list
    key: Any
    resets_left: int
    random_state: int
    obj_tracked: bool = True
    # HER extrapolation state (nmf(accel='her')): dict with keys
    # Wy/Ty (extrapolated factors), beta (momentum), e (last accepted
    # objective), Wb/Tb/eb (best accepted iterate) — present iff the run
    # that wrote the checkpoint was extrapolating, so a resumed HER run
    # continues the momentum sequence AND the best-iterate selection
    # exactly (resume ≡ straight run). Checkpoints written before
    # best-iterate tracking lack Wb/Tb/eb; the driver seeds them from
    # the checkpointed factors on restore.
    her: Optional[dict] = None
    # early-stopping comparison score (the driver's ``last_score``) as of
    # this checkpoint — restoring it keeps resumed ≡ straight for
    # early-stop fits (a fresh np.inf would miss the stop+rollback the
    # straight run performs at the first post-resume score increase)
    es_score: Optional[float] = None

    def tree(self):
        # an empty history is padded with one NaN and its true length
        # stored alongside (the tree keeps fixed-rank entries)
        oh = np.asarray(self.obj_history, np.float64)
        if oh.size == 0:
            oh = np.asarray([np.nan], np.float64)
        t = {
            'W': self.W,
            'T': self.T,
            'iteration': np.asarray(self.iteration, np.int64),
            'obj_history': oh,
            'obj_history_len': np.asarray(len(self.obj_history), np.int64),
            'key': jax.random.key_data(self.key)
            if hasattr(jax.random, 'key_data') else self.key,
            'resets_left': np.asarray(self.resets_left, np.int32),
            'random_state': np.asarray(self.random_state, np.int64),
            'obj_tracked': np.asarray(self.obj_tracked, np.bool_),
        }
        if self.her is not None:
            # flattened so the sharded-restore abstract tree can give the
            # factor-shaped entries the run's W/T shardings
            for k in sorted(self.her):
                t['her_' + k] = self.her[k]
        if self.es_score is not None:
            t['es_score'] = np.asarray(self.es_score, np.float64)
        return t

    @classmethod
    def from_tree(cls, tree):
        key = tree['key']
        key = jax.numpy.asarray(np.asarray(key, dtype=np.uint32))
        oh = np.asarray(tree['obj_history'])
        oh_len = int(tree.get('obj_history_len', oh.size))
        her = {k[len('her_'):]: v for k, v in tree.items()
               if k.startswith('her_')} or None
        return cls(
            W=tree['W'], T=tree['T'],
            iteration=int(tree['iteration']),
            obj_history=list(oh[:oh_len]),
            key=key,
            resets_left=int(tree['resets_left']),
            random_state=int(tree['random_state']),
            obj_tracked=bool(tree.get('obj_tracked', True)),
            her=her,
            es_score=(float(tree['es_score'])
                      if 'es_score' in tree else None))


_STEP_FILE = re.compile(r'^step_(\d+)\.npz$')


def _host(a):
    """Host copy of a (possibly process-spanning) array."""
    if isinstance(a, jax.Array) and not a.is_fully_addressable:
        if a.is_fully_replicated:
            return np.asarray(a.addressable_data(0))
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)


class NMFCheckpointer:
    """Checkpoint manager for NMF training state: one ``step_<n>.npz``
    file per saved step in ``directory``, the newest ``keep`` retained.

    Usage::

        ckpt = NMFCheckpointer('/path/to/ckpts', keep=3)
        ckpt.save(step, state)            # synchronous, atomic
        state = ckpt.restore()            # latest, or restore(step)
        soln = nmf(X, k, W_in=state.W, T_in=state.T, ...)  # warm resume

    In a multi-process run every process calls :meth:`save` (sharded
    arrays are gathered collectively), process 0 writes, and all
    processes wait for the write before going on; ``directory`` must be
    visible to every process.
    """

    def __init__(self, directory, keep=3):
        self.directory = os.fspath(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.directory, 'step_%d.npz' % step)

    def steps(self):
        """Saved steps, ascending."""
        return sorted(int(m.group(1)) for m in
                      map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: NMFState, wait: bool = False):
        """Write ``state`` as ``step``. Saves are synchronous; ``wait`` is
        accepted for callers written against asynchronous managers."""
        arrays, dtypes = {}, {}
        for key, value in state.tree().items():
            a = _host(value)
            if type(a.dtype).__module__ != 'numpy':
                # extension dtypes (bfloat16) travel as raw bits
                dtypes[key] = str(a.dtype)
                a = a.view('u%d' % a.dtype.itemsize)
            arrays[key] = a
        arrays['__dtypes__'] = np.asarray(json.dumps(dtypes))
        if jax.process_index() == 0:
            path = self._path(step)
            tmp = path + '.partial'
            with open(tmp, 'wb') as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            for old in self.steps()[:-self.keep] if self.keep > 0 else ():
                os.remove(self._path(old))
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices('nmf_checkpoint_%d' % step)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                shardings: Optional[dict] = None) -> Optional[NMFState]:
        """Restore a step (default: latest; None when there is none).

        Pass ``shardings`` (a dict mapping tree keys — usually 'W'/'T' —
        to ``jax.sharding.Sharding``) to restore those entries directly as
        ``jax.Array``s laid out on the mesh, each device taking only its
        own slice of the host copy."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        with np.load(self._path(step)) as f:
            tree = {key: f[key] for key in f.files}
        dtypes = json.loads(str(tree.pop('__dtypes__')))
        for key, name in dtypes.items():
            tree[key] = tree[key].view(jax.numpy.dtype(name))
        for key, sharding in (shardings or {}).items():
            if key in tree and sharding is not None:
                a = tree[key]
                tree[key] = jax.make_array_from_callback(
                    a.shape, sharding, lambda idx, a=a: a[idx])
        return NMFState.from_tree(tree)

    def close(self):
        """Nothing to release: every save completed before it returned."""
