"""Large dense fits: mixed storage + checkpointing.

The capacity recipe for the BASELINE #4 class (100k x 50k, k=256 — a
20 GB f32 matrix):

- ``x_dtype='bfloat16'`` stores X at half residency while the factors,
  accumulators, and Gauss-Seidel topic loops stay full float32;
- ``update_order='phase'`` runs the two X GEMMs per sweep plus the
  Gauss-Seidel topic-loop kernel on a GPU;
- ``checkpoint=`` makes long fits resumable (``.npz`` steps; factors are
  gathered on save and laid back onto a mesh on restore).

Run: python examples/large_dense.py  (sized down so CPU works too;
raise N/D on a GPU.)
"""

import sys
import tempfile
from pathlib import Path


import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rri_nmf_tpu.nmf import nmf

N, D, K = 2048, 1024, 32        # 100000, 50000, 256 on a GPU


def main():
    rng = np.random.RandomState(0)
    X = rng.rand(N, K) @ rng.rand(K, D)   # exactly rank-K, well-posed

    ck = tempfile.mkdtemp(prefix='rri_nmf_large_')
    soln = nmf(
        X, K,
        dtype='float32', x_dtype='bfloat16',   # mixed storage
        update_order='phase', reset_topic_method=None,
        max_iter=60, random_state=0,
        checkpoint=ck, checkpoint_every=20,
        compute_obj_each_iter=True)

    rel = (np.linalg.norm(X - soln['W'] @ soln['T'])
           / np.linalg.norm(X))
    print('factors: W %s %s, T %s %s' %
          (soln['W'].shape, soln['W'].dtype,
           soln['T'].shape, soln['T'].dtype))
    print('rel Frobenius error after %d sweeps: %.3e'
          % (len(soln['obj_history']), rel))
    print('objective %.4f -> %.4f (monotone: %s)'
          % (soln['obj_history'][0], soln['obj_history'][-1],
             bool(np.all(np.diff(soln['obj_history']) <= 1e-6))))
    print('checkpoints in %s — rerunning the same call resumes' % ck)


if __name__ == '__main__':
    main()
