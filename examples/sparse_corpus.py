"""Sparse-corpus factorization: X never materializes densely on the host.

The reference densifies sparse input (reference sklearn_interface.py:78-83)
— at web-corpus scale that is the difference between 60 MB and 6 GB of
host->device transfer, or between fitting and not fitting at all.

- ``sparse='auto'`` (default): the compressed matrix crosses the link; if
  the DENSE form fits device memory the driver densifies ON DEVICE (one
  O(nnz) scatter) and runs the dense phase sweep; otherwise it stays
  BCOO end to end.
- ``sparse=True``: pins O(nnz) memory end to end (the beyond-memory mode).

Run: python examples/sparse_corpus.py  (CPU or GPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


import numpy as np
import scipy.sparse as sp

from rri_nmf_tpu.nmf import nmf

rng = np.random.RandomState(0)
n, d, k = 3000, 2000, 16
# synthetic sparse counts: exactly rank-k with SPARSE factors, so the
# product is itself sparse (~2% density) and reconstructible
Wg = np.abs(rng.rand(n, k)) * (rng.rand(n, k) < 0.10)
Tg = np.abs(rng.rand(k, d)) * (rng.rand(k, d) < 0.15)
X = sp.csr_matrix(Wg @ Tg)
print('X: %dx%d, %.2f%% dense, %.1f MB compressed vs %.1f MB dense'
      % (n, d, 100 * X.nnz / (n * d), X.data.nbytes / 1e6,
         n * d * 8 / 1e6))

soln = nmf(X, k, max_iter=30, random_state=0,
           update_order='phase',          # sparse mode requires phase order
           reset_topic_method=None,       # and no residual-scanning resets
           compute_obj_each_iter=True)

oh = soln['obj_history']
# tolerance: on a GPU a plain f32 dot runs in TF32, so late
# near-converged sweeps can tick up by ~1e-6*obj0 (pass
# matmul_precision='highest' for strictly monotone descent there)
mono = bool(np.all(np.diff(oh) <= 1e-6 * abs(oh[0])))
print('objective %.4f -> %.4f over %d sweeps (monotone to roundoff: %s)'
      % (oh[0], oh[-1], len(oh), mono))
W, T = soln['W'], soln['T']
err = np.linalg.norm(X.toarray() - W @ T) / sp.linalg.norm(X)
print('relative reconstruction error: %.4f' % err)
