"""Non-negative Matrix Factorization by Rank-one Residue Iterations in JAX.

A from-scratch JAX/XLA/Pallas/pjit implementation with the capabilities of the
reference library ``maksimt/rri_nmf`` (see /root/reference): RRI (Ho's thesis
Alg. 7) and masked WRRI (Alg. 10) coordinate-descent NMF with simplex
constraints, L1/L2 regularization, NNDSVD/random initialization, topic resets,
a differential-privacy hook, and sklearn-style estimators.

Public module layout mirrors the reference package
(``rri_nmf/__init__.py:1-8``) so users can switch imports 1:1:

- :mod:`rri_nmf_tpu.matrixops`      — projections / normalization / tfidf
- :mod:`rri_nmf_tpu.optimization`   — qf_min subproblem solver + stopping rules
- :mod:`rri_nmf_tpu.initialization` — NNDSVD family, random, coherence init
- :mod:`rri_nmf_tpu.nmf`            — the ``nmf()`` driver
- :mod:`rri_nmf_tpu.sklearn_interface` — NMF_TM_Estimator / NMF_RS_Estimator
- :mod:`rri_nmf_tpu.parallel`       — GSPMD mesh sharding for multi-chip runs
- :mod:`rri_nmf_tpu.ops`            — jitted sweep kernels (XLA + Pallas)
"""

from rri_nmf_tpu import matrixops
from rri_nmf_tpu import optimization
from rri_nmf_tpu import initialization
from rri_nmf_tpu import nmf
from rri_nmf_tpu import sklearn_interface

__all__ = [
    'nmf', 'initialization', 'optimization', 'matrixops', 'sklearn_interface',
]

__version__ = '0.1.0'
