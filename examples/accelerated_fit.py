"""HER-accelerated fits: breaking the ill-conditioned plateau.

Plain RRI/HALS converges linearly with a rate set by the data's
conditioning; on mean-dominated data (U[0,1]-like factors — most count
and rating matrices) every solver, including the reference in float64,
stalls around 1e-3 relative error for thousands of sweeps.
``accel='her'`` (Ang & Gillis
2019 extrapolation with objective-checked restarts, the rebuild's
net-new answer) roughly halves the error at equal sweeps — dense or
masked, one device or a mesh, and its momentum state rides checkpoints
(resumed ≡ straight).

Run: python examples/accelerated_fit.py
"""

import sys
from pathlib import Path


import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rri_nmf_tpu.nmf import nmf

N, D, K = 1024, 512, 16


def rel_err(X, s, M=None):
    R = X - s['W'] @ s['T']
    if M is not None:
        R = M * R
        X = M * X
    return np.linalg.norm(R) / np.linalg.norm(X)


def main():
    rng = np.random.RandomState(0)
    X = rng.rand(N, K) @ rng.rand(K, D)       # the plateau class

    kw = dict(k=K, random_state=0, early_stop=False, eps_stop=0.0,
              update_order='phase', reset_topic_method=None, max_iter=150)
    plain = nmf(X, **kw)
    her = nmf(X, accel='her', **kw)
    print('dense, 150 sweeps:  plain %.3e   her %.3e'
          % (rel_err(X, plain), rel_err(X, her)))

    # masked (recommender) class: the restart check uses the masked
    # objective; the error on OBSERVED entries is what improves
    M = (rng.rand(N, D) < 0.3).astype(float)
    kwm = dict(k=K, random_state=0, early_stop=False, eps_stop=0.0,
               reset_topic_method=None, max_iter=80, W_mat=M)
    mp = nmf(X, **kwm)
    mh = nmf(X, accel='her', **kwm)
    print('masked, 80 sweeps:  plain %.3e   her %.3e'
          % (rel_err(X, mp, M), rel_err(X, mh, M)))

    # estimators take it through nmf_kwargs (overrides the preset;
    # dropped automatically from the fixed-T transform presets). The TM
    # preset fits row-stochastic factors, so hand it row-normalized data.
    from rri_nmf_tpu.sklearn_interface import NMF_TM_Estimator
    Xn = X / X.sum(axis=1, keepdims=True)
    est = NMF_TM_Estimator(N, D, K, random_state=0, max_iter=40,
                           nmf_kwargs=dict(accel='her',
                                           reset_topic_method=None))
    est.fit(Xn)
    print('TM estimator with accel via nmf_kwargs: R^2 = %.4f'
          % est.score(Xn))


if __name__ == '__main__':
    main()
