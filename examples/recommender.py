"""Recommender-system NMF: masked WRRI over (user, item, rating) triples.

The masked WRRI sweep runs as XLA on any backend.
Run: python examples/recommender.py
"""

import sys
from pathlib import Path


import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rri_nmf_tpu.sklearn_interface import NMF_RS_Estimator


def synthetic_ratings(n_users=600, n_items=400, n_obs=30000, k=6, seed=0):
    rng = np.random.RandomState(seed)
    scores = rng.rand(n_users, k) @ rng.rand(k, n_items)
    lo, hi = scores.min(), scores.max()
    scores = 1 + 4 * (scores - lo) / (hi - lo)
    I = rng.randint(0, n_users, n_obs)
    J = rng.randint(0, n_items, n_obs)
    R = np.clip(np.round(scores[I, J] + 0.3 * rng.randn(n_obs)), 1, 5)
    return np.stack([I, J], axis=1), R


def main():
    UI, ratings = synthetic_ratings()
    n_users, n_items = UI[:, 0].max() + 1, UI[:, 1].max() + 1

    est = NMF_RS_Estimator(n_users, n_items, k=12, random_state=0,
                           max_iter=25)
    est.fit(UI, ratings)

    preds = est.predict(UI[:10])
    print('first ratings   :', ratings[:10].astype(int).tolist())
    print('first predictions:', np.round(preds, 2).tolist())
    print('train RMSE: %.4f' % est.score(UI, y=ratings))
    print('iterations ran (validation early stop): %d'
          % len(est.nmf_outputs['obj_history']))


if __name__ == '__main__':
    main()
