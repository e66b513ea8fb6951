"""Topic modeling with simplex-constrained RRI-NMF.

Run: python examples/topic_modeling.py  (CPU or GPU)
"""

import sys
from pathlib import Path


import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rri_nmf_tpu.matrixops import normalize, tfidf
from rri_nmf_tpu.sklearn_interface import NMF_TM_Estimator


def synthetic_corpus(n_docs=500, n_words=1000, n_topics=8, seed=0):
    rng = np.random.RandomState(seed)
    topics = rng.dirichlet(np.full(n_words, 0.05), size=n_topics)
    theta = rng.dirichlet(np.full(n_topics, 0.2), size=n_docs)
    X = np.vstack([rng.multinomial(120, p) for p in theta @ topics])
    return X.astype(float)


def main():
    counts = synthetic_corpus()
    X = np.asarray(normalize(tfidf(counts)))
    n, d = X.shape
    k = 8

    model = NMF_TM_Estimator(n, d, k, random_state=0, max_iter=30,
                             nmf_kwargs={'compute_obj_each_iter': True})
    model.fit(X)

    oh = model.nmf_outputs['obj_history']
    print('objective: %.4f -> %.4f over %d iterations (monotone: %s)'
          % (oh[0], oh[-1], len(oh), bool(np.all(np.diff(oh) <= 0))))
    print('doc-topic rows sum to 1:',
          np.allclose(np.asarray(model.W).sum(1), 1.0, atol=1e-8))

    scores = model.score_all(X, X_counts=counts)
    for name, val in scores.items():
        print('%-22s %.4f' % (name, val))

    top_words = np.argsort(-np.asarray(model.T), axis=1)[:, :6]
    print('top word ids per topic:')
    for t, words in enumerate(top_words):
        print('  topic %d: %s' % (t, words.tolist()))


if __name__ == '__main__':
    main()
