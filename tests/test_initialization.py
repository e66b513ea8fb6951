"""Initialization tests: RNG parity, NNDSVD variants, masked SVD, coherence."""

import numpy as np
import pytest

from rri_nmf_tpu.initialization import (
    initialize_nmf, masked_svd_init, randomized_svd_jax,
)


def _data(n=30, d=20, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d))


def test_random_init_rng_parity():
    """'random' must reproduce the NumPy RandomState stream the reference
    uses (reference ``initialization.py:80-87``: T drawn before W)."""
    W, T = initialize_nmf(np.ones((5, 7)), 3, init='random', random_state=42)
    rng = np.random.RandomState(42)
    T_exp = rng.rand(3, 7)
    W_exp = rng.rand(5, 3)
    assert np.allclose(T, T_exp)
    assert np.allclose(W, W_exp)


def test_smart_random_scaling():
    X = _data()
    W, T = initialize_nmf(X, 4, init='smart_random', random_state=0)
    avg = np.sqrt(X.mean() / 4)
    assert np.all(W >= 0) and np.all(T >= 0)
    # scaled |N(0,1)|: mean magnitude ~ avg * sqrt(2/pi)
    assert 0.3 * avg < W.mean() < 2.0 * avg


def test_default_init_dispatch():
    X = _data()
    W1, T1 = initialize_nmf(X, 4, init=None, random_state=0)   # -> nndsvd
    W2, T2 = initialize_nmf(X, 4, init='nndsvd', random_state=0)
    assert np.allclose(W1, W2) and np.allclose(T1, T2)


@pytest.mark.parametrize('variant', ['nndsvda', 'nndsvdar'])
def test_nndsvd_zero_filling(variant):
    X = _data()
    W0, T0 = initialize_nmf(X, 4, init='nndsvd', random_state=0)
    W, T = initialize_nmf(X, 4, init=variant, random_state=0)
    # zeros filled, nonzeros unchanged
    assert np.all(W > 0) and np.all(T > 0)
    nz = W0 > 0
    assert np.allclose(W[nz], W0[nz])


def test_invalid_init_raises():
    with pytest.raises(ValueError):
        initialize_nmf(_data(), 4, init='not_a_method')


def test_row_normalize():
    X = _data()
    _, T = initialize_nmf(X, 4, init='nndsvd', random_state=0,
                          row_normalize=True)
    assert np.allclose(np.asarray(T).sum(1), 1.0, atol=1e-12)


def test_jax_svd_backend_close_to_exact():
    """The jittable randomized SVD reconstructs as well as the host SVD."""
    X = _data(n=40, d=25, k=5)
    W1, T1 = initialize_nmf(X, 5, init='nndsvd', random_state=0,
                            svd_backend='numpy')
    W2, T2 = initialize_nmf(X, 5, init='nndsvd', random_state=0,
                            svd_backend='jax')
    r1 = np.linalg.norm(X - np.asarray(W1) @ np.asarray(T1))
    r2 = np.linalg.norm(X - np.asarray(W2) @ np.asarray(T2))
    assert r2 < r1 * 1.05 + 1e-8


def test_randomized_svd_jax_accuracy():
    import jax
    X = _data(n=50, d=30, k=6)
    U, S, Vt = randomized_svd_jax(X, 6, jax.random.PRNGKey(0))
    Us, Ss, Vts = np.linalg.svd(X)
    assert np.allclose(np.asarray(S), Ss[:6], rtol=1e-6)
    recon = np.asarray(U) * np.asarray(S) @ np.asarray(Vt)
    exact = np.linalg.norm(X - (Us[:, :6] * Ss[:6]) @ Vts[:6])
    assert np.linalg.norm(X - recon) <= max(exact * (1 + 1e-6), 1e-10)


def test_masked_svd_init():
    """BIRSVD-style masked init recovers structure from observed entries
    only (the reference's unimplemented TODO, ``README.md:18``)."""
    rng = np.random.RandomState(0)
    Wg, Tg = np.abs(rng.rand(40, 3)), np.abs(rng.rand(3, 25))
    X_full = Wg @ Tg
    M = (rng.rand(40, 25) < 0.5).astype(float)
    W, T = masked_svd_init(X_full * M, M, 3, random_state=0)
    assert W.shape == (40, 3) and T.shape == (3, 25)
    assert np.all(W >= 0) and np.all(T >= 0)
    # reconstruction on observed entries beats the trivial mean baseline
    recon = W @ T
    obs = M > 0
    err = np.mean((recon[obs] - X_full[obs]) ** 2)
    base = np.mean((X_full[obs].mean() - X_full[obs]) ** 2)
    assert err < base


def test_coherence_pmi_reachable(text_train):
    """init='coherence_pmi' must dispatch (fixes reference dead code:
    documented at ``nmf.py:206-208`` but unreachable through
    ``initialization.py:154-157``)."""
    X = text_train
    W, T = initialize_nmf(X, 3, init='coherence_pmi', n_words_beam=5)
    W, T = np.asarray(W), np.asarray(T)
    assert W.shape == (X.shape[0], 3) and T.shape == (3, X.shape[1])
    assert np.allclose(T.sum(1), 1.0, atol=1e-12)
    # each topic selected 5 distinct words
    assert np.all((T > 0).sum(1) <= 5)


def test_jax_svd_backend_mean_dominated_no_dead_topics():
    """Regression: the Gram-eigh orthonormalization must FLOOR near-null
    eigenvalues, not hard-zero them. λ ratios are (σ/σmax)², so a clamp
    at c·ε kills every direction with σ < √(cε)·σmax — on mean-dominated
    matrices (uniform-factor products: σ2/σ1 ~ 1/400) an early 100ε cut
    dead-topiced 255/256 NNDSVD components. Pin: f32 exactly-rank-k
    mean-dominated X → zero dead topics, recon error matches the sklearn
    backend."""
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    n, d, k = 1024, 512, 32
    X = (rng.rand(n, k) @ rng.rand(k, d)).astype(np.float32)
    Wj, Tj = initialize_nmf(jnp.asarray(X), k, 'nndsvd', random_state=0,
                            svd_backend='jax')
    Ws, Ts = initialize_nmf(X.astype(np.float64), k, 'nndsvd',
                            random_state=0, svd_backend='numpy')
    assert int((np.asarray(Wj).sum(0) == 0).sum()) == 0
    ej = np.linalg.norm(X - np.asarray(Wj) @ np.asarray(Tj)) \
        / np.linalg.norm(X)
    es = np.linalg.norm(X - Ws @ Ts) / np.linalg.norm(X)
    assert abs(ej - es) < 0.02, (ej, es)


def test_nndsvd_lrc_beats_nndsvd_initial_error():
    """NNSVD-LRC (arXiv:1807.04020): half-rank SVD with BOTH ±-parts kept
    plus a low-rank HALS correction must produce a strictly better initial
    reconstruction than plain NNDSVD (the paper's headline claim), with
    nonnegative deterministic factors, on low-rank-plus-noise data."""
    for seed, (n, d, ktrue, k) in enumerate(
            [(300, 200, 10, 10), (400, 300, 8, 16)]):
        rng = np.random.RandomState(seed)
        X = np.abs(rng.rand(n, ktrue) @ rng.rand(ktrue, d)) \
            + 0.01 * rng.rand(n, d)
        Wa, Ha = initialize_nmf(X, k, 'nndsvd', random_state=0)
        Wb, Hb = initialize_nmf(X, k, 'nndsvd_lrc', random_state=0)
        assert Wb.shape == (n, k) and Hb.shape == (k, d)
        assert (Wb >= 0).all() and (Hb >= 0).all()
        xn = np.linalg.norm(X)
        ea = np.linalg.norm(X - Wa @ Ha) / xn
        eb = np.linalg.norm(X - Wb @ Hb) / xn
        assert eb < ea, 'lrc %.4f vs nndsvd %.4f' % (eb, ea)
        # deterministic
        Wb2, Hb2 = initialize_nmf(X, k, 'nndsvd_lrc', random_state=0)
        assert np.array_equal(Wb, Wb2) and np.array_equal(Hb, Hb2)


def test_nndsvd_lrc_jax_backend_close_to_host():
    """The jitted device path (randomized half-rank SVD + the shared
    Gram-blocked GS correction) must land at the same corrected error as
    the sklearn host path — the HALS correction absorbs SVD-backend
    differences."""
    rng = np.random.RandomState(1)
    X = np.abs(rng.rand(250, 180, ) ** 2)
    X = np.abs(rng.rand(250, 12) @ rng.rand(12, 180)) + 0.02 * X
    Wh, Hh = initialize_nmf(X, 12, 'nndsvd_lrc', random_state=0)
    Wj, Hj = initialize_nmf(X, 12, 'nndsvd_lrc', random_state=0,
                            svd_backend='jax')
    xn = np.linalg.norm(X)
    eh = np.linalg.norm(X - Wh @ Hh) / xn
    ej = np.linalg.norm(X - Wj @ Hj) / xn
    assert abs(eh - ej) < 0.05 * eh + 1e-3


def test_nndsvd_lrc_degenerate_rank_falls_back():
    """k near/above full rank: the half-rank construction cannot yield k
    candidates; the dispatcher must fall back to plain NNDSVD rather than
    crash (and still return valid factors)."""
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(9, 6))
    W, H = initialize_nmf(X, 6, 'nndsvd_lrc', random_state=0)
    assert W.shape == (9, 6) and H.shape == (6, 6)
    assert (W >= 0).all() and (H >= 0).all()


def test_nndsvd_lrc_fit_integration():
    """nmf(init='nndsvd_lrc') threads through the driver: monotone descent
    and a final error at least as good as the nndsvd-initialized fit at
    equal sweeps."""
    from rri_nmf_tpu.nmf import nmf
    rng = np.random.RandomState(2)
    X = np.abs(rng.rand(60, 8) @ rng.rand(8, 40)) + 0.01 * rng.rand(60, 40)
    kw = dict(k=6, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None)
    s_lrc = nmf(X, init='nndsvd_lrc', **kw)
    oh = s_lrc['obj_history']
    assert all(b <= a + 1e-9 for a, b in zip(oh, oh[1:]))
    s_std = nmf(X, init='nndsvd', **kw)
    assert oh[0] <= s_std['obj_history'][0] + 1e-9  # better start


def test_initialize_nmf_randomstate_jax_backend():
    """A np.random.RandomState seed works on the device SVD backends too
    (every host branch accepts it; the jax branches crashed in
    PRNGKey)."""
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(24, 5) @ rng.rand(5, 16))
    W, H = initialize_nmf(X, 3, 'nndsvd',
                          random_state=np.random.RandomState(0),
                          svd_backend='jax')
    assert W.shape == (24, 3) and np.isfinite(W).all()
    W2, H2 = initialize_nmf(X, 4, 'nndsvd_lrc',
                            random_state=np.random.RandomState(0),
                            svd_backend='jax')
    assert W2.shape == (24, 4) and np.isfinite(H2).all()


def test_initialize_nmf_k_exceeds_rank_raises():
    """nndsvd-family inits with n_components > min(n, d) used to return
    silently truncated factors; now a clear error points at
    init='random'."""
    X = np.abs(np.random.RandomState(0).rand(12, 8))
    with pytest.raises(ValueError, match='n_components'):
        initialize_nmf(X, 9, 'nndsvd')
    # random init supports overcomplete factorizations
    W, H = initialize_nmf(X, 9, 'random', random_state=0)
    assert W.shape == (12, 9) and H.shape == (9, 8)


@pytest.mark.parametrize('shape,k,sparse,dtype', [
    ((60, 40), 3, False, np.float64),
    ((30, 80), 10, False, np.float64),     # transposed path
    ((50, 50), 5, False, np.float32),
    ((70, 90), 4, True, np.float64),       # scipy sparse input
    ((200, 150), 10, False, np.float64),   # LU power iterations
])
def test_randomized_svd_matches_sklearn_bitwise(shape, k, sparse, dtype):
    """The NumPy/SciPy port of scikit-learn's randomized_svd returns the
    same bits: same draws, normalizer, SVD driver and sign rule (the
    NNDSVD goldens rest on it)."""
    extmath = pytest.importorskip('sklearn.utils.extmath')
    import scipy.sparse as sps
    from rri_nmf_tpu.initialization import randomized_svd
    rng = np.random.RandomState(sum(shape) + k)
    M = (sps.random(*shape, density=0.1, random_state=rng, format='csr')
         if sparse else rng.rand(*shape).astype(dtype))
    for seed in (0, 7):
        ref = extmath.randomized_svd(M, k, random_state=seed)
        got = randomized_svd(M, k, random_state=seed)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
