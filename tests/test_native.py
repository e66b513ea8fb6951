"""Native host data-path kernels vs their NumPy fallbacks."""

import numpy as np
import pytest

from rri_nmf_tpu import native


def test_native_builds():
    # the build image has g++; if this fails the fallback still works, but
    # we want to know
    assert native.available()


def test_coo_to_dense_mask():
    rows = np.array([0, 2, 1, 2])
    cols = np.array([1, 0, 3, 2])
    vals = np.array([5.0, 3.0, 4.0, 1.0])
    X, M = native.coo_to_dense_mask(rows, cols, vals, 3, 4)
    assert X.dtype == np.float32 and M.dtype == np.float32
    expected = np.zeros((3, 4))
    expected[rows, cols] = vals
    assert np.allclose(X, expected)
    assert np.allclose(M, (expected > 0))


def test_coo_large_random_matches_scipy():
    import scipy.sparse as sp
    rng = np.random.RandomState(0)
    nnz, n, d = 20000, 300, 400
    # unique positions (ratings data has no duplicates)
    pos = rng.choice(n * d, nnz, replace=False)
    rows, cols = pos // d, pos % d
    vals = rng.randint(1, 6, nnz).astype(float)
    X, M = native.coo_to_dense_mask(rows, cols, vals, n, d)
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(n, d)).toarray()
    assert np.allclose(X, ref)
    assert np.allclose(M, ref > 0)


def test_coo_out_of_range_raises():
    with pytest.raises(ValueError):
        native.coo_to_dense_mask(np.array([5]), np.array([0]),
                                 np.array([1.0]), 3, 4)


def test_column_df():
    X = np.array([[1.0, 0.0, 2.0], [0.0, 0.0, 3.0]])
    assert np.array_equal(native.column_df(X), [1, 0, 2])


def test_coo_duplicates_accumulate_like_scipy():
    """Duplicate (i, j) triples must SUM (scipy.sparse.coo_matrix semantics,
    reference sklearn_interface.py:78-83) and the mask must come from the
    final nonzero pattern (reference's Xtr.nonzero(), :100-102) — entries
    whose duplicates cancel to zero count as unobserved."""
    import scipy.sparse as sp
    rows = np.array([0, 0, 1, 1, 2, 2, 2])
    cols = np.array([1, 1, 0, 0, 3, 3, 3])
    vals = np.array([2.0, 3.0, 1.5, -1.5, 1.0, 1.0, 2.0])
    X, M = native.coo_to_dense_mask(rows, cols, vals, 3, 4)
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(3, 4)).toarray()
    assert np.allclose(X, ref)       # (0,1)=5, (1,0)=0 (cancelled), (2,3)=4
    assert np.allclose(M, ref != 0)  # cancelled entry is unobserved
    # NumPy fallback agrees with the native path
    import rri_nmf_tpu.native as nat
    lib = nat._load()
    if lib is not None:
        saved, nat._lib = nat._lib, None
        try:
            Xf, Mf = nat.coo_to_dense_mask(rows, cols, vals, 3, 4)
        finally:
            nat._lib = saved
        assert np.allclose(X, Xf) and np.allclose(M, Mf)


def test_stale_abi_library_rebuilt(tmp_path):
    """A width-incompatible _nmfdata.so whose mtime survived a copy must
    be detected by the ABI version check and rebuilt from source — the
    mtime guard alone cannot catch it, and a stale library may export
    other signatures than the bindings declare. Also exercises the
    pathname-cache workaround: dlopen caches by path string, so the fresh
    build is loaded through a unique temp path."""
    if not native.available():
        pytest.skip('no native library / compiler')
    import os
    import subprocess

    src = native._SRC.read_text()
    stale_src = src.replace('nmfdata_abi_version(void) { return 3; }',
                            'nmfdata_abi_version(void) { return 1; }')
    assert stale_src != src
    stale_cpp = tmp_path / 'stale.cpp'
    stale_cpp.write_text(stale_src)
    stale_so = tmp_path / 'stale.so'
    subprocess.run(['g++', '-O3', '-shared', '-fPIC', str(stale_cpp),
                    '-o', str(stale_so)], check=True)
    # replace the canonical .so atomically (new inode, fresh mtime) —
    # what an archived copy / rsync -t deploy looks like
    os.replace(stale_so, native._SO)
    os.utime(native._SO)

    native._lib = None
    native._tried = False
    try:
        assert native.available(), 'ABI mismatch should trigger a rebuild'
        df = native.column_df(np.array([[1.0, 0.0], [2.0, 0.0]]))
        assert df.tolist() == [2, 0]
    finally:
        # leave a good library + fresh loader state for later tests
        native._lib = None
        native._tried = False
        assert native.available()


def test_corrupt_library_rebuilt():
    """A corrupt cached .so (e.g. a crashed earlier build) must trigger a
    rebuild instead of pinning the NumPy fallback forever — the CDLL
    OSError previously escaped to the broad fallback except."""
    if not native.available():
        pytest.skip('no native library / compiler')
    import os
    native._SO.write_bytes(b'not an ELF library')
    os.utime(native._SO)
    native._lib = None
    native._tried = False
    try:
        assert native.available(), 'corrupt .so should be rebuilt'
        df = native.column_df(np.array([[1.0, 0.0], [2.0, 0.0]]))
        assert df.tolist() == [2, 0]
    finally:
        native._lib = None
        native._tried = False
        assert native.available()
