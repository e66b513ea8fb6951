"""Native (C++/OpenMP) host data-path kernels with NumPy fallback.

The device compute path is JAX/XLA/Pallas; this is the *runtime around it*:
host-side data preparation that would otherwise serialize fits behind
scipy materializations (the reference's COO→dense+mask construction,
``sklearn_interface.py:78-102``). The library is compiled on first use
with the toolchain baked into the image (g++, ``-O3 -fopenmp``), cached
next to the source, and bound via ``ctypes`` (no pybind11 in the image).
Every entry point has a NumPy fallback so the package works without a
compiler.
"""

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / 'coo_dense.cpp'
_SO = Path(__file__).parent / '_nmfdata.so'
_lock = threading.Lock()
_lib = None
_tried = False

# Must match nmfdata_abi_version() in coo_dense.cpp. A stale .so with a
# surviving mtime (archived copies, rsync -t) may export other functions
# or other signatures than the bindings below declare.
_ABI_VERSION = 3


def _build():
    # compile to a UNIQUE temp name and rename into place: dlopen caches
    # by dev/inode, so overwriting the .so in place (same inode) would
    # make the post-rebuild CDLL return the already-loaded stale handle —
    # and a FIXED temp name would let concurrent first-use processes
    # (multihost launches) interleave g++ writes into one file and
    # os.replace a corrupt library into place. mkstemp + atomic replace:
    # every completed build is self-consistent; last writer wins.
    import tempfile
    fd, tmppath = tempfile.mkstemp(suffix='.so.tmp', prefix='_nmfdata_',
                                   dir=str(_SO.parent))
    os.close(fd)
    try:
        cmd = ['g++', '-O3', '-march=native', '-fopenmp', '-shared',
               '-fPIC', str(_SRC), '-o', tmppath]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmppath, _SO)
    finally:
        if os.path.exists(tmppath):
            os.unlink(tmppath)


def _cdll_unique(so_path):
    """CDLL through a unique temp copy: dlopen caches by PATHNAME (glibc
    compares l_name before stat'ing), so re-CDLL'ing the canonical path
    after a rebuild would hand back the stale handle. The mapping
    survives the unlink."""
    import shutil
    import tempfile
    fd, tmppath = tempfile.mkstemp(suffix='.so', prefix='_nmfdata_')
    os.close(fd)
    try:
        shutil.copy2(so_path, tmppath)
        return ctypes.CDLL(tmppath)
    finally:
        os.unlink(tmppath)


def _abi_ok(lib):
    try:
        fn = lib.nmfdata_abi_version
    except AttributeError:          # pre-versioning library
        return False
    fn.restype = ctypes.c_int64
    fn.argtypes = []
    return fn() == _ABI_VERSION


def _load():
    """Compile (once) and load the shared library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _build()
            try:
                lib = ctypes.CDLL(str(_SO))
            except OSError:
                # a corrupt cached .so (crashed/interrupted earlier build)
                # must not pin the NumPy slow path forever: rebuild once
                # and load through a unique temp path
                logger.info('cached native library failed to load; '
                            'rebuilding')
                _build()
                lib = _cdll_unique(_SO)
            if not _abi_ok(lib):
                # stale binary (mtime lied) — rebuild from source and load
                # through a unique temp path (the canonical .so on disk is
                # correct for future processes)
                logger.info('native library ABI mismatch; rebuilding')
                _build()
                lib = _cdll_unique(_SO)
                if not _abi_ok(lib):
                    raise RuntimeError(
                        'rebuilt native library still reports a foreign '
                        'ABI version')
            lib.coo_to_dense_mask.restype = ctypes.c_int
            lib.coo_to_dense_mask.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
            lib.column_df.restype = None
            lib.column_df.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
        except Exception as e:  # no compiler / load failure -> fallback
            logger.info('native data-path unavailable (%s); using NumPy '
                        'fallback', e)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def coo_to_dense_mask(rows, cols, vals, n, d):
    """COO triples → (X float32 (n,d), M float32 (n,d)) in one parallel
    pass. Native when available, NumPy otherwise.

    Duplicate (i, j) triples accumulate and the mask is the final nonzero
    pattern — matching the reference's ``coo_matrix(...).toarray()`` +
    ``Xtr.nonzero()`` construction (``sklearn_interface.py:78-102``)."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    lib = _load()
    if lib is not None:
        X = np.empty((n, d), dtype=np.float32)
        M = np.empty((n, d), dtype=np.float32)
        rc = lib.coo_to_dense_mask(
            _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
            _ptr(vals, ctypes.c_double), len(vals), n, d,
            _ptr(X, ctypes.c_float), _ptr(M, ctypes.c_float))
        if rc != 0:
            raise ValueError('COO indices out of range for shape (%d, %d)'
                             % (n, d))
        return X, M
    if len(rows) and (rows.min() < 0 or rows.max() >= n or
                      cols.min() < 0 or cols.max() >= d):
        raise ValueError('COO indices out of range for shape (%d, %d)'
                         % (n, d))
    X = np.zeros((n, d), dtype=np.float32)
    np.add.at(X, (rows, cols), vals.astype(np.float32))
    M = (X != 0).astype(np.float32)
    return X, M


def _int_flag(a):
    """(array, is32 flag) for an int index array; int64-normalize others."""
    if a.dtype == np.int32:
        return np.ascontiguousarray(a), 1
    return np.ascontiguousarray(a, dtype=np.int64), 0


def column_df(X):
    """Per-column document frequency of a dense count matrix (the tfidf
    host path, :func:`rri_nmf_tpu.matrixops.tfidf`)."""
    lib = _load()
    if lib is not None:
        # the f64 contiguous copy is only the NATIVE call's ABI need —
        # the NumPy fallback works on the original array (the copy is
        # 2x a float32 matrix's RAM for nothing)
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, d = X.shape
        df = np.empty((d,), dtype=np.int64)
        lib.column_df(_ptr(X, ctypes.c_double), n, d,
                      _ptr(df, ctypes.c_int64))
        return df
    return (np.asarray(X) > 0).sum(0).astype(np.int64)
