"""Test fixtures, ported from the reference suite (tests/conftest.py there).

Environment: tests run on CPU with float64 enabled (the reference is
float64 NumPy; the monotone-descent and 1e-13 feasibility tolerances need
it) and 8 virtual XLA host devices so the GSPMD sharding tests exercise a
real multi-device mesh without accelerator hardware.

Tests marked ``gpu`` need a card and skip elsewhere (the ``gpu`` fixture
decides at run time). ``chip_smoke.py`` runs them on the card in its own
process with ``RRI_NMF_TESTS_ON_DEVICE=1``, which leaves the backend to
JAX instead of forcing the CPU.

The golden W/T values for the NNDSVD init test are the reference's byte
blobs (`tests/conftest.py:12-18` there, Python-2 ``np.fromstring``) decoded
to float64 literals. The .npz data files are the reference's own fixtures
(data, not code).
"""

import os
import re
from pathlib import Path

ON_DEVICE = os.environ.get('RRI_NMF_TESTS_ON_DEVICE') == '1'

if not ON_DEVICE:
    os.environ['JAX_PLATFORMS'] = 'cpu'
    _flags = os.environ.get('XLA_FLAGS', '')
    _m = re.search(r'--xla_force_host_platform_device_count=(\d+)', _flags)
    if _m is None:
        os.environ['XLA_FLAGS'] = (
            _flags + ' --xla_force_host_platform_device_count=8').strip()
    elif int(_m.group(1)) < 8:
        # a pre-existing LOWER count (e.g. left over from another
        # harness) would silently skip every requires_8_devices mesh test
        # — the suite would go green with zero multi-device coverage
        os.environ['XLA_FLAGS'] = _flags.replace(
            _m.group(0), '--xla_force_host_platform_device_count=8')
    # silence XLA:CPU AOT cache-load machine-feature chatter (the
    # 'prefer-no-scatter/gather' pseudo-features trip a spurious mismatch
    # warning on every persistent-cache hit). Level 2 filters WARNING and
    # below but keeps genuine XLA ERRORs visible.
    os.environ.setdefault('TF_CPP_MIN_LOG_LEVEL', '2')

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)

# Persistent XLA compilation cache: the suite's wall-clock is dominated by
# jit compiles of distinct SweepConfigs. The first run pays them once;
# every rerun loads compiled programs from disk. JAX_COMPILATION_CACHE_DIR
# names the directory when set; otherwise it is the fixed in-repo path
# .cache/jax_compile.
_cache = os.environ.get('JAX_COMPILATION_CACHE_DIR') or str(
    Path(__file__).resolve().parent.parent / '.cache' / 'jax_compile')


def _sanitize_compile_cache(cache_dir):
    """Prune truncated/corrupt persistent-cache entries before jax reads any.

    A process killed mid-cache-write leaves a short-read zstd file; jax's
    reader decompresses the partial payload without noticing (stream ends
    before the frame does) and SEGFAULTS deserializing the truncated
    executable (`compilation_cache.get_executable_and_time`). Entries
    whose zstd stream either raises or ends without reaching end-of-frame
    (``decompressobj().eof`` False) are deleted; jax then recompiles and
    rewrites them. Full scan of a warm ~25 MB cache costs ~1 s.
    """
    import zstandard
    for entry in Path(cache_dir).iterdir():
        if not entry.is_file():
            continue
        try:
            blob = entry.read_bytes()
            dec = zstandard.ZstdDecompressor().decompressobj()
            dec.decompress(blob)
            ok = dec.eof
        except Exception:
            ok = False
        if not ok:
            try:
                entry.unlink()
            except OSError:
                pass


if Path(_cache).is_dir() and not ON_DEVICE:
    _sanitize_compile_cache(_cache)
jax.config.update('jax_compilation_cache_dir', _cache)
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)
jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse  # noqa: E402

from rri_nmf_tpu.matrixops import normalize, tfidf  # noqa: E402

DATA_DIR = Path(__file__).parent / 'data'

# Cap on /proc/self/maps entries before jax's in-memory executable caches
# are flushed (see pytest_runtest_teardown below). The kernel default
# vm.max_map_count is 65530; a full-suite burst between teardown checks
# adds well under 10k maps, so 40k leaves ample headroom.
_MAP_GUARD_THRESHOLD = int(os.environ.get('RRI_NMF_MAP_GUARD', '40000'))


def _map_count():
    try:
        with open('/proc/self/maps', 'rb') as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux: guard disabled
        return 0


def pytest_runtest_teardown(item, nextitem):
    """Flush jax executable caches before the process hits vm.max_map_count.

    Root cause of the round-4 positional suite SIGSEGV (~437th of 441
    tests, always inside ``backend_compile_and_load``): XLA:CPU's LLVM JIT
    maps three anonymous regions (code/rodata/data) per compiled object,
    and jax retains every compiled executable in its in-memory caches for
    the life of the process. A full suite run accumulates ~60k mappings,
    crosses the kernel's default ``vm.max_map_count`` (65530), and the
    next mmap failure segfaults LLVM mid-compile — positional, not
    test-specific. ``jax.clear_caches()`` releases the executables and
    their JIT mappings (measured 13.5k -> 1.6k); the persistent compile
    cache makes the subsequent reloads cheap, so we only clear when close
    to the limit.
    """
    if _map_count() > _MAP_GUARD_THRESHOLD:
        jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a GPU; skips elsewhere (chip_smoke.py runs '
        'these on the card)')


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test at
    run time, never at import: the suite's workers must all collect the
    same tests)."""
    if jax.default_backend() != 'gpu':
        pytest.skip('needs a GPU (backend is %s)' % jax.default_backend())
    return jax.devices()[0]


@pytest.fixture(scope='session')
def small_X_W_T():
    X = np.array([[1.0, 0.0],
                  [0.5, 0.5],
                  [0.25, 0.75]])
    # decoded from the reference's np.fromstring golden bytes
    Wt = np.frombuffer(
        b'\xb9X\x18pb\xbd\xe8?\x00\x00\x00\x00\x00\x00\x00\x00\x114#('
        b'e\x8c\xe3?%\x86\x8c"D\x08\xcd?\xbd\xa1('
        b'\x84\xe6\xf3\xe0?\xbc\xad\x84\xb3f\xec\xe4?',
        dtype=np.float64).reshape(3, 2)
    Tt = np.frombuffer(
        b'\x04\x89=\x03\x95\xf6\xee?v)\xdfe\xf9\xf7\xe1?\x00\x00\x00\x00'
        b'\x00\x00\x00\x00l\x8d.\xd8\x84%\xe6?',
        dtype=np.float64).reshape(2, 2)
    return X, Wt, Tt


def _tm_xform(X):
    return np.asarray(normalize(tfidf(X)))


@pytest.fixture(scope='session')
def text_train():
    X = scipy.sparse.load_npz(DATA_DIR / 'text_data_train.npz')
    return _tm_xform(X.toarray())


@pytest.fixture(scope='session')
def text_test():
    X = scipy.sparse.load_npz(DATA_DIR / 'text_data_test.npz')
    return _tm_xform(X.toarray())


@pytest.fixture(scope='session')
def recsys_train():
    X = scipy.sparse.load_npz(DATA_DIR / 'recsys_data_train.npz')
    return X.toarray()


@pytest.fixture(scope='session')
def recsys_test():
    X = scipy.sparse.load_npz(DATA_DIR / 'recsys_data_test.npz')
    return X.toarray()
