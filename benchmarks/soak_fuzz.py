"""Soak runner for the randomized fuzz/differential draws.

Drives arbitrary seed ranges of the standalone draw functions the test
suite samples only a prefix of (tests/test_fuzz.py, test_consistency.py,
test_dense_oracle.py), with the suite's environment (CPU backend, 8
virtual devices, float64, persistent compile cache) set up the same way
tests/conftest.py does — so draws compile once and soak ranges rerun
warm.

Usage:
    python benchmarks/soak_fuzz.py --draw invariants --seeds 12 312
    python benchmarks/soak_fuzz.py --draw mesh --seeds 0 42
    python benchmarks/soak_fuzz.py --draw all --seeds 0 20
    python benchmarks/soak_fuzz.py --draw invariants --seed-list 27 65 96

Exit code 0 iff every draw passed; failures print the full traceback and
are summarized at the end (soak keeps going past failures).
"""

import argparse
import os
import sys
import tempfile
import traceback

# Environment BEFORE importing jax (mirrors tests/conftest.py).
os.environ['JAX_PLATFORMS'] = 'cpu'
_flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8').strip()
os.environ.setdefault('TF_CPP_MIN_LOG_LEVEL', '2')

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
# the suite's compile cache (tests/conftest.py): JAX_COMPILATION_CACHE_DIR
# when set, else the fixed in-repo .cache/jax_compile
_cache = os.environ.get('JAX_COMPILATION_CACHE_DIR') or os.path.join(
    os.path.abspath(os.path.join(os.path.dirname(__file__), '..')),
    '.cache', 'jax_compile')
jax.config.update('jax_compilation_cache_dir', _cache)
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)
jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)

_root = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, os.path.join(_root, 'tests'))
sys.path.insert(0, _root)


def _draws():
    import test_consistency
    import test_dense_oracle
    import test_fuzz
    import test_masked_gram_mesh
    import test_quantized

    def resume(seed):
        with tempfile.TemporaryDirectory() as td:
            test_fuzz.resume_parity_draw(seed, td)

    return {
        'invariants': test_fuzz.invariant_draw,
        'invariants_midsize': test_fuzz.invariant_midsize_draw,
        'estimator': test_fuzz.estimator_draw,
        'mesh': test_fuzz.mesh_parity_draw,
        'resume': resume,
        'sparse': test_fuzz.sparse_parity_draw,
        'stepped': test_fuzz.stepped_parity_draw,
        'masked_oracle': test_consistency.masked_oracle_draw,
        'quantized': test_quantized.quantized_draw,
        'dense_oracle': test_dense_oracle.test_dense_sweep_matches_oracle_randomized,
        'masked_gram_mesh': test_masked_gram_mesh.masked_gram_mesh_draw,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--draw', required=True,
                    choices=['invariants', 'invariants_midsize', 'estimator',
                             'mesh', 'resume', 'sparse', 'stepped',
                             'masked_oracle', 'dense_oracle', 'quantized',
                             'masked_gram_mesh', 'all'])
    ap.add_argument('--seeds', nargs=2, type=int, metavar=('START', 'END'),
                    help='half-open seed range [START, END)')
    ap.add_argument('--seed-list', nargs='+', type=int,
                    help='explicit seeds instead of a range')
    args = ap.parse_args()
    if bool(args.seeds) == bool(args.seed_list):
        ap.error('give exactly one of --seeds / --seed-list')
    seeds = (range(args.seeds[0], args.seeds[1]) if args.seeds
             else args.seed_list)

    table = _draws()
    names = list(table) if args.draw == 'all' else [args.draw]
    fails = []
    n_run = 0
    for name in names:
        fn = table[name]
        for seed in seeds:
            n_run += 1
            try:
                fn(seed)
                print('%s seed %d ok' % (name, seed), flush=True)
            except Exception:
                fails.append((name, seed))
                traceback.print_exc()
                print('%s seed %d FAIL' % (name, seed), flush=True)
    print('soak: %d draws, %d failures %s'
          % (n_run, len(fails), fails if fails else ''), flush=True)
    sys.exit(1 if fails else 0)


if __name__ == '__main__':
    main()
