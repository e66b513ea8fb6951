"""Generate per-module API reference pages from the package docstrings.

The reference ships Sphinx autodoc HTML over its five modules
(``/root/reference/doc/docs/source/rri_nmf.rst``); this is the rebuild's
equivalent: one markdown page per public module, extracted from the live
package (module docstring, then every public function/class with its
signature and docstring), written to ``docs/api/<module>.md``.

Run from the repo root::

    python docs/gen_api.py

The output is checked in so the docs are readable without running
anything; re-run after changing any public docstring.
"""

import importlib
import inspect
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault('XLA_FLAGS', '')

import jax  # noqa: E402

# the pages are read from the live package on the CPU backend
jax.config.update('jax_platforms', 'cpu')

MODULES = [
    'rri_nmf_tpu',
    'rri_nmf_tpu.nmf',
    'rri_nmf_tpu.optimization',
    'rri_nmf_tpu.initialization',
    'rri_nmf_tpu.matrixops',
    'rri_nmf_tpu.metrics',
    'rri_nmf_tpu.checkpoint',
    'rri_nmf_tpu.sklearn_interface',
    'rri_nmf_tpu.ops.sweep_xla',
    'rri_nmf_tpu.ops.dense_phase',
    'rri_nmf_tpu.ops.capability',
    'rri_nmf_tpu.ops.sweep_sparse',
    'rri_nmf_tpu.ops.sweep_masked_sparse',
    'rri_nmf_tpu.ops.sweep_masked_gram',
    'rri_nmf_tpu.ops.quantized',
    'rri_nmf_tpu.ops.accel',
    'rri_nmf_tpu.parallel.mesh',
    'rri_nmf_tpu.parallel.multihost',
    'rri_nmf_tpu.parallel.sharded_dense',
    'rri_nmf_tpu.parallel.sparse_mesh',
    'rri_nmf_tpu.parallel.masked_sparse_mesh',
    'rri_nmf_tpu.parallel.masked_gram_mesh',
    'rri_nmf_tpu.utils.debug',
    'rri_nmf_tpu.utils.profiling',
    'rri_nmf_tpu.native',
]

OUT = Path(__file__).resolve().parent / 'api'


def _public_members(mod):
    names = getattr(mod, '__all__', None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith('_')]
    for name in names:
        obj = getattr(mod, name, None)
        if obj is None:
            continue
        # only document what this module defines (skip re-exports of
        # other documented modules and third-party imports)
        owner = getattr(obj, '__module__', mod.__name__)
        if inspect.ismodule(obj):
            continue
        if owner != mod.__name__ and mod.__name__ != 'rri_nmf_tpu':
            continue
        # unwrap functools wrappers (lru_cache'd sweep factories) so they
        # document like plain functions instead of being skipped
        unwrapped = inspect.unwrap(obj)
        if not (inspect.isfunction(unwrapped) or inspect.isclass(unwrapped)):
            continue
        yield name, unwrapped


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return '(...)'


def _doc(obj):
    d = inspect.getdoc(obj)
    return d.rstrip() if d else '*No docstring.*'


def render(modname):
    mod = importlib.import_module(modname)
    lines = ['# `%s`' % modname, '']
    lines += [_doc(mod), '']
    for name, obj in _public_members(mod):
        kind = 'class' if inspect.isclass(obj) else 'def'
        lines += ['## `%s %s%s`' % (kind, name, _signature(obj)), '']
        lines += [_doc(obj), '']
        if inspect.isclass(obj):
            for mname, meth in sorted(vars(obj).items()):
                if mname.startswith('_') or not inspect.isfunction(meth):
                    continue
                lines += ['### `%s.%s%s`' % (name, mname,
                                             _signature(meth)), '']
                lines += [_doc(meth), '']
    return '\n'.join(lines) + '\n'


def main():
    OUT.mkdir(exist_ok=True)
    index = ['# API reference', '',
             'Generated by `docs/gen_api.py` from the package docstrings '
             '(the autodoc equivalent of the reference\'s Sphinx pages). '
             'For the narrative API guide see [`../api.md`](../api.md).',
             '']
    for modname in MODULES:
        page = render(modname)
        fname = modname.replace('.', '_') + '.md'
        (OUT / fname).write_text(page)
        first = page.split('\n\n', 2)[1].split('\n')[0].strip()
        index.append('- [`%s`](%s) — %s' % (modname, fname, first))
        print('wrote', OUT / fname)
    (OUT / 'README.md').write_text('\n'.join(index) + '\n')
    print('wrote', OUT / 'README.md')


if __name__ == '__main__':
    main()
