"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, fails
without the package beside it, and its phases pass end to end at tiny
shapes (``--rehearse``: the Gauss-Seidel kernel interpreted)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / 'chip_smoke.py'


def _run(args, cwd=ROOT, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
    env['JAX_PLATFORMS'] = 'cpu'
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_refuses_without_gpu():
    r = _run([str(SCRIPT)])
    assert r.returncode != 0
    assert 'no GPU' in r.stderr
    assert '"ok"' not in r.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SCRIPT, tmp_path / 'chip_smoke.py')
    r = _run([str(tmp_path / 'chip_smoke.py')], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize('extra', [[], ['--four']])
def test_rehearsal_passes(extra):
    r = _run([str(SCRIPT), '--rehearse'] + extra)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert out[-1] == 'rehearsal passed'
    assert not any('FAILED' in line for line in out)
    assert '"ok"' not in r.stdout
