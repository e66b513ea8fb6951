"""True multi-controller validation of the multi-host wiring.

``parallel/multihost.py`` was previously pinned only by single-process
contracts; these tests run a REAL 2-process ``jax.distributed`` group on
localhost (XLA:CPU gloo collectives, 4 virtual devices per process) and
drive the full public path — initialize_distributed, make_global_mesh
(the no-slice-metadata layout), process_row_block, distribute_dense /
distribute_factors, and ``nmf(mesh=...)`` end-to-end — then check

- both processes return bitwise-identical gathered results, and
- the multi-controller fit matches a single-controller oracle fit.

The driver's host materializations (result gather, early-stop snapshot
and rollback, diagnostics) go through ``process_allgather`` on
process-spanning arrays; config B exercises those paths explicitly.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = Path(__file__).parent / 'mp_worker.py'


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(tmp_path, nproc=2, timeout=540):
    port = _free_port()
    env = dict(os.environ)
    env['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    repo_root = str(WORKER.parent.parent)
    env['PYTHONPATH'] = repo_root + os.pathsep + env.get('PYTHONPATH', '')
    env.setdefault('TF_CPP_MIN_LOG_LEVEL', '2')
    env.pop('JAX_PLATFORMS', None)  # worker pins the cpu platform itself
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(i), str(nproc), str(port),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            'worker %d failed (rc=%s):\n%s' % (i, p.returncode, out[-4000:]))
    return outs


@pytest.fixture(scope='module')
def group_results(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp('mp')
    _run_group(tmp_path)
    return [np.load(tmp_path / ('result_%d.npz' % i)) for i in range(2)]


def test_two_process_results_agree_bitwise(group_results):
    r0, r1 = group_results
    for key in ('WA', 'TA', 'ohA', 'WB', 'TB', 'ohB',
                'WD', 'TD', 'ohD', 'WF', 'TF', 'ohF',
                'WG', 'TG', 'ohG', 'WH', 'TH', 'ohH',
                'WI', 'TI', 'ohI', 'WJ', 'TJ', 'ohJ'):
        np.testing.assert_array_equal(np.asarray(r0[key]),
                                      np.asarray(r1[key]), err_msg=key)


def test_multiprocess_matches_single_controller(group_results):
    from rri_nmf_tpu.nmf import nmf

    r0 = group_results[0]
    n, d, k = 64, 32, 5
    X = np.random.RandomState(0).rand(n, d)
    W0 = np.abs(np.random.RandomState(1).rand(n, k))
    T0 = np.abs(np.random.RandomState(2).rand(k, d))

    ra = nmf(X, k, W_in=W0, T_in=T0, max_iter=5, random_state=7,
             compute_obj_each_iter=True, update_order='phase',
             project_T_each_iter=True, t_row_sum=1.0)
    rb = nmf(X, k, W_in=W0, T_in=T0, max_iter=5, random_state=7,
             compute_obj_each_iter=True, early_stop=True,
             project_T_each_iter=True, t_row_sum=1.0)
    rd = nmf(X, k, W_in=W0, T_in=T0, max_iter=5, random_state=7,
             compute_obj_each_iter=True, accel='her',
             reset_topic_method=None, update_order='phase',
             project_T_each_iter=True, t_row_sum=1.0)

    np.testing.assert_allclose(r0['WA'], ra['W'], atol=1e-10)
    np.testing.assert_allclose(r0['TA'], ra['T'], atol=1e-10)
    np.testing.assert_allclose(r0['ohA'], ra['obj_history'], rtol=1e-12)
    np.testing.assert_allclose(r0['WB'], rb['W'], atol=1e-10)
    np.testing.assert_allclose(r0['TB'], rb['T'], atol=1e-10)
    np.testing.assert_allclose(r0['ohB'], rb['obj_history'], rtol=1e-12)
    np.testing.assert_allclose(r0['WD'], rd['W'], atol=1e-10)
    np.testing.assert_allclose(r0['TD'], rd['T'], atol=1e-10)
    np.testing.assert_allclose(r0['ohD'], rd['obj_history'], rtol=1e-11)

    # fresh random init on the process-spanning X draws the same host
    # RNG stream as a single-controller fit
    rf = nmf(X, k, max_iter=4, random_state=7, init='random',
             compute_obj_each_iter=True, update_order='phase',
             project_T_each_iter=True, t_row_sum=1.0)
    np.testing.assert_allclose(r0['WF'], rf['W'], atol=1e-10)
    np.testing.assert_allclose(r0['TF'], rf['T'], atol=1e-10)
    np.testing.assert_allclose(r0['ohF'], rf['obj_history'], rtol=1e-11)

    # masked multi-controller fits (distribute_masked_coo slabs) match
    # the single-controller masked oracles — the observed set never
    # existed on one host in the group run
    import scipy.sparse as sps
    rngm = np.random.RandomState(3)
    M_full = (rngm.rand(n, d) < 0.4).astype(np.float64)
    Xm_full = rngm.rand(n, d) * M_full
    Msp = sps.csr_matrix(M_full)
    rg = nmf(Xm_full, k, W_mat=Msp, W_in=W0, T_in=T0, max_iter=4,
             random_state=7, compute_obj_each_iter=True,
             reset_topic_method=None, t_row_sum=1.0)
    np.testing.assert_allclose(r0['WG'], rg['W'], atol=1e-10)
    np.testing.assert_allclose(r0['TG'], rg['T'], atol=1e-10)
    np.testing.assert_allclose(r0['ohG'], rg['obj_history'], rtol=1e-11)
    rh = nmf(Xm_full, k, W_mat=Msp, W_in=W0, T_in=T0, max_iter=4,
             random_state=7, compute_obj_each_iter=True,
             update_order='phase', reset_topic_method=None,
             reg_t_l1=0.01)
    np.testing.assert_allclose(r0['WH'], rh['W'], atol=1e-10)
    np.testing.assert_allclose(r0['TH'], rh['T'], atol=1e-10)
    np.testing.assert_allclose(r0['ohH'], rh['obj_history'], rtol=1e-11)

    # unmasked sparse multi-controller fits (distribute_sparse_coo
    # slabs) match the single-controller sparse oracles
    rngs = np.random.RandomState(4)
    Xs_full = sps.csr_matrix(
        rngs.rand(n, d) * (rngs.rand(n, d) < 0.3))
    ri = nmf(Xs_full, k, sparse=True, W_in=W0, T_in=T0, max_iter=4,
             random_state=7, compute_obj_each_iter=True,
             early_stop=False, project_W_each_iter=True, w_row_sum=1.0,
             reg_t_l2=0.05, reset_topic_method=None)
    np.testing.assert_allclose(r0['WI'], ri['W'], atol=1e-10)
    np.testing.assert_allclose(r0['TI'], ri['T'], atol=1e-10)
    np.testing.assert_allclose(r0['ohI'], ri['obj_history'], rtol=1e-11)
    rj = nmf(Xs_full, k, sparse=True, W_in=W0, T_in=T0, max_iter=4,
             random_state=7, compute_obj_each_iter=True,
             early_stop=False, project_T_each_iter=True, t_row_sum=1.0,
             reset_topic_method=None)
    np.testing.assert_allclose(r0['WJ'], rj['W'], atol=1e-10)
    np.testing.assert_allclose(r0['TJ'], rj['T'], atol=1e-10)
    np.testing.assert_allclose(r0['ohJ'], rj['obj_history'], rtol=1e-11)
