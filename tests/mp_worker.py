"""Multi-controller worker: one JAX process of a 2-process gloo group.

Launched by tests/test_multiprocess.py (never collected by pytest). Each
process owns 4 virtual CPU devices; together they form a (4, 2) global
mesh with ``dp`` spanning the two processes — the layout
``parallel.multihost`` promises on fabrics without slice metadata. The
worker drives the REAL public entry points end-to-end:

    initialize_distributed -> make_global_mesh -> process_row_block ->
    distribute_dense / distribute_factors -> nmf(mesh=...) -> host results

and writes its gathered results to ``<outdir>/result_<pid>.npz``; the
parent test compares both processes' files bitwise and checks parity
against a single-controller oracle fit.
"""

import json
import os
import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    outdir = sys.argv[4]

    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    cache = os.environ.get('JAX_COMPILATION_CACHE_DIR') or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        '.cache', 'jax_compile')
    jax.config.update('jax_compilation_cache_dir', cache)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)

    import numpy as np

    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import (
        distribute_dense, distribute_factors, initialize_distributed,
        make_global_mesh, process_row_block)

    p, r = initialize_distributed('localhost:' + port, nproc, pid)
    assert (p, r) == (pid, nproc), (p, r)
    assert len(jax.local_devices()) == 4 and len(jax.devices()) == 8

    # dp = 4 over 2 processes: each process owns 2 consecutive dp rows,
    # tp = 2 stays inside a process (the process-major layout contract)
    mesh = make_global_mesh(mesh_shape=(4, 2))
    procs = np.vectorize(lambda d: d.process_index)(mesh.devices)
    assert (procs == procs[:, :1]).all(), 'tp row spans processes'
    assert sorted(set(procs[:, 0])) == [0, 1], 'dp does not span processes'

    n, d, k = 64, 32, 5
    rng = np.random.RandomState(0)
    X_full = rng.rand(n, d)          # deterministic: every process agrees
    W0 = np.abs(np.random.RandomState(1).rand(n, k))
    T0 = np.abs(np.random.RandomState(2).rand(k, d))

    lo, hi = process_row_block(n, mesh)
    expected = (0, 32) if pid == 0 else (32, 64)
    assert (lo, hi) == expected, (lo, hi)

    Xg = distribute_dense(X_full[lo:hi], (n, d), mesh)
    assert not Xg.is_fully_addressable
    Wg, Tg = distribute_factors(W0[lo:hi], T0, n, mesh)

    # config A: phase-order TM-style fit on the GSPMD sweep
    ra = nmf(Xg, k, W_in=Wg, T_in=Tg, mesh=mesh, max_iter=5,
             random_state=7, compute_obj_each_iter=True,
             update_order='phase', project_T_each_iter=True, t_row_sum=1.0)
    # config B: interleaved order + early stopping (exercises the
    # _to_host snapshot / _from_host rollback multi-controller paths)
    rb = nmf(Xg, k, W_in=Wg, T_in=Tg, mesh=mesh, max_iter=5,
             random_state=7, compute_obj_each_iter=True, early_stop=True,
             project_T_each_iter=True, t_row_sum=1.0)
    # config C: grouped dispatch (fori-loop multi-sweep wrapper) must
    # equal config A's per-iteration fit exactly
    rc = nmf(Xg, k, W_in=Wg, T_in=Tg, mesh=mesh, max_iter=5,
             random_state=7, sweeps_per_dispatch=5,
             update_order='phase', project_T_each_iter=True, t_row_sum=1.0)
    np.testing.assert_array_equal(rc['W'], ra['W'])
    np.testing.assert_array_equal(rc['T'], ra['T'])
    # config D: HER extrapolation over the group (momentum + distributed
    # restart-check objective on process-spanning factors)
    rd = nmf(Xg, k, W_in=Wg, T_in=Tg, mesh=mesh, max_iter=5,
             random_state=7, compute_obj_each_iter=True, accel='her',
             reset_topic_method=None, update_order='phase',
             project_T_each_iter=True, t_row_sum=1.0)
    # config E: checkpointing across the process group — sharded factors
    # are gathered, process 0 writes; a resumed run ≡ the straight run
    ckdir = os.path.join(outdir, 'ckpt')
    re1 = nmf(Xg, k, W_in=Wg, T_in=Tg, mesh=mesh, max_iter=2,
              random_state=7, compute_obj_each_iter=True,
              update_order='phase', project_T_each_iter=True,
              t_row_sum=1.0, checkpoint=ckdir, checkpoint_every=2)
    assert len(re1['obj_history']) == 2
    # resume with DIFFERENT warm starts: matching config A's straight
    # run proves the checkpoint state was actually restored (identical
    # warm starts could not tell a resume from a fresh 5-iter fit)
    Wg2, Tg2 = distribute_factors(1.0 - W0[lo:hi], 1.0 - T0, n, mesh)
    re2 = nmf(Xg, k, W_in=Wg2, T_in=Tg2, mesh=mesh, max_iter=5,
              random_state=7, compute_obj_each_iter=True,
              update_order='phase', project_T_each_iter=True,
              t_row_sum=1.0, checkpoint=ckdir, checkpoint_every=100)
    assert len(re2['obj_history']) == 5
    np.testing.assert_allclose(re2['obj_history'][:2], re1['obj_history'],
                               rtol=1e-12)
    np.testing.assert_allclose(re2['W'], ra['W'], atol=1e-12)
    np.testing.assert_allclose(re2['T'], ra['T'], atol=1e-12)

    # config F: fresh init on the process-spanning X. random init draws
    # the reference's host RNG stream (shape-only), so it must equal the
    # single-controller fit exactly; the parent test pins that.
    rf = nmf(Xg, k, mesh=mesh, max_iter=4, random_state=7, init='random',
             compute_obj_each_iter=True, update_order='phase',
             project_T_each_iter=True, t_row_sum=1.0)
    # device NNDSVD on the global X ≡ the same jitted program on a
    # local replica (reduction-order noise only)
    from rri_nmf_tpu.initialization import initialize_nmf
    Wi_g, Ti_g = initialize_nmf(Xg, k, 'nndsvd', random_state=5,
                                svd_backend='jax')
    Wi_l, Ti_l = initialize_nmf(np.asarray(X_full), k, 'nndsvd',
                                random_state=5, svd_backend='jax')
    np.testing.assert_allclose(Wi_g, Wi_l, atol=1e-10)
    np.testing.assert_allclose(Ti_g, Ti_l, atol=1e-10)

    # config G/H: multi-controller MASKED (WRRI) fits — the observed set
    # is assembled from per-process row slabs (distribute_masked_coo)
    # and never exists on one host. G: interleaved COO plan (reference
    # order); H: Gram-phase segsum plan (one psum per T-phase).
    import scipy.sparse as sps

    from rri_nmf_tpu.parallel import distribute_masked_coo
    mesh_m = make_global_mesh(mesh_shape=(8, 1))
    lo_m, hi_m = process_row_block(n, mesh_m)
    assert (lo_m, hi_m) == ((0, 32) if pid == 0 else (32, 64))
    rngm = np.random.RandomState(3)
    M_full = (rngm.rand(n, d) < 0.4).astype(np.float64)
    Xm_full = rngm.rand(n, d) * M_full
    plan_coo = distribute_masked_coo(
        Xm_full[lo_m:hi_m], sps.csr_matrix(M_full[lo_m:hi_m]),
        (n, d), mesh_m)
    plan_gram = distribute_masked_coo(
        Xm_full[lo_m:hi_m], sps.csr_matrix(M_full[lo_m:hi_m]),
        (n, d), mesh_m, gram=True)
    Wgm, Tgm = distribute_factors(W0[lo_m:hi_m], T0, n, mesh_m)
    rg = nmf(plan_coo, k, W_in=Wgm, T_in=Tgm, mesh=mesh_m, max_iter=4,
             random_state=7, compute_obj_each_iter=True,
             reset_topic_method=None, t_row_sum=1.0)
    rh = nmf(plan_gram, k, W_in=Wgm, T_in=Tgm, mesh=mesh_m, max_iter=4,
             random_state=7, compute_obj_each_iter=True,
             update_order='phase', reset_topic_method=None,
             reg_t_l1=0.01)

    # config I/J: multi-controller UNMASKED sparse corpora
    # (distribute_sparse_coo slabs — the corpus never exists on one
    # host). I: BCOO plan on the (4, 2) mesh (a tp axis IS supported on
    # the unmasked path); J: BCOO plan on the (8, 1) row layout with the
    # T-row simplex projection (rows device-local).
    rngs = np.random.RandomState(4)
    Xs_full = sps.csr_matrix(
        rngs.rand(n, d) * (rngs.rand(n, d) < 0.3))
    from rri_nmf_tpu.parallel import distribute_sparse_coo
    plan_sp = distribute_sparse_coo(Xs_full[lo:hi], (n, d), mesh,
                                    dtype=np.float64)
    ri = nmf(plan_sp, k, W_in=Wg, T_in=Tg, mesh=mesh, max_iter=4,
             random_state=7, compute_obj_each_iter=True,
             early_stop=False, project_W_each_iter=True, w_row_sum=1.0,
             reg_t_l2=0.05, reset_topic_method=None)
    plan_mx = distribute_sparse_coo(Xs_full[lo_m:hi_m], (n, d), mesh_m,
                                    dtype=np.float64)
    Wgs, Tgs = distribute_factors(W0[lo_m:hi_m], T0, n, mesh_m)
    rj = nmf(plan_mx, k, W_in=Wgs, T_in=Tgs, mesh=mesh_m, max_iter=4,
             random_state=7, compute_obj_each_iter=True,
             early_stop=False, project_T_each_iter=True, t_row_sum=1.0,
             reset_topic_method=None)

    for tag, res in (('A', ra), ('B', rb), ('D', rd), ('F', rf),
                     ('G', rg), ('H', rh), ('I', ri), ('J', rj)):
        assert isinstance(res['W'], np.ndarray) and res['W'].shape == (n, k)
        assert np.isfinite(res['W']).all() and np.isfinite(res['T']).all()
        oh = res['obj_history']
        assert len(oh) >= 2 and oh[-1] <= oh[0], (tag, oh)

    np.savez(os.path.join(outdir, 'result_%d.npz' % pid),
             WA=ra['W'], TA=ra['T'], ohA=np.asarray(ra['obj_history']),
             WB=rb['W'], TB=rb['T'], ohB=np.asarray(rb['obj_history']),
             WD=rd['W'], TD=rd['T'], ohD=np.asarray(rd['obj_history']),
             WF=rf['W'], TF=rf['T'], ohF=np.asarray(rf['obj_history']),
             WG=rg['W'], TG=rg['T'], ohG=np.asarray(rg['obj_history']),
             WH=rh['W'], TH=rh['T'], ohH=np.asarray(rh['obj_history']),
             WI=ri['W'], TI=ri['T'], ohI=np.asarray(ri['obj_history']),
             WJ=rj['W'], TJ=rj['T'], ohJ=np.asarray(rj['obj_history']))
    with open(os.path.join(outdir, 'ok_%d.json' % pid), 'w') as f:
        json.dump({'rows': [int(lo), int(hi)]}, f)
    print('worker', pid, 'OK', flush=True)


if __name__ == '__main__':
    main()
