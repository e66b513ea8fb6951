"""Multi-controller (multi-host) factorization: one process per host.

Launch this script once per process as
``python examples/multiprocess.py <process_id> <num_processes> <port>``
(the coordinator listens on ``localhost:<port>``, so all processes share
one machine, e.g. one per GPU); every process then sees the global
device set. Each process loads ONLY its own row block of X
(no host ever materializes the full matrix), and every process receives
the same gathered factors back.

Without GPUs, emulate a 2-process group on CPU (two terminals,
or let the script self-spawn):

    python examples/multiprocess.py --spawn-cpu
"""

import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

N, D, K = 512, 256, 4


def load_row_block(lo, hi):
    """Stand-in for a per-host data loader (each host reads only its
    rows: a file shard, a DB range, ...). Deterministic here so every
    process agrees on the underlying matrix."""
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(N, 8) @ rng.rand(8, D))
    return X[lo:hi]


def main():
    import jax

    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import (
        distribute_dense, initialize_distributed, make_global_mesh,
        process_row_block)

    # the process group comes from argv (nothing is autodetected)
    if len(sys.argv) > 3:
        pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        initialize_distributed('localhost:' + port, nproc, pid)
    else:
        initialize_distributed()
    print('process %d/%d, %d local of %d global devices'
          % (jax.process_index(), jax.process_count(),
             len(jax.local_devices()), len(jax.devices())))

    # dp across hosts (only the small T-phase numerator crosses the
    # network), tp within a host
    mesh = make_global_mesh()
    lo, hi = process_row_block(N, mesh)
    Xg = distribute_dense(load_row_block(lo, hi), (N, D), mesh)

    # fresh init works multi-controller: 'random'/'smart_random' need
    # only shape / a replicated mean; the NNDSVD family runs the device
    # backend's jitted program under GSPMD
    soln = nmf(Xg, k=K, mesh=mesh, max_iter=10, random_state=0,
               init='random', compute_obj_each_iter=True,
               project_T_each_iter=True, t_row_sum=1.0)

    oh = soln['obj_history']
    print('process %d: objective %.4f -> %.4f (monotone: %s), W %s'
          % (jax.process_index(), oh[0], oh[-1],
             bool(np.all(np.diff(oh) <= 1e-12)), soln['W'].shape))

    # ---- sparse corpora: each process contributes its slab as a COO
    # plan passed DIRECTLY as X (the corpus never exists on one host).
    # Masked observed sets go through distribute_masked_coo the same
    # way.
    import scipy.sparse as sp

    from rri_nmf_tpu.parallel import (distribute_factors,
        distribute_sparse_coo)
    Xs_local = sp.csr_matrix(load_row_block(lo, hi)
                             * (np.random.RandomState(1)
                                .rand(hi - lo, D) < 0.2))
    plan = distribute_sparse_coo(Xs_local, (N, D), mesh,
                                 dtype=np.float32)
    # plan inputs carry no host X: initialize from a shared seed
    rng = np.random.RandomState(7)
    W0 = np.abs(rng.rand(N, K)).astype(np.float32)
    T0 = np.abs(rng.rand(K, D)).astype(np.float32)
    Wg, Tg = distribute_factors(W0[lo:hi], T0, N, mesh)
    soln_sp = nmf(plan, k=K, W_in=Wg, T_in=Tg, mesh=mesh, max_iter=6,
                  random_state=0, compute_obj_each_iter=True,
                  reg_t_l2=0.05, project_W_each_iter=True,
                  w_row_sum=1.0, reset_topic_method=None)
    oh = soln_sp['obj_history']
    print('process %d: sparse-plan objective %.4f -> %.4f (nnz stays '
          'per-process)' % (jax.process_index(), oh[0], oh[-1]))


def spawn_cpu():
    """Self-spawn a 2-process CPU group (4 virtual devices each)."""
    import socket
    s = socket.socket()
    s.bind(('localhost', 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ,
               XLA_FLAGS='--xla_force_host_platform_device_count=4',
               JAX_PLATFORMS='cpu')
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(i), '2', port], env=env)
        for i in range(2)]
    rcs = [p.wait() for p in procs]
    sys.exit(max(rcs))


if __name__ == '__main__':
    if '--spawn-cpu' in sys.argv:
        spawn_cpu()
    else:
        main()
