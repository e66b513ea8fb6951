"""Multi-chip sharded factorization over a (dp, tp) device mesh.

On a host with several GPUs the mesh spans them all. Without them,
emulate 8 devices on CPU:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py --cpu
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    import jax
    if '--cpu' in sys.argv:
        jax.config.update('jax_platforms', 'cpu')
    print('devices:', jax.devices())

    from rri_nmf_tpu.nmf import nmf
    from rri_nmf_tpu.parallel import make_mesh

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    print('mesh:', mesh)

    from rri_nmf_tpu.matrixops import normalize
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(512, 4) @ rng.rand(4, 256) +
               0.01 * rng.rand(512, 256))
    X = np.asarray(normalize(X))   # row-stochastic, like the TM preset

    soln = nmf(X, k=4, mesh=mesh, max_iter=10, random_state=0,
               compute_obj_each_iter=True, early_stop=False,
               project_T_each_iter=True, project_W_each_iter=True,
               t_row_sum=1.0, w_row_sum=1.0)

    oh = soln['obj_history']
    print('objective: %.4f -> %.4f (monotone: %s)'
          % (oh[0], oh[-1], bool(np.all(np.diff(oh) <= 0))))
    print('W %s, T %s, rows feasible: %s' % (
        soln['W'].shape, soln['T'].shape,
        np.allclose(soln['W'].sum(1), 1.0, atol=1e-8)))


if __name__ == '__main__':
    main()
