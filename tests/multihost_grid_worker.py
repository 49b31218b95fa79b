"""Worker for the deployment-shape multi-host test (tests/test_multihost.py).

Each of N processes owns ``devs_per_proc`` virtual CPU devices and joins a
jax.distributed cluster; the global mesh is ('blocks', 'grid') =
(N*devs_per_proc // 2, 2) — a multi-host deployment scaled down (4 hosts
x 4 chips -> 4 processes x 2 devices). Unlike multihost_worker.py (raw
em_fit), this worker drives the FULL policy layer across the process
boundary: a VIPRSGrid fit with staggered lane convergence (so the chunked
driver's power-of-2 lane compaction fires), followed by a VIPRS fit on
inflated marginal betas (so the restart-on-negative-MSE ladder fires).

Run as:
    python tests/multihost_grid_worker.py <pid> <nproc> <port> <out> [dpp]
"""

import json
import os
import sys

DPP = int(sys.argv[5]) if len(sys.argv) > 5 else 2
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + f' --xla_force_host_platform_device_count={DPP}'
                           ).strip()
os.environ['JAX_PLATFORMS'] = 'cpu'

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_datasets():
    """Deterministic problems (identical on every process)."""
    import numpy as np
    from viprs_tpu.data.simulate import simulate_sumstats_blocks
    from viprs_tpu.data.dataset import SummaryStatsDataset

    # small n + high h2 + dense signal stagger lane convergence across
    # chunks (same recipe as __graft_entry__.dryrun_multichip), so the
    # driver's power-of-2 lane compaction fires mid-run:
    sim = simulate_sumstats_blocks(
        n=800, block_sizes=(96, 96, 96, 96, 96, 96, 96, 96),
        h2=0.6, prop_causal=0.2, seed=1)
    ds = SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128)
    # inflated marginal betas deterministically drive the summary-stats MSE
    # negative -> the restart ladder fires (reference VIPRS.py:1025-1038):
    sb_bad = {c: 3.0 * v for c, v in sim['std_beta'].items()}
    ds_bad = SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sb_bad, sim['n_per_snp'], block_size=128)
    return ds, ds_bad


def run(mesh=None):
    """Run the two driver scenarios; returns a JSON-able result dict."""
    import numpy as np
    import jax
    from viprs_tpu.model import VIPRS, VIPRSGrid
    from viprs_tpu.gridsearch import HyperparameterGrid, bayesian_model_average
    from viprs_tpu.parallel.mesh import make_mesh

    ds, ds_bad = build_datasets()
    if mesh is None:
        mesh = make_mesh(n_grid_axis=2)
    assert dict(mesh.shape) == {'blocks': jax.device_count() // 2, 'grid': 2}

    # --- scenario 1: S=16 grid fit, chunked so lane compaction fires ---
    np.random.seed(0)
    grid = HyperparameterGrid(pi_steps=8, sigma_epsilon_steps=2,
                              n_snps=ds.m, h2_est=0.6, h2_se=0.2)
    g = VIPRSGrid(ds, grid, mesh=mesh)
    # tight tolerances stagger lane convergence across chunks, so the
    # driver's power-of-2 lane compaction fires mid-run (widths must stay
    # divisible by the mesh 'grid' axis — the driver rounds up):
    g.fit(max_iter=80, min_iter=1, chunk_iters=10,
          f_abs_tol=1e-9, x_abs_tol=1e-9)
    trace = list(g._chunk_trace)
    elbos = [float(e) for e in
             np.asarray(g.validation_result['ELBO'], dtype=np.float64)]
    bayesian_model_average(g)
    bma_h2 = float(g.get_heritability())

    # --- scenario 2: restart-on-negative-MSE across the process boundary ---
    np.random.seed(0)
    mr = VIPRS(ds_bad, mesh=mesh)
    mr.fit(max_iter=40, min_iter=1, chunk_iters=10)
    restart_fired = mr.fix_params.get('sigma_epsilon') == 0.95
    restart_elbo = float(np.atleast_1d(
        np.asarray(mr.history['ELBO'][-1], dtype=np.float64))[0])

    return {
        'grid_elbos': elbos,
        'chunk_trace': [list(t) for t in trace],
        'bma_h2': bma_h2,
        'restart_fired': bool(restart_fired),
        'restart_elbo': restart_elbo,
        'restart_nit': int(mr.optim_result.nit),
    }


def main():
    process_id, num_processes, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                                            int(sys.argv[3]), sys.argv[4])
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.distributed.initialize(coordinator_address=f'127.0.0.1:{port}',
                               num_processes=num_processes,
                               process_id=process_id)
    assert jax.process_count() == num_processes
    assert jax.device_count() == DPP * num_processes

    res = run()
    res['process'] = process_id
    res['n_global_devices'] = jax.device_count()
    with open(out, 'w') as f:
        json.dump(res, f)


if __name__ == '__main__':
    main()
