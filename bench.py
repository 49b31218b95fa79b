#!/usr/bin/env python3
"""Genome-scale VIPRS fit benchmark on the accelerator.

Reproduces the reference's headline workload (BASELINE.md): a genome-wide EM
fit over ~1.1M HapMap3-scale variants with block LD — 57.4 s wall-clock on the
reference CPU implementation (viprs v0.1.2, 1 thread). Here the LD is
synthesized analytically (AR(1) blocks at LDetect-like sizes, int8-quantized)
with a spike-and-slab architecture, so the optimization workload matches the
real one (same nnz(LD) touched per sweep, realistic convergence behavior).

Prints exactly ONE JSON line:
  {"metric": "genomewide_em_fit_seconds", "value": <steady-state fit seconds>,
   "unit": "s", "vs_baseline": <57.4 / value>}
Everything else goes to stderr.
"""

import json
import sys
import time

import numpy as np

BASELINE_SECONDS = 57.4  # reference genome-wide EM fit (BASELINE.md)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def synthesize_genome(m_target=1_100_000, n_gwas=350_000, h2=0.25,
                      prop_causal=0.002, seed=0, block_dtype=None):
    """Analytic genome-scale problem: AR(1) LD blocks + spike-slab sumstats.

    For each block with parameter rho: R_ij = rho^|i-j| (exact correlation
    matrix). Marginal betas: beta_hat = R beta + eps with eps an AR(1) process
    scaled by 1/sqrt(n) — i.e. eps ~ N(0, R/n) exactly.

    :param block_dtype: store LD blocks in this dtype (default float64,
        unchanged arithmetic). benchmarks/measure_capacity.py passes float32
        so the 9.6M-variant panel fits in host RAM; the blocks are
        int8-quantized downstream either way.
    """
    rng = np.random.default_rng(seed)

    # LDetect-like block sizes per chromosome (22 chromosomes, mean ~650):
    chrom_weights = np.linspace(2.0, 0.55, 22)
    chrom_weights /= chrom_weights.sum()
    blocks_per_chrom = {}
    total = 0
    for c in range(1, 23):
        m_c = int(m_target * chrom_weights[c - 1])
        sizes = []
        while sum(sizes) < m_c:
            sizes.append(int(np.clip(rng.lognormal(np.log(600), 0.5), 80, 3500)))
        sizes[-1] -= sum(sizes) - m_c
        if sizes[-1] < 40:
            sizes.pop()
        blocks_per_chrom[c] = sizes
        total += sum(sizes)
    log(f"synthesizing {total} variants in "
        f"{sum(len(v) for v in blocks_per_chrom.values())} LD blocks")

    ld_blocks, std_beta, n_per_snp = {}, {}, {}
    for c, sizes in blocks_per_chrom.items():
        blocks, sb_parts = [], []
        for m_b in sizes:
            rho = rng.uniform(0.2, 0.95)
            # AR(1) correlation matrix (analytic, PSD):
            from scipy.linalg import toeplitz
            R = toeplitz(rho ** np.arange(m_b))
            blocks.append(R if block_dtype is None else R.astype(block_dtype))

            beta = np.where(rng.random(m_b) < prop_causal,
                            rng.standard_normal(m_b) * np.sqrt(h2 / (prop_causal * total)),
                            0.0)
            # AR(1) noise with covariance R/n (vectorized recursion):
            from scipy.signal import lfilter
            z = rng.standard_normal(m_b)
            a = np.sqrt(1 - rho ** 2)
            z[0] /= a  # so the filtered series starts at z_0 exactly
            eps = lfilter([1.0], [1.0, -rho], a * z)
            sb_parts.append(R @ beta + eps / np.sqrt(n_gwas))
        ld_blocks[c] = blocks
        m_c = sum(sizes)
        std_beta[c] = np.concatenate(sb_parts)
        n_per_snp[c] = np.full(m_c, float(n_gwas))

    return ld_blocks, std_beta, n_per_snp


def main():
    import viprs_tpu  # noqa: F401  (enables x64, honors JAX_PLATFORMS)
    import jax
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.model import VIPRS

    m_target = int(sys.argv[1]) if len(sys.argv) > 1 else 1_100_000

    log(f"devices: {jax.devices()}")
    t0 = time.time()
    ld_blocks, std_beta, n_per_snp = synthesize_genome(m_target=m_target)
    log(f"synthesis: {time.time() - t0:.1f}s")

    t0 = time.time()
    ds = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=True)
    log(f"packing: {time.time() - t0:.1f}s; NB={ds.layout.nb} "
        f"B={ds.layout.block_size} n_off={ds.ld.n_off} M={ds.m} "
        f"(padding overhead {ds.layout.m_padded / ds.m - 1:.1%})")

    np.random.seed(0)
    fit_kwargs = dict(max_iter=1000, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10)

    # cold run (includes XLA compilation):
    t0 = time.time()
    model = VIPRS(ds)
    model.fit(**fit_kwargs)
    cold = time.time() - t0
    log(f"cold fit (incl. compile): {cold:.2f}s; "
        f"iters={model.optim_result.nit}; success={model.optim_result.success}; "
        f"message={model.optim_result.message}; h2={model.get_heritability():.4f}; "
        f"prop_causal={model.get_proportion_causal():.5f}")

    # steady-state runs (compilation cached): the headline is the MEDIAN
    # over repeats, with min/max reported alongside.
    n_rep = int(sys.argv[sys.argv.index('--reps') + 1]) \
        if '--reps' in sys.argv else 3
    times, iters = [], []
    model2 = None
    for rep in range(n_rep):
        np.random.seed(0)
        t0 = time.time()
        model2 = VIPRS(ds)
        model2.fit(**fit_kwargs)
        times.append(time.time() - t0)
        iters.append(model2.optim_result.nit)
        log(f"steady-state fit rep {rep + 1}/{n_rep}: {times[-1]:.2f}s over "
            f"{iters[-1]} iterations ({iters[-1] / times[-1]:.1f} it/s)")
    steady = float(np.median(times))
    log(f"steady-state fit: median {steady:.2f}s  min {min(times):.2f}s  "
        f"max {max(times):.2f}s  iters {sorted(iters)}")

    assert model2.optim_result.valid_optim_result, model2.optim_result.message

    print(json.dumps({
        "metric": "genomewide_em_fit_seconds",
        "value": round(steady, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / steady, 2),
    }), flush=True)

    # the other workloads: a failure in any of them fails the benchmark
    _grid_section(ds)
    _mix_section(ds)
    _mix_grid_section(ds)


def _grid_section(ds):
    if '--no-grid' not in sys.argv:
        from viprs_tpu.model import VIPRSGrid
        from viprs_tpu.gridsearch import HyperparameterGrid, bayesian_model_average
        np.random.seed(0)
        grid = HyperparameterGrid(pi_steps=20, sigma_epsilon_steps=5,
                                  n_snps=ds.m, h2_est=0.25, h2_se=0.05)
        gmodel = VIPRSGrid(ds, grid)
        assert gmodel.n_models == 100
        t0 = time.time()
        gmodel.fit(max_iter=500)
        bayesian_model_average(gmodel)
        grid_cold = time.time() - t0
        log(f"grid(100)+BMA cold (incl. compile): {grid_cold:.2f}s; "
            f"converged={int(np.sum([r.success for r in gmodel.optim_results]))}/100")

        np.random.seed(0)
        gmodel2 = VIPRSGrid(ds, grid)
        t0 = time.time()
        gmodel2.fit(max_iter=500)
        bayesian_model_average(gmodel2)
        grid_steady = time.time() - t0
        log(f"grid(100)+BMA steady-state: {grid_steady:.2f}s")

def _mix_grid_section(ds):
    # ---- 20-point mixture grid in ONE simultaneous batched fit (the
    # reference fits any model across grid rows in parallel processes,
    # HyperparameterSearch.py:197-351; round 2 fell back to serial pathwise
    # fits here) ----
    if '--no-mix-grid' not in sys.argv:
        from viprs_tpu.model import VIPRSMixGrid
        from viprs_tpu.gridsearch import HyperparameterGrid
        np.random.seed(0)
        grid = HyperparameterGrid(pi_steps=20, n_snps=ds.m,
                                  h2_est=0.25, h2_se=0.05)
        g = VIPRSMixGrid(ds, grid, K=3)
        t0 = time.time()
        g.fit(max_iter=500)
        cold = time.time() - t0
        conv = int(np.sum([r.success for r in g.optim_results]))
        log(f"VIPRSMixGrid(20 x K=3) cold (incl. compile): {cold:.2f}s; "
            f"converged={conv}/20")

        np.random.seed(0)
        g2 = VIPRSMixGrid(ds, grid, K=3)
        t0 = time.time()
        g2.fit(max_iter=500)
        steady = time.time() - t0
        conv2 = int(np.sum([r.success for r in g2.optim_results]))
        log(f"VIPRSMixGrid(20 x K=3) steady-state: {steady:.2f}s; "
            f"converged={conv2}/20 (one simultaneous batched fit)")


def _mix_section(ds):
    # ---- VIPRSMix at genome scale (reference -m VIPRSMix is a first-class
    # CLI model; e_step.hpp:447-551) ----
    if '--no-mix' not in sys.argv:
        from viprs_tpu.model import VIPRSMix
        np.random.seed(0)
        mix = VIPRSMix(ds, K=3)
        t0 = time.time()
        mix.fit(max_iter=500)
        mix_cold = time.time() - t0
        log(f"VIPRSMix(K=3) cold (incl. compile): {mix_cold:.2f}s; "
            f"iters={mix.optim_result.nit}; success={mix.optim_result.success}; "
            f"h2={mix.get_heritability():.4f}")

        np.random.seed(0)
        mix2 = VIPRSMix(ds, K=3)
        t0 = time.time()
        mix2.fit(max_iter=500)
        mix_steady = time.time() - t0
        log(f"VIPRSMix(K=3) steady-state: {mix_steady:.2f}s over "
            f"{mix2.optim_result.nit} iterations")


if __name__ == '__main__':
    main()
