#!/usr/bin/env python3
"""Measured capacity runs: the large reference panels on ONE device.

The reference's MAF>0.1% and full-EUR panel scales (9.6M / 18M variants,
docs/download_ld.md:6-13); this harness MEASURES the two product paths:

  --scale 9.6m   in-memory: ~10 GB packed int8 LD resident in one device's
                 memory, joint genome-wide VIPRS fit.
  --scale 18m    does-not-fit: synthesizes per chromosome straight into a
                 native LD store on disk (host RAM never holds the genome),
                 then drives the REAL CLI (`viprs_fit --device-memory-gb`)
                 so the chromosome-group streaming planner splits the panel
                 (the reference's per-chromosome mode, bin/viprs_fit:232-238).

Usage: python benchmarks/measure_capacity.py --scale 9.6m [--m M] [--reps N]
All output to stderr except a final one-line JSON summary on stdout.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_9p6m(m_target, reps):
    import bench
    import jax
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.model import VIPRS

    log(f"devices: {jax.devices()}")
    t0 = time.time()
    # float32 block storage: the raw genome is ~33 GB instead of ~67 GB;
    # the fit consumes int8 quantized tiles either way.
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(
        m_target=m_target, block_dtype=np.float32)
    t_syn = time.time() - t0
    log(f"synthesis: {t_syn:.1f}s")

    t0 = time.time()
    ds = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=True)
    del ld_blocks
    gc.collect()
    t_pack = time.time() - t0
    packed_gb = (ds.ld.diag.nbytes + ds.ld.off_data.nbytes) / 1e9
    log(f"packing: {t_pack:.1f}s; NB={ds.layout.nb} B={ds.layout.block_size} "
        f"n_off={ds.ld.n_off} M={ds.m} packed={packed_gb:.2f} GB "
        f"(padding {ds.layout.m_padded / ds.m - 1:.1%})")

    fit_kwargs = dict(max_iter=1000, f_abs_tol=1e-6, x_abs_tol=1e-6,
                      patience=10)
    np.random.seed(0)
    t0 = time.time()
    model = VIPRS(ds)
    model.fit(**fit_kwargs)
    cold = time.time() - t0
    log(f"cold fit (incl. compile + {packed_gb:.1f} GB HBM upload): "
        f"{cold:.1f}s; iters={model.optim_result.nit}; "
        f"success={model.optim_result.success}; "
        f"h2={model.get_heritability():.4f}; "
        f"prop_causal={model.get_proportion_causal():.5f}")

    times, iters = [], []
    for rep in range(reps):
        np.random.seed(0)
        t0 = time.time()
        m2 = VIPRS(ds)
        m2.fit(**fit_kwargs)
        times.append(time.time() - t0)
        iters.append(m2.optim_result.nit)
        log(f"steady-state rep {rep + 1}/{reps}: {times[-1]:.2f}s over "
            f"{iters[-1]} iters ({iters[-1] / times[-1]:.1f} it/s)")
        assert m2.optim_result.valid_optim_result, m2.optim_result.message
    steady = float(np.median(times))
    log(f"steady-state: median {steady:.2f}s min {min(times):.2f}s "
        f"max {max(times):.2f}s iters {sorted(iters)}")
    print(json.dumps({
        "metric": "capacity_9p6m_em_fit_seconds", "value": round(steady, 3),
        "unit": "s", "m_variants": int(ds.m),
        "packed_ld_gb": round(packed_gb, 2),
        "iters": sorted(iters), "cold_seconds": round(cold, 1),
    }), flush=True)


def synthesize_chromosome(c, m_c, n_gwas, h2, prop_causal, m_total, seed):
    """One chromosome of the analytic AR(1) spike-slab genome (f32 blocks).

    Same generative family as bench.synthesize_genome, but with a
    per-chromosome rng so chromosomes can be synthesized (and freed) one at
    a time — the 18M-variant genome never lives in host RAM at once.
    """
    from scipy.linalg import toeplitz
    from scipy.signal import lfilter
    rng = np.random.default_rng([seed, c])
    sizes = []
    while sum(sizes) < m_c:
        sizes.append(int(np.clip(rng.lognormal(np.log(600), 0.5), 80, 3500)))
    sizes[-1] -= sum(sizes) - m_c
    if sizes[-1] < 40:
        sizes.pop()
    blocks, sb_parts = [], []
    for m_b in sizes:
        rho = rng.uniform(0.2, 0.95)
        R = toeplitz((rho ** np.arange(m_b)).astype(np.float32))
        beta = np.where(rng.random(m_b) < prop_causal,
                        rng.standard_normal(m_b) * np.sqrt(
                            h2 / (prop_causal * m_total)),
                        0.0)
        z = rng.standard_normal(m_b)
        a = np.sqrt(1 - rho ** 2)
        z[0] /= a
        eps = lfilter([1.0], [1.0, -rho], a * z)
        sb_parts.append(R.astype(np.float64) @ beta + eps / np.sqrt(n_gwas))
        blocks.append(R)
    return blocks, np.concatenate(sb_parts)


def run_18m(m_target, workdir, budget_gb, phase='all'):
    import os
    import os.path as osp
    import json as _json
    import pandas as pd

    store = osp.join(workdir, 'ld_store')
    os.makedirs(store, exist_ok=True)
    os.makedirs(osp.join(workdir, 'out'), exist_ok=True)
    ss_file = osp.join(workdir, 'sumstats.tsv')
    out = osp.join(workdir, 'out', 'fit18m')
    n_gwas, h2, prop_causal = 350_000, 0.25, 0.002

    chrom_weights = np.linspace(2.0, 0.55, 22)
    chrom_weights /= chrom_weights.sum()

    t_syn = 0.0
    if phase in ('all', 'build'):
        t_syn = _build_18m_store(m_target, store, ss_file, n_gwas, h2,
                                 prop_causal, chrom_weights)
        if phase == 'build':
            log("store build complete (phase=build); "
                "run with --phase fit to measure the streamed CLI fit")
            return
    if phase == 'fit':
        assert osp.exists(osp.join(store, 'metadata.json')), (
            f"no store under {store}; run --phase build first")

    from viprs_tpu.cli import fit as cli_fit
    t0 = time.time()
    # --dequantize-on-the-fly keeps the store's int8 tiles in HBM (the
    # framework's capacity configuration; without it the CLI mirrors the
    # reference's float default and packs 4x the bytes — the planner then
    # streams ~4x the groups):
    rc = cli_fit.main(['-l', store, '-s', ss_file,
                       '--output-file', out,
                       '--block-size', '1024', '--max-iter', '1000',
                       '--seed', '0', '--dequantize-on-the-fly',
                       '--device-memory-gb', str(budget_gb)])
    wall = time.time() - t0
    assert rc == 0, f"streamed 18M CLI fit failed rc={rc}"
    fit_tab = pd.read_csv(out + '.fit.gz', sep='\t')
    hyp = pd.read_csv(out + '.hyp', sep='\t')
    # one .hyp row group per streamed chromosome group ('Chromosomes' carries
    # the group's chromosome list):
    n_groups = hyp['Chromosomes'].nunique()
    store_gb = sum(os.path.getsize(osp.join(store, f))
                   for f in os.listdir(store)) / 1e9
    log(f"streamed CLI fit: {wall:.0f}s wall; "
        f"{len(fit_tab)} variants in output; groups={n_groups}")
    print(json.dumps({
        "metric": "capacity_18m_streamed_cli_fit_seconds",
        "value": round(wall, 1), "unit": "s",
        "m_variants": int(len(fit_tab)), "store_gb": round(store_gb, 1),
        "n_groups": int(n_groups), "synthesis_seconds": round(t_syn, 0),
    }), flush=True)


def _build_18m_store(m_target, store, ss_file, n_gwas, h2, prop_causal,
                     chrom_weights):
    import json as _json
    import os.path as osp
    import pandas as pd

    t0 = time.time()
    ss_rows = []
    store_gb = 0.0
    for c in range(1, 23):
        m_c = int(m_target * chrom_weights[c - 1])
        blocks, sb = synthesize_chromosome(
            c, m_c, n_gwas, h2, prop_causal, m_target, seed=0)
        m_c = len(sb)
        arrays = {f'block_{i:05d}': np.clip(
            np.rint(b * 127.0), -127, 127).astype(np.int8)
            for i, b in enumerate(blocks)}
        np.savez(osp.join(store, f'chr_{c}.npz'), **arrays)
        store_gb += sum(a.nbytes for a in arrays.values()) / 1e9
        z = sb * np.sqrt(n_gwas / np.maximum(1e-12, 1.0 - sb ** 2))
        tab = pd.DataFrame({
            'CHR': c, 'SNP': [f'rs{c}_{i}' for i in range(m_c)],
            'POS': np.arange(1, m_c + 1) * 1000,
            'A1': 'A', 'A2': 'G', 'N': n_gwas, 'Z': z})
        tab[['CHR', 'SNP', 'POS', 'A1', 'A2']].to_csv(
            osp.join(store, f'chr_{c}.snps.csv'), index=False)
        ss_rows.append(tab)
        del blocks, arrays
        gc.collect()
        log(f"chr{c}: {m_c} variants written "
            f"(cum {store_gb:.1f} GB int8, {time.time() - t0:.0f}s)")
    with open(osp.join(store, 'metadata.json'), 'w') as f:
        _json.dump({'quantized': True,
                    'chromosomes': [str(c) for c in range(1, 23)]}, f)
    pd.concat(ss_rows).to_csv(ss_file, sep='\t', index=False)
    del ss_rows
    gc.collect()
    t_syn = time.time() - t0
    log(f"18M store build: {t_syn:.0f}s, {store_gb:.1f} GB int8 on disk")
    return t_syn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--scale', choices=['9.6m', '18m'], required=True)
    ap.add_argument('--m', type=int, default=None)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--workdir', default='/tmp/viprs_capacity')
    ap.add_argument('--budget-gb', type=float, default=12.0,
                    help='--device-memory-gb for the 18m streaming run')
    ap.add_argument('--phase', choices=['all', 'build', 'fit'], default='all',
                    help='18m only: build the on-disk store (CPU), run the '
                         'streamed fit on an existing store, or both')
    args = ap.parse_args()
    import viprs_tpu  # noqa: F401

    if args.scale == '9.6m':
        run_9p6m(args.m or 9_600_000, args.reps)
    else:
        Path(args.workdir).mkdir(parents=True, exist_ok=True)
        run_18m(args.m or 18_000_000, args.workdir, args.budget_gb,
                phase=args.phase)


if __name__ == '__main__':
    main()
