#!/usr/bin/env python3
"""int8 LD error budget at genome scale.

The framework's default LD representation is int8-quantized tiles
(dequantize-on-the-fly, scale 1/127 — the reference exposes the same
storage choice via ``dequantize_on_the_fly``, VIPRS.py:156-166, 201-207).
This harness publishes the cost of that default: fit the same ~1.1M-variant
problem twice — once on int8 LD, once on float32 LD — with identical
theta_0 initialization and the same sweep implementation, and report the
PIP / posterior-mean / h2 / ELBO deltas.

Output: one JSON line on stdout, plus a human-readable log on stderr.

Usage: python benchmarks/int8_budget.py [m_variants]
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fit_once(ds, label):
    from viprs_tpu.model import VIPRS
    # identical RNG state -> identical pi draw / variational init on both
    # datasets (initialize_theta's U[...] pi draw is numpy-seeded):
    np.random.seed(0)
    model = VIPRS(ds)
    t0 = time.time()
    # hold the algorithm fixed across the comparison: the XLA tile loop on
    # both sides, whatever the dispatch policy would pick:
    model.fit(max_iter=1000, sweep_impl='xla')
    secs = time.time() - t0
    res = model.optim_result
    pip = np.concatenate([model.pip[c] for c in model.chromosomes])
    eta = np.concatenate([model.post_mean_beta[c] for c in model.chromosomes])
    log(f"{label}: {secs:.2f}s, iters={res.nit}, success={res.success}, "
        f"h2={model.get_heritability():.6f}, pi={model.pi:.6f}, "
        f"elbo={model.history['ELBO'][-1]:.3f}")
    return dict(seconds=secs, iters=int(res.nit),
                h2=float(model.get_heritability()),
                pi=float(model.pi),
                elbo=float(model.history['ELBO'][-1]),
                pip=pip, eta=eta)


def main():
    import viprs_tpu  # noqa: F401
    import jax
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'bench', Path(__file__).resolve().parent.parent / 'bench.py')
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    from viprs_tpu.data.dataset import SummaryStatsDataset

    m_target = int(sys.argv[1]) if len(sys.argv) > 1 else 1_100_000
    log(f"devices: {jax.devices()}")

    t0 = time.time()
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(
        m_target=m_target, h2=0.25, prop_causal=0.002, seed=0,
        block_dtype=np.float32)
    log(f"synthesis: {time.time() - t0:.1f}s")

    t0 = time.time()
    ds8 = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=True)
    log(f"int8 pack: {time.time() - t0:.1f}s  "
        f"diag={ds8.ld.diag.nbytes / 1e9:.2f} GB")
    r8 = fit_once(ds8, "fit[int8 LD]")
    # free the int8 device residency before standing up the 4x f32 one:
    del ds8

    t0 = time.time()
    ds32 = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=False)
    del ld_blocks
    log(f"f32 pack: {time.time() - t0:.1f}s  "
        f"diag={ds32.ld.diag.nbytes / 1e9:.2f} GB")
    r32 = fit_once(ds32, "fit[f32 LD]")
    m = ds32.m
    del ds32

    pip8, pip32 = r8.pop('pip'), r32.pop('pip')
    eta8, eta32 = r8.pop('eta'), r32.pop('eta')

    d_pip = pip8 - pip32
    d_eta = eta8 - eta32
    sel8, sel32 = pip8 > 0.5, pip32 > 0.5
    deltas = dict(
        m=int(m),
        h2_delta=r8['h2'] - r32['h2'],
        pi_delta=r8['pi'] - r32['pi'],
        elbo_rel_delta=(r8['elbo'] - r32['elbo']) / abs(r32['elbo']),
        pip_corr=float(np.corrcoef(pip8, pip32)[0, 1]),
        pip_max_abs_delta=float(np.abs(d_pip).max()),
        pip_rms_delta=float(np.sqrt(np.mean(d_pip ** 2))),
        pip_selection_flips=int(np.sum(sel8 != sel32)),
        pip_selected_int8=int(sel8.sum()),
        pip_selected_f32=int(sel32.sum()),
        eta_corr=float(np.corrcoef(eta8, eta32)[0, 1]),
        eta_max_abs_delta=float(np.abs(d_eta).max()),
        eta_rms_delta=float(np.sqrt(np.mean(d_eta ** 2))),
        eta_rms=float(np.sqrt(np.mean(eta32 ** 2))),
    )
    out = dict(int8=r8, f32=r32, deltas=deltas)
    log(json.dumps(deltas, indent=2))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
