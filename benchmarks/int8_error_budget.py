#!/usr/bin/env python3
"""int8 LD error budget at genome scale.

The framework's default packs LD into int8 tiles (scale 1/127), like the
reference's quantized stores (viprs/model/VIPRS.py:156-166, 201-207 —
``dequantize_on_the_fly``); the reference also exposes float LD. This
harness publishes the cost of the int8 default: it fits the identical 1.1M
problem with int8 and float32 LD storage (same explicit theta_0) and
reports the posterior deltas (PIP, posterior mean, h2, ELBO).

Usage: python benchmarks/int8_error_budget.py [--m M]
One JSON line on stdout; narrative to stderr.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--m', type=int, default=1_100_000)
    args = ap.parse_args()

    import viprs_tpu  # noqa: F401
    import jax
    import bench
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.model import VIPRS

    log(f"devices: {jax.devices()}")
    t0 = time.time()
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(m_target=args.m)
    log(f"synthesis: {time.time() - t0:.1f}s")

    fits = {}
    theta_0 = None
    for name, quantize in (('int8', True), ('f32', False)):
        t0 = time.time()
        ds = SummaryStatsDataset.from_dense_blocks(
            ld_blocks, std_beta, n_per_snp, block_size=1024,
            quantize=quantize)
        log(f"[{name}] packed in {time.time() - t0:.1f}s "
            f"({ds.ld.diag.nbytes / 1e9:.2f} GB diag tiles)")
        np.random.seed(0)
        model = VIPRS(ds)
        if theta_0 is None:
            # one explicit theta for both sides (no draw-order sensitivity):
            pi0, se0, tb0 = model._resolve_theta0(None)
            theta_0 = {'pi': pi0, 'sigma_epsilon': se0, 'tau_beta': tb0}
        t0 = time.time()
        model.fit(max_iter=1000, theta_0=theta_0)
        secs = time.time() - t0
        pip = np.concatenate([model.pip[c] for c in sorted(model.pip)])
        eta = np.concatenate(
            [model.post_mean_beta[c] for c in sorted(model.post_mean_beta)])
        fits[name] = dict(
            pip=pip, eta=eta, h2=float(model.get_heritability()),
            elbo=float(np.atleast_1d(model.history['ELBO'][-1])[0]),
            nit=int(model.optim_result.nit), seconds=secs)
        log(f"[{name}] fit: {secs:.2f}s, {fits[name]['nit']} iters, "
            f"h2={fits[name]['h2']:.5f}, elbo={fits[name]['elbo']:.2f}")
        del ds, model

    a, b = fits['int8'], fits['f32']
    sel_b = b['pip'] > 0.5
    sel_a = a['pip'] > 0.5
    out = {
        "metric": "int8_error_budget_1p1m",
        "h2": {"int8": round(a['h2'], 6), "f32": round(b['h2'], 6),
               "abs_diff": round(abs(a['h2'] - b['h2']), 6)},
        "elbo": {"int8": round(a['elbo'], 2), "f32": round(b['elbo'], 2),
                 "rel_diff": round(abs(a['elbo'] - b['elbo'])
                                   / abs(b['elbo']), 8)},
        "iters": {"int8": a['nit'], "f32": b['nit']},
        "pip": {
            "corr": round(float(np.corrcoef(a['pip'], b['pip'])[0, 1]), 6),
            "max_abs_diff": round(float(np.max(np.abs(a['pip'] - b['pip']))),
                                  6),
            "mean_abs_diff": round(
                float(np.mean(np.abs(a['pip'] - b['pip']))), 8),
            "n_selected_int8": int(sel_a.sum()),
            "n_selected_f32": int(sel_b.sum()),
            "selection_overlap": int((sel_a & sel_b).sum()),
        },
        "post_mean": {
            "corr": round(float(np.corrcoef(a['eta'], b['eta'])[0, 1]), 6),
            "max_abs_diff": round(float(np.max(np.abs(a['eta'] - b['eta']))),
                                  8),
            "rms_diff_over_rms": round(
                float(np.sqrt(np.mean((a['eta'] - b['eta']) ** 2))
                      / np.sqrt(np.mean(b['eta'] ** 2))), 6),
        },
        "seconds": {"int8": round(a['seconds'], 2),
                    "f32": round(b['seconds'], 2)},
    }
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
