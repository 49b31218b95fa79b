#!/usr/bin/env python3
"""Attribute the host-side cost of a steady-state genome-scale VIPRS fit.

A fresh-model fit costs more than its iterations' device time: host-side
work (model construction, initialize(), input refresh, dispatch round
trips, result pulls) sits around it. This harness breaks that down, in one
process on a warm compile cache:

  phase timing : VIPRS(ds) ctor / initialize() / fit() split out
  cProfile     : top host functions by cumulative time inside one fresh fit

Usage: python benchmarks/profile_fit_host.py [m_variants] [--reps 5]
"""

import cProfile
import io
import pickle
import pstats
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CACHE = Path('/tmp/viprs_fit_cache')


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_dataset(m_target):
    """Build (and disk-cache) the bench.py genome-scale SummaryStatsDataset."""
    import jax.numpy as jnp
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.ops.block_ld import BlockLD

    tag = CACHE / f'm{m_target}'
    if (tag / 'layout.pkl').exists():
        log(f"loading cached dataset from {tag}")
        with open(tag / 'layout.pkl', 'rb') as f:
            meta = pickle.load(f)
        arr = np.load(tag / 'arrays.npz')
        ld = BlockLD(diag=jnp.asarray(arr['diag']),
                     off_data=jnp.asarray(arr['off_data']),
                     off_src=jnp.asarray(arr['off_src']),
                     off_dst=jnp.asarray(arr['off_dst']),
                     mask=jnp.asarray(arr['mask']), scale=float(arr['scale']))
        return SummaryStatsDataset(ld=ld, layout=meta['layout'],
                                   std_beta=meta['std_beta'],
                                   n_per_snp=meta['n_per_snp'])

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'bench', Path(__file__).resolve().parent.parent / 'bench.py')
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    from viprs_tpu.data.dataset import SummaryStatsDataset

    t0 = time.time()
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(m_target=m_target)
    log(f"synthesis: {time.time() - t0:.1f}s")
    t0 = time.time()
    ds = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=True)
    log(f"packing: {time.time() - t0:.1f}s NB={ds.layout.nb}")

    tag.mkdir(parents=True, exist_ok=True)
    np.savez(tag / 'arrays.npz',
             diag=np.asarray(ds.ld.diag), off_data=np.asarray(ds.ld.off_data),
             off_src=np.asarray(ds.ld.off_src),
             off_dst=np.asarray(ds.ld.off_dst),
             mask=np.asarray(ds.ld.mask), scale=ds.ld.scale)
    with open(tag / 'layout.pkl', 'wb') as f:
        pickle.dump({'layout': ds.layout, 'std_beta': ds.std_beta,
                     'n_per_snp': ds.n_per_snp}, f)
    return ds


def main():
    import viprs_tpu  # noqa: F401
    import jax
    from viprs_tpu.model import VIPRS

    m_target = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 1_100_000
    n_rep = int(sys.argv[sys.argv.index('--reps') + 1]) \
        if '--reps' in sys.argv else 5

    ds = build_dataset(m_target)
    log(f"devices: {jax.devices()}  M={ds.m} NB={ds.layout.nb}")
    fit_kwargs = dict(max_iter=1000, f_abs_tol=1e-6, x_abs_tol=1e-6,
                      patience=10)

    # warm-up (compile + device caches):
    np.random.seed(0)
    t0 = time.time()
    m = VIPRS(ds)
    m.fit(**fit_kwargs)
    log(f"warm-up fit: {time.time() - t0:.2f}s iters={m.optim_result.nit}")

    # ---- phase timing over reps ----
    rows = []
    for rep in range(n_rep):
        np.random.seed(0)
        t0 = time.time()
        model = VIPRS(ds)
        t_ctor = time.time() - t0

        t0 = time.time()
        model.initialize()
        t_init = time.time() - t0

        t0 = time.time()
        model.fit(continued=True, **fit_kwargs)
        t_fit = time.time() - t0
        rows.append((t_ctor, t_init, t_fit))
        log(f"rep {rep + 1}: ctor {t_ctor * 1e3:.1f} ms  "
            f"initialize {t_init * 1e3:.1f} ms  fit(continued) {t_fit:.3f} s  "
            f"total {t_ctor + t_init + t_fit:.3f} s "
            f"iters={model.optim_result.nit}")
    med = np.median(np.asarray(rows), axis=0)
    log(f"median: ctor {med[0] * 1e3:.1f} ms  initialize {med[1] * 1e3:.1f} ms"
        f"  fit {med[2]:.3f} s  total {med.sum():.3f} s")

    # ---- fresh-fit total (the headline path) ----
    fresh = []
    for rep in range(n_rep):
        np.random.seed(0)
        t0 = time.time()
        model = VIPRS(ds)
        model.fit(**fit_kwargs)
        fresh.append(time.time() - t0)
    log(f"fresh fit totals: {['%.3f' % t for t in fresh]} "
        f"(median {np.median(fresh):.3f} s)")

    # ---- cProfile one fresh fit ----
    np.random.seed(0)
    pr = cProfile.Profile()
    pr.enable()
    model = VIPRS(ds)
    model.fit(**fit_kwargs)
    pr.disable()
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats('cumulative')
    ps.print_stats(45)
    log(s.getvalue())


if __name__ == '__main__':
    main()
