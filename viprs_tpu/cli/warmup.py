"""viprs_warmup — precompile the fused EM programs for an LD store.

Cold start: the fused EM loop is a small program (~1.6k StableHLO lines),
but a cold compile for an accelerator still takes seconds to tens of
seconds. The compiled executable is keyed by the LD store's
packed SHAPES (number of blocks x block size) and the fit's static
parameters — so it can be built AHEAD of time, from store metadata alone
(no LD data is read), into the persistent compile cache
(``JAX_COMPILATION_CACHE_DIR`` if set, else ``.cache/jax`` in the checkout;
see ``viprs_tpu/__init__.py``). After a warmup, every fresh process fitting that
panel starts at steady-state speed.

Usage:
    viprs_warmup -l LD_STORE_PATH [--block-size 1024] [--max-iter 1000]
                 [--grid-widths 100 [S2 ...]] [--mesh auto|off|NxM]
"""

import argparse
import logging
import sys
import time

import numpy as np

logger = logging.getLogger('viprs_warmup')


def build_parser():
    p = argparse.ArgumentParser(
        'viprs_warmup', description=__doc__.split('\n\n')[0])
    p.add_argument('-l', '--ld-panel', dest='ld_dir', required=True,
                   help='Path to the LD store (native or magenpy Zarr).')
    p.add_argument('--block-size', dest='block_size', type=int, default=1024)
    p.add_argument('--max-iter', dest='max_iter', type=int, default=1000,
                   help='Must match the --max-iter of the later fits '
                        '(it is a static shape of the compiled loop).')
    p.add_argument('--grid-widths', dest='grid_widths', type=int, nargs='*',
                   default=[], help='Also precompile grid fits at these '
                                    'model counts (e.g. 100).')
    p.add_argument('--dequantize-on-the-fly', dest='dequantize',
                   action='store_true',
                   help='Must match the later fits (int8 vs f32 LD in HBM '
                        'changes the compiled program).')
    p.add_argument('--mesh', dest='mesh', default='auto',
                   help="Device mesh spec, as for viprs_fit ('auto', 'off', "
                        "'NxM').")
    return p


def _shape_dataset(ld_dir, block_size, quantize=False):
    """A dataset with the store's exact packed shapes and ZERO data —
    np.zeros blocks cost no physical memory until written, and the packer
    only needs shapes. No LD data is decompressed."""
    import os.path as osp
    from ..data import ld_store
    from ..data.dataset import SummaryStatsDataset

    if osp.exists(osp.join(ld_dir, 'metadata.json')):
        sizes = ld_store.native_store_block_sizes(ld_dir)
    else:
        # magenpy Zarr store (boundary metadata only, no LD data read):
        sizes = ld_store.magenpy_zarr_block_sizes(ld_dir)
    ld_blocks, std_beta, n_per_snp = {}, {}, {}
    for c, per_block in sizes.items():
        bl = [np.zeros((m_b, m_b)) for m_b in per_block]
        m_c = sum(b.shape[0] for b in bl)
        ld_blocks[c] = bl
        std_beta[c] = np.zeros(m_c)
        n_per_snp[c] = np.full(m_c, 1000.0)
    return SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=block_size,
        quantize=quantize)


def warm(ds, S, max_iter, mesh='auto'):
    """Compile (into the persistent cache) the fused fit program for S lanes
    on this dataset's shapes, without running it.

    Drives the REAL model driver with ``compile_only=True`` — the lowered
    program is by construction the exact dispatch a later ``fit()`` makes
    (same mesh resolution, same dispatch policy, same in-graph-restart
    configuration); there is no separate arg transcription to drift."""
    from ..model import VIPRS, VIPRSGrid
    from ..gridsearch import HyperparameterGrid

    t0 = time.time()
    np_state = np.random.get_state()
    try:
        if S == 1:
            model = VIPRS(ds, mesh=mesh)
        else:
            grid = HyperparameterGrid(pi_steps=S, n_snps=ds.m,
                                      h2_est=0.1, h2_se=0.05)
            model = VIPRSGrid(ds, grid, mesh=mesh)
        model.fit(max_iter=max_iter, compile_only=True)
    finally:
        np.random.set_state(np_state)   # warmup must not perturb RNG streams
    logger.info("compiled S=%d em_fit%s in %.1fs", S,
                '' if model.mesh is None
                else f" (mesh {dict(model.mesh.shape)})", time.time() - t0)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    args = build_parser().parse_args(argv)
    import viprs_tpu  # noqa: F401  (enables x64 + the persistent cache)
    import jax
    # the whole point of warmup is persisting — drop the min-compile-time
    # gate (the package default skips persisting sub-second compiles):
    try:
        jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
    except Exception:
        pass
    logger.info("> backend: %s  devices: %s", jax.default_backend(),
                jax.devices())
    t0 = time.time()
    ds = _shape_dataset(args.ld_dir, args.block_size,
                        quantize=args.dequantize)
    logger.info("> store shapes: M=%d NB=%d B=%d (%.1fs, metadata only)",
                ds.m, ds.layout.nb, ds.layout.block_size, time.time() - t0)
    warm(ds, 1, args.max_iter, mesh=args.mesh)
    for S in args.grid_widths:
        # warms the full-width grid program (the dominant compile); the
        # compacted re-run widths carry chunk state (init_elbo arrays) and
        # compile lazily on first use:
        warm(ds, int(S), args.max_iter, mesh=args.mesh)
    logger.info("> done in %.1fs — compiled programs are in the persistent "
                "cache; fits on this panel now start at steady-state speed.",
                time.time() - t0)
    return 0


if __name__ == '__main__':
    sys.exit(main())
