#!/usr/bin/env python3
"""Data-path throughput benchmark: pack / quantize / cache round trips.

The fit dropped to ~1 s genome-wide, so ingestion+packing is the practical
floor for cold runs. This harness measures the
host-side stages in isolation (no device transfer) and reports GB/s over the
raw float64 LD bytes consumed.

Usage: python benchmarks/benchmark_datapath.py [m_variants]
"""

import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    # host-path benchmark: force the CPU backend so jnp.asarray placement and
    # array reads measure the host alone; set the config directly (before any
    # backend initialization) rather than relying on env-var defaults.
    import viprs_tpu  # noqa: F401
    import jax
    try:
        jax.config.update('jax_platforms', 'cpu')
    except Exception:
        pass
    assert jax.default_backend() == 'cpu', jax.default_backend()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'bench', Path(__file__).resolve().parent.parent / 'bench.py')
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    from viprs_tpu.ops.block_ld import pack_dense_blocks
    from viprs_tpu.data.native import load_native
    from viprs_tpu.data import pack_cache

    m_target = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 400_000
    log(f"native kernels: {'yes' if load_native() else 'NO (NumPy fallbacks)'}")

    t0 = time.time()
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(m_target=m_target)
    raw_bytes = sum(b.nbytes for blks in ld_blocks.values() for b in blks)
    log(f"synthesis: {time.time() - t0:.1f}s  raw LD {raw_bytes / 1e9:.2f} GB f64")

    # host-side packing (int8 quantize + tile fill), excluding device_put:
    for quantize in (True, False):
        t0 = time.time()
        ld, lay = pack_dense_blocks(ld_blocks, block_size=1024,
                                    quantize=quantize)
        np.asarray(ld.mask)  # touch
        dt = time.time() - t0
        packed = ld.diag.size * ld.diag.dtype.itemsize \
            + ld.off_data.size * ld.off_data.dtype.itemsize
        log(f"pack(quantize={quantize}): {dt:.2f}s  "
            f"{raw_bytes / dt / 1e9:.2f} GB/s raw-in  "
            f"packed {packed / 1e9:.2f} GB (NB={lay.nb})")

    # packed-LD disk cache round trip:
    tmp = tempfile.mkdtemp(prefix='vt_packcache_')
    try:
        key = 'bench' + '0' * 58
        t0 = time.time()
        pack_cache.save_packed(key, ld, lay, root=tmp)
        t_save = time.time() - t0
        t0 = time.time()
        hit = pack_cache.load_packed(key, root=tmp)
        assert hit is not None
        np.asarray(hit[0].mask)
        t_load = time.time() - t0
        log(f"pack cache: save {t_save:.2f}s  load {t_load:.2f}s "
            f"({packed / max(t_load, 1e-9) / 1e9:.2f} GB/s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    import json
    print(json.dumps({'m': int(lay.m), 'raw_gb': raw_bytes / 1e9,
                      'native': load_native() is not None}))


if __name__ == '__main__':
    main()
