#!/usr/bin/env python3
"""Cold-start census: which programs compile during a fresh genome-scale fit,
and what each costs.

Runs with the persistent compile cache pointed at a new, EMPTY directory
under $TMPDIR (a fresh machine's situation) and jax_log_compiles on, timing
each tracing/compile event around the phases of `VIPRS(ds)` + `fit()`.

Usage: python benchmarks/cold_compile_census.py [m_variants]
"""

import logging
import os
import sys
import tempfile
import time
from pathlib import Path

# before JAX is imported, which reads it: every compile below is cold
os.environ['JAX_COMPILATION_CACHE_DIR'] = tempfile.mkdtemp(
    prefix='census_cache_')

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
from profile_fit_host import build_dataset  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class CompileLogHandler(logging.Handler):
    def __init__(self):
        super().__init__()
        self.events = []

    def emit(self, record):
        msg = record.getMessage()
        if 'Compiling' in msg or 'compil' in msg.lower():
            self.events.append((time.time(), msg.split('\n')[0][:160]))


def main():
    import viprs_tpu  # noqa: F401
    import jax
    jax.config.update('jax_log_compiles', True)
    handler = CompileLogHandler()
    logging.getLogger('jax').addHandler(handler)
    logging.getLogger('jax').setLevel(logging.DEBUG)
    from viprs_tpu.model import VIPRS

    m_target = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 1_100_000
    ds = build_dataset(m_target)
    log(f"devices: {jax.devices()}  M={ds.m} NB={ds.layout.nb}  "
        f"cache={os.environ['JAX_COMPILATION_CACHE_DIR']}")

    def phase(name, fn):
        n0 = len(handler.events)
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        evs = handler.events[n0:]
        log(f"--- {name}: {dt:.2f}s, {len(evs)} compile events ---")
        prev = t0
        for t, msg in evs:
            log(f"   [+{t - t0:7.2f}s] {msg}")
        return out

    np.random.seed(0)
    model = phase('VIPRS(ds) ctor', lambda: VIPRS(ds))
    phase('initialize()', model.initialize)
    phase('fit()', lambda: model.fit(max_iter=1000, f_abs_tol=1e-6,
                                     x_abs_tol=1e-6, patience=10))
    log(f"iters={model.optim_result.nit} success={model.optim_result.success}")

    # steady-state sanity in the same process:
    np.random.seed(0)
    t0 = time.time()
    m2 = VIPRS(ds)
    m2.fit(max_iter=1000)
    log(f"second fresh fit same process: {time.time() - t0:.2f}s")


if __name__ == '__main__':
    main()
