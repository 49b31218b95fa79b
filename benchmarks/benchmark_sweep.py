#!/usr/bin/env python3
"""E-step sweep benchmark: the fused Pallas kernel against the XLA tile loop,
on the synthetic ~1.1M-variant panel of ``bench.synthesize_genome``
(B=1024, int8), on one GPU.

For each lane count S it times a fused chain of sweeps (one dispatch of a
``fori_loop``, ended by ``block_until_ready``), repeated, for both
implementations in turns (xla, fused, fused, xla), after checking one fused
sweep with chip_smoke's phase f criterion (``_kernel_ok``). It then
times the S=1 fit to convergence with each implementation, in turns, and
compares the converged fits (max |d eta| <= 1e-5, |d h2| <= 1e-4).

Each time is reported beside the LD bytes a sweep must read, the achieved
rate, its share of the device's published peak bandwidth (table below) and
of a large copy measured in the same process. A device kind missing from the
peak table is an error.

Prints one JSON line per measurement; the last line is a summary. A failed
parity check is reported in its line and makes the run exit non-zero after
the timings.

Usage: python benchmarks/benchmark_sweep.py [--S 1,16,100] [--reps 5]
           [--chain 20] [--m-target 1100000] [--no-fit]
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: Published peaks by ``device_kind`` (NVIDIA H100 Tensor Core GPU data
#: sheet; dense rates, at the 700 W SXM / 350 W PCIe power limit).
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'hbm_bytes_s': 3.35e12, 'fp32_flops': 67e12,
                              'source': 'NVIDIA H100 data sheet, SXM5'},
    'NVIDIA H100 PCIe': {'hbm_bytes_s': 2.0e12, 'fp32_flops': 51e12,
                         'source': 'NVIDIA H100 data sheet, PCIe'},
}

FIT_ETA_ATOL = 1e-5
FIT_H2_ATOL = 1e-4


def emit(**row):
    print(json.dumps(row), flush=True)


def _flag(name, default, cast=str):
    if f'--{name}' in sys.argv:
        return cast(sys.argv[sys.argv.index(f'--{name}') + 1])
    return default


def peak_for(kind):
    if kind not in PEAKS:
        raise SystemExit(f"benchmark_sweep: no peak entry for device kind "
                         f"{kind!r}; add it to PEAKS with its source.")
    return PEAKS[kind]


def copy_bandwidth(jax, jnp, n_bytes=4 << 30, reps=5):
    """Bytes/s of a large device copy (read + write counted)."""
    x = jnp.zeros(n_bytes // 4, jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    f(x).block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        ts.append(time.perf_counter() - t0)
    del x
    return 2 * n_bytes / float(np.median(ts))


def main():
    import viprs_tpu  # noqa: F401  (float64 scalars, compile cache)
    import jax
    import jax.numpy as jnp
    from chip_smoke import make_problem, _sweep_parity, _kernel_ok
    from viprs_tpu.ops.cavi_jax import CaviState, Hyper, cavi_sweep
    from viprs_tpu.ops.cavi_fused import cavi_sweep_fused

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(f"benchmark_sweep: needs a GPU, found {dev.platform}")
    peak = peak_for(dev.device_kind)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    lanes_list = [int(v) for v in _flag('S', '1,16,100').split(',')]
    reps = _flag('reps', 5, int)
    chain_n = _flag('chain', 20, int)

    copy_bw = copy_bandwidth(jax, jnp)
    emit(device=dev.device_kind, platform=dev.platform, count=1,
         nvidia_smi=smi, copy_bytes_s=copy_bw, peak=peak)

    ds = make_problem(m_target=_flag('m-target', 1_100_000, int))
    ld = ds.ld
    sb, nf = ds.device_inputs(None)
    NB, B = ld.nb, ld.block_size
    ld_bytes = ld.diag.nbytes + ld.off_data.nbytes
    emit(M=ds.m, NB=NB, B=B, n_off=ld.n_off, ld_bytes=ld_bytes)

    impls = {'xla': cavi_sweep, 'fused': cavi_sweep_fused}
    order = ('xla', 'fused', 'fused', 'xla')

    def chain(impl):
        @jax.jit
        def run(state, ld_, sb_, nf_, hyper_, act_, n_):
            def body(_, st):
                return impls[impl](ld_, st, sb_, nf_, hyper_, act_)[0]
            return jax.lax.fori_loop(0, n_, body, state)
        return run

    chains = {k: chain(k) for k in impls}
    summary = {}
    for S in lanes_list:
        rng = np.random.default_rng(S)
        pi = np.geomspace(1e-4, 0.05, S).astype(np.float32)
        state = CaviState(
            logits=jnp.broadcast_to(
                jnp.asarray(np.log(pi) - np.log1p(-pi))[:, None, None],
                (S, NB, B)).astype(jnp.float32),
            mu=jnp.zeros((S, NB, B), jnp.float32),
            eta=jnp.zeros((S, NB, B), jnp.float32),
            q=jnp.zeros((S, NB, B), jnp.float32))
        hyper = Hyper(sigma_eps=jnp.full(S, 0.75, jnp.float32),
                      tau_beta=jnp.asarray(pi * ds.m / 0.25, jnp.float32),
                      pi=jnp.asarray(pi), lambda_min=jnp.zeros(S, jnp.float32))
        act = jnp.ones(S, jnp.float32)
        del rng

        # parity of one sweep from a warmed-up state (a few XLA sweeps in),
        # against the float32 loop and the float64 sweep:
        warm = chains['xla'](state, ld, sb, nf, hyper, act, 3)
        err, _ = _sweep_parity(ld, warm, sb, nf, hyper, False)
        ok = all(_kernel_ok(err, S).values())
        emit(S=S, parity=err, parity_ok=ok)
        summary[f'S{S}_parity_ok'] = ok

        times = {k: [] for k in impls}
        for k in impls:      # compile every chain outside the timing
            chains[k](warm, ld, sb, nf, hyper, act, 1).eta.block_until_ready()
        for _ in range(reps):
            for k in order:
                t0 = time.perf_counter()
                chains[k](warm, ld, sb, nf, hyper, act,
                          chain_n).eta.block_until_ready()
                times[k].append((time.perf_counter() - t0) / chain_n)
        for k, ts in times.items():
            ms = float(np.median(ts)) * 1e3
            rate = ld_bytes / (ms / 1e3)
            emit(S=S, impl=k, ms_per_sweep=ms, ms_min=min(ts) * 1e3,
                 ms_max=max(ts) * 1e3, n=len(ts), chain=chain_n,
                 ld_bytes_s=rate, share_of_peak_hbm=rate / peak['hbm_bytes_s'],
                 share_of_copy=rate / copy_bw)
            summary[f'S{S}_{k}_ms'] = ms
        if S == 1 and '--no-fit' not in sys.argv:
            summary.update(fit_ab(ds))
    emit(summary=summary, device=dev.device_kind, nvidia_smi=smi)
    if not all(v for k, v in summary.items() if k.endswith('_ok')):
        raise SystemExit("benchmark_sweep: a parity check failed")


def fit_ab(ds):
    """The S=1 fit to convergence with each implementation, in turns; the
    first round of each includes its compilation and is not counted."""
    from viprs_tpu.model import VIPRS
    summary, fits = {}, {}
    for rnd, k in enumerate(('xla', 'fused', 'fused', 'xla', 'xla',
                             'fused')):
        np.random.seed(0)
        t0 = time.perf_counter()
        m = VIPRS(ds)
        m.fit(max_iter=1000, f_abs_tol=1e-6, x_abs_tol=1e-6,
              sweep_impl=k)
        dt = time.perf_counter() - t0
        eta = np.asarray(m._state.eta)
        emit(fit=k, round=rnd, seconds=dt, nit=int(m.optim_result.nit),
             h2=float(m.get_heritability()),
             message=m.optim_result.message)
        fits.setdefault(k, []).append((dt, eta, m.get_heritability()))
    d_eta = float(np.max(np.abs(fits['xla'][-1][1] - fits['fused'][-1][1])))
    d_h2 = abs(float(fits['xla'][-1][2]) - float(fits['fused'][-1][2]))
    # round 0 of each implementation includes its compilation:
    for k in fits:
        summary[f'fit_{k}_s'] = float(np.median([f[0] for f in fits[k][1:]]))
    summary.update(fit_d_eta=d_eta, fit_d_h2=d_h2,
                   fit_ok=d_eta <= FIT_ETA_ATOL and d_h2 <= FIT_H2_ATOL)
    return summary


if __name__ == '__main__':
    main()
