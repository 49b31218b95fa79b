#!/usr/bin/env python3
"""Smoke test of the fit path on one GPU, through the library entry points.

Builds the ~1.1M-variant synthetic panel of ``bench.synthesize_genome``
(22 chromosomes, AR(1) LD blocks, packed at B=1024 in int8, seeded) and runs:

  a. device     — a ``gpu`` platform, its kind and count, and the card's name
                  and power limit from nvidia-smi;
  b. sweep      — one ``cavi_sweep(relax=False, inner_steps=1)`` on a few real
                  B=1024 blocks of the panel held in f32, against the float64
                  NumPy tile schedule of ``tests/reference_impl.py``;
  c. fit        — ``VIPRS`` to convergence (f_abs_tol = x_abs_tol = 1e-6),
                  cold (with compilation) and warm;
  d. grid       — ``VIPRSGrid`` over 100 settings, then
                  ``bayesian_model_average``;
  e. mixtures   — ``VIPRSMix(K=3)`` and ``VIPRSMixGrid(20 x K=3)``;
  f. kernel     — the fused sweep kernel against ``cavi_sweep``, one sweep at
                  S=1 and S=100, from the fits' initial state and after three
                  sweeps.

With ``--four-cards`` it runs only the sharded path instead: the S=1 fit and a
16-lane grid on mesh 'auto' over four cards, each against the same fit with
mesh 'off' on card 0.

Every phase prints one line; any failure raises and exits non-zero. The last
line of stdout is one JSON object naming the device. On a platform other than
``gpu`` the script exits non-zero before printing any result.

Usage: python3 chip_smoke.py [--four-cards]
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: Tolerances of phase b: those of tests/test_ops.py's single-sweep parity.
SWEEP_ATOL = {'eta': 2e-5, 'gamma': 2e-4, 'q': 2e-4}
#: Tolerances of phase f: the fused kernel against the XLA sweep, one sweep.
KERNEL_ATOL = {'eta': 1e-5, 'mu': 1e-5, 'gamma': 1e-5, 'q': 1e-4}
#: Phase f: at most this many coordinates, or this share of the live ones
#: if larger, may be left out of the kernel's mu/gamma check (see
#: ``_sweep_parity``) or differ from the float32 loop in the keep decision.
KERNEL_MAX_EXCLUDED = 10
KERNEL_MAX_EXCLUDED_FRAC = 1e-4
#: Tolerances of phase f: the converged S=1 fit, fused kernel against XLA.
FIT_ETA_ATOL = 1e-5
FIT_H2_ATOL = 1e-4
#: Tolerances of the four-card comparison against one card.
MESH_H2_ATOL = 1e-4
MESH_ELBO_RTOL = 1e-6
MESH_NIT_SLACK = 2


def say(tag, msg):
    print(f"[{tag}] {msg}", flush=True)


def make_problem(m_target=1_100_000, block_size=1024, seed=0):
    """The seeded synthetic panel, packed in int8 tiles of ``block_size``."""
    from bench import synthesize_genome
    from viprs_tpu.data.dataset import SummaryStatsDataset
    ld_blocks, std_beta, n_per_snp = synthesize_genome(
        m_target=m_target, seed=seed, block_dtype=np.float32)
    return SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=block_size, quantize=True)


def phase_device(platform='gpu'):
    """Phase a: the first device must be on ``platform``. Returns its
    (platform, kind, count) and the nvidia-smi lines (empty off a GPU)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != platform:
        raise SystemExit(f"chip_smoke: no {platform} device "
                         f"(JAX platform is {dev.platform!r})")
    smi = []
    if platform == 'gpu':
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    return dev.platform, dev.device_kind, len(jax.devices()), smi


def phase_sweep(ds, n_blocks=4, tile=128, pi0=0.002, sigma_eps=0.75,
                h2=0.25):
    """Phase b: one unrelaxed single-pass sweep on ``n_blocks`` diagonal
    tiles of the panel (held in f32) against the float64 reference schedule.
    Returns {name: max |delta|}; raises if any exceeds SWEEP_ATOL."""
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    import reference_impl as ref
    from viprs_tpu.ops.block_ld import BlockLD
    from viprs_tpu.ops.cavi_jax import CaviState, Hyper, cavi_sweep

    ld = ds.ld
    B = ld.block_size
    # the fullest blocks: the most coupled coordinates per tile
    fill = np.asarray(ld.mask).sum(axis=1)
    blocks = np.sort(np.argsort(-fill, kind='stable')[:n_blocks])
    diag = np.asarray(ld.diag[blocks]).astype(np.float32) \
        * np.float32(ld.scale)
    mask = np.asarray(ld.mask[blocks])
    sb, n_flat = (np.asarray(x, np.float32)[blocks]
                  for x in ds.device_inputs(None))
    tau_beta = pi0 * ds.m / h2

    sub = BlockLD(diag=jnp.asarray(diag),
                  off_data=jnp.zeros((0, B, B), jnp.float32),
                  off_src=jnp.zeros(0, jnp.int32),
                  off_dst=jnp.zeros(0, jnp.int32),
                  mask=jnp.asarray(mask), scale=1.0)
    nb = len(blocks)
    logit0 = np.float32(np.log(pi0) - np.log1p(-pi0))
    zeros = jnp.zeros((1, nb, B), jnp.float32)
    state = CaviState(logits=jnp.full((1, nb, B), logit0), mu=zeros,
                      eta=zeros, q=zeros)
    f = lambda v: jnp.full((1,), v, jnp.float32)  # noqa: E731
    hyper = Hyper(sigma_eps=f(sigma_eps), tau_beta=f(tau_beta), pi=f(pi0),
                  lambda_min=f(0.0))
    new, _ = cavi_sweep(sub, state, jnp.asarray(sb), jnp.asarray(n_flat),
                        hyper, jnp.ones(1), tile=tile, relax=False,
                        inner_steps=1)
    got = {'eta': np.asarray(new.eta)[0], 'gamma': np.asarray(new.gamma)[0],
           'q': np.asarray(new.q)[0]}

    err = {k: 0.0 for k in SWEEP_ATOL}
    for i in range(nb):
        # the reference runs in float64 on the same f32 tile and inputs;
        # padded lanes have n = 0, so they never move:
        R = diag[i].astype(np.float64)
        gamma = np.full(B, float(np.float32(pi0)))
        mu, eta, q = np.zeros(B), np.zeros(B), np.zeros(B)
        ref.tile_e_step(R, sb[i].astype(np.float64),
                        n_flat[i].astype(np.float64), gamma, mu, eta, q,
                        float(np.float32(sigma_eps)),
                        float(np.float32(tau_beta)), float(np.float32(pi0)),
                        tile=tile)
        live = mask[i] > 0
        for k, v in (('eta', eta), ('gamma', gamma), ('q', q)):
            err[k] = max(err[k], float(np.max(np.abs(got[k][i] - v)[live])))
    bad = {k: v for k, v in err.items() if not v <= SWEEP_ATOL[k]}
    if bad:
        raise AssertionError(f"sweep differs from the float64 reference: "
                             f"{bad} (limits {SWEEP_ATOL})")
    return err


def _check_fit(model, what):
    res = model.optim_result
    elbo = float(np.max(np.atleast_1d(model.objective())))
    h2 = float(model.get_heritability())
    if not res.valid_optim_result:
        raise AssertionError(f"{what}: invalid result: {res.message}")
    if not np.isfinite(elbo):
        raise AssertionError(f"{what}: non-finite ELBO {elbo}")
    if not 0.0 < h2 < 1.0:
        raise AssertionError(f"{what}: h2 {h2} outside (0, 1)")
    return elbo, h2


def phase_fit(ds, mesh='auto', max_iter=1000):
    """Phase c: S=1 VIPRS fit to convergence, cold then warm. Returns a dict
    of the warm fit's iterations, h2 and ELBO, and both wall times."""
    from viprs_tpu.model import VIPRS
    out = {}
    for run in ('cold', 'warm'):
        np.random.seed(0)
        t0 = time.perf_counter()
        model = VIPRS(ds, mesh=mesh)
        model.fit(max_iter=max_iter, f_abs_tol=1e-6, x_abs_tol=1e-6)
        out[f'{run}_s'] = time.perf_counter() - t0
    out['elbo'], out['h2'] = _check_fit(model, 'VIPRS')
    out['nit'] = int(model.optim_result.nit)
    out['model'] = model
    return out


def _grid(ds, pi_steps, sigma_epsilon_steps=None):
    from viprs_tpu.gridsearch import HyperparameterGrid
    return HyperparameterGrid(pi_steps=pi_steps,
                              sigma_epsilon_steps=sigma_epsilon_steps,
                              n_snps=ds.m, h2_est=0.25, h2_se=0.05)


def _lane_elbos(g):
    """Final ELBO of every grid lane; raises unless all are finite."""
    elbo = np.asarray(g.validation_result['ELBO'], np.float64)
    if not np.all(np.isfinite(elbo)):
        raise AssertionError(f"non-finite grid ELBOs in lanes "
                             f"{np.nonzero(~np.isfinite(elbo))[0].tolist()}")
    return elbo


def phase_grid(ds, pi_steps=20, sigma_epsilon_steps=5, max_iter=500,
               mesh='auto'):
    """Phase d: VIPRSGrid over pi_steps x sigma_epsilon_steps settings, then
    BMA. Returns lane count, converged lanes, BMA h2 and the wall time."""
    from viprs_tpu.model import VIPRSGrid
    from viprs_tpu.gridsearch import bayesian_model_average
    np.random.seed(0)
    t0 = time.perf_counter()
    g = VIPRSGrid(ds, _grid(ds, pi_steps, sigma_epsilon_steps), mesh=mesh)
    lanes = g.n_models
    g.fit(max_iter=max_iter)
    _lane_elbos(g)
    converged = int(np.sum(g.converged_models))
    bayesian_model_average(g)
    h2 = float(g.get_heritability())
    if not np.isfinite(h2):
        raise AssertionError(f"BMA h2 is {h2}")
    return {'lanes': lanes, 'converged': converged, 'bma_h2': h2,
            'seconds': time.perf_counter() - t0}


def phase_mixtures(ds, K=3, pi_steps=20, max_iter=500):
    """Phase e: VIPRSMix(K) and VIPRSMixGrid(pi_steps x K); each must end
    with finite objectives."""
    from viprs_tpu.model import VIPRSMix, VIPRSMixGrid
    out = {}
    np.random.seed(0)
    t0 = time.perf_counter()
    mix = VIPRSMix(ds, K=K)
    mix.fit(max_iter=max_iter)
    elbo = float(mix.objective())
    if not (np.isfinite(elbo) and np.isfinite(mix.get_heritability())):
        raise AssertionError(f"VIPRSMix: ELBO {elbo}, "
                             f"h2 {mix.get_heritability()}")
    out['mix'] = {'nit': int(mix.optim_result.nit), 'elbo': elbo,
                  'h2': float(mix.get_heritability()),
                  'seconds': time.perf_counter() - t0}
    np.random.seed(0)
    t0 = time.perf_counter()
    g = VIPRSMixGrid(ds, _grid(ds, pi_steps), K=K)
    g.fit(max_iter=max_iter)
    _lane_elbos(g)
    out['mix_grid'] = {'lanes': g.n_models,
                       'converged': int(np.sum(g.converged_models)),
                       'seconds': time.perf_counter() - t0}
    return out


def _sweep_parity(ld, state, sb, nf, hyper, interpret):
    """One sweep from ``state`` by the XLA loop and by the fused kernel (both
    float32), and by the XLA loop in float64 as the reference.

    Returns per field the max |delta| of the kernel against the float32 loop
    (``vs_xla``) and of each against the float64 sweep (``xla_vs_f64``,
    ``fused_vs_f64``). For mu and gamma, ``settled_vs_f64`` is the kernel's
    max |delta| against float64 over the coordinates where the float32 loop
    itself meets the field's tolerance against float64 and both float32
    sweeps made the same 1e-8 keep decision. Elsewhere no float32 sweep is
    held to that tolerance: where one sweep moved a coordinate and the other
    kept it, mu and gamma differ by a whole update; and a 1e-8 change in q
    moves gamma by up to ~1e-5 for strongly associated variants.
    ``excluded`` counts the coordinates left out, ``flipped`` those where
    the two keep decisions differ, and ``live`` the unpadded coordinates of
    all lanes. Also returns the float32 loop's next state."""
    import jax.numpy as jnp
    from viprs_tpu.ops.cavi_jax import CaviState, Hyper, cavi_sweep
    from viprs_tpu.ops.cavi_fused import cavi_sweep_fused
    S = state.eta.shape[0]
    act = jnp.ones(S, jnp.float32)
    f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    a, da = cavi_sweep(ld, state, sb, nf, hyper, act)
    b, db = cavi_sweep_fused(ld, state, sb, nf, hyper, act,
                             interpret=interpret)
    c, _ = cavi_sweep(ld, CaviState(*map(f64, state)), f64(sb), f64(nf),
                      Hyper(*map(f64, hyper)), f64(act))
    same_keep = (da == 0) == (db == 0)
    out = {'vs_xla': {}, 'xla_vs_f64': {}, 'fused_vs_f64': {},
           'settled_vs_f64': {}, 'excluded': {},
           'flipped': int(jnp.sum(~same_keep)),
           'live': S * int(jnp.sum(ld.mask > 0))}
    for k, tol in KERNEL_ATOL.items():
        x, y, z = (getattr(v, k).astype(jnp.float64) for v in (a, b, c))
        d = jnp.abs(y - x)
        out['vs_xla'][k] = float(jnp.max(d))
        out['xla_vs_f64'][k] = float(jnp.max(jnp.abs(x - z)))
        out['fused_vs_f64'][k] = float(jnp.max(jnp.abs(y - z)))
        if k in ('mu', 'gamma'):
            settled = same_keep & (jnp.abs(x - z) <= tol)
            out['settled_vs_f64'][k] = float(jnp.max(
                jnp.where(settled, jnp.abs(y - z), 0.0)))
            out['excluded'][k] = int(jnp.sum(~settled))
    return out, a


def max_excluded(live):
    """How many coordinates phase f may leave out of ``live``."""
    return max(KERNEL_MAX_EXCLUDED, int(KERNEL_MAX_EXCLUDED_FRAC * live))


def _kernel_ok(e, S=1):
    """eta and q within KERNEL_ATOL of the float32 loop everywhere, and the
    keep decisions of the two float32 sweeps differing on at most
    ``max_excluded`` coordinates. At S=1 also mu and gamma, within
    KERNEL_ATOL of the float64 sweep wherever the float32 loop is (see
    ``_sweep_parity``), with at most ``max_excluded`` coordinates left out.
    With grid lanes, single-sweep mu and gamma are reported, not held: lanes
    with large pi are conditioned so that the float32 loop itself is ~1e-3
    from float64 there, and the policy runs the kernel at S=1 only; the
    converged fit is held instead."""
    cap = max_excluded(e['live'])
    fields = KERNEL_ATOL if S == 1 else ('eta', 'q')
    ok = {k: (e['settled_vs_f64'][k] if k in e['settled_vs_f64']
              else e['vs_xla'][k]) <= KERNEL_ATOL[k] for k in fields}
    ok['flipped'] = e['flipped'] <= cap
    if S == 1:
        ok.update({f'excluded_{k}': n <= cap
                   for k, n in e['excluded'].items()})
    return ok


def phase_kernel(ds, lanes=(1, 100), warm_sweeps=3, interpret=False,
                 max_iter=1000):
    """Phase f: the fused kernel against ``cavi_sweep`` at each lane count,
    one sweep from the fit's own initial state (a VIPRS, or a VIPRSGrid over
    ``S // 5`` pi x 5 sigma_epsilon settings) and after ``warm_sweeps``
    sweeps, each held by ``_kernel_ok``; then the S=1 fit to convergence
    with each sweep, held to max |d eta| <= FIT_ETA_ATOL and
    |d h2| <= FIT_H2_ATOL. Returns the sweep rows and the fit comparison."""
    import jax.numpy as jnp
    from viprs_tpu.model import VIPRS, VIPRSGrid
    from viprs_tpu.ops.cavi_jax import cavi_sweep
    rows = []
    for S in lanes:
        np.random.seed(0)
        model = (VIPRS(ds, mesh='off') if S == 1 else
                 VIPRSGrid(ds, _grid(ds, S // 5, 5), mesh='off'))
        model.initialize()
        model._refresh_inputs()
        args = (model._ld, model._std_beta_flat, model._n_flat,
                model._hyper_f32())
        state = model._state
        for k in range(warm_sweeps + 1):
            if k in (0, warm_sweeps):
                e, nxt = _sweep_parity(args[0], state, *args[1:], interpret)
                rows.append({'S': S, 'after': k, **e})
                ok = _kernel_ok(e, S)
                if not all(ok.values()):
                    raise AssertionError(
                        f"fused sweep fails at S={S} after {k} sweeps in "
                        f"{[f for f, v in ok.items() if not v]}: {e}")
                state = nxt
            else:
                state = cavi_sweep(args[0], state, *args[1:],
                                   jnp.ones(S, jnp.float32))[0]

    fits = {}
    for impl in ('xla', 'fused'):
        np.random.seed(0)
        m = VIPRS(ds, mesh='off')
        m.fit(max_iter=max_iter, f_abs_tol=1e-6, x_abs_tol=1e-6,
              sweep_impl=impl)
        fits[impl] = (np.asarray(m._state.eta), float(m.get_heritability()),
                      int(m.optim_result.nit))
    fit = {'d_eta': float(np.max(np.abs(fits['xla'][0] - fits['fused'][0]))),
           'd_h2': abs(fits['xla'][1] - fits['fused'][1]),
           'nit': (fits['xla'][2], fits['fused'][2])}
    if not (fit['d_eta'] <= FIT_ETA_ATOL and fit['d_h2'] <= FIT_H2_ATOL):
        raise AssertionError(f"converged S=1 fits differ: {fit} (limits "
                             f"{FIT_ETA_ATOL}, {FIT_H2_ATOL})")
    return rows, fit


def _compare_fits(sharded, single, what):
    """Four cards against one: h2, relative ELBO and iterations."""
    d_h2 = np.max(np.abs(np.asarray(sharded['h2']) - single['h2']))
    d_elbo = np.max(np.abs(np.asarray(sharded['elbo']) - single['elbo'])
                    / np.abs(single['elbo']))
    d_nit = np.max(np.abs(np.asarray(sharded['nit']) - single['nit']))
    if not (d_h2 <= MESH_H2_ATOL and d_elbo <= MESH_ELBO_RTOL
            and d_nit <= MESH_NIT_SLACK):
        raise AssertionError(
            f"{what}: 4 cards vs 1 differ: |dh2|={d_h2:.3g} "
            f"(<= {MESH_H2_ATOL}), rel dELBO={d_elbo:.3g} "
            f"(<= {MESH_ELBO_RTOL}), |dnit|={d_nit} (<= {MESH_NIT_SLACK})")
    return {'d_h2': float(d_h2), 'd_elbo_rel': float(d_elbo),
            'd_nit': int(d_nit)}


def _grid_lanes(ds, mesh, lanes, max_iter):
    from viprs_tpu.model import VIPRSGrid
    np.random.seed(0)
    g = VIPRSGrid(ds, _grid(ds, lanes), mesh=mesh)
    g.fit(max_iter=max_iter)
    return {'elbo': _lane_elbos(g),
            'h2': np.asarray(g.get_heritability(), np.float64),
            'nit': np.asarray([r.nit for r in g.optim_results])}, g


def phase_four_cards(ds, n_cards=4, lanes=16, max_iter=1000):
    """The sharded path: S=1 fit and a ``lanes``-lane grid on mesh 'auto'
    over ``n_cards`` devices, each against mesh 'off' on device 0, and the
    diagonal LD tiles split over every device."""
    import jax
    if len(jax.devices()) != n_cards:
        raise SystemExit(f"chip_smoke: --four-cards needs {n_cards} devices, "
                         f"found {len(jax.devices())}")
    sharded = phase_fit(ds, mesh='auto', max_iter=max_iter)
    model = sharded.pop('model')
    diag = model._ld.diag
    holders = {s.device for s in diag.addressable_shards}
    rows = {s.data.shape[0] for s in diag.addressable_shards}
    if len(holders) != n_cards or len(rows) != 1 \
            or rows.pop() * n_cards != diag.shape[0]:
        raise AssertionError(f"diagonal LD tiles are not split over "
                             f"{n_cards} devices: {diag.sharding}")
    single = phase_fit(ds, mesh='off', max_iter=max_iter)
    single.pop('model')
    out = {'fit': _compare_fits(sharded, single, 'S=1 fit'),
           'fit_s': (sharded['warm_s'], single['warm_s'])}
    g4, g = _grid_lanes(ds, 'auto', lanes, max_iter)
    if g.mesh is None or g.mesh.devices.size != n_cards:
        raise AssertionError(f"grid did not run on a {n_cards}-device mesh")
    g1, _ = _grid_lanes(ds, 'off', lanes, max_iter)
    out['grid'] = _compare_fits(g4, g1, f'{lanes}-lane grid')
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = '--four-cards' in argv
    sys.path.insert(0, REPO)
    import viprs_tpu  # noqa: F401  (float64 scalars, compile cache)

    platform, kind, count, smi = phase_device('gpu')
    say(kind, f"a. device: platform={platform} kind={kind} count={count}")

    t0 = time.perf_counter()
    ds = make_problem()
    say(kind, f"problem: M={ds.m} NB={ds.layout.nb} B={ds.layout.block_size}"
              f" n_off={ds.ld.n_off} diag={ds.ld.diag.nbytes / 1e9:.3f} GB "
              f"int8, built in {time.perf_counter() - t0:.1f} s")

    if four:
        r = phase_four_cards(ds)
        say(kind, f"four cards vs one: S=1 {r['fit']} (warm s: 4 cards "
                  f"{r['fit_s'][0]:.3f}, 1 card {r['fit_s'][1]:.3f}); "
                  f"grid {r['grid']}")
    else:
        err = phase_sweep(ds)
        say(kind, "b. sweep vs float64 reference: " + ", ".join(
            f"max|d{k}|={v:.3g} (<= {SWEEP_ATOL[k]})" for k, v in err.items()))
        r = phase_fit(ds)
        say(kind, f"c. S=1 fit: nit={r['nit']} h2={r['h2']:.6f} "
                  f"ELBO={r['elbo']:.6f} cold={r['cold_s']:.3f} s "
                  f"warm={r['warm_s']:.3f} s")
        r = phase_grid(ds)
        say(kind, f"d. grid({r['lanes']})+BMA: converged "
                  f"{r['converged']}/{r['lanes']} BMA h2={r['bma_h2']:.6f} "
                  f"{r['seconds']:.3f} s (cold)")
        r = phase_mixtures(ds)
        say(kind, f"e. VIPRSMix(K=3): nit={r['mix']['nit']} "
                  f"h2={r['mix']['h2']:.6f} {r['mix']['seconds']:.3f} s; "
                  f"VIPRSMixGrid({r['mix_grid']['lanes']} x K=3): converged "
                  f"{r['mix_grid']['converged']}/{r['mix_grid']['lanes']} "
                  f"{r['mix_grid']['seconds']:.3f} s (both cold)")
        rows, fit = phase_kernel(ds)
        for r in rows:
            say(kind, f"f. fused kernel, S={r['S']} after {r['after']} "
                      f"sweeps, keep decisions differ at {r['flipped']} of "
                      f"{r['live']} (<= {max_excluded(r['live'])}), max|d| "
                      + "; ".join(
                          f"{k}: vs xla {r['vs_xla'][k]:.3g}"
                          + (f" (settled vs f64 {r['settled_vs_f64'][k]:.3g}"
                             f", {r['excluded'][k]} excluded"
                             + (f" <= {max_excluded(r['live'])})"
                                if r['S'] == 1 else ", not held)")
                             if k in r['excluded'] else "")
                          + f", vs f64: xla {r['xla_vs_f64'][k]:.3g} "
                            f"fused {r['fused_vs_f64'][k]:.3g}"
                          for k in KERNEL_ATOL))
        say(kind, f"f. converged S=1 fit, fused vs xla: max|deta|="
                  f"{fit['d_eta']:.3g} (<= {FIT_ETA_ATOL}), |dh2|="
                  f"{fit['d_h2']:.3g} (<= {FIT_H2_ATOL}), iterations "
                  f"{fit['nit'][0]} vs {fit['nit'][1]}")

    for line in smi:
        print(f"nvidia-smi: {line}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}}), flush=True)


if __name__ == '__main__':
    main()
