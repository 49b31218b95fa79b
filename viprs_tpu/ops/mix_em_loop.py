"""Fused on-device EM loops for the mixture-prior model (VIPRSMix).

The mixture analog of ops/em_loop.py: one lax.while_loop runs
[mixture sweep -> M-step (VIPRSMix.py:227-260) -> ELBO -> convergence ladder].

``mix_em_fit`` is the single-model loop; ``mix_em_fit_batch`` adds the grid
axis S — the mixture counterpart of the vmapped grid fit (the reference fits
any model class across grid rows in parallel processes,
HyperparameterSearch.py:197-351) — with per-lane convergence masking AND the
oscillation/stall damping-escalation ladder of ops/em_loop.py (whose absence
is what let round-2's batched mixture kernel fall into an fp-order limit
cycle)."""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .block_ld import BlockLD
from .cavi_mix import (MixState, MixHyper, cavi_sweep_mixture, mix_var_tau,
                       mix_stats)
from ..utils import optimize as opt

F32 = jnp.float32
F64 = jnp.float64
I32 = jnp.int32


class MixFix(NamedTuple):
    sigma_eps: jnp.ndarray   # scalar bool
    tau_betas: jnp.ndarray   # scalar bool (pins the whole tau vector)
    pis: jnp.ndarray         # scalar bool (pins the whole pi vector)
    total_pi: jnp.ndarray    # scalar f64; >0 => renormalize pi to this total


def _mix_elbo(stats, hyper: MixHyper, sigma_eps_fixed, sigma_g, n, m_total, d):
    sig_e = hyper.sigma_eps.astype(F64)
    tau_b = hyper.tau_beta.astype(F64)
    pi = hyper.pi.astype(F64)
    n = F64(n)

    quad = (1.0 / sig_e) * (1.0 - 2.0 * stats['sum_beta_eta'] + sigma_g)
    fit_term = jnp.where(sigma_eps_fixed, quad, 1.0)
    e = 0.5 * n * (-jnp.log(2.0 * jnp.pi * sig_e) - fit_term)

    e = e - (stats['sum_g_logg'] - jnp.dot(stats['sum_gamma_k'], jnp.log(pi)))
    null_pi = jnp.maximum(1.0 - pi.sum(), 1e-12)
    e = e - (stats['sum_ng_logng'] - stats['sum_null_g'] * jnp.log(null_pi))
    e = e + 0.5 * (jnp.dot(stats['sum_gamma_k'], 1.0 + jnp.log(tau_b))
                   - stats['sum_g_logvt'].sum())
    e = e - 0.5 * jnp.dot(tau_b, stats['sum_zeta_k'])
    return e


class MixEMResult(NamedTuple):
    state: MixState
    hyper: MixHyper
    sigma_g: jnp.ndarray
    status: jnp.ndarray
    nit: jnp.ndarray
    elbo_hist: jnp.ndarray
    final_elbo: jnp.ndarray
    final_mse: jnp.ndarray


@partial(jax.jit, static_argnames=('tile', 'max_iter', 'min_iter',
                                   'inner_steps'))
def mix_em_fit(ld: BlockLD,
               state0: MixState,
               std_beta, n_per_snp,
               hyper0: MixHyper,
               fix: MixFix,
               d_mult,
               n_sample,
               m_total,
               init_elbo,
               max_iter: int = 1000,
               min_iter: int = 3,
               f_abs_tol: float = 1e-6,
               x_abs_tol: float = 1e-6,
               patience: int = 10,
               tile: int = 128,
               inner_steps: int = 8,
               sigma_g0=None):
    """Fused mixture EM. ``d_mult``: (K,) prior-variance multipliers.

    ``init_elbo=None`` computes the initial objective in-graph from
    ``state0`` (one dispatch for the whole fit — same contract as
    em_loop.em_fit). ``sigma_g0``: warm sigma_g carry for continued fits
    (None = 0; with a fixed sigma_epsilon the initial objective's
    data-fit term depends on it)."""
    from .cavi_mix import mix_var_tau, mix_stats

    K = hyper0.pi.shape[0]
    mask = ld.mask
    d64 = d_mult.astype(F64)
    sigma_g_init = (jnp.asarray(0.0, F64) if sigma_g0 is None
                    else jnp.asarray(sigma_g0, F64))

    if init_elbo is None:
        hy0 = MixHyper(*(x.astype(F32) for x in hyper0))
        vt0 = mix_var_tau(n_per_snp, hy0)
        stats0 = mix_stats(state0, vt0, std_beta, mask)
        init_elbo = _mix_elbo(stats0, hy0, fix.sigma_eps,
                              sigma_g_init, n_sample, m_total, d64)
    else:
        init_elbo = jnp.asarray(init_elbo, F64)

    elbo_hist = jnp.full((max_iter + 1,), jnp.nan, dtype=F64)
    elbo_hist = elbo_hist.at[0].set(init_elbo)

    hyper64 = MixHyper(sigma_eps=hyper0.sigma_eps.astype(F64),
                       tau_beta=hyper0.tau_beta.astype(F64),
                       pi=hyper0.pi.astype(F64),
                       lambda_min=hyper0.lambda_min.astype(F64))

    carry = dict(state=state0, hyper=hyper64,
                 sigma_g=sigma_g_init, i=jnp.asarray(0, I32),
                 status=jnp.asarray(opt.RUNNING, I32),
                 prev_elbo=init_elbo.astype(F64),
                 sigma_g_counter=jnp.asarray(0, I32),
                 div_counter=jnp.asarray(0, I32),
                 elbo_hist=elbo_hist)

    def h32(h):
        return MixHyper(sigma_eps=h.sigma_eps.astype(F32),
                        tau_beta=h.tau_beta.astype(F32),
                        pi=h.pi.astype(F32),
                        lambda_min=h.lambda_min.astype(F32))

    def cond(c):
        return (c['i'] < max_iter) & (c['status'] == opt.RUNNING)

    def body(c):
        i = c['i'] + 1
        hy = h32(c['hyper'])

        state, eta_diff = cavi_sweep_mixture(ld, c['state'], std_beta,
                                             n_per_snp, hy, tile=tile,
                                             inner_steps=inner_steps)
        vt = mix_var_tau(n_per_snp, hy)
        stats = mix_stats(state, vt, std_beta, mask)

        # ---- M-step (VIPRSMix.py:227-260) ----
        h = c['hyper']
        pi_est = stats['sum_gamma_k']
        pi_renorm = fix.total_pi * pi_est / pi_est.sum()
        pi_free = pi_est / F64(m_total)
        pi_new = jnp.where(fix.total_pi > 0, pi_renorm, pi_free)
        pi = jnp.where(fix.pis, h.pi, pi_new)

        tau_est = jnp.sum(pi) * F64(m_total) / jnp.dot(d64, stats['sum_zeta_k'])
        tau_new = jnp.clip(d64 * tau_est, 1.0, None)
        tau_beta = jnp.where(fix.tau_betas, h.tau_beta, tau_new)

        lam = h.lambda_min
        sigma_g = (1.0 + lam) * stats['sum_zeta_k'].sum() + stats['sum_q_eta']
        sig_e_new = 1.0 - 2.0 * stats['sum_beta_eta'] + sigma_g
        sigma_eps = jnp.where(fix.sigma_eps, h.sigma_eps, sig_e_new)

        hyper = MixHyper(sigma_eps=sigma_eps, tau_beta=tau_beta, pi=pi,
                         lambda_min=lam)

        curr_elbo = _mix_elbo(stats, hyper, fix.sigma_eps, sigma_g,
                              n_sample, m_total, d64)
        curr_mse = (1.0 - 2.0 * stats['sum_beta_eta'] + sigma_g
                    - stats['sum_zeta_k'].sum() + stats['sum_eta_sq'])
        h2 = sigma_g / (sigma_g + sigma_eps)
        max_ed = jnp.max(jnp.abs(eta_diff) * mask)

        sigg_cond = ((i > min_iter)
                     & (jnp.abs(sigma_g - c['sigma_g']) <= x_abs_tol)
                     & (max_ed < x_abs_tol * 10.0))
        sigma_g_counter = jnp.where(sigg_cond, c['sigma_g_counter'] + 1, 0)
        dropped = curr_elbo < c['prev_elbo']
        div_cond = dropped & ~(jnp.abs(curr_elbo - c['prev_elbo'])
                               <= 1e3 * f_abs_tol + 1e-4 * jnp.abs(c['prev_elbo']))
        div_counter = jnp.where(div_cond, c['div_counter'] + 1, 0)

        status = jnp.asarray(opt.RUNNING, I32)

        def set_status(status, cond_, code):
            return jnp.where((status == opt.RUNNING) & cond_, code, status)

        status = set_status(status, curr_mse < 0.0, opt.MSE_NEGATIVE)
        status = set_status(status, ~jnp.isfinite(curr_elbo), opt.ELBO_NONFINITE)
        status = set_status(status, sigma_eps < 0.0, opt.SIGMA_EPS_NEGATIVE)
        status = set_status(status, (h2 > 1.0) | (h2 < 0.0), opt.H2_OUT_OF_BOUNDS)
        status = set_status(
            status, (i > min_iter) & (jnp.abs(curr_elbo - c['prev_elbo']) <= f_abs_tol),
            opt.CONVERGED_F)
        status = set_status(status, (i > min_iter) & (max_ed < x_abs_tol),
                            opt.CONVERGED_X)
        status = set_status(status, sigma_g_counter > patience,
                            opt.CONVERGED_SIGMA_G)
        status = set_status(status, div_counter > patience, opt.DIVERGED_ELBO)

        hist = lax.dynamic_update_slice(c['elbo_hist'], curr_elbo[None], (i,))

        return dict(state=state, hyper=hyper, sigma_g=sigma_g, i=i,
                    status=status, prev_elbo=curr_elbo,
                    sigma_g_counter=sigma_g_counter, div_counter=div_counter,
                    elbo_hist=hist)

    c = lax.while_loop(cond, body, carry)
    status = jnp.where(c['status'] == opt.RUNNING, opt.MAX_ITER, c['status'])

    hy = h32(c['hyper'])
    vt = mix_var_tau(n_per_snp, hy)
    stats = mix_stats(c['state'], vt, std_beta, mask)
    final_mse = (1.0 - 2.0 * stats['sum_beta_eta'] + c['sigma_g']
                 - stats['sum_zeta_k'].sum() + stats['sum_eta_sq'])

    return MixEMResult(state=c['state'], hyper=c['hyper'], sigma_g=c['sigma_g'],
                       status=status, nit=c['i'], elbo_hist=c['elbo_hist'],
                       final_elbo=c['prev_elbo'], final_mse=final_mse)


# ---------------------------------------------------------------------------
# Grid-batched mixture EM (S hyperparameter settings simultaneously)
# ---------------------------------------------------------------------------

class MixFixBatch(NamedTuple):
    """Per-lane hyperparameter pinning for the batched loop."""
    sigma_eps: jnp.ndarray   # (S,) bool
    tau_betas: jnp.ndarray   # (S,) bool
    pis: jnp.ndarray         # (S,) bool (pins the whole per-lane pi vector)
    total_pi: jnp.ndarray    # (S,) f64; >0 => renormalize pi to this total


class MixCounters(NamedTuple):
    """Convergence-ladder state carried across chunked mix_em_fit_batch
    calls (the mixture analog of em_loop.EMCounters)."""
    prev_dropped: jnp.ndarray    # (S,) bool
    osc_counter: jnp.ndarray     # (S,) i32
    best_elbo: jnp.ndarray       # (S,) f64
    stall_counter: jnp.ndarray   # (S,) i32
    sigma_g_counter: jnp.ndarray  # (S,) i32
    div_counter: jnp.ndarray     # (S,) i32
    damping: jnp.ndarray         # (S,) f32


def init_mix_counters(S) -> MixCounters:
    return MixCounters(
        prev_dropped=jnp.zeros(S, bool),
        osc_counter=jnp.zeros(S, I32),
        best_elbo=jnp.full(S, -jnp.inf, F64),
        stall_counter=jnp.zeros(S, I32),
        sigma_g_counter=jnp.zeros(S, I32),
        div_counter=jnp.zeros(S, I32),
        damping=jnp.ones(S, F32))


class MixEMBatchResult(NamedTuple):
    state: MixState          # (S, K, NB, B) / (S, NB, B)
    hyper: MixHyper          # (S,) / (S, K) float64
    sigma_g: jnp.ndarray     # (S,) f64
    status: jnp.ndarray      # (S,) i32
    nit: jnp.ndarray         # (S,) i32
    elbo_hist: jnp.ndarray   # (max_iter+1, S) f64
    n_iter_total: jnp.ndarray
    final_elbo: jnp.ndarray  # (S,) f64
    final_mse: jnp.ndarray   # (S,) f64
    counters: MixCounters


def _mix_stats_batch(state: MixState, var_tau, std_beta, mask):
    from .cavi_mix import mix_stats
    return jax.vmap(lambda g, m, e, q, vt: mix_stats(
        MixState(gamma=g, mu=m, eta=e, q=q), vt, std_beta, mask))(
        state.gamma, state.mu, state.eta, state.q, var_tau)


@partial(jax.jit, static_argnames=('tile', 'max_iter', 'min_iter',
                                   'inner_steps'))
def mix_em_fit_batch(ld: BlockLD,
                     state0: MixState,
                     std_beta, n_per_snp,
                     hyper0: MixHyper,
                     fix: MixFixBatch,
                     d_mult,
                     n_sample,
                     m_total,
                     max_iter: int = 1000,
                     min_iter: int = 3,
                     f_abs_tol: float = 1e-6,
                     x_abs_tol: float = 1e-6,
                     patience: int = 10,
                     tile: int = 128,
                     inner_steps: int = 8,
                     active0=None,
                     sigma_g0=None,
                     i0=0,
                     counters0: MixCounters = None,
                     init_elbo=None):
    """Fused grid-batched mixture EM: all S settings advance together with
    converged-lane masking; the initial objective is computed in-graph.

    ``hyper0``: sigma_eps/lambda_min (S,) f32, tau_beta/pi (S, K) f32.
    ``d_mult``: (K,) prior-variance multipliers (shared across lanes).
    ``active0``: (S,) bool — lanes to optimize (None = all; the host restart
    pass re-runs only the restarted + unfinished lanes).
    ``sigma_g0``: (S,) f64 carry for re-entrant calls (None = zeros).
    ``i0`` / ``counters0`` / ``init_elbo``: chunked-run carries (global
    iteration offset, ladder counters, previous chunk's final objective) —
    with them a chunked run is iteration-for-iteration identical to one
    fused dispatch (the same contract as ops/em_loop.em_fit).
    """
    from .cavi_mix import cavi_sweep_mixture_batch, mix_var_tau

    S, K = hyper0.pi.shape
    mask = ld.mask
    d64 = d_mult.astype(F64)

    def h32(h):
        return MixHyper(*(x.astype(F32) for x in h))

    def batch_var_tau(hy32):
        return jax.vmap(lambda h: mix_var_tau(n_per_snp, h))(hy32)

    def m_step_elbo(h, stats, active):
        """Vectorized M-step + objectives; frozen lanes keep their values."""
        act = active.astype(bool)
        pi_est = stats['sum_gamma_k']                       # (S,K)
        tot = pi_est.sum(axis=1, keepdims=True)
        pi_renorm = fix.total_pi[:, None] * pi_est / tot
        pi_free = pi_est / F64(m_total)
        pi_new = jnp.where(fix.total_pi[:, None] > 0, pi_renorm, pi_free)
        pi = jnp.where((fix.pis | ~act)[:, None], h.pi, pi_new)

        tau_est = pi.sum(axis=1) * F64(m_total) \
            / jnp.einsum('k,sk->s', d64, stats['sum_zeta_k'])
        tau_new = jnp.clip(d64[None] * tau_est[:, None], 1.0, None)
        tau_beta = jnp.where((fix.tau_betas | ~act)[:, None], h.tau_beta,
                             tau_new)

        lam = h.lambda_min
        sigma_g = (1.0 + lam) * stats['sum_zeta_k'].sum(axis=1) \
            + stats['sum_q_eta']
        sig_e_new = 1.0 - 2.0 * stats['sum_beta_eta'] + sigma_g
        sigma_eps = jnp.where(fix.sigma_eps | ~act, h.sigma_eps, sig_e_new)

        hyper = MixHyper(sigma_eps=sigma_eps, tau_beta=tau_beta, pi=pi,
                         lambda_min=lam)
        elbo = jax.vmap(
            lambda st, hy, fse, sg: _mix_elbo(st, hy, fse, sg, n_sample,
                                              m_total, d64))(
            stats, hyper, fix.sigma_eps, sigma_g)
        mse = (1.0 - 2.0 * stats['sum_beta_eta'] + sigma_g
               - stats['sum_zeta_k'].sum(axis=1) + stats['sum_eta_sq'])
        return hyper, sigma_g, elbo, mse

    hyper64 = MixHyper(*(x.astype(F64) for x in hyper0))

    sigma_g_init = (jnp.zeros(S, F64) if sigma_g0 is None
                    else jnp.asarray(sigma_g0, F64))
    active_init = (jnp.ones(S, bool) if active0 is None
                   else jnp.asarray(active0, bool))
    i0 = jnp.asarray(i0, I32)
    ctr = counters0 if counters0 is not None else init_mix_counters(S)

    if init_elbo is None:
        # in-graph initial objective (history slot 0):
        hy0 = h32(hyper64)
        vt0 = batch_var_tau(hy0)
        stats0 = _mix_stats_batch(state0, vt0, std_beta, mask)
        init_elbo = jax.vmap(
            lambda st, hy, fse, sg: _mix_elbo(st, hy, fse, sg,
                                              n_sample, m_total, d64))(
            stats0, hy0, fix.sigma_eps, sigma_g_init)
    else:
        init_elbo = jnp.asarray(init_elbo, F64)

    elbo_hist = jnp.full((max_iter + 1, S), jnp.nan, dtype=F64)
    elbo_hist = elbo_hist.at[0].set(init_elbo)

    carry = dict(state=state0, hyper=hyper64,
                 sigma_g=sigma_g_init, i=jnp.asarray(0, I32),
                 active=active_init,
                 status=jnp.full(S, opt.RUNNING, I32),
                 nit=jnp.zeros(S, I32),
                 prev_elbo=init_elbo,
                 prev_dropped=ctr.prev_dropped,
                 osc_counter=ctr.osc_counter,
                 best_elbo=ctr.best_elbo,
                 stall_counter=ctr.stall_counter,
                 sigma_g_counter=ctr.sigma_g_counter,
                 div_counter=ctr.div_counter,
                 damping=ctr.damping,
                 elbo_hist=elbo_hist)

    def cond(c):
        return (c['i'] < max_iter) & jnp.any(c['active'])

    def body(c):
        i = c['i'] + 1
        gi = i0 + i          # global iteration (chunk-aware)
        hy = h32(c['hyper'])
        act_f = c['active'].astype(F32) * c['damping']

        state, eta_diff = cavi_sweep_mixture_batch(
            ld, c['state'], std_beta, n_per_snp, hy, act_f,
            tile=tile, inner_steps=inner_steps)
        vt = batch_var_tau(hy)
        stats = _mix_stats_batch(state, vt, std_beta, mask)
        hyper, sigma_g, curr_elbo, curr_mse = m_step_elbo(
            c['hyper'], stats, c['active'])
        sigma_g = jnp.where(c['active'], sigma_g, c['sigma_g'])
        curr_elbo = jnp.where(c['active'], curr_elbo, c['prev_elbo'])
        h2 = sigma_g / (sigma_g + hyper.sigma_eps)
        max_ed = jnp.max(jnp.abs(eta_diff) * mask[None], axis=(1, 2))

        # --- patience / damping ladder (mirrors ops/em_loop.py) ---
        sigg_cond = ((gi > min_iter)
                     & (jnp.abs(sigma_g - c['sigma_g']) <= x_abs_tol)
                     & (max_ed < x_abs_tol * 10.0))
        sigma_g_counter = jnp.where(sigg_cond, c['sigma_g_counter'] + 1, 0)
        dropped = curr_elbo < c['prev_elbo']
        div_cond = dropped & ~(jnp.abs(curr_elbo - c['prev_elbo'])
                               <= 1e3 * f_abs_tol
                               + 1e-4 * jnp.abs(c['prev_elbo']))
        div_counter = jnp.where(div_cond, c['div_counter'] + 1, 0)

        osc = jnp.where(dropped & c['prev_dropped'], c['osc_counter'] + 1,
                        jnp.where(dropped, c['osc_counter'], 0))
        escalate = c['active'] & (osc > 5) & (c['damping'] > 0.01)
        damping = jnp.where(escalate, c['damping'] * F32(0.7), c['damping'])
        osc = jnp.where(escalate, 0, osc)

        improved = curr_elbo > c['best_elbo'] + f_abs_tol
        best_elbo = jnp.maximum(c['best_elbo'], curr_elbo)
        stall = jnp.where(improved | ~c['active'], 0, c['stall_counter'] + 1)
        stall_escalate = c['active'] & (stall > 2 * patience) & (damping > 0.01)
        damping = jnp.where(stall_escalate, damping * F32(0.5), damping)
        stall = jnp.where(stall_escalate, 0, stall)

        status = jnp.full(S, opt.RUNNING, I32)

        def set_status(status, cond_, code):
            return jnp.where((status == opt.RUNNING) & cond_, code, status)

        status = set_status(status, curr_mse < 0.0, opt.MSE_NEGATIVE)
        status = set_status(status, ~jnp.isfinite(curr_elbo),
                            opt.ELBO_NONFINITE)
        status = set_status(status, hyper.sigma_eps < 0.0,
                            opt.SIGMA_EPS_NEGATIVE)
        status = set_status(status, (h2 > 1.0) | (h2 < 0.0),
                            opt.H2_OUT_OF_BOUNDS)
        status = set_status(
            status,
            (gi > min_iter) & (jnp.abs(curr_elbo - c['prev_elbo']) <= f_abs_tol),
            opt.CONVERGED_F)
        status = set_status(status, (gi > min_iter) & (max_ed < x_abs_tol),
                            opt.CONVERGED_X)
        status = set_status(status, sigma_g_counter > patience,
                            opt.CONVERGED_SIGMA_G)
        status = set_status(status, div_counter > patience, opt.DIVERGED_ELBO)

        newly_done = c['active'] & (status != opt.RUNNING)
        status = jnp.where(newly_done, status, c['status'])
        active = c['active'] & ~newly_done
        nit = jnp.where(c['active'], gi, c['nit'])

        hist = lax.dynamic_update_slice(c['elbo_hist'], curr_elbo[None, :],
                                        (i, jnp.asarray(0, I32)))
        return dict(state=state, hyper=hyper, sigma_g=sigma_g, i=i,
                    active=active, status=status, nit=nit,
                    prev_elbo=curr_elbo, prev_dropped=dropped,
                    osc_counter=osc, best_elbo=best_elbo,
                    stall_counter=stall, sigma_g_counter=sigma_g_counter,
                    div_counter=div_counter, damping=damping,
                    elbo_hist=hist)

    c = lax.while_loop(cond, body, carry)
    status = jnp.where(c['active'], opt.MAX_ITER, c['status'])

    hy = h32(c['hyper'])
    vt = batch_var_tau(hy)
    stats = _mix_stats_batch(c['state'], vt, std_beta, mask)
    final_mse = (1.0 - 2.0 * stats['sum_beta_eta'] + c['sigma_g']
                 - stats['sum_zeta_k'].sum(axis=1) + stats['sum_eta_sq'])

    return MixEMBatchResult(state=c['state'], hyper=c['hyper'],
                            sigma_g=c['sigma_g'], status=status, nit=c['nit'],
                            elbo_hist=c['elbo_hist'], n_iter_total=c['i'],
                            final_elbo=c['prev_elbo'], final_mse=final_mse,
                            counters=MixCounters(
                                prev_dropped=c['prev_dropped'],
                                osc_counter=c['osc_counter'],
                                best_elbo=c['best_elbo'],
                                stall_counter=c['stall_counter'],
                                sigma_g_counter=c['sigma_g_counter'],
                                div_counter=c['div_counter'],
                                damping=c['damping']))
