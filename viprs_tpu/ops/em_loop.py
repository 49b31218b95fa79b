"""Fused on-device variational EM loop.

One ``lax.while_loop`` runs [e-step sweep -> M-step -> ELBO -> convergence
ladder] for all S models simultaneously, mirroring the reference's host loop
(VIPRS.py:909-1124) but vectorized over the model axis and compiled once:

- per-model status codes (utils/optimize.py) replace OptimizeResult messages;
- per-model patience counters implement the sigma_g-stability and
  ELBO-divergence checks (VIPRS.py:1002-1016, 1083-1094);
- the oscillation counter (OptimizeResult.py:121-150) triggers *damping
  escalation* on-device — the deterministic analog of the reference's
  "reduce thread count for better parameter synchronization" (VIPRS.py:1056-1061);
- pathological states (negative MSE, non-finite ELBO, negative sigma_eps,
  heritability out of [0,1]) stop the affected model with an error status;
  the host wrapper (model/viprs.py) handles the restart-with-fixed-sigma_eps
  behavior of the reference (VIPRS.py:1025-1038).

Everything the host needs afterwards (statuses, iteration counts, ELBO history)
comes back in one device->host transfer.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from . import updates
from .cavi_jax import CaviState, Hyper, cavi_sweep
from .block_ld import BlockLD
from ..utils import optimize as opt

F32 = jnp.float32
F64 = jnp.float64
I32 = jnp.int32


class EMCarry(NamedTuple):
    state: CaviState
    hyper: Hyper                 # (S,) float64 each
    sigma_g: jnp.ndarray         # (S,) f64
    i: jnp.ndarray               # scalar i32 — global iteration (1-based inside loop)
    active: jnp.ndarray          # (S,) bool
    status: jnp.ndarray          # (S,) i32
    nit: jnp.ndarray             # (S,) i32 — iterations each model actually ran
    prev_elbo: jnp.ndarray       # (S,) f64
    prev_dropped: jnp.ndarray    # (S,) bool — ELBO dropped last iteration
    osc_counter: jnp.ndarray     # (S,) i32
    best_elbo: jnp.ndarray       # (S,) f64 — best objective so far
    stall_counter: jnp.ndarray   # (S,) i32 — iters since the best improved
    sigma_g_counter: jnp.ndarray  # (S,) i32
    div_counter: jnp.ndarray     # (S,) i32
    damping: jnp.ndarray         # (S,) f32
    elbo_hist: jnp.ndarray       # (max_iter+1, S) f64
    max_eta_diff: jnp.ndarray    # (S,) f32
    fix_se: jnp.ndarray          # (S,) bool — sigma_eps fixed (set by restart)
    restarts_left: jnp.ndarray   # (S,) i32 — in-graph restart budget


class EMCounters(NamedTuple):
    """The convergence-ladder state that must survive across chunked em_fit
    calls (tracking / live-progress runs split one optimization into bounded
    segments; carrying these keeps the ladder identical to a single fused
    run)."""
    prev_dropped: jnp.ndarray    # (S,) bool
    osc_counter: jnp.ndarray     # (S,) i32
    best_elbo: jnp.ndarray       # (S,) f64
    stall_counter: jnp.ndarray   # (S,) i32
    sigma_g_counter: jnp.ndarray  # (S,) i32
    div_counter: jnp.ndarray     # (S,) i32
    damping: jnp.ndarray         # (S,) f32


def init_counters(S) -> EMCounters:
    return EMCounters(
        prev_dropped=jnp.zeros(S, bool),
        osc_counter=jnp.zeros(S, I32),
        best_elbo=jnp.full(S, -jnp.inf, F64),
        stall_counter=jnp.zeros(S, I32),
        sigma_g_counter=jnp.zeros(S, I32),
        div_counter=jnp.zeros(S, I32),
        damping=jnp.ones(S, F32))


class EMResult(NamedTuple):
    state: CaviState
    hyper: Hyper
    sigma_g: jnp.ndarray
    status: jnp.ndarray
    nit: jnp.ndarray
    elbo_hist: jnp.ndarray
    n_iter_total: jnp.ndarray
    final_elbo: jnp.ndarray
    final_mse: jnp.ndarray
    counters: EMCounters
    max_eta_diff: jnp.ndarray
    restarts_used: jnp.ndarray = None  # (S,) i32 — in-graph restarts taken


def _hyper_f32(h: Hyper) -> Hyper:
    return Hyper(*(x.astype(F32) for x in h))


@partial(jax.jit, static_argnames=(
    'tile', 'max_iter', 'min_iter', 'inner_steps', 'sweep', 'max_restarts'))
def em_fit(ld: BlockLD,
           state0: CaviState,
           std_beta, n_per_snp,
           hyper0: Hyper,
           fix: updates.FixMask,
           n_sample,
           m_total,
           init_elbo,
           active0,
           max_iter: int = 1000,
           min_iter: int = 3,
           f_abs_tol: float = 1e-6,
           x_abs_tol: float = 1e-6,
           patience: int = 10,
           tile: int = 128,
           inner_steps: int = 8,
           sweep: str = 'xla',
           i0=0,
           counters0: EMCounters = None,
           sigma_g0=None,
           max_restarts: int = 0,
           restart_hyper: Hyper = None,
           restart_logits=None):
    """Run the fused EM loop until every model terminates (or max_iter).

    :param init_elbo: (S,) f64 — ELBO of the initial state (history slot 0;
        reference appends the initial objective before iterating, VIPRS.py:942).
        Pass ``None`` to compute it in-graph from ``state0`` — folds the
        host-side "initial ELBO" dispatch of a fresh fit into this call.
    :param active0: (S,) bool — models to optimize (False lanes stay frozen).
    :param i0: global iteration offset (chunked runs: min_iter and nit are
        counted from the start of the whole optimization, not the chunk).
    :param counters0: convergence-ladder carry for chunked runs (None = fresh).
    :param sigma_g0: (S,) f64 sigma_g carry for chunked runs (None = zeros).
    :param max_restarts: in-graph restart-on-negative-MSE budget per lane
        (reference VIPRS.py:1025-1038). With ``max_restarts > 0``, a lane
        whose MSE goes negative is reset INSIDE the loop — variational state
        re-initialized from ``restart_logits`` (f32 (S,) logit of the
        restart pi draw), hyperparameters from ``restart_hyper`` (pre-drawn
        on the host so the np.random stream matches the reference's
        restart-time draw), sigma_eps fixed at restart_hyper.sigma_eps from
        then on, counters/sigma_g reset, and the fresh initial objective
        computed in-graph — the whole fit stays ONE dispatch. The driver
        enables this only on the single-dispatch S=1 path; chunked runs keep
        the host restart (identical trajectory either way).
    :param sweep: e-step implementation, as chosen by
        ``model/_dispatch.select_sweep_impl``: ``'xla'`` (the batched tile
        loop, ops/cavi_jax.py) or ``'fused'`` (the per-block Pallas kernel,
        ops/cavi_fused.py).
    :returns: EMResult (``status == MAX_ITER`` means the lane ran out of THIS
        call's iteration budget — a chunked driver continues those lanes).
    """
    S = hyper0.sigma_eps.shape[0]
    mask = ld.mask
    i0 = jnp.asarray(i0, I32)
    ctr = counters0 if counters0 is not None else init_counters(S)
    sigma_g_init = (jnp.zeros(S, F64) if sigma_g0 is None
                    else jnp.asarray(sigma_g0, F64))

    if init_elbo is None:
        # in-graph initial objective (identical arithmetic to the host's
        # _elbo_jit path: f32 hyperparameters, f64 reductions):
        h32_0 = _hyper_f32(hyper0)
        var_tau0 = updates.compute_var_tau(n_per_snp, h32_0)
        stats0 = updates.collect_stats(state0, var_tau0, std_beta, mask)
        init_elbo = updates.elbo(stats0, h32_0, fix.sigma_eps, sigma_g_init,
                                 n_sample, m_total)

    elbo_hist = jnp.full((max_iter + 1, S), jnp.nan, dtype=F64)
    elbo_hist = elbo_hist.at[0].set(init_elbo)

    carry = EMCarry(
        state=state0,
        hyper=Hyper(*(x.astype(F64) for x in hyper0)),
        sigma_g=sigma_g_init,
        i=jnp.asarray(0, I32),
        active=active0.astype(bool),
        status=jnp.full(S, opt.RUNNING, I32),
        nit=jnp.zeros(S, I32),
        prev_elbo=init_elbo.astype(F64),
        prev_dropped=ctr.prev_dropped,
        osc_counter=ctr.osc_counter,
        best_elbo=ctr.best_elbo,
        stall_counter=ctr.stall_counter,
        sigma_g_counter=ctr.sigma_g_counter,
        div_counter=ctr.div_counter,
        damping=ctr.damping,
        elbo_hist=elbo_hist,
        max_eta_diff=jnp.zeros(S, F32),
        fix_se=jnp.broadcast_to(jnp.asarray(fix.sigma_eps, bool), (S,)),
        restarts_left=jnp.full(S, max_restarts, I32),
    )

    def cond(c: EMCarry):
        return (c.i < max_iter) & jnp.any(c.active)

    def body(c: EMCarry):
        i = c.i + 1
        gi = i0 + i          # global iteration number (chunk-aware)
        h32 = _hyper_f32(c.hyper)
        act_f = c.active.astype(F32) * c.damping

        # ---- E-step ----
        if sweep == 'fused':
            from .cavi_fused import cavi_sweep_fused
            state, eta_diff = cavi_sweep_fused(
                ld, c.state, std_beta, n_per_snp, h32, act_f, tile=tile,
                inner_steps=inner_steps)
        else:
            state, eta_diff = cavi_sweep(ld, c.state, std_beta, n_per_snp,
                                         h32, act_f, tile=tile,
                                         inner_steps=inner_steps)

        # ---- reductions with e-step hyperparameters ----
        var_tau = updates.compute_var_tau(n_per_snp, h32)
        stats = updates.collect_stats(state, var_tau, std_beta, mask)

        # ---- M-step ----
        # fix.sigma_eps lives in the carry: an in-graph restart fixes it
        # mid-run (reference VIPRS.py:1032-1036):
        fix_cur = updates.FixMask(sigma_eps=c.fix_se, tau_beta=fix.tau_beta,
                                  pi=fix.pi)
        hyper, sigma_g = updates.m_step(stats, c.hyper, fix_cur, m_total,
                                        c.active)
        sigma_g = jnp.where(c.active, sigma_g, c.sigma_g)

        # ---- objectives ----
        curr_elbo = updates.elbo(stats, hyper, c.fix_se, sigma_g,
                                 n_sample, m_total)
        curr_elbo = jnp.where(c.active, curr_elbo, c.prev_elbo)
        curr_mse = updates.mse(stats, sigma_g)
        h2 = updates.heritability(sigma_g, hyper.sigma_eps)

        max_ed = jnp.max(jnp.abs(eta_diff) * mask[None], axis=(1, 2))  # (S,) f32
        max_ed = jnp.where(c.active, max_ed, c.max_eta_diff)

        # ---- patience counters (VIPRS.py:1002-1016) ----
        sigg_cond = ((gi > min_iter)
                     & (jnp.abs(sigma_g - c.sigma_g) <= x_abs_tol)
                     & (max_ed < x_abs_tol * 10.0))
        sigma_g_counter = jnp.where(sigg_cond, c.sigma_g_counter + 1, 0)

        dropped = curr_elbo < c.prev_elbo
        div_cond = dropped & ~(jnp.abs(curr_elbo - c.prev_elbo)
                               <= 1e3 * f_abs_tol + 1e-4 * jnp.abs(c.prev_elbo))
        div_counter = jnp.where(div_cond, c.div_counter + 1, 0)

        # Oscillation: consecutive-iteration objective drops.
        osc = jnp.where(dropped & c.prev_dropped, c.osc_counter + 1,
                        jnp.where(dropped, c.osc_counter, 0))
        # Damping escalation replaces thread-count reduction (VIPRS.py:1056-1061):
        escalate = c.active & (osc > 5) & (c.damping > 0.01)
        damping = jnp.where(escalate, c.damping * F32(0.7), c.damping)
        osc = jnp.where(escalate, 0, osc)

        # Stall detection: limit cycles (e.g. correlated variants trading
        # inclusion) can oscillate without consecutive drops. If the best
        # objective hasn't improved for 2*patience iterations, halve the step:
        # damping preserves the CAVI fixed point, and once steps fall below the
        # keep-threshold the state freezes and the x-tolerance fires.
        improved = curr_elbo > c.best_elbo + f_abs_tol
        best_elbo = jnp.maximum(c.best_elbo, curr_elbo)
        stall = jnp.where(improved | ~c.active, 0, c.stall_counter + 1)
        stall_escalate = c.active & (stall > 2 * patience) & (damping > 0.01)
        damping = jnp.where(stall_escalate, damping * F32(0.5), damping)
        stall = jnp.where(stall_escalate, 0, stall)

        # ---- the ladder (ordered elif chain, VIPRS.py:1022-1097) ----
        status = jnp.full(S, opt.RUNNING, I32)

        def set_status(status, cond_, code):
            return jnp.where((status == opt.RUNNING) & cond_, code, status)

        status = set_status(status, curr_mse < 0.0, opt.MSE_NEGATIVE)
        status = set_status(status, ~jnp.isfinite(curr_elbo), opt.ELBO_NONFINITE)
        status = set_status(status, hyper.sigma_eps < 0.0, opt.SIGMA_EPS_NEGATIVE)
        status = set_status(status, (h2 > 1.0) | (h2 < 0.0), opt.H2_OUT_OF_BOUNDS)
        status = set_status(
            status, (gi > min_iter) & (jnp.abs(curr_elbo - c.prev_elbo) <= f_abs_tol),
            opt.CONVERGED_F)
        status = set_status(status, (gi > min_iter) & (max_ed < x_abs_tol),
                            opt.CONVERGED_X)
        status = set_status(status, sigma_g_counter > patience, opt.CONVERGED_SIGMA_G)
        status = set_status(status, div_counter > patience, opt.DIVERGED_ELBO)

        # ---- in-graph restart-on-negative-MSE (VIPRS.py:1025-1038) ----
        fix_se = c.fix_se
        restarts_left = c.restarts_left
        prev_elbo_out = curr_elbo
        if max_restarts > 0:
            # A restart on the budget's LAST iteration would exit the loop
            # mid-reset reporting MAX_ITER + the fresh objective; the chunked
            # host path reports MSE_NEGATIVE there — keep them aligned by
            # only firing when iterations remain:
            fire = (c.active & (status == opt.MSE_NEGATIVE)
                    & (restarts_left > 0) & ~c.fix_se & (i < max_iter))
            status = jnp.where(fire, opt.RUNNING, status)

            def _apply_restart(ops):
                (state, hyper, sigma_g, prev, dropped_, osc_, best_, stall_,
                 sgc_, dvc_, damp_, fse_, left_) = ops
                f3 = fire[:, None, None]
                zero = jnp.zeros((), F32)
                rstate = CaviState(
                    logits=jnp.where(
                        f3, restart_logits.astype(F32)[:, None, None],
                        state.logits),
                    mu=jnp.where(f3, zero, state.mu),
                    eta=jnp.where(f3, zero, state.eta),
                    q=jnp.where(f3, zero, state.q))
                # round through f32 exactly like a host re-dispatch would
                # (the host passes hyper0 as _hyper_f32 and em_fit carries
                # its f64 upcast — 0.95 becomes 0.94999998...):
                rh32 = _hyper_f32(restart_hyper)
                rhyper = Hyper(
                    sigma_eps=jnp.where(fire, rh32.sigma_eps.astype(F64),
                                        hyper.sigma_eps),
                    tau_beta=jnp.where(fire, rh32.tau_beta.astype(F64),
                                       hyper.tau_beta),
                    pi=jnp.where(fire, rh32.pi.astype(F64), hyper.pi),
                    lambda_min=hyper.lambda_min)
                rsg = jnp.where(fire, 0.0, sigma_g)
                nfix = fse_ | fire
                # fresh initial objective for the reset lanes (identical
                # arithmetic to the init_elbo=None entry path):
                h32r = _hyper_f32(rhyper)
                vt0 = updates.compute_var_tau(n_per_snp, h32r)
                st0 = updates.collect_stats(rstate, vt0, std_beta, mask)
                fe = updates.elbo(st0, h32r, nfix, rsg, n_sample, m_total)
                fresh = init_counters(S)
                return (rstate, rhyper, rsg, jnp.where(fire, fe, prev),
                        jnp.where(fire, fresh.prev_dropped, dropped_),
                        jnp.where(fire, fresh.osc_counter, osc_),
                        jnp.where(fire, fresh.best_elbo, best_),
                        jnp.where(fire, fresh.stall_counter, stall_),
                        jnp.where(fire, fresh.sigma_g_counter, sgc_),
                        jnp.where(fire, fresh.div_counter, dvc_),
                        jnp.where(fire, fresh.damping, damp_),
                        nfix, left_ - fire.astype(I32))

            ops = (state, hyper, sigma_g, prev_elbo_out, dropped, osc,
                   best_elbo, stall, sigma_g_counter, div_counter, damping,
                   fix_se, restarts_left)
            (state, hyper, sigma_g, prev_elbo_out, dropped, osc, best_elbo,
             stall, sigma_g_counter, div_counter, damping, fix_se,
             restarts_left) = lax.cond(jnp.any(fire), _apply_restart,
                                       lambda o: o, ops)

        newly_done = c.active & (status != opt.RUNNING)
        status = jnp.where(newly_done, status, c.status)
        active = c.active & ~newly_done
        nit = jnp.where(c.active, gi, c.nit)

        hist = lax.dynamic_update_slice(c.elbo_hist, curr_elbo[None, :],
                                        (i, jnp.asarray(0, I32)))

        return EMCarry(state=state, hyper=hyper, sigma_g=sigma_g, i=i,
                       active=active, status=status, nit=nit,
                       prev_elbo=prev_elbo_out, prev_dropped=dropped,
                       osc_counter=osc, best_elbo=best_elbo,
                       stall_counter=stall, sigma_g_counter=sigma_g_counter,
                       div_counter=div_counter, damping=damping,
                       elbo_hist=hist, max_eta_diff=max_ed,
                       fix_se=fix_se, restarts_left=restarts_left)

    c = lax.while_loop(cond, body, carry)

    # Models still active after max_iter:
    status = jnp.where(c.active, opt.MAX_ITER, c.status)

    # Final diagnostics with the terminal hyperparameters:
    h32 = _hyper_f32(c.hyper)
    var_tau = updates.compute_var_tau(n_per_snp, h32)
    stats = updates.collect_stats(c.state, var_tau, std_beta, mask)
    final_mse = updates.mse(stats, c.sigma_g)

    return EMResult(state=c.state, hyper=c.hyper, sigma_g=c.sigma_g,
                    status=status, nit=c.nit, elbo_hist=c.elbo_hist,
                    n_iter_total=c.i, final_elbo=c.prev_elbo,
                    final_mse=final_mse,
                    counters=EMCounters(
                        prev_dropped=c.prev_dropped,
                        osc_counter=c.osc_counter,
                        best_elbo=c.best_elbo,
                        stall_counter=c.stall_counter,
                        sigma_g_counter=c.sigma_g_counter,
                        div_counter=c.div_counter,
                        damping=c.damping),
                    max_eta_diff=c.max_eta_diff,
                    restarts_used=jnp.full(S, max_restarts, I32)
                    - c.restarts_left)
