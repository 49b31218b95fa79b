"""Closed-form M-step updates and variational objectives (ELBO, MSE, entropy...).

Vectorized over the model/grid axis S; reductions follow the framework's
mixed-precision discipline: per-block float32 partial sums, float64 accumulation
across blocks (the device equivalent of the reference's float64 ELBO accumulation over
float32 state, VIPRS.py:497-581 & compute_zeta note at :888-897).

Update equations (parity anchors):
    pi        = mean(gamma)                       VIPRS.py:426-434
    tau_beta  = pi * M / sum(zeta)                VIPRS.py:436-444
    sigma_g   = sum((1+lambda_min) zeta + q*eta)  VIPRS.py:446-457
    sigma_eps = 1 - 2 beta'eta + sigma_g          VIPRS.py:459-471
    mse       = 1 - 2 beta'eta + sigma_g - sum(zeta) + sum(eta^2)   VIPRS.py:689-704
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .cavi_jax import CaviState, Hyper

F32 = jnp.float32
F64 = jnp.float64


class FixMask(NamedTuple):
    """Per-model booleans: True where the hyperparameter is pinned out of the
    M-step (the reference's ``fix_params`` dict, VIPRS.py:361-379)."""
    sigma_eps: jnp.ndarray
    tau_beta: jnp.ndarray
    pi: jnp.ndarray


def masked_sum(x, mask):
    """(S, NB, B) * (NB, B) -> (S,) float64 via hierarchical reduction."""
    part = jnp.sum(x * mask[None, :, :], axis=2)  # (S, NB) f32
    return jnp.sum(part.astype(F64), axis=1)


def compute_var_tau(n_per_snp, hyper: Hyper):
    """var_tau = n (1 + lambda_min)/sigma_eps + tau_beta, shape (S, NB, B) f32.

    Must be evaluated with the hyperparameters *used by the e-step sweep*
    (pre-M-step), matching the reference's update ordering.
    """
    n = n_per_snp[None, :, :]
    return (n * (1.0 + hyper.lambda_min[:, None, None]) / hyper.sigma_eps[:, None, None]
            + hyper.tau_beta[:, None, None])


def compute_zeta(state: CaviState, var_tau):
    """zeta = gamma (mu^2 + 1/var_tau): E[beta^2] under the posterior, f32."""
    return state.gamma * (state.mu * state.mu + 1.0 / var_tau)


class SweepStats(NamedTuple):
    """Per-model (S,) float64 reductions shared by the M-step / ELBO / MSE."""
    sum_gamma: jnp.ndarray
    sum_zeta: jnp.ndarray
    sum_q_eta: jnp.ndarray
    sum_beta_eta: jnp.ndarray
    sum_eta_sq: jnp.ndarray
    # ELBO entropy/prior pieces computed from logits (stable):
    sum_g_logg: jnp.ndarray          # sum gamma*log(gamma)
    sum_ng_logng: jnp.ndarray        # sum (1-gamma)*log(1-gamma)
    sum_g_logvt: jnp.ndarray         # sum gamma*log(var_tau)


def collect_stats(state: CaviState, var_tau, std_beta, mask) -> SweepStats:
    g = state.gamma
    zeta = compute_zeta(state, var_tau)
    # Stable Bernoulli entropy pieces from logits u:
    #   log gamma     = -softplus(-u)
    #   log (1-gamma) = -softplus(u)
    u = state.logits
    g_logg = -g * jax.nn.softplus(-u)
    ng_logng = -(1.0 - g) * jax.nn.softplus(u)

    return SweepStats(
        sum_gamma=masked_sum(g, mask),
        sum_zeta=masked_sum(zeta, mask),
        sum_q_eta=masked_sum(state.q * state.eta, mask),
        sum_beta_eta=masked_sum(state.eta * std_beta[None, :, :], mask),
        sum_eta_sq=masked_sum(state.eta * state.eta, mask),
        sum_g_logg=masked_sum(g_logg, mask),
        sum_ng_logng=masked_sum(ng_logng, mask),
        sum_g_logvt=masked_sum(g * jnp.log(var_tau), mask),
    )


def m_step(stats: SweepStats, hyper: Hyper, fix: FixMask, m_total, active):
    """Closed-form hyperparameter updates; frozen lanes (fixed or inactive
    models) keep their previous values. Returns (new_hyper_f64, sigma_g)."""
    m_total = F64(m_total)
    act = active.astype(bool)

    pi_new = stats.sum_gamma / m_total
    pi = jnp.where(fix.pi | ~act, hyper.pi.astype(F64), pi_new)

    tau_beta_new = pi * m_total / stats.sum_zeta
    tau_beta = jnp.where(fix.tau_beta | ~act, hyper.tau_beta.astype(F64), tau_beta_new)

    lam = hyper.lambda_min.astype(F64)
    sigma_g = (1.0 + lam) * stats.sum_zeta + stats.sum_q_eta

    sig_e_new = 1.0 - 2.0 * stats.sum_beta_eta + sigma_g
    sigma_eps = jnp.where(fix.sigma_eps | ~act, hyper.sigma_eps.astype(F64), sig_e_new)

    new_hyper = Hyper(sigma_eps=sigma_eps, tau_beta=tau_beta, pi=pi,
                      lambda_min=lam)
    return new_hyper, sigma_g


def elbo(stats: SweepStats, hyper: Hyper, fix_sigma_eps, sigma_g, n, m_total):
    """Evidence lower bound, (S,) float64. Mirrors VIPRS.py:497-581:
    ``hyper`` holds the post-M-step values; ``stats`` (incl. the log var_tau
    terms) come from the e-step. The null-component sum uses
    sum(1-gamma) = M - sum(gamma)."""
    sig_e = hyper.sigma_eps.astype(F64)
    tau_b = hyper.tau_beta.astype(F64)
    pi = hyper.pi.astype(F64)
    n = F64(n)
    m_total = F64(m_total)

    quad = (1.0 / sig_e) * (1.0 - 2.0 * stats.sum_beta_eta + sigma_g)
    fit_term = jnp.where(fix_sigma_eps.astype(bool), quad, 1.0)
    e = 0.5 * n * (-jnp.log(2.0 * jnp.pi * sig_e) - fit_term)

    e = e - (stats.sum_g_logg - stats.sum_gamma * jnp.log(pi))
    e = e - (stats.sum_ng_logng - (m_total - stats.sum_gamma) * jnp.log1p(-pi))

    e = e + 0.5 * (stats.sum_gamma * (1.0 + jnp.log(tau_b)) - stats.sum_g_logvt)
    e = e - 0.5 * tau_b * stats.sum_zeta
    return e


def mse(stats: SweepStats, sigma_g):
    """Summary-statistics training MSE (VIPRS.py:689-704)."""
    return (1.0 - 2.0 * stats.sum_beta_eta + sigma_g
            - stats.sum_zeta + stats.sum_eta_sq)


def heritability(sigma_g, sigma_eps):
    return sigma_g / (sigma_g + sigma_eps.astype(F64))


def entropy(stats: SweepStats, m_total):
    """Entropy of the variational distribution (VIPRS.py:583-612)."""
    m_total = F64(m_total)
    e = -stats.sum_g_logg - stats.sum_ng_logng - 0.5 * stats.sum_g_logvt
    return 0.5 * m_total * (jnp.log(2.0 * jnp.pi) + 1.0) + e


def log_prior(stats: SweepStats, hyper: Hyper, m_total):
    """Expected log prior under the variational density (VIPRS.py:630-677)."""
    m_total = F64(m_total)
    tau_b = hyper.tau_beta.astype(F64)
    pi = hyper.pi.astype(F64)
    lp = 0.5 * stats.sum_gamma * jnp.log(tau_b)
    lp = lp + stats.sum_gamma * jnp.log(pi)
    lp = lp + (m_total - stats.sum_gamma) * jnp.log1p(-pi)
    lp = lp - 0.5 * tau_b * stats.sum_zeta
    return lp - 0.5 * m_total * jnp.log(2.0 * jnp.pi)


def loglikelihood(stats: SweepStats, hyper: Hyper, sigma_g, n):
    """Expected data log-likelihood (VIPRS.py:614-628)."""
    sig_e = hyper.sigma_eps.astype(F64)
    n = F64(n)
    return -0.5 * n * (jnp.log(2.0 * jnp.pi * sig_e)
                       + (1.0 / sig_e) * (1.0 - 2.0 * stats.sum_beta_eta + sigma_g))


@jax.jit
def collect_stats_jit(state, var_tau, std_beta, mask):
    """Jitted collect_stats — one dispatch instead of ~25 eager ops (matters on
    high-latency device transports)."""
    return collect_stats(state, var_tau, std_beta, mask)


@jax.jit
def stats_bundle(state, n_per_snp, std_beta, mask, hyper: Hyper):
    """One-dispatch computation of var_tau + SweepStats from raw inputs."""
    var_tau = compute_var_tau(n_per_snp, hyper)
    return collect_stats(state, var_tau, std_beta, mask)
