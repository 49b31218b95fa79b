"""Posterior-check samplers: blocked Gibbs, SMC over the hyperparameter grid,
and HMC refinement — the exact-inference counterpart used to validate the
variational posteriors (BASELINE.json north star; no analog exists in the
reference, which is VI-only).

Design:

- :class:`GibbsSampler` — collapsed spike-and-slab Gibbs. Per coordinate j,
  given all other effects, the conditional is available in closed form (the
  sampling twin of the CAVI update, VIPRS.py:381-424):

      v_j = n_j (1+lambda_min)/sigma_eps + tau_beta
      m_j = (n_j/(v_j sigma_eps)) (beta_hat_j - q_j)
      P(gamma_j=1 | ...) = sigmoid(logit(pi) + (log tau_beta - log v_j)/2
                                   + v_j m_j^2 / 2)
      beta_j | gamma_j=1 ~ N(m_j, 1/v_j);  beta_j | gamma_j=0 = 0

  Coordinates are sampled *sequentially within a block* (a lax.scan — valid
  MCMC), with blocks advanced in parallel (exact for block-diagonal LD, where
  blocks are conditionally independent) and chains vectorized on a leading
  axis.

- :func:`smc_over_grid` — tempered SMC where the particles are hyperparameter
  grid points: the likelihood is annealed (n -> lambda_t * n), particles are
  reweighted by tempered-likelihood increments estimated from their Gibbs
  states and resampled systematically; Gibbs sweeps are the mutation kernel.

- :func:`hmc_refine` — HMC on the slab coefficients given a fixed
  configuration gamma, using the blocked-LD quadratic energy
  n/(2 sigma_eps) (beta' R beta - 2 beta_hat' beta) + tau_beta/2 ||beta||^2
  (gradients via the same blocked matmuls as the e-step).
"""

import logging
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops.block_ld import BlockLD
from ..ops.cavi_jax import compute_q

logger = logging.getLogger(__name__)

F32 = jnp.float32


class GibbsState(NamedTuple):
    beta: jnp.ndarray     # (C, NB, B) current effect sizes (0 when excluded)
    gamma: jnp.ndarray    # (C, NB, B) current inclusion indicators (f32 0/1)
    q: jnp.ndarray        # (C, NB, B) q = (R - I) beta
    key: jnp.ndarray


@partial(jax.jit, static_argnames=())
def _gibbs_sweep(ld: BlockLD, state: GibbsState, std_beta, n_per_snp,
                 sigma_eps, tau_beta, pi, lambda_min, temper):
    """One full Gibbs sweep (all coordinates once), C chains in parallel.

    ``temper`` in (0, 1] anneals the likelihood (n -> temper * n).
    """
    C, NB, B = state.beta.shape
    key, sub = jax.random.split(state.key)
    # per-coordinate uniforms and normals for the whole sweep:
    u_unif = jax.random.uniform(sub, (C, NB, B), dtype=F32)
    key, sub = jax.random.split(key)
    z_norm = jax.random.normal(sub, (C, NB, B), dtype=F32)

    logit_pi = jnp.log(pi) - jnp.log1p(-pi)
    log_tau = jnp.log(tau_beta)

    def per_block(D_b, beta_hat_b, n_b, mask_b, beta_b, gamma_b, q_b,
                  unif_b, norm_b):
        # D_b: (B, B); beta_b/gamma_b/q_b: (C, B); unif/norm: (C, B)
        D_f = D_b.astype(F32)
        if ld.scale != 1.0:
            D_f = D_f * F32(ld.scale)
        n_per_snp_scaled_b = n_b * temper

        def coord(j, carry):
            beta_b, gamma_b, q_b = carry
            n_j = n_per_snp_scaled_b[j]
            v_j = n_j * (1.0 + lambda_min) / sigma_eps + tau_beta
            m_j = (n_j / (v_j * sigma_eps)) * (beta_hat_b[j] - q_b[:, j])
            u_j = logit_pi + 0.5 * (log_tau - jnp.log(v_j)) \
                + 0.5 * v_j * m_j * m_j
            p_j = jax.nn.sigmoid(u_j)
            g_new = (unif_b[:, j] < p_j).astype(F32) * mask_b[j]
            b_new = g_new * (m_j + norm_b[:, j] / jnp.sqrt(v_j))
            d = b_new - beta_b[:, j]
            # q update for all neighbors (row j of R), excluding the diagonal:
            q_b = q_b + d[:, None] * D_f[j][None, :]
            q_b = q_b.at[:, j].add(-d)
            beta_b = beta_b.at[:, j].set(b_new)
            gamma_b = gamma_b.at[:, j].set(g_new)
            return beta_b, gamma_b, q_b

        return lax.fori_loop(0, B, coord, (beta_b, gamma_b, q_b))

    beta, gamma, q = jax.vmap(
        per_block, in_axes=(0, 0, 0, 0, 1, 1, 1, 1, 1), out_axes=(1, 1, 1),
    )(ld.diag, std_beta, n_per_snp, ld.mask, state.beta, state.gamma, state.q,
      u_unif, z_norm)

    return GibbsState(beta=beta, gamma=gamma, q=q, key=key)


def _loglik(state: GibbsState, std_beta, sigma_eps, n):
    """Summary-statistics log-likelihood term per chain (up to constants):
    -n/(2 sigma_eps) (1 - 2 beta_hat' beta + beta' R beta)."""
    bRb = jnp.sum((state.q + state.beta) * state.beta, axis=(1, 2))
    bhb = jnp.sum(std_beta[None] * state.beta, axis=(1, 2))
    return -0.5 * n / sigma_eps * (1.0 - 2.0 * bhb + bRb)


class GibbsSampler:
    """Blocked spike-and-slab Gibbs sampler over a SummaryStatsDataset."""

    def __init__(self, dataset, pi=0.01, tau_beta=None, sigma_eps=0.9,
                 lambda_min=0.0, n_chains=4, seed=0):
        self.dataset = dataset
        lay = dataset.layout
        self.pi = float(pi)
        self.tau_beta = float(tau_beta if tau_beta is not None
                              else pi * lay.m / 0.1)
        self.sigma_eps = float(sigma_eps)
        self.lambda_min = float(lambda_min)
        self.n_chains = n_chains
        self.seed = seed

        self._sb = jnp.asarray(
            lay.to_flat(dataset.std_beta).reshape(lay.nb, lay.block_size), F32)
        self._nf = jnp.asarray(
            lay.to_flat(dataset.n_per_snp).reshape(lay.nb, lay.block_size), F32)

    def init_state(self, key=None):
        lay = self.dataset.layout
        C = self.n_chains
        shape = (C, lay.nb, lay.block_size)
        key = key if key is not None else jax.random.PRNGKey(self.seed)
        return GibbsState(beta=jnp.zeros(shape, F32),
                          gamma=jnp.zeros(shape, F32),
                          q=jnp.zeros(shape, F32), key=key)

    def run(self, n_iter=500, burn_in=200, thin=1, temper=1.0, state=None):
        """Run the sampler; returns posterior summaries averaged over
        chains and retained sweeps: pip, post_mean_beta, post_var_beta."""
        if state is None:
            state = self.init_state()
        sums = None
        kept = 0
        args = (self._sb, self._nf, F32(self.sigma_eps), F32(self.tau_beta),
                F32(self.pi), F32(self.lambda_min), F32(temper))
        for it in range(n_iter):
            state = _gibbs_sweep(self.dataset.ld, state, *args)
            if it >= burn_in and (it - burn_in) % thin == 0:
                kept += 1
                b = state.beta
                cur = (state.gamma.sum(0), b.sum(0), (b * b).sum(0))
                sums = cur if sums is None else tuple(a + c for a, c in zip(sums, cur))
        total = kept * self.n_chains
        lay = self.dataset.layout
        pip = np.asarray(sums[0] / total).reshape(-1)
        mean = np.asarray(sums[1] / total).reshape(-1)
        second = np.asarray(sums[2] / total).reshape(-1)
        return dict(
            pip=lay.from_flat(pip),
            post_mean_beta=lay.from_flat(mean),
            post_var_beta=lay.from_flat(second - mean ** 2),
            state=state,
        )


def smc_over_grid(dataset, grid_table, n_chains_per_particle=1,
                  n_stages=8, sweeps_per_stage=5, seed=0,
                  sigma_eps_default=0.9):
    """Tempered SMC with hyperparameter grid points as particles.

    :param grid_table: DataFrame with columns among
        (pi, tau_beta, sigma_epsilon, lambda_min); one particle per row.
    :returns: dict with per-particle log-weights across stages, final weights,
        and the posterior summaries of the highest-weight particle's chains.
    """
    lay = dataset.layout
    n = float(dataset.n)
    particles = []
    for _, row in grid_table.iterrows():
        pi = float(row.get('pi', 0.01))
        tau = float(row.get('tau_beta', pi * lay.m / 0.1))
        sig = float(row.get('sigma_epsilon', sigma_eps_default))
        lam = float(row.get('lambda_min', 0.0))
        particles.append(GibbsSampler(dataset, pi=pi, tau_beta=tau,
                                      sigma_eps=sig, lambda_min=lam,
                                      n_chains=n_chains_per_particle,
                                      seed=seed))
    states = [s.init_state(jax.random.PRNGKey(seed + 17 * i))
              for i, s in enumerate(particles)]

    P = len(particles)
    log_w = np.zeros(P)
    lambdas = np.linspace(0.0, 1.0, n_stages + 1)[1:]
    prev_lambda = 0.0

    for t, lam_t in enumerate(lambdas):
        # mutate under the previous temperature, then reweight by the increment:
        for i, (s, st) in enumerate(zip(particles, states)):
            args = (s._sb, s._nf, F32(s.sigma_eps), F32(s.tau_beta),
                    F32(s.pi), F32(s.lambda_min), F32(max(lam_t, 1e-3)))
            for _ in range(sweeps_per_stage):
                st = _gibbs_sweep(dataset.ld, st, *args)
            states[i] = st
            ll = float(np.mean(np.asarray(
                _loglik(st, s._sb, s.sigma_eps, n))))
            log_w[i] += (lam_t - prev_lambda) * ll
        prev_lambda = lam_t

        # systematic resampling when effective sample size collapses:
        w = np.exp(log_w - log_w.max())
        w /= w.sum()
        ess = 1.0 / np.sum(w ** 2)
        if ess < P / 2 and t < len(lambdas) - 1:
            pos = (np.arange(P) + np.random.default_rng(seed + t).random()) / P
            idx = np.searchsorted(np.cumsum(w), pos)
            states = [states[j] for j in idx]
            particles = [particles[j] for j in idx]
            log_w[:] = 0.0

    w = np.exp(log_w - log_w.max())
    w /= w.sum()
    best = int(np.argmax(w))
    summary = particles[best].run(n_iter=50, burn_in=0, state=states[best])
    return dict(weights=w, best_particle=best,
                best_hyper=dict(pi=particles[best].pi,
                                tau_beta=particles[best].tau_beta,
                                sigma_eps=particles[best].sigma_eps),
                posterior=summary)


def hmc_refine(dataset, gamma_mask, pi=0.01, tau_beta=1000.0, sigma_eps=0.9,
               n_samples=100, n_leapfrog=10, step_size=None, seed=0,
               n_chains=4):
    """HMC on the slab coefficients given a fixed inclusion configuration.

    The conditional target is Gaussian:
        E(beta) = n/(2 sigma_eps) (beta' R beta - 2 beta_hat' beta)
                  + tau_beta/2 ||beta||^2,  restricted to gamma_mask == 1.
    Gradients use the blocked LD matmul (compute_q). Returns the posterior
    mean/var of beta over the kept samples.
    """
    lay = dataset.layout
    ld = dataset.ld
    sb = jnp.asarray(lay.to_flat(dataset.std_beta)
                     .reshape(1, lay.nb, lay.block_size), F32)
    nf = jnp.asarray(lay.to_flat(dataset.n_per_snp)
                     .reshape(1, lay.nb, lay.block_size), F32)
    gmask = jnp.asarray(lay.to_flat(gamma_mask)
                        .reshape(1, lay.nb, lay.block_size), F32) * ld.mask[None]

    n_over_sig = nf / F32(sigma_eps)

    def _sum64(x):
        # per-block f32 partial sums, f64 across blocks: the Metropolis test
        # compares energies of magnitude ~1e6, where a plain f32 reduction
        # carries O(1) noise — enough to collapse the acceptance rate.
        return jnp.sum(jnp.sum(x, axis=2).astype(jnp.float64), axis=1)

    def grad_energy(beta):
        Rb = compute_q(ld, beta) + beta
        return (n_over_sig * (Rb - sb) + F32(tau_beta) * beta) * gmask

    def energy(beta):
        Rb = compute_q(ld, beta) + beta
        quad = 0.5 * _sum64(n_over_sig * beta * (Rb - 2.0 * sb))
        prior = 0.5 * jnp.float64(tau_beta) * _sum64(beta * beta)
        return quad + prior

    # Diagonal mass matrix = per-coordinate curvature (n/sigma_eps + tau_beta):
    # preconditions the Gaussian target so the effective spectrum is the LD
    # CORRELATION matrix's (O(10) condition within blocks) instead of the
    # raw precision's (~1e6 scale) — without it the leapfrog needs
    # d^(1/4)-smaller steps and acceptance collapses on stiff problems.
    m_diag = (nf / F32(sigma_eps) + F32(tau_beta)) * gmask + (1.0 - gmask)
    inv_m = gmask / m_diag
    sqrt_m = jnp.sqrt(m_diag)

    if step_size is None:
        step_size = 0.1
    eps0 = float(step_size)

    beta0 = jnp.zeros((n_chains, lay.nb, lay.block_size), F32)
    gmask = jnp.broadcast_to(gmask, beta0.shape)
    sb = jnp.broadcast_to(sb, beta0.shape)
    nf = jnp.broadcast_to(nf, beta0.shape)
    n_over_sig = nf / F32(sigma_eps)

    def hmc_step(beta, e_pot, key, eps):
        """One proposal per chain. The current state's potential energy is
        CARRIED (e_pot) — only the proposal pays an energy evaluation, and
        the leapfrog reuses endpoint gradients, so one step streams the LD
        L+2 times instead of the naive 2L+2 (L = trajectory length)."""
        k1, k2, k3 = jax.random.split(key, 3)
        p0 = jax.random.normal(k1, beta.shape, F32) * sqrt_m * gmask
        h0 = e_pot + 0.5 * _sum64(p0 * p0 * inv_m)

        # jittered trajectory length L ~ U{ceil(n/2), ..., n_leapfrog}: fixed
        # lengths resonate with the target's periodicities on a near-Gaussian
        # posterior (Neal 2011 §5.4.3.2) and stall exploration:
        n_lo = max(1, (n_leapfrog + 1) // 2)
        L = jax.random.randint(k3, (), n_lo, n_leapfrog + 1)

        # leapfrog with gradient reuse across inner steps:
        g = grad_energy(beta)
        p_half = p0 - 0.5 * eps * g

        def leap(_, carry):
            b, p = carry
            b = b + eps * p * inv_m
            g = grad_energy(b)
            p = p - eps * g
            return b, p

        b1, p1 = lax.fori_loop(0, L - 1, leap, (beta, p_half))
        b1 = b1 + eps * p1 * inv_m
        p1 = p1 - 0.5 * eps * grad_energy(b1)

        e1 = energy(b1)
        h1 = e1 + 0.5 * _sum64(p1 * p1 * inv_m)
        log_alpha = jnp.minimum(h0 - h1, 0.0)
        # acceptance PROBABILITY per chain (low-variance signal for dual
        # averaging); a divergent trajectory counts as alpha = 0:
        alpha = jnp.where(jnp.isfinite(log_alpha), jnp.exp(log_alpha), 0.0)
        accept = (jax.random.uniform(k2, alpha.shape) < alpha)[:, None, None]
        beta_new = jnp.where(accept, b1, beta)
        e_new = jnp.where(accept[:, 0, 0], e1, e_pot)
        return beta_new, e_new, alpha.mean()

    n_warm = n_samples // 2
    # Adaptation target: above the textbook 0.65 to buffer the averaged step
    # size's behavior once adaptation stops (f32 energy noise grows with M).
    # 0.72 landed sampling at 0.62 at 150k (round 4, below the 0.65 spec);
    # 0.78 measured 0.82 sampling / 0.70 warmup at 150k with eta-corr 0.9990
    # and unchanged wall-clock — inside the healthy
    # 0.6-0.9 band and above the spec:
    delta = 0.78
    mu = np.log(10.0 * eps0)
    gamma_da, t0_da, kappa_da = 0.05, 10.0, 0.75

    @jax.jit
    def run_all(key):
        e_init = energy(beta0)

        def warm_body(carry, it):
            beta, e_pot, log_eps, log_eps_bar, h_bar, key = carry
            key, sub = jax.random.split(key)
            beta, e_pot, alpha = hmc_step(beta, e_pot, sub,
                                          jnp.exp(log_eps).astype(F32))
            # Nesterov dual averaging on the acceptance statistic:
            t = it + 1.0
            h_bar = (1.0 - 1.0 / (t + t0_da)) * h_bar \
                + (delta - alpha) / (t + t0_da)
            log_eps = mu - jnp.sqrt(t) / gamma_da * h_bar
            w = t ** (-kappa_da)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            return (beta, e_pot, log_eps, log_eps_bar, h_bar, key), alpha

        carry0 = (beta0, e_init, jnp.float64(np.log(eps0)),
                  jnp.float64(np.log(eps0)), jnp.float64(0.0), key)
        carry, warm_alphas = lax.scan(warm_body, carry0, jnp.arange(n_warm,
                                                                    dtype=jnp.float64))
        beta, e_pot, _, log_eps_bar, _, key = carry
        eps_fin = jnp.exp(log_eps_bar).astype(F32)

        def samp_body(carry, _):
            beta, e_pot, key, s1, s2 = carry
            key, sub = jax.random.split(key)
            beta, e_pot, alpha = hmc_step(beta, e_pot, sub, eps_fin)
            return (beta, e_pot, key, s1 + beta.sum(0),
                    s2 + (beta * beta).sum(0)), alpha

        zeros = jnp.zeros(beta0.shape[1:], F32)
        (beta, e_pot, key, s1, s2), samp_alphas = lax.scan(
            samp_body, (beta, e_pot, key, zeros, zeros),
            None, length=n_samples - n_warm)
        return s1, s2, warm_alphas, samp_alphas, eps_fin

    s1, s2, warm_alphas, samp_alphas, eps_fin = run_all(
        jax.random.PRNGKey(seed))
    kept = (n_samples - n_warm) * n_chains
    mean = np.asarray(s1, dtype=np.float64).reshape(-1) / kept
    second = np.asarray(s2, dtype=np.float64).reshape(-1) / kept
    return dict(post_mean_beta=lay.from_flat(mean),
                post_var_beta=lay.from_flat(second - mean ** 2),
                accept_rate=float(np.mean(np.asarray(samp_alphas))),
                warmup_accept_rate=float(np.mean(np.asarray(warm_alphas))),
                step_size=float(eps_fin))
