"""Clean-room NumPy implementation of spike-and-slab CAVI for parity testing.

Implements the published update equations (Zabad et al. 2023 AJHG, supplementary
material) with strict *sequential* per-variant coordinate ascent in float64 —
the single-threaded ground-truth ordering that the reference's C++ kernel
realizes (and that its multithreaded mode only approximates). Our sweep kernels
are validated against the fixed points of this implementation.

This file is test-support code, deliberately simple and slow.
"""

import numpy as np


def sigmoid(x):
    out = np.empty_like(x, dtype=np.float64)
    neg = x < 0
    out[neg] = np.exp(x[neg]) / (1.0 + np.exp(x[neg]))
    out[~neg] = 1.0 / (1.0 + np.exp(-x[~neg]))
    return out


def seq_e_step(R, std_beta, n_per_snp, gamma, mu, eta, q,
               sigma_eps, tau_beta, pi, lambda_min=0.0, eps=1e-8):
    """One strict sequential CAVI sweep (in place). R is the dense LD matrix."""
    M = len(std_beta)
    var_tau = n_per_snp * (1.0 + lambda_min) / sigma_eps + tau_beta
    mu_mult = n_per_snp / (var_tau * sigma_eps)
    u_logs = np.log(pi) - np.log(1.0 - pi) + 0.5 * (np.log(tau_beta) - np.log(var_tau))

    for j in range(M):
        mu_j = mu_mult[j] * (std_beta[j] - q[j])
        u_j = u_logs[j] + 0.5 * var_tau[j] * mu_j * mu_j
        g_j = 1.0 / (1.0 + np.exp(-u_j)) if u_j >= 0 else np.exp(u_j) / (1.0 + np.exp(u_j))
        d = g_j * mu_j - eta[j]
        if abs(d) < eps:
            continue
        mu[j] = mu_j
        gamma[j] = g_j
        q += R[:, j] * d
        q[j] -= d  # q excludes the diagonal
        eta[j] += d
    return var_tau


def tile_e_step(R, std_beta, n_per_snp, gamma, mu, eta, q,
                sigma_eps, tau_beta, pi, lambda_min=0.0, tile=128, eps=1e-8):
    """Tile-synchronous sweep: Jacobi within a tile, Gauss-Seidel across tiles —
    the exact update schedule of the blocked sweep, in float64 NumPy.
    (Single block: R dense over all M variants.)"""
    M = len(std_beta)
    var_tau = n_per_snp * (1.0 + lambda_min) / sigma_eps + tau_beta
    mu_mult = n_per_snp / (var_tau * sigma_eps)
    u_logs = np.log(pi) - np.log(1.0 - pi) + 0.5 * (np.log(tau_beta) - np.log(var_tau))

    for t0 in range(0, M, tile):
        t1 = min(t0 + tile, M)
        sl = slice(t0, t1)
        mu_t = mu_mult[sl] * (std_beta[sl] - q[sl])
        u_t = u_logs[sl] + 0.5 * var_tau[sl] * mu_t ** 2
        g_t = sigmoid(u_t)
        d = g_t * mu_t - eta[sl]
        keep = np.abs(d) >= eps
        d = np.where(keep, d, 0.0)
        mu[sl] = np.where(keep, mu_t, mu[sl])
        gamma[sl] = np.where(keep, g_t, gamma[sl])
        eta[sl] += d
        q += R[:, sl] @ d
        q[sl] -= d
    return var_tau


def m_step(std_beta, gamma, mu, eta, q, var_tau, lambda_min,
           fix_pi=None, fix_tau_beta=None, fix_sigma_eps=None):
    """Closed-form M-step. Returns (pi, tau_beta, sigma_g, sigma_eps, zeta)."""
    M = len(std_beta)
    zeta = gamma * (mu ** 2 + 1.0 / var_tau)
    pi = np.mean(gamma) if fix_pi is None else fix_pi
    tau_beta = pi * M / zeta.sum() if fix_tau_beta is None else fix_tau_beta
    sigma_g = np.sum((1.0 + lambda_min) * zeta + q * eta)
    if fix_sigma_eps is None:
        sigma_eps = 1.0 - 2.0 * std_beta.dot(eta) + sigma_g
    else:
        sigma_eps = fix_sigma_eps
    return pi, tau_beta, sigma_g, sigma_eps, zeta


def elbo(std_beta, n, gamma, eta, zeta, var_tau, pi, tau_beta,
         sigma_eps, sigma_g, sigma_eps_fixed=False):
    """ELBO with the reference's structure (VIPRS.py:497-581)."""
    resolution = np.finfo(np.float64).resolution
    g = np.clip(gamma, resolution, 1.0 - resolution)
    ng = np.clip(1.0 - gamma, resolution, 1.0 - resolution)

    e = -np.log(2.0 * np.pi * sigma_eps)
    if sigma_eps_fixed:
        e -= (1.0 / sigma_eps) * (1.0 - 2.0 * std_beta.dot(eta) + sigma_g)
    else:
        e -= 1.0
    e *= 0.5 * n

    e -= np.sum(g * (np.log(g) - np.log(pi)))
    e -= np.sum(ng * (np.log(ng) - np.log(1.0 - pi)))
    e += 0.5 * np.sum(g * (1.0 - np.log(var_tau) + np.log(tau_beta)))
    e -= 0.5 * tau_beta * zeta.sum()
    return e


def fit(R, std_beta, n_per_snp, pi0, sigma_eps0, tau_beta0,
        lambda_min=0.0, max_iter=200, f_abs_tol=1e-8,
        fix_pi=None, fix_tau_beta=None, fix_sigma_eps=None,
        schedule='sequential', tile=128):
    """Full float64 EM fit; returns a dict of final state and history."""
    M = len(std_beta)
    pi, sigma_eps, tau_beta = pi0, sigma_eps0, tau_beta0
    if fix_pi is not None:
        pi = fix_pi
    if fix_sigma_eps is not None:
        sigma_eps = fix_sigma_eps
    if fix_tau_beta is not None:
        tau_beta = fix_tau_beta

    gamma = np.full(M, pi, dtype=np.float64)
    mu = np.zeros(M)
    eta = gamma * mu
    q = np.zeros(M)
    sweep = seq_e_step if schedule == 'sequential' else tile_e_step
    kw = {} if schedule == 'sequential' else {'tile': tile}

    history = []
    sigma_g = 0.0
    for it in range(max_iter):
        var_tau = sweep(R, std_beta, n_per_snp, gamma, mu, eta, q,
                        sigma_eps, tau_beta, pi, lambda_min, **kw)
        pi, tau_beta, sigma_g, sigma_eps, zeta = m_step(
            std_beta, gamma, mu, eta, q, var_tau, lambda_min,
            fix_pi, fix_tau_beta, fix_sigma_eps)
        e = elbo(std_beta, n_per_snp.max(), gamma, eta, zeta, var_tau, pi,
                 tau_beta, sigma_eps, sigma_g,
                 sigma_eps_fixed=fix_sigma_eps is not None)
        history.append(e)
        if len(history) > 3 and abs(history[-1] - history[-2]) < f_abs_tol:
            break

    return dict(gamma=gamma, mu=mu, eta=eta, q=q, pi=pi, tau_beta=tau_beta,
                sigma_eps=sigma_eps, sigma_g=sigma_g, elbo=history[-1],
                history=np.array(history), n_iter=len(history))


def seq_e_step_mixture(R, std_beta, n_per_snp, gamma, mu, eta, q,
                       sigma_eps, tau_beta, pi, lambda_min=0.0):
    """One strict sequential mixture-CAVI sweep (in place).

    gamma/mu: (M, K); eta/q: (M,); tau_beta/pi: (K,) vectors.
    Mirrors the published K-component update: softmax over K slab logits plus
    the null logit log(1 - sum(pi))."""
    M, K = gamma.shape
    var_tau = n_per_snp[:, None] * (1.0 + lambda_min) / sigma_eps + tau_beta[None, :]
    mu_mult = n_per_snp[:, None] / (var_tau * sigma_eps)
    u_logs = (np.log(pi) - np.log(1.0 - pi))[None, :] \
        + 0.5 * (np.log(tau_beta)[None, :] - np.log(var_tau))
    log_null_pi = np.log(1.0 - pi.sum())

    for j in range(M):
        mu_j = mu_mult[j] * (std_beta[j] - q[j])          # (K,)
        u_j = u_logs[j] + 0.5 * var_tau[j] * mu_j ** 2    # (K,)
        logits = np.concatenate([u_j, [log_null_pi]])
        m_ = logits.max()
        e = np.exp(logits - m_)
        g_j = e[:K] / e.sum()
        d = float(np.dot(g_j, mu_j) - eta[j])
        mu[j] = mu_j
        gamma[j] = g_j
        q += R[:, j] * d
        q[j] -= d
        eta[j] += d
    return var_tau


def fit_mixture(R, std_beta, n_per_snp, pis, sigma_eps0, tau_betas, d_mult,
                lambda_min=0.0, max_iter=200, fix_sigma_eps=None):
    """Float64 sequential mixture EM fit (test support)."""
    M = len(std_beta)
    K = len(pis)
    pi = np.asarray(pis, dtype=np.float64)
    tau_beta = np.asarray(tau_betas, dtype=np.float64)
    d_mult = np.asarray(d_mult, dtype=np.float64)
    sigma_eps = sigma_eps0 if fix_sigma_eps is None else fix_sigma_eps

    gamma = np.tile(pi[None, :], (M, 1))
    mu = np.zeros((M, K))
    eta = np.zeros(M)
    q = np.zeros(M)

    for it in range(max_iter):
        var_tau = seq_e_step_mixture(R, std_beta, n_per_snp, gamma, mu, eta, q,
                                     sigma_eps, tau_beta, pi, lambda_min)
        zeta_k = (gamma * (mu ** 2 + 1.0 / var_tau)).sum(axis=0)  # (K,)
        pi = gamma.sum(axis=0) / M
        tau_est = pi.sum() * M / np.dot(d_mult, zeta_k)
        tau_beta = np.clip(d_mult * tau_est, 1.0, None)
        sigma_g = (1.0 + lambda_min) * zeta_k.sum() + q.dot(eta)
        if fix_sigma_eps is None:
            sigma_eps = 1.0 - 2.0 * std_beta.dot(eta) + sigma_g

    return dict(gamma=gamma, mu=mu, eta=eta, q=q, pi=pi, tau_beta=tau_beta,
                sigma_eps=sigma_eps, sigma_g=sigma_g)
