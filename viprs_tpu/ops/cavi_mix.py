"""Blocked CAVI sweep for the sparse Gaussian-mixture prior (VIPRSMix).

Accelerator re-design of ``e_step_mixture`` (viprs/model/vi/e_step.hpp:447-551): K slab
components ride a leading axis of the variational state; per tile, the K+1
component logits (K slabs + null) go through a softmax, the scalar eta update
feeds the same rank-T q-update as the spike-and-slab kernel.

State layout: gamma/mu are (K, NB, B); eta/q are (NB, B). Hyperparameters:
sigma_eps/lambda_min scalars, tau_beta/pi are (K,) vectors.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .block_ld import BlockLD
from .cavi_jax import HIGHEST, _dequant_matmul, _off_contrib

F32 = jnp.float32


class MixState(NamedTuple):
    gamma: jnp.ndarray   # (K, NB, B) responsibilities of the slab components
    mu: jnp.ndarray      # (K, NB, B)
    eta: jnp.ndarray     # (NB, B)
    q: jnp.ndarray       # (NB, B)


class MixHyper(NamedTuple):
    sigma_eps: jnp.ndarray    # scalar
    tau_beta: jnp.ndarray     # (K,)
    pi: jnp.ndarray           # (K,)
    lambda_min: jnp.ndarray   # scalar


def compute_q_mix(ld: BlockLD, eta):
    """q = (R - I) eta for (NB, B) eta."""
    from .cavi_jax import compute_q
    return compute_q(ld, eta[None])[0]


def _mix_block_tile_loop(D_b, beta_b, n_b, mask_b, gamma_b, mu_b, eta_b, q_b,
                         hyper: MixHyper, scale, tile, n_tiles, inner_steps,
                         active=None):
    """gamma_b/mu_b: (K, B); eta_b/q_b: (B,); D_b: (B, B).

    Tile-Gauss-Seidel with ``inner_steps`` tile-local fixed-point refinements
    (same scheme as the spike-and-slab kernel, ops/cavi_jax.py) — each inner
    pass recomputes the K-component updates from a tile-locally refreshed q.

    ``active``: scalar f32 — 0 freezes the lane (the converged-model masking
    of the batched grid path, the mixture analog of ``active_model_idx`` in
    e_step_grid, e_step.hpp:606-634); values in (0, 1) act as extra damping.
    """
    K = gamma_b.shape[0]
    act = F32(1.0) if active is None else active.astype(F32)
    on = (act > 0.0).astype(F32)
    sig_e = hyper.sigma_eps
    tau_b = hyper.tau_beta[:, None]          # (K,1)
    lam = hyper.lambda_min
    pi_ = hyper.pi[:, None]
    # reference formula (VIPRSMix.py:196-204): log pi_k - log(1-pi_k) + log(tau_k)/2
    base_logit = jnp.log(pi_) - jnp.log1p(-pi_) + 0.5 * jnp.log(tau_b)
    log_null_pi = jnp.log1p(-jnp.sum(hyper.pi))

    def body(t, carry):
        gamma_b, mu_b, eta_b, q_b = carry
        idx = t * tile

        q_t = lax.dynamic_slice(q_b, (idx,), (tile,))
        eta_t = lax.dynamic_slice(eta_b, (idx,), (tile,))
        n_t = lax.dynamic_slice(n_b, (idx,), (tile,))[None, :]
        beta_t = lax.dynamic_slice(beta_b, (idx,), (tile,))[None, :]
        mask_t = lax.dynamic_slice(mask_b, (idx,), (tile,))
        g_t = lax.dynamic_slice(gamma_b, (0, idx), (gamma_b.shape[0], tile))
        mu_t = lax.dynamic_slice(mu_b, (0, idx), (mu_b.shape[0], tile))

        var_tau_t = n_t * (1.0 + lam) / sig_e + tau_b          # (K,T)
        mu_mult_t = n_t / (var_tau_t * sig_e)
        mu_mult_max = jnp.max(jnp.abs(mu_mult_t), axis=0)      # (T,)

        D_rows = lax.dynamic_slice(D_b, (idx, 0), (tile, D_b.shape[1]))
        R_tt = lax.dynamic_slice(D_rows, (0, idx), (tile, tile)).astype(F32)
        if scale != 1.0:
            R_tt = R_tt * F32(scale)
        R_abs = jnp.abs(R_tt)
        R_abs_diag = jnp.diagonal(R_abs)

        g_cur, mu_cur, eta_cur, q_cur = g_t, mu_t, eta_t, q_t
        for step in range(inner_steps):
            mu_star = mu_mult_t * (beta_t - q_cur[None, :])    # (K,T)
            u = base_logit - 0.5 * jnp.log(var_tau_t) \
                + 0.5 * var_tau_t * mu_star * mu_star          # (K,T)

            # softmax over K slabs + the null component:
            u_max = jnp.maximum(jnp.max(u, axis=0), log_null_pi)   # (T,)
            exp_u = jnp.exp(u - u_max[None, :])
            denom = exp_u.sum(axis=0) + jnp.exp(log_null_pi - u_max)
            g_star = exp_u / denom[None, :]                        # (K,T)

            # gamma-weighted within-tile under-relaxation (same stabilization
            # as the spike-and-slab kernel; Jacobi overshoots on stiff LD).
            # Recomputed on EVERY inner pass: the inclusion probabilities can
            # grow by orders of magnitude across the refinement steps, and a
            # weight frozen from the first pass overshoots catastrophically on
            # stiff genome-scale blocks (the w_once regression — see
            # DESIGN.md; the extra (T,)x(T,T) matvec per step is noise next
            # to the block matmul).
            pip_star = jnp.sum(g_star, axis=0)                     # (T,)
            coupling = jnp.dot(pip_star * mu_mult_max, R_abs,
                               precision=HIGHEST, preferred_element_type=F32)
            coupling = coupling - R_abs_diag * pip_star * mu_mult_max
            w = (act / (1.0 + coupling))[None, :]                  # (1,T)

            g_cur = g_cur + w * (g_star - g_cur)
            mu_cur = mu_cur + w * (mu_star - mu_cur)
            eta_new = jnp.sum(g_cur * mu_cur, axis=0)
            d_in = (eta_new - eta_cur) * mask_t * on
            q_cur = q_cur + jnp.dot(d_in[None, :], R_tt, precision=HIGHEST,
                                    preferred_element_type=F32)[0] - d_in
            eta_cur = eta_cur + d_in

        d_t = (eta_cur - eta_t) * mask_t * on                      # (T,)

        gamma_b = lax.dynamic_update_slice(gamma_b, g_cur, (0, idx))
        mu_b = lax.dynamic_update_slice(mu_b, mu_cur, (0, idx))
        eta_b = lax.dynamic_update_slice(eta_b, eta_t + d_t, (idx,))

        q_b = q_b + _dequant_matmul(d_t[None, :], D_rows, scale)[0]
        q_tt = lax.dynamic_slice(q_b, (idx,), (tile,))
        q_b = lax.dynamic_update_slice(q_b, q_tt - d_t, (idx,))

        return gamma_b, mu_b, eta_b, q_b

    return lax.fori_loop(0, n_tiles, body, (gamma_b, mu_b, eta_b, q_b))


@partial(jax.jit, static_argnames=('tile', 'inner_steps'))
def cavi_sweep_mixture(ld: BlockLD, state: MixState, std_beta, n_per_snp,
                       hyper: MixHyper, tile: int = 128, inner_steps: int = 8):
    """One mixture-CAVI sweep. Returns (new_state, eta_diff)."""
    assert ld.block_size % tile == 0
    eta0 = state.eta
    new_state = _sweep_mixture_impl(ld, state, std_beta, n_per_snp, hyper,
                                    None, tile, inner_steps)
    return new_state, new_state.eta - eta0


def _mix_block_tile_loop_batch(D_b, beta_b, n_b, mask_b, gamma_b, mu_b,
                               eta_b, q_b, hyper: MixHyper, active, scale,
                               tile, n_tiles, inner_steps):
    """Grid-batched tile loop: the lane axis S rides INSIDE the block loop so
    the LD tiles stream ONCE per sweep for all lanes and the rank-T q-update
    is an (S, T) @ (T, B) matrix product (lane-outside vmapping re-reads the
    LD per lane and lowers to vector-sized ops).

    gamma_b/mu_b: (S, K, B); eta_b/q_b: (S, B); D_b: (B, B);
    hyper: sigma_eps/lambda_min (S,), tau_beta/pi (S, K); active: (S,) f32.
    """
    S, K = gamma_b.shape[0], gamma_b.shape[1]
    act = active.astype(F32)[:, None]              # (S,1)
    on = (act > 0.0).astype(F32)
    sig_e = hyper.sigma_eps[:, None, None]         # (S,1,1)
    tau_b = hyper.tau_beta[:, :, None]             # (S,K,1)
    lam = hyper.lambda_min[:, None, None]
    pi_ = hyper.pi[:, :, None]
    base_logit = jnp.log(pi_) - jnp.log1p(-pi_) + 0.5 * jnp.log(tau_b)
    log_null_pi = jnp.log1p(-jnp.sum(hyper.pi, axis=1))[:, None]   # (S,1)

    def body(t, carry):
        gamma_b, mu_b, eta_b, q_b = carry
        idx = t * tile

        q_t = lax.dynamic_slice(q_b, (0, idx), (S, tile))
        eta_t = lax.dynamic_slice(eta_b, (0, idx), (S, tile))
        n_t = lax.dynamic_slice(n_b, (idx,), (tile,))[None, None, :]
        beta_t = lax.dynamic_slice(beta_b, (idx,), (tile,))[None, :]
        mask_t = lax.dynamic_slice(mask_b, (idx,), (tile,))[None, :]
        g_t = lax.dynamic_slice(gamma_b, (0, 0, idx), (S, K, tile))
        mu_t = lax.dynamic_slice(mu_b, (0, 0, idx), (S, K, tile))

        var_tau_t = n_t * (1.0 + lam) / sig_e + tau_b          # (S,K,T)
        mu_mult_t = n_t / (var_tau_t * sig_e)
        mu_mult_max = jnp.max(jnp.abs(mu_mult_t), axis=1)      # (S,T)

        D_rows = lax.dynamic_slice(D_b, (idx, 0), (tile, D_b.shape[1]))
        R_tt = lax.dynamic_slice(D_rows, (0, idx), (tile, tile))
        R_abs = jnp.abs(R_tt.astype(F32))
        if scale != 1.0:
            R_abs = R_abs * F32(scale)
        R_abs_diag = jnp.diagonal(R_abs)[None, :]

        g_cur, mu_cur, eta_cur, q_cur = g_t, mu_t, eta_t, q_t
        for step in range(inner_steps):
            mu_star = mu_mult_t * (beta_t[:, None] - q_cur[:, None, :])
            u = base_logit - 0.5 * jnp.log(var_tau_t) \
                + 0.5 * var_tau_t * mu_star * mu_star          # (S,K,T)

            u_max = jnp.maximum(jnp.max(u, axis=1), log_null_pi)   # (S,T)
            exp_u = jnp.exp(u - u_max[:, None, :])
            denom = exp_u.sum(axis=1) + jnp.exp(log_null_pi - u_max)
            g_star = exp_u / denom[:, None, :]                     # (S,K,T)

            # gamma-weighted within-tile under-relaxation, recomputed every
            # inner pass (see the scalar kernel's correctness note):
            pip_star = jnp.sum(g_star, axis=1)                     # (S,T)
            coupling = _dequant_matmul(pip_star * mu_mult_max, R_abs, 1.0)
            coupling = coupling - R_abs_diag * pip_star * mu_mult_max
            w = (act / (1.0 + coupling))[:, None, :]               # (S,1,T)

            g_cur = g_cur + w * (g_star - g_cur)
            mu_cur = mu_cur + w * (mu_star - mu_cur)
            eta_new = jnp.sum(g_cur * mu_cur, axis=1)              # (S,T)
            d_in = (eta_new - eta_cur) * mask_t * on
            q_cur = q_cur + _dequant_matmul(d_in, R_tt, scale) - d_in
            eta_cur = eta_cur + d_in

        d_t = (eta_cur - eta_t) * mask_t * on                      # (S,T)

        gamma_b = lax.dynamic_update_slice(gamma_b, g_cur, (0, 0, idx))
        mu_b = lax.dynamic_update_slice(mu_b, mu_cur, (0, 0, idx))
        eta_b = lax.dynamic_update_slice(eta_b, eta_t + d_t, (0, idx))

        q_b = q_b + _dequant_matmul(d_t, D_rows, scale)
        q_tt = lax.dynamic_slice(q_b, (0, idx), (S, tile))
        q_b = lax.dynamic_update_slice(q_b, q_tt - d_t, (0, idx))

        return gamma_b, mu_b, eta_b, q_b

    return lax.fori_loop(0, n_tiles, body, (gamma_b, mu_b, eta_b, q_b))


@partial(jax.jit, static_argnames=('tile', 'inner_steps'))
def cavi_sweep_mixture_batch(ld: BlockLD, state: MixState, std_beta,
                             n_per_snp, hyper: MixHyper, active,
                             tile: int = 128, inner_steps: int = 8):
    """Grid-batched mixture sweep: S hyperparameter settings advance
    simultaneously (the mixture analog of the vmapped grid axis /
    ``e_step_grid``, e_step.hpp:555-647). Lanes ride inside the tile loop —
    one LD stream serves all S lanes (see _mix_block_tile_loop_batch).

    State: gamma/mu (S, K, NB, B); eta/q (S, NB, B).
    Hyper: sigma_eps/lambda_min (S,); tau_beta/pi (S, K).
    active: (S,) f32 — converged-lane masking (0 freezes; <1 damps).
    Returns (new_state, eta_diff) with eta_diff (S, NB, B).
    """
    B = ld.block_size
    assert B % tile == 0
    n_tiles = B // tile
    eta0 = state.eta
    act = active.astype(F32)

    def per_block(D_b, beta_b, n_b, mask_b, gamma_b, mu_b, eta_b, q_b):
        return _mix_block_tile_loop_batch(D_b, beta_b, n_b, mask_b,
                                          gamma_b, mu_b, eta_b, q_b,
                                          hyper, act, ld.scale, tile,
                                          n_tiles, inner_steps)

    gamma, mu, eta, q = jax.vmap(
        per_block,
        in_axes=(0, 0, 0, 0, 2, 2, 1, 1),
        out_axes=(2, 2, 1, 1),
    )(ld.diag, std_beta, n_per_snp, ld.mask, state.gamma, state.mu,
      state.eta, state.q)

    eta_diff = eta - eta0
    if ld.n_off > 0:
        q = q + _off_contrib(ld, eta_diff)

    return MixState(gamma=gamma, mu=mu, eta=eta, q=q), eta_diff


def _sweep_mixture_impl(ld, state, std_beta, n_per_snp, hyper, active,
                        tile, inner_steps):
    """Single-lane mixture sweep body shared by the scalar and batched
    entry points (returns a MixState)."""
    B = ld.block_size
    n_tiles = B // tile

    def per_block(D_b, beta_b, n_b, mask_b, gamma_b, mu_b, eta_b, q_b):
        return _mix_block_tile_loop(D_b, beta_b, n_b, mask_b,
                                    gamma_b, mu_b, eta_b, q_b,
                                    hyper, ld.scale, tile, n_tiles,
                                    inner_steps, active=active)

    gamma, mu, eta, q = jax.vmap(
        per_block,
        in_axes=(0, 0, 0, 0, 1, 1, 0, 0),
        out_axes=(1, 1, 0, 0),
    )(ld.diag, std_beta, n_per_snp, ld.mask, state.gamma, state.mu,
      state.eta, state.q)

    eta_diff = eta - state.eta
    if ld.n_off > 0:
        q = q + _off_contrib(ld, eta_diff[None])[0]
    return MixState(gamma=gamma, mu=mu, eta=eta, q=q)


def mix_var_tau(n_per_snp, hyper: MixHyper):
    """(K, NB, B) posterior precisions with the e-step hyperparameters."""
    return (n_per_snp[None] * (1.0 + hyper.lambda_min) / hyper.sigma_eps
            + hyper.tau_beta[:, None, None])


def mix_stats(state: MixState, var_tau, std_beta, mask):
    """Masked reductions used by the mixture M-step/ELBO.

    Mixed-precision discipline (same as updates.collect_stats on the S=1
    path, and the reason the batched mixture EM body is cheap): every
    elementwise term — including the entropy logs — is computed in FLOAT32,
    the minor (B) axis is summed in f32, and only the per-block partial
    sums are upcast to float64 for the cross-block accumulation, which keeps
    the elementwise work over (S, K, NB, B) in float32.

    Returns dict with per-component (K,) and scalar reductions.
    """
    g = state.gamma
    mk = mask[None]
    zeta_k = g * (state.mu ** 2 + 1.0 / var_tau)            # (K,NB,B)

    def rsum(x, axes):
        return jnp.sum(jnp.sum(x, axis=-1).astype(jnp.float64), axis=axes)

    sum_gamma_k = rsum(g * mk, (-1,))                        # (K,)
    sum_zeta_k = rsum(zeta_k * mk, (-1,))                    # (K,)
    sum_q_eta = jnp.sum(jnp.sum(state.q * state.eta * mask, axis=-1)
                        .astype(jnp.float64))
    sum_beta_eta = jnp.sum(jnp.sum(std_beta * state.eta * mask, axis=-1)
                           .astype(jnp.float64))
    sum_eta_sq = jnp.sum(jnp.sum(state.eta ** 2 * mask, axis=-1)
                         .astype(jnp.float64))

    eps = jnp.float32(1e-12)
    one = jnp.float32(1.0)
    pip = jnp.clip(jnp.sum(g, axis=0), eps, one - eps)       # f32 (NB,B)
    null_g = one - pip
    gc = jnp.clip(g, eps, one - eps)
    sum_g_logg = jnp.sum(jnp.sum(gc * jnp.log(gc) * mask[None], axis=-1)
                         .astype(jnp.float64))
    ngc = jnp.clip(null_g, eps, one - eps)
    sum_ng_logng = jnp.sum(jnp.sum(ngc * jnp.log(ngc) * mask, axis=-1)
                           .astype(jnp.float64))
    sum_null_g = jnp.sum(jnp.sum(null_g * mask, axis=-1).astype(jnp.float64))
    sum_g_logvt = jnp.sum(jnp.sum(g * jnp.log(var_tau) * mk, axis=-1)
                          .astype(jnp.float64), axis=-1)     # (K,)

    return dict(sum_gamma_k=sum_gamma_k, sum_zeta_k=sum_zeta_k,
                sum_q_eta=sum_q_eta, sum_beta_eta=sum_beta_eta,
                sum_eta_sq=sum_eta_sq, sum_g_logg=sum_g_logg,
                sum_ng_logng=sum_ng_logng, sum_null_g=sum_null_g,
                sum_g_logvt=sum_g_logvt)
