"""Blocked CAVI e-step sweep — XLA implementation.

Accelerator re-design of the reference's sequential coordinate-ascent kernel
(``e_step`` in viprs/model/vi/e_step.hpp:343-442 and ``e_step_grid``
at :555-647):

- tiles of T=128 coordinates update *jointly* (Jacobi within tile) from the
  current residual ``q``;
- tiles within a block update *sequentially* (Gauss-Seidel), with the rank-T
  q-update expressed as an (S,T)@(T,B) matrix product, where S is the model/grid
  axis (the reference's (M, n_models) matrices become a leading batch axis);
- blocks update in parallel (exact for block-diagonal LD; one-sweep-stale at
  block boundaries for banded LD — a deterministic, *stronger* synchronization
  than the reference's racy OpenMP mode, VIPRS.py:1056-1061);
- cross-block coupling (n_bands > 0) is refreshed once per sweep with batched
  matmuls over the coupling blocks (the analog of ``update_q_factor``'s second
  pass, e_step.hpp:435-441).

State layout: all per-variant state is (S, NB, B) float32 — B (a multiple of
128) is the contiguous minor dimension; S is the model-grid batch axis.

The per-variant update equations (Zabad et al. 2023 AJHG, as implemented at
VIPRS.py:381-424):

    var_tau_j = n_j (1 + lambda_min) / sigma_eps + tau_beta
    mu_j      = n_j / (var_tau_j sigma_eps) * (std_beta_j - q_j)
    u_j       = logit(pi) + (log tau_beta - log var_tau_j)/2 + var_tau_j mu_j^2 / 2
    gamma_j   = sigmoid(u_j)
    d_eta_j   = gamma_j mu_j - eta_j   (zeroed below machine-precision threshold)
    q        += (R - I)[:, j] d_eta_j ;  eta_j += d_eta_j
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .block_ld import BlockLD
from .memory import chunk_threshold_bytes, off_scan_threshold_bytes

F32 = jnp.float32
#: Every float32 product on the fit path runs at full float32 precision: a
#: backend may otherwise lower an f32 dot to TF32 (about three decimal
#: digits), far coarser than the 1e-6 tolerances the fit converges at.
HIGHEST = lax.Precision.HIGHEST
# The reference zeroes updates below max(machine eps, 1e-8) (e_step.hpp:382).
ETA_DIFF_EPS = 1e-8


class CaviState(NamedTuple):
    """Per-variant variational state, all (S, NB, B) float32.

    ``logits`` are the Bernoulli logits of gamma (gamma = sigmoid(logits)); we
    carry logits rather than gamma so entropy/ELBO terms can be computed in a
    numerically stable way (log gamma = -softplus(-u) exactly).
    """
    logits: jnp.ndarray
    mu: jnp.ndarray
    eta: jnp.ndarray
    q: jnp.ndarray

    @property
    def gamma(self):
        return jax.nn.sigmoid(self.logits)


class Hyper(NamedTuple):
    """Per-model hyperparameters, all (S,) float32 on kernel entry."""
    sigma_eps: jnp.ndarray
    tau_beta: jnp.ndarray
    pi: jnp.ndarray
    lambda_min: jnp.ndarray


def _dequant_matmul(d_t, rows, scale):
    """(S,T) @ (T,B) with on-the-fly dequantization of the LD tile."""
    dt = d_t.dtype
    out = jnp.dot(d_t, rows.astype(dt), precision=HIGHEST,
                  preferred_element_type=dt)
    if scale != 1.0:
        out = out * jnp.asarray(scale, dt)
    return out


def _off_contrib(ld: BlockLD, v):
    """Cross-tile contribution of the compact coupling blocks:
    out[src_o] += U_o @ v[dst_o]; out[dst_o] += U_o^T @ v[src_o].

    v: (S, NB, B). Returns (S, NB, B).
    """
    if ld.off_data.nbytes > off_scan_threshold_bytes():
        return _off_contrib_scanned(ld, v)
    dt = v.dtype
    U = ld.off_data.astype(dt)                        # (n_off, B, B)
    v_dst = jnp.take(v, ld.off_dst, axis=1)           # (S, n_off, B)
    v_src = jnp.take(v, ld.off_src, axis=1)
    row_part = jnp.einsum('oij,soj->soi', U, v_dst, precision=HIGHEST,
                          preferred_element_type=dt)
    col_part = jnp.einsum('oji,soj->soi', U, v_src, precision=HIGHEST,
                          preferred_element_type=dt)
    out = jnp.zeros_like(v)
    out = out.at[:, ld.off_src].add(row_part)
    out = out.at[:, ld.off_dst].add(col_part)
    if ld.scale != 1.0:
        out = out * jnp.asarray(ld.scale, dt)
    return out


def _off_contrib_scanned(ld: BlockLD, v):
    """Capacity-scale _off_contrib: one (B, B) coupling tile dequantized at
    a time (peak f32 temp = one tile instead of the whole off stack)."""
    dt = v.dtype
    v_dst = jnp.take(v, ld.off_dst, axis=1)           # (S, n_off, B)
    v_src = jnp.take(v, ld.off_src, axis=1)
    v_dst_t = jnp.moveaxis(v_dst, 1, 0)               # (n_off, S, B)
    v_src_t = jnp.moveaxis(v_src, 1, 0)

    def body(_, xs):
        U_b, vd, vs = xs                              # (B,B), (S,B), (S,B)
        Uf = U_b.astype(dt)
        row = jnp.einsum('ij,sj->si', Uf, vd, precision=HIGHEST,
                         preferred_element_type=dt)
        col = jnp.einsum('ji,sj->si', Uf, vs, precision=HIGHEST,
                         preferred_element_type=dt)
        return None, (row, col)

    _, (row_t, col_t) = lax.scan(body, None, (ld.off_data, v_dst_t, v_src_t))
    out = jnp.zeros_like(v)
    out = out.at[:, ld.off_src].add(jnp.moveaxis(row_t, 0, 1))
    out = out.at[:, ld.off_dst].add(jnp.moveaxis(col_t, 0, 1))
    if ld.scale != 1.0:
        out = out * jnp.asarray(ld.scale, dt)
    return out


@jax.jit
def _compute_q_dense(ld: BlockLD, eta):
    diag_f = ld.diag.astype(F32)
    q = jnp.einsum('bij,sbj->sbi', diag_f, eta, precision=HIGHEST,
                   preferred_element_type=F32)
    if ld.scale != 1.0:
        q = q * F32(ld.scale)
    q = q - eta  # remove the unit diagonal
    if ld.n_off > 0:
        q = q + _off_contrib(ld, eta)
    return q


@jax.jit
def _compute_q_scanned(ld: BlockLD, eta):
    # One block at a time: the f32 view of the int8 tiles (4 bytes/element)
    # and any layout-change copy exist only per (B, B) slice — at the
    # 9.6M/18M panel scales a dense einsum's operand copy alone exceeds HBM.
    eta_t = jnp.moveaxis(eta, 1, 0)                   # (NB, S, B)

    def body(_, xs):
        D_b, e_b = xs                                  # (B, B), (S, B)
        q_b = jnp.einsum('ij,sj->si', D_b.astype(F32), e_b,
                         precision=HIGHEST, preferred_element_type=F32)
        if ld.scale != 1.0:
            q_b = q_b * F32(ld.scale)
        return None, q_b

    _, q_t = lax.scan(body, None, (ld.diag, eta_t))
    q = jnp.moveaxis(q_t, 0, 1) - eta
    if ld.n_off > 0:
        q = q + _off_contrib(ld, eta)
    return q


def compute_q(ld: BlockLD, eta, chunked=None):
    """q = (R - I) @ eta, fresh from scratch (used at warm starts / validation).

    eta: (S, NB, B) -> q: (S, NB, B). Jitted, so the int8->f32 dequantization
    fuses into the matmul tiles instead of materializing a full f32 copy of
    the LD (the eager path did — 4x the LD bytes in HBM, 39 GB at 9.6M
    variants). ``chunked`` (default: tiles above the memory plan's chunk
    threshold, ops/memory.py) streams block-by-block so peak temp memory is one (B, B) tile.

    The chunk decision is per DEVICE: when ``ld.diag`` is GSPMD-sharded over
    the 'blocks' mesh axis, the dense einsum 'bij,sbj->sbi' partitions
    perfectly over b, while ``lax.scan`` is sequential over that axis and
    would force per-step cross-device slicing/replication — so a sharded LD
    only chunks if its per-device share exceeds the threshold.
    """
    if chunked is None:
        n_dev = 1
        sh = getattr(ld.diag, 'sharding', None)
        if sh is not None:
            try:
                n_dev = max(1, len(sh.device_set))
            except (AttributeError, TypeError):
                n_dev = 1
        chunked = ld.diag.nbytes / n_dev > chunk_threshold_bytes()
    return (_compute_q_scanned if chunked else _compute_q_dense)(ld, eta)


def refresh_q(ld: BlockLD, q, eta_diff):
    """Apply the cross-tile coupling part of the q update for this sweep's
    total eta change. The in-tile part was applied incrementally in the tile
    loop. No-op for block-diagonal LD (no coupling tiles)."""
    if ld.n_off == 0:
        return q
    return q + _off_contrib(ld, eta_diff)


def _block_tile_loop(D_b, beta_b, n_b, mask_b, logits_b, mu_b, eta_b, q_b,
                     hyper: Hyper, active, scale, tile, n_tiles, relax,
                     inner_steps):
    """Gauss-Seidel over tiles within one LD block.

    Within a tile the T coordinates update jointly (Jacobi), which overshoots
    when the gamma-weighted LD coupling exceeds 1 (e.g. clusters of highly
    correlated variants with high inclusion probability — the same regime where
    the reference's Hogwild threading oscillates, VIPRS.py:1056-1061). With
    ``relax=True`` each coordinate takes an under-relaxed step

        w_j = 1 / (1 + sum_{k in tile, k != j} |R_jk| gamma_k^*)

    applied jointly to (gamma, mu) — the eta = gamma*mu invariant holds exactly
    and the CAVI fixed point is unchanged; w ~= 1 wherever LD or gamma is small,
    so well-conditioned problems pay nothing.

    D_b: (B, B) storage dtype; beta_b, n_b, mask_b: (B,);
    logits_b, mu_b, eta_b, q_b: (S, B); active: (S,) f32 (0 disables a model;
    values < 1 act as extra global damping).
    """
    S = q_b.shape[0]
    sig_e = hyper.sigma_eps[:, None]          # (S,1)
    tau_b = hyper.tau_beta[:, None]
    lam = hyper.lambda_min[:, None]
    # logit(pi) + 0.5*log(tau_beta); pi guarded away from {0,1} by the caller.
    pi_ = hyper.pi[:, None]
    base_logit = jnp.log(pi_) - jnp.log1p(-pi_) + 0.5 * jnp.log(tau_b)
    act = active[:, None]
    on = (active > 0.0).astype(q_b.dtype)[:, None]

    def body(t, carry):
        logits_b, mu_b, eta_b, q_b = carry
        idx = t * tile

        q_t = lax.dynamic_slice(q_b, (0, idx), (S, tile))
        eta_t = lax.dynamic_slice(eta_b, (0, idx), (S, tile))
        n_t = lax.dynamic_slice(n_b, (idx,), (tile,))[None, :]
        beta_t = lax.dynamic_slice(beta_b, (idx,), (tile,))[None, :]
        mask_t = lax.dynamic_slice(mask_b, (idx,), (tile,))[None, :]
        logits_t = lax.dynamic_slice(logits_b, (0, idx), (S, tile))
        mu_t = lax.dynamic_slice(mu_b, (0, idx), (S, tile))

        var_tau_t = n_t * (1.0 + lam) / sig_e + tau_b
        mu_mult_t = n_t / (var_tau_t * sig_e)

        D_rows = lax.dynamic_slice(D_b, (idx, 0), (tile, D_b.shape[1]))
        # Keep the (T, T) diagonal tile in storage dtype (int8 when quantized):
        # each consumer below fuses its own dequantization, so the inner loop's
        # repeated reads stream 1-byte data instead of a materialized f32 copy
        # (the f32 (NB, T, T) tiles re-read inner_steps+1 times were the
        # dominant HBM traffic of the whole sweep at S=1).
        R_tt = lax.dynamic_slice(D_rows, (0, idx), (tile, tile))
        R_abs = jnp.abs(R_tt)
        R_abs_diag = jnp.diagonal(R_abs).astype(q_b.dtype)[None, :] \
            * jnp.asarray(scale, q_b.dtype)

        # Inner fixed-point iterations on the tile: each pass recomputes the
        # coordinate updates from a tile-locally refreshed q, converging toward
        # the tile's joint CAVI fixed point (exact tile-level block-coordinate
        # ascent in the limit). Iterations beyond the first touch only the
        # (T, T) R_tt — ~T/B of the main matmul's cost.
        g_cur = jax.nn.sigmoid(logits_t)
        mu_cur = mu_t
        eta_cur = eta_t
        q_cur = q_t
        for _ in range(inner_steps):
            mu_star = mu_mult_t * (beta_t - q_cur)
            u_star = base_logit - 0.5 * jnp.log(var_tau_t) \
                + 0.5 * var_tau_t * mu_star * mu_star
            g_star = jax.nn.sigmoid(u_star)
            if relax:
                # gamma-weighted within-tile row dominance -> per-coord step
                # (recomputed every pass: a weight frozen from the first pass
                # overshoots on stiff blocks, see DESIGN.md):
                coupling = _dequant_matmul(g_star * jnp.abs(mu_mult_t), R_abs,
                                           scale)
                coupling = coupling - R_abs_diag * g_star * jnp.abs(mu_mult_t)
                w = act / (1.0 + coupling)
            else:
                w = act
            g_cur = g_cur + w * (g_star - g_cur)
            mu_cur = mu_cur + w * (mu_star - mu_cur)
            eta_new = g_cur * mu_cur
            d_in = (eta_new - eta_cur) * mask_t * on
            # refresh the local q for the next inner pass (within-tile only;
            # discarded afterwards — the block-wide update uses d_t below):
            q_cur = q_cur + _dequant_matmul(d_in, R_tt, scale) - d_in
            eta_cur = eta_cur + d_in

        g_new, mu_new = g_cur, mu_cur
        d_t = (eta_cur - eta_t) * mask_t * on
        keep = jnp.abs(d_t) >= ETA_DIFF_EPS
        d_t = jnp.where(keep, d_t, 0.0)

        # carry logits for the damped gamma (stable logit of g_new):
        u_new = jnp.log(jnp.clip(g_new, 1e-30, None)) \
            - jnp.log1p(-jnp.clip(g_new, None, 1.0 - 1e-7))
        logits_b = lax.dynamic_update_slice(
            logits_b, jnp.where(keep, u_new, logits_t), (0, idx))
        mu_b = lax.dynamic_update_slice(
            mu_b, jnp.where(keep, mu_new, mu_t), (0, idx))
        eta_b = lax.dynamic_update_slice(eta_b, eta_t + d_t, (0, idx))

        # Rank-T q update over the whole block: q_b += d_t @ R[tile_rows, :].
        # (R symmetric: row-slice == column-slice transposed.)
        q_b = q_b + _dequant_matmul(d_t, D_rows, scale)
        # The stored diagonal R_jj = 1 also updated q at the focal variants;
        # q excludes the diagonal, so correct it (cf. e_step.hpp:423-428).
        q_tt = lax.dynamic_slice(q_b, (0, idx), (S, tile))
        q_b = lax.dynamic_update_slice(q_b, q_tt - d_t, (0, idx))

        return logits_b, mu_b, eta_b, q_b

    return lax.fori_loop(0, n_tiles, body, (logits_b, mu_b, eta_b, q_b))


@partial(jax.jit, static_argnames=('tile', 'relax', 'inner_steps'))
def cavi_sweep(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
               hyper: Hyper, active, damping=1.0, tile: int = 128,
               relax: bool = True, inner_steps: int = 8):
    """One full CAVI e-step sweep over all blocks and models.

    :param ld: BlockLD operator.
    :param state: CaviState with (S, NB, B) arrays.
    :param std_beta: (NB, B) standardized marginal betas (flat-packed).
    :param n_per_snp: (NB, B) per-variant GWAS sample sizes.
    :param hyper: per-model hyperparameters, (S,) float32 each.
    :param active: (S,) float32 — 1.0 for models still being optimized
        (the vmapped analog of ``active_model_idx``, e_step.hpp:606-634);
        fractional values act as global damping on top of ``relax``.
    :param damping: scalar or (S,) extra step damping (the deterministic analog
        of the reference's oscillation-triggered thread backoff).
    :param relax: enable gamma-weighted per-coordinate under-relaxation within
        tiles (see _block_tile_loop); disable only for schedule-parity tests.
    :returns: (new_state, eta_diff) where eta_diff = eta_new - eta_old.

    The sweep computes in the dtype of ``state``: float32 in every fit; a
    float64 state gives the float64 sweep that kernels are measured against.
    """
    B = ld.block_size
    assert B % tile == 0
    n_tiles = B // tile
    eta0 = state.eta

    dt = state.eta.dtype
    active = active.astype(dt) * (jnp.ones_like(active, dt) * damping)

    def per_block(D_b, beta_b, n_b, mask_b, logits_b, mu_b, eta_b, q_b):
        return _block_tile_loop(D_b, beta_b, n_b, mask_b,
                                logits_b, mu_b, eta_b, q_b,
                                hyper, active, ld.scale, tile, n_tiles, relax,
                                inner_steps)

    logits, mu, eta, q = jax.vmap(
        per_block,
        in_axes=(0, 0, 0, 0, 1, 1, 1, 1),
        out_axes=(1, 1, 1, 1),
    )(ld.diag, std_beta, n_per_snp, ld.mask, state.logits, state.mu, state.eta, state.q)

    eta_diff = eta - eta0
    q = refresh_q(ld, q, eta_diff)

    return CaviState(logits=logits, mu=mu, eta=eta, q=q), eta_diff
