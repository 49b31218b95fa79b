"""Fused CAVI sweep — one Pallas (Triton) program per LD block and model lane.

The same update schedule as ``cavi_jax.cavi_sweep`` (Gauss-Seidel over the
tiles of a block, ``inner_steps`` Jacobi refinement passes within a tile,
under-relaxation, the 1e-8 keep threshold), but where XLA lowers the vmapped
tile loop as many small kernels per tile, here the whole block runs inside
one program:

- the grid is (NB, S): one program per LD block and model lane; programs run
  in any order (blocks are independent within a sweep, lanes always). The
  lanes of one block are adjacent in the grid, so they share its LD through
  the L2 cache;
- the tile loop and its inner passes run inside the program, so the (T, T)
  diagonal tile stays on chip for all of its passes;
- the tile's rank-T update of the block's residual streams the other (T, T)
  tiles of its column slab, each read once, so the block's LD is read once
  per sweep;
- the block's residual q stays on chip for the whole program and is written
  once at the end;
- every product is a float32 multiply-and-reduce along the tile's minor
  axis. R is symmetric, so ``d @ R[t, c] == R[c, t] @ d``: the kernel reads
  the (c, t) tile and reduces along its rows.

The cross-block coupling refresh (``refresh_q``) stays outside the kernel.
No Pallas call may see GSPMD-sharded state: the dispatch policy
(model/_dispatch.py) sends meshed fits to the XLA tile loop.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .block_ld import BlockLD
from .cavi_jax import CaviState, ETA_DIFF_EPS, Hyper, refresh_q

F32 = jnp.float32

#: Warps per program: 8 beat 4 at S=1 and S=100 on an H100 (PERF.md).
NUM_WARPS = 8


def shape_supported(block_size: int, tile: int) -> bool:
    """True iff the kernel compiles for this block size and tile width.

    Triton lowers only arrays whose every dimension is a power of two, and
    the kernel holds (n_tiles, T), (T, T) and (B, B) arrays: T and
    n_tiles = B / T must both be powers of two (so B=384 or 1536 is not).
    """
    def pow2(n):
        return n > 0 and (n & (n - 1)) == 0
    return block_size % tile == 0 and pow2(tile) and pow2(block_size // tile)


def _sigmoid(u):
    return 1.0 / (1.0 + jnp.exp(-u))


def _sweep_kernel(D_ref, beta_ref, n_ref, mask_ref, logits_ref, mu_ref,
                  eta_ref, q_ref, sig_ref, tau_ref, lam_ref, base_ref, act_ref,
                  logits_o, mu_o, eta_o, q_o, *, tile, n_tiles, scale, relax,
                  inner_steps):
    """One LD block, one lane. Per-variant refs are (n_tiles, T); D_ref is
    the (B, B) block; the hyperparameter refs hold this lane's value."""
    T = tile
    sig_e, tau_b, lam = sig_ref[...], tau_ref[...], lam_ref[...]   # (1,)
    base_logit, act = base_ref[...], act_ref[...]
    on = (act > 0.0).astype(F32)
    sc = F32(scale)
    row = lax.broadcasted_iota(jnp.int32, (n_tiles, T), 0)
    ii = lax.broadcasted_iota(jnp.int32, (T, T), 0)
    jj = lax.broadcasted_iota(jnp.int32, (T, T), 1)

    def matvec(R, v):
        """R @ v for a (T, T) tile in storage dtype and a (T,) vector."""
        out = jnp.sum(R.astype(F32) * v[None, :], axis=1)
        return out * sc if scale != 1.0 else out

    def tile_at(r, c):
        return D_ref[pl.ds(r * T, T), pl.ds(c * T, T)]

    def tile_body(t, q):
        n_t, beta_t, mask_t = n_ref[t, :], beta_ref[t, :], mask_ref[t, :]
        logits_t, mu_t, eta_t = logits_ref[t, :], mu_ref[t, :], eta_ref[t, :]
        q_t = jnp.sum(jnp.where(row == t, q, 0.0), axis=0)

        var_tau_t = n_t * (1.0 + lam) / sig_e + tau_b
        mu_mult_t = n_t / (var_tau_t * sig_e)
        half_log_vt = 0.5 * jnp.log(var_tau_t)
        abs_mm = jnp.abs(mu_mult_t)

        R_tt = tile_at(t, t)
        R_abs = jnp.abs(R_tt)
        R_abs_diag = jnp.sum(jnp.where(ii == jj, R_abs.astype(F32), 0.0),
                             axis=1) * sc

        def inner(_, carry):
            g_cur, mu_cur, eta_cur, q_cur = carry
            mu_star = mu_mult_t * (beta_t - q_cur)
            u_star = base_logit - half_log_vt \
                + 0.5 * var_tau_t * mu_star * mu_star
            g_star = _sigmoid(u_star)
            if relax:
                gm = g_star * abs_mm
                w = act / (1.0 + matvec(R_abs, gm) - R_abs_diag * gm)
            else:
                w = act
            g_cur = g_cur + w * (g_star - g_cur)
            mu_cur = mu_cur + w * (mu_star - mu_cur)
            d_in = (g_cur * mu_cur - eta_cur) * mask_t * on
            q_cur = q_cur + matvec(R_tt, d_in) - d_in
            return g_cur, mu_cur, eta_cur + d_in, q_cur

        g_new, mu_new, eta_cur, _ = lax.fori_loop(
            0, inner_steps, inner, (_sigmoid(logits_t), mu_t, eta_t, q_t))

        d_t = (eta_cur - eta_t) * mask_t * on
        keep = jnp.abs(d_t) >= ETA_DIFF_EPS
        d_t = jnp.where(keep, d_t, 0.0)
        u_new = jnp.log(jnp.maximum(g_new, 1e-30)) \
            - jnp.log1p(-jnp.minimum(g_new, 1.0 - 1e-7))
        logits_o[t, :] = jnp.where(keep, u_new, logits_t)
        mu_o[t, :] = jnp.where(keep, mu_new, mu_t)
        eta_o[t, :] = eta_t + d_t

        # rank-T update of the whole block's residual (q excludes the unit
        # diagonal); the diagonal tile is still on chip, the others stream:
        q = q + jnp.where(row == t, (matvec(R_tt, d_t) - d_t)[None, :], 0.0)

        def chunk(c, q):
            return q + jnp.where(row == c,
                                 matvec(tile_at(c, t), d_t)[None, :], 0.0)

        q = lax.fori_loop(0, t, chunk, q)
        return lax.fori_loop(t + 1, n_tiles, chunk, q)

    q_o[...] = lax.fori_loop(0, n_tiles, tile_body, q_ref[...])


@partial(jax.jit, static_argnames=('tile', 'relax', 'inner_steps',
                                   'interpret'))
def cavi_sweep_fused(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                     hyper: Hyper, active, damping=1.0, tile: int = 128,
                     relax: bool = True, inner_steps: int = 8,
                     interpret: bool = False):
    """One full CAVI e-step sweep; the arguments and results of
    ``cavi_jax.cavi_sweep``. ``interpret=True`` runs the kernel in the Pallas
    interpreter (any backend)."""
    S, NB, B = state.eta.shape
    if not shape_supported(B, tile):
        raise ValueError(f"the fused sweep needs a power-of-two tile and "
                         f"tile count; got block size {B}, tile {tile}")
    n_tiles = B // tile
    active = active.astype(F32) * (jnp.ones_like(active, F32) * damping)
    h = Hyper(*(x.astype(F32) for x in hyper))
    base_logit = jnp.log(h.pi) - jnp.log1p(-h.pi) + 0.5 * jnp.log(h.tau_beta)

    def tiled(x):     # (..., B) -> (..., n_tiles, T): free in XLA
        return x.reshape(x.shape[:-1] + (n_tiles, tile))

    blk = pl.BlockSpec((None, n_tiles, tile), lambda b, s: (b, 0, 0))
    lane = pl.BlockSpec((None, None, n_tiles, tile),
                        lambda b, s: (s, b, 0, 0))
    scalar = pl.BlockSpec((1,), lambda b, s: (s,))
    kernel = partial(_sweep_kernel, tile=tile, n_tiles=n_tiles,
                     scale=float(ld.scale), relax=relax,
                     inner_steps=inner_steps)
    logits, mu, eta, q = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((S, NB, n_tiles, tile), F32)] * 4,
        grid=(NB, S),
        in_specs=[pl.BlockSpec((None, B, B), lambda b, s: (b, 0, 0)),
                  blk, blk, blk, lane, lane, lane, lane,
                  scalar, scalar, scalar, scalar, scalar],
        out_specs=[lane] * 4,
        backend='triton',
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name='cavi_sweep_fused',
    )(ld.diag, tiled(std_beta.astype(F32)), tiled(n_per_snp.astype(F32)),
      tiled(ld.mask), *(tiled(x) for x in state),
      h.sigma_eps, h.tau_beta, h.lambda_min, base_logit, active)

    logits, mu, eta, q = (x.reshape(S, NB, B) for x in (logits, mu, eta, q))
    eta_diff = eta - state.eta
    q = refresh_q(ld, q, eta_diff)
    return CaviState(logits=logits, mu=mu, eta=eta, q=q), eta_diff
