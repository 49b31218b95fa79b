"""Unit and parity tests for the core blocked-CAVI ops."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from viprs_tpu.ops import block_ld as bld
from viprs_tpu.ops.block_ld import pack_dense_blocks, pack_banded, blockld_to_dense
from viprs_tpu.ops.cavi_jax import CaviState, Hyper, cavi_sweep, compute_q
from viprs_tpu.ops import updates, em_loop
from viprs_tpu.utils import optimize as opt
from viprs_tpu.data.simulate import simulate_sumstats_blocks

import reference_impl as ref

RNG = np.random.default_rng(42)


def _rand_ld_block(m, rng=RNG):
    X = rng.standard_normal((4 * m, m))
    X = (X - X.mean(0)) / X.std(0)
    return (X.T @ X) / X.shape[0]


def _logit(p):
    return np.log(p) - np.log1p(-p)


def make_state(pi0, nb, B, S=1):
    logits = jnp.full((S, nb, B), _logit(pi0), dtype=jnp.float32)
    zeros = jnp.zeros((S, nb, B), dtype=jnp.float32)
    return CaviState(logits=logits, mu=zeros, eta=zeros, q=zeros)


def make_hyper(sigma_eps, tau_beta, pi, lam=0.0, S=1):
    f = lambda v: jnp.full((S,), v, dtype=jnp.float32)
    return Hyper(sigma_eps=f(sigma_eps), tau_beta=f(tau_beta), pi=f(pi),
                 lambda_min=f(lam))


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

class TestPacking:

    def test_dense_roundtrip_single_band(self):
        blocks = [_rand_ld_block(100), _rand_ld_block(130)]
        ld, layout = pack_dense_blocks({1: blocks}, block_size=128)
        assert ld.n_off >= 1  # the 130-variant block spans two tiles
        R = blockld_to_dense(ld)
        # locate each block via the layout's flat index mapping:
        idx = layout.flat_index
        i0, i1 = idx[:100], idx[100:230]
        np.testing.assert_allclose(R[np.ix_(i0, i0)], blocks[0], atol=1e-6)
        np.testing.assert_allclose(R[np.ix_(i1, i1)], blocks[1], atol=1e-6)
        # cross-LD-block entries are zero:
        assert np.all(R[np.ix_(i0, i1)] == 0)

    def test_layout_scatter_gather(self):
        blocks = [_rand_ld_block(60), _rand_ld_block(70)]
        _, layout = pack_dense_blocks({1: blocks, 2: [_rand_ld_block(50)]},
                                      block_size=128)
        x = {1: np.arange(130, dtype=np.float32), 2: np.arange(50, dtype=np.float32)}
        flat = layout.to_flat(x)
        back = layout.from_flat(flat)
        np.testing.assert_array_equal(back[1], x[1])
        np.testing.assert_array_equal(back[2], x[2])
        assert layout.m == 180

    def test_quantized_pack(self):
        blocks = [_rand_ld_block(90)]
        ld, _ = pack_dense_blocks({1: blocks}, block_size=128, quantize=True)
        assert ld.diag.dtype == jnp.int8
        R = blockld_to_dense(ld)
        np.testing.assert_allclose(R[:90, :90], blocks[0], atol=1.0 / 127)

    def test_banded_roundtrip(self):
        # build a banded matrix with bandwidth 40, stored as symmetric rows
        m, w = 200, 40
        X = RNG.standard_normal((800, m))
        X = (X - X.mean(0)) / X.std(0)
        R_full = X.T @ X / 800
        R_band = np.zeros_like(R_full)
        for j in range(m):
            lo, hi = max(0, j - w), min(m, j + w + 1)
            R_band[j, lo:hi] = R_full[j, lo:hi]
        # extract banded CSR-like arrays (symmetric rows)
        data, indptr, left = [], [0], []
        for j in range(m):
            lo, hi = max(0, j - w), min(m, j + w + 1)
            data.extend(R_band[j, lo:hi])
            indptr.append(len(data))
            left.append(lo)
        ld, layout = pack_banded({1: (np.array(data), np.array(indptr), np.array(left))},
                                 block_size=128)
        assert ld.n_off >= 1  # the 130-variant block spans two tiles
        R = blockld_to_dense(ld)
        np.testing.assert_allclose(R[:m, :m], R_band, atol=1e-6)


# ---------------------------------------------------------------------------
# q computation
# ---------------------------------------------------------------------------

class TestComputeQ:

    @pytest.mark.parametrize("sizes", [[(100,)], [(100, 200, 90)]])
    def test_matches_dense(self, sizes):
        blocks = [_rand_ld_block(m) for m in sizes[0]]
        ld, layout = pack_dense_blocks({1: blocks}, block_size=128)
        R = blockld_to_dense(ld)
        Mp = layout.m_padded
        eta = RNG.standard_normal(Mp).astype(np.float32) * np.asarray(ld.mask).ravel()
        q = compute_q(ld, jnp.asarray(eta).reshape(1, ld.nb, ld.block_size))
        expected = (R - np.eye(Mp)) @ eta
        np.testing.assert_allclose(np.asarray(q).ravel(), expected, atol=1e-4)

    @pytest.mark.parametrize("quantize", [False, True])
    def test_scanned_matches_dense_path(self, quantize):
        """The block-scanned variant (capacity-scale tiles, one (B, B) f32
        temp at a time) computes the same q as the dense einsum."""
        blocks = [_rand_ld_block(m) for m in (100, 200, 90)]
        ld, layout = pack_dense_blocks({1: blocks}, block_size=128,
                                       quantize=quantize)
        S = 3
        eta = (RNG.standard_normal((S, layout.nb, 128)).astype(np.float32)
               * np.asarray(ld.mask)[None])
        q_dense = compute_q(ld, jnp.asarray(eta), chunked=False)
        q_scan = compute_q(ld, jnp.asarray(eta), chunked=True)
        np.testing.assert_allclose(np.asarray(q_scan), np.asarray(q_dense),
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Sweep parity vs NumPy tile schedule
# ---------------------------------------------------------------------------

def _problem(m=200, seed=1):
    rng = np.random.default_rng(seed)
    R = _rand_ld_block(m, rng)
    beta_true = np.zeros(m)
    idx = rng.choice(m, 5, replace=False)
    beta_true[idx] = rng.standard_normal(5) * 0.05
    n = 5000
    std_beta = R @ beta_true + rng.standard_normal(m) / np.sqrt(n)
    n_per_snp = np.full(m, float(n))
    return R, std_beta, n_per_snp


class TestSweepParity:

    def test_single_sweep_matches_numpy_tile_schedule(self):
        m = 200
        R, std_beta, n_per_snp = _problem(m)
        pi0, sig_e, tau_b = 0.05, 0.9, 1000.0
        tile = 64
        B = 256

        # numpy tile schedule on the padded problem (pad R with zeros):
        Rp = np.zeros((B, B)); Rp[:m, :m] = R
        sb = np.zeros(B); sb[:m] = std_beta
        npn = np.zeros(B); npn[:m] = n_per_snp
        gamma = np.full(B, pi0); mu = np.zeros(B); eta = np.zeros(B); q = np.zeros(B)
        # padded lanes have n=0 -> mu=0 -> d=0; mirror kernel masking by zeroing
        ref.tile_e_step(Rp, sb, npn, gamma, mu, eta, q, sig_e, tau_b, pi0, tile=tile)

        ld, layout = pack_dense_blocks({1: [R]}, block_size=B)
        state = make_state(pi0, ld.nb, B)
        hyper = make_hyper(sig_e, tau_b, pi0)
        # relax=False, inner_steps=1: compare the raw tile schedule against
        # the numpy mirror
        new_state, eta_diff = cavi_sweep(
            ld, state,
            jnp.asarray(sb.reshape(1, B), dtype=jnp.float32),
            jnp.asarray(npn.reshape(1, B), dtype=jnp.float32),
            hyper, jnp.ones(1), tile=tile, relax=False, inner_steps=1)

        got_eta = np.asarray(new_state.eta).ravel()[:m]
        got_q = np.asarray(new_state.q).ravel()[:m]
        got_gamma = np.asarray(new_state.gamma).ravel()[:m]
        np.testing.assert_allclose(got_eta, eta[:m], atol=2e-5)
        np.testing.assert_allclose(got_gamma, gamma[:m], atol=2e-4)
        np.testing.assert_allclose(got_q, q[:m], atol=2e-4)

    def test_multiblock_independent(self):
        """With block-diagonal LD, multi-block processing equals per-block runs."""
        ms = [150, 100]
        Rs, sbs, ns = [], [], []
        for i, m in enumerate(ms):
            R, sb, n = _problem(m, seed=10 + i)
            Rs.append(R); sbs.append(sb); ns.append(n)
        pi0, sig_e, tau_b = 0.05, 0.9, 1000.0
        B = 256

        # greedy=False: tile boundaries must line up with the separate runs
        # for exact comparison
        ld, layout = pack_dense_blocks({1: Rs}, block_size=B, greedy=False)
        sb_flat = layout.to_flat({1: np.concatenate(sbs)})
        n_flat = layout.to_flat({1: np.concatenate(ns)})
        state = make_state(pi0, ld.nb, B)
        new_state, _ = cavi_sweep(
            ld, state,
            jnp.asarray(sb_flat.reshape(ld.nb, B)),
            jnp.asarray(n_flat.reshape(ld.nb, B)),
            make_hyper(sig_e, tau_b, pi0), jnp.ones(1), tile=64)
        eta_joint = layout.from_flat(np.asarray(new_state.eta).reshape(-1))[1]

        # per-block separate runs:
        etas = []
        for R, sb, n in zip(Rs, sbs, ns):
            ldi, layi = pack_dense_blocks({1: [R]}, block_size=B)
            st = make_state(pi0, ldi.nb, B)
            ns_, _ = cavi_sweep(
                ldi, st,
                jnp.asarray(layi.to_flat({1: sb}).reshape(ldi.nb, B)),
                jnp.asarray(layi.to_flat({1: n}).reshape(ldi.nb, B)),
                make_hyper(sig_e, tau_b, pi0), jnp.ones(1), tile=64)
            etas.append(layi.from_flat(np.asarray(ns_.eta).reshape(-1))[1])
        np.testing.assert_allclose(eta_joint, np.concatenate(etas), atol=1e-6)

    def test_grid_axis_matches_separate_models(self):
        """S>1 with different hyperparameters == separate S=1 sweeps."""
        R, sb, n = _problem(180, seed=3)
        B = 256
        ld, layout = pack_dense_blocks({1: [R]}, block_size=B)
        sbf = jnp.asarray(layout.to_flat({1: sb}).reshape(ld.nb, B))
        nf = jnp.asarray(layout.to_flat({1: n}).reshape(ld.nb, B))

        pis = [0.01, 0.1]
        hyper = Hyper(sigma_eps=jnp.asarray([0.9, 0.8], jnp.float32),
                      tau_beta=jnp.asarray([500.0, 2000.0], jnp.float32),
                      pi=jnp.asarray(pis, jnp.float32),
                      lambda_min=jnp.zeros(2, jnp.float32))
        logits = jnp.stack([jnp.full((ld.nb, B), _logit(p), jnp.float32) for p in pis])
        zeros = jnp.zeros((2, ld.nb, B), jnp.float32)
        state = CaviState(logits=logits, mu=zeros, eta=zeros, q=zeros)
        joint, _ = cavi_sweep(ld, state, sbf, nf, hyper, jnp.ones(2), tile=64)

        for s in range(2):
            h1 = Hyper(*(x[s:s + 1] for x in hyper))
            st1 = CaviState(*(x[s:s + 1] for x in state))
            sep, _ = cavi_sweep(ld, st1, sbf, nf, h1, jnp.ones(1), tile=64)
            # f32 matmul accumulation order differs between batch shapes:
            np.testing.assert_allclose(np.asarray(joint.eta[s]),
                                       np.asarray(sep.eta[0]), atol=1e-5)

    def test_int8_close_to_f32(self):
        R, sb, n = _problem(128, seed=7)
        B = 128
        ld_f, lay = pack_dense_blocks({1: [R]}, block_size=B)
        ld_q, _ = pack_dense_blocks({1: [R]}, block_size=B, quantize=True)
        sbf = jnp.asarray(lay.to_flat({1: sb}).reshape(ld_f.nb, B))
        nf = jnp.asarray(lay.to_flat({1: n}).reshape(ld_f.nb, B))
        st = make_state(0.05, ld_f.nb, B)
        h = make_hyper(0.9, 1000.0, 0.05)
        out_f, _ = cavi_sweep(ld_f, st, sbf, nf, h, jnp.ones(1), tile=64)
        out_q, _ = cavi_sweep(ld_q, st, sbf, nf, h, jnp.ones(1), tile=64)
        np.testing.assert_allclose(np.asarray(out_q.eta), np.asarray(out_f.eta),
                                   atol=5e-4)


# ---------------------------------------------------------------------------
# Full EM parity vs the sequential float64 reference
# ---------------------------------------------------------------------------

class TestEMFit:

    def _run_em(self, ld, layout, sb_flat, n_flat, pi0, sig_e0, tau_b0,
                S=1, max_iter=200, fix=(False, False, False)):
        nb, B = ld.nb, ld.block_size
        state = make_state(pi0, nb, B, S)
        hyper = make_hyper(sig_e0, tau_b0, pi0, S=S)
        fixm = updates.FixMask(
            sigma_eps=jnp.full(S, fix[0]), tau_beta=jnp.full(S, fix[1]),
            pi=jnp.full(S, fix[2]))
        res = em_loop.em_fit(
            ld, state, jnp.asarray(sb_flat.reshape(nb, B), jnp.float32),
            jnp.asarray(n_flat.reshape(nb, B), jnp.float32),
            hyper, fixm,
            n_sample=float(n_flat.max()), m_total=float(layout.m),
            init_elbo=jnp.zeros(S, jnp.float64),
            active0=jnp.ones(S, bool),
            max_iter=max_iter, f_abs_tol=1e-8)
        return res

    def test_matches_sequential_reference(self):
        sim = simulate_sumstats_blocks(n=3000, block_sizes=(200, 150), h2=0.4,
                                       prop_causal=0.05, seed=11)
        R = np.zeros((sim['m'], sim['m']))
        r0 = 0
        for blk in sim['ld_blocks'][22]:
            m_i = blk.shape[0]
            R[r0:r0 + m_i, r0:r0 + m_i] = blk
            r0 += m_i
        sb = sim['std_beta'][22]
        npn = sim['n_per_snp'][22]
        pi0, sig_e0, tau_b0 = 0.05, 0.7, float(0.05 * sim['m'] / 0.3)

        ref_fit = ref.fit(R, sb, npn, pi0, sig_e0, tau_b0,
                          max_iter=300, f_abs_tol=1e-8)

        ld, layout = pack_dense_blocks({22: sim['ld_blocks'][22]}, block_size=256)
        res = self._run_em(ld, layout,
                           layout.to_flat({22: sb}), layout.to_flat({22: npn}),
                           pi0, sig_e0, tau_b0, max_iter=300)

        assert opt.status_is_success(int(res.status[0])), \
            opt.STATUS_MESSAGES[int(res.status[0])]

        eta = layout.from_flat(np.asarray(res.state.eta[0]).reshape(-1))[22]
        gamma = layout.from_flat(np.asarray(res.state.gamma[0]).reshape(-1))[22]

        # Fixed-point parity within float32-state tolerance:
        np.testing.assert_allclose(eta, ref_fit['eta'], atol=5e-4)
        np.testing.assert_allclose(gamma, ref_fit['gamma'], atol=5e-3)
        np.testing.assert_allclose(float(res.hyper.sigma_eps[0]),
                                   ref_fit['sigma_eps'], rtol=1e-3)
        np.testing.assert_allclose(float(res.hyper.pi[0]), ref_fit['pi'], rtol=0.05)
        np.testing.assert_allclose(float(res.final_elbo[0]), ref_fit['elbo'],
                                   rtol=1e-5)

    def test_h2_recovery(self):
        sim = simulate_sumstats_blocks(n=4000, block_sizes=(256, 256), h2=0.5,
                                       prop_causal=0.02, seed=5)
        ld, layout = pack_dense_blocks({22: sim['ld_blocks'][22]}, block_size=256)
        res = self._run_em(ld, layout,
                           layout.to_flat(sim['std_beta']),
                           layout.to_flat(sim['n_per_snp']),
                           0.05, 0.5, float(0.02 * sim['m'] / 0.5))
        sigma_g = float(res.sigma_g[0])
        sig_e = float(res.hyper.sigma_eps[0])
        h2 = sigma_g / (sigma_g + sig_e)
        assert 0.2 < h2 < 0.8  # recovered heritability in a sane range

    def test_grid_em_matches_individual(self):
        sim = simulate_sumstats_blocks(n=2000, block_sizes=(200,), h2=0.3, seed=9)
        ld, layout = pack_dense_blocks({22: sim['ld_blocks'][22]}, block_size=256)
        sbf = layout.to_flat(sim['std_beta'])
        nf = layout.to_flat(sim['n_per_snp'])
        nb, B = ld.nb, ld.block_size

        pis = np.array([0.01, 0.05, 0.2])
        S = len(pis)
        logits = jnp.stack([jnp.full((nb, B), _logit(p), jnp.float32) for p in pis])
        zeros = jnp.zeros((S, nb, B), jnp.float32)
        state = CaviState(logits=logits, mu=zeros, eta=zeros, q=zeros)
        hyper = Hyper(sigma_eps=jnp.full(S, 0.7, jnp.float32),
                      tau_beta=jnp.asarray(pis * layout.m / 0.3, jnp.float32),
                      pi=jnp.asarray(pis, jnp.float32),
                      lambda_min=jnp.zeros(S, jnp.float32))
        fixm = updates.FixMask(sigma_eps=jnp.zeros(S, bool),
                               tau_beta=jnp.zeros(S, bool),
                               pi=jnp.ones(S, bool))  # pi fixed per grid row
        # Fixed iteration count (tolerances never trigger) so that the joint and
        # separate runs follow identical-length trajectories:
        kw = dict(n_sample=2000.0, m_total=float(layout.m),
                  max_iter=40, f_abs_tol=0.0, x_abs_tol=0.0)
        res = em_loop.em_fit(ld, state,
                             jnp.asarray(sbf.reshape(nb, B), jnp.float32),
                             jnp.asarray(nf.reshape(nb, B), jnp.float32),
                             hyper, fixm,
                             init_elbo=jnp.zeros(S, jnp.float64),
                             active0=jnp.ones(S, bool), **kw)

        for s in range(S):
            st1 = CaviState(*(x[s:s + 1] for x in state))
            h1 = Hyper(*(x[s:s + 1] for x in hyper))
            f1 = updates.FixMask(*(x[s:s + 1] for x in fixm))
            r1 = em_loop.em_fit(ld, st1,
                                jnp.asarray(sbf.reshape(nb, B), jnp.float32),
                                jnp.asarray(nf.reshape(nb, B), jnp.float32),
                                h1, f1,
                                init_elbo=jnp.zeros(1, jnp.float64),
                                active0=jnp.ones(1, bool), **kw)
            # CAVI amplifies f32 batch-shape noise through steep sigmoids, so
            # trajectories are not bit-identical; fixed points agree to ~1e-4
            # relative (same order as the reference's own thread-count
            # nondeterminism):
            np.testing.assert_allclose(float(res.final_elbo[s]),
                                       float(r1.final_elbo[0]), rtol=5e-4)
            np.testing.assert_allclose(np.asarray(res.state.eta[s]),
                                       np.asarray(r1.state.eta[0]), atol=5e-3)



@pytest.mark.parametrize('relax', [True, False])
def test_sweep_computes_in_state_dtype(relax):
    """A float64 state gives a float64 sweep (the reference that kernels are
    measured against); it agrees with the float32 sweep to float32 noise."""
    m = 200
    R, std_beta, n_per_snp = _problem(m, seed=3)
    ld, layout = pack_dense_blocks({1: [R]}, block_size=256, quantize=True)
    nb, B = ld.nb, ld.block_size
    sb = layout.to_flat({1: std_beta}).reshape(nb, B)
    nf = layout.to_flat({1: n_per_snp}).reshape(nb, B)
    st32 = make_state(0.05, nb, B)
    hy32 = make_hyper(0.9, 1000.0, 0.05)
    f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    a, da = cavi_sweep(ld, st32, jnp.asarray(sb, jnp.float32),
                       jnp.asarray(nf, jnp.float32), hy32, jnp.ones(1),
                       tile=64, relax=relax)
    b, db = cavi_sweep(ld, CaviState(*map(f64, st32)), f64(sb), f64(nf),
                       Hyper(*map(f64, hy32)), f64(jnp.ones(1)), tile=64,
                       relax=relax)
    assert a.eta.dtype == jnp.float32 and b.eta.dtype == jnp.float64
    assert db.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(a.eta), np.asarray(b.eta),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.q), np.asarray(b.q), atol=1e-6)
