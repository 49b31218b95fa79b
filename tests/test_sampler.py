"""Posterior-check sampler tests: Gibbs vs VI agreement, SMC, HMC."""

import numpy as np
import pandas as pd
import pytest

from viprs_tpu.data.dataset import SummaryStatsDataset
from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.model import VIPRS
from viprs_tpu.model.sampler import GibbsSampler, smc_over_grid, hmc_refine


@pytest.fixture(scope='module')
def dataset():
    sim = simulate_sumstats_blocks(n=4000, block_sizes=(150, 120), h2=0.4,
                                   prop_causal=0.03, seed=33)
    return SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128)


class TestGibbs:

    def test_gibbs_matches_vi_posterior_mean(self, dataset):
        """VI and MCMC should agree on the posterior mean within MC error
        (the BASELINE parity criterion)."""
        np.random.seed(0)
        vi = VIPRS(dataset, fix_params={'pi': 0.05, 'sigma_epsilon': 0.7,
                                        'tau_beta': 500.0})
        vi.fit(max_iter=300)

        gibbs = GibbsSampler(dataset, pi=0.05, tau_beta=500.0, sigma_eps=0.7,
                             n_chains=4, seed=1)
        out = gibbs.run(n_iter=400, burn_in=150)

        eta_vi = np.concatenate([vi.post_mean_beta[c] for c in vi.chromosomes])
        eta_mc = np.concatenate([out['post_mean_beta'][c]
                                 for c in vi.chromosomes])
        r = np.corrcoef(eta_vi, eta_mc)[0, 1]
        assert r > 0.95, f"VI/MCMC posterior-mean correlation too low: {r}"

        pip_vi = np.concatenate([vi.pip[c] for c in vi.chromosomes])
        pip_mc = np.concatenate([out['pip'][c] for c in vi.chromosomes])
        # PIPs agree for confidently-included variants:
        strong = pip_vi > 0.9
        if strong.any():
            assert np.all(pip_mc[strong] > 0.5)


class TestSMC:

    def test_smc_weights_favor_reasonable_hyper(self, dataset):
        grid = pd.DataFrame({'pi': [0.001, 0.03, 0.3],
                             'sigma_epsilon': [0.7, 0.7, 0.7],
                             'tau_beta': [500.0, 500.0, 500.0]})
        out = smc_over_grid(dataset, grid, n_stages=4, sweeps_per_stage=3,
                            seed=2)
        assert out['weights'].shape == (3,)
        np.testing.assert_allclose(out['weights'].sum(), 1.0, atol=1e-8)
        assert np.isfinite(out['weights']).all()
        assert 'post_mean_beta' in out['posterior']


class TestHMC:

    def test_hmc_gaussian_refinement(self, dataset):
        # include the top-|std_beta| variants:
        mask = {c: (np.abs(dataset.std_beta[c])
                    > np.quantile(np.abs(dataset.std_beta[c]), 0.9)).astype(float)
                for c in dataset.chromosomes}
        out = hmc_refine(dataset, mask, tau_beta=500.0, sigma_eps=0.7,
                         n_samples=60, seed=3)
        assert 0.2 < out['accept_rate'] <= 1.0
        eta = np.concatenate([out['post_mean_beta'][c]
                              for c in dataset.chromosomes])
        m = np.concatenate([mask[c] for c in dataset.chromosomes])
        assert np.all(eta[m == 0] == 0)
        # included coordinates move toward the marginal signal:
        sb = np.concatenate([dataset.std_beta[c] for c in dataset.chromosomes])
        r = np.corrcoef(eta[m == 1], sb[m == 1])[0, 1]
        assert r > 0.5


class TestMixtureParity:

    def test_mixture_matches_sequential_reference(self, dataset):
        """VIPRSMix fixed point vs strict sequential float64 mixture CAVI."""
        import sys, os
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import reference_impl as ref
        from viprs_tpu.model import VIPRSMix

        # dense R for the reference run:
        sim_blocks = []
        lay = dataset.layout
        R = np.zeros((dataset.m, dataset.m))
        off = 0
        from viprs_tpu.ops.block_ld import blockld_to_dense
        Rd = blockld_to_dense(dataset.ld)
        idx = lay.flat_index
        R = Rd[np.ix_(idx, idx)]
        sb = np.concatenate([dataset.std_beta[c] for c in dataset.chromosomes])
        nn = np.concatenate([dataset.n_per_snp[c] for c in dataset.chromosomes])

        K = 2
        d = np.array([0.5, 1.0])
        pis = np.array([0.02, 0.02])
        taus = d * 800.0

        ref_fit = ref.fit_mixture(R, sb, nn, pis, 0.7, taus, d,
                                  max_iter=150, fix_sigma_eps=0.7)

        np.random.seed(0)
        m = VIPRSMix(dataset, K=K, prior_multipliers=d,
                     fix_params={'sigma_epsilon': 0.7})
        m.fit(max_iter=300,
              theta_0={'pis': pis, 'tau_betas': taus, 'sigma_epsilon': 0.7})

        eta_vi = np.concatenate([m.post_mean_beta[c] for c in m.chromosomes])
        r = np.corrcoef(eta_vi, ref_fit['eta'])[0, 1]
        assert r > 0.99, f"mixture fixed-point correlation too low: {r}"
        # per-component mass is weakly identified (overlapping slabs); the
        # total proportion of causal variants is the comparable quantity:
        np.testing.assert_allclose(m.pi.sum(), ref_fit['pi'].sum(), rtol=0.1)
