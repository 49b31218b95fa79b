"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.ops.block_ld import pack_dense_blocks
from viprs_tpu.ops.cavi_jax import CaviState, Hyper
from viprs_tpu.ops import em_loop, updates
from viprs_tpu.parallel.mesh import make_mesh, shard_problem, pad_blocks


def _logit(p):
    return float(np.log(p) - np.log1p(-p))


def _problem(S=4, seed=0):
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(100, 90, 110, 80),
                                   h2=0.3, prop_causal=0.05, seed=seed)
    ld, lay = pack_dense_blocks(sim['ld_blocks'], block_size=128)
    sb = jnp.asarray(lay.to_flat(sim['std_beta']).reshape(lay.nb, 128),
                     jnp.float32)
    nf = jnp.asarray(lay.to_flat(sim['n_per_snp']).reshape(lay.nb, 128),
                     jnp.float32)
    pis = np.geomspace(0.01, 0.2, S)
    logits = jnp.stack([jnp.full((lay.nb, 128), np.float32(_logit(p)))
                        for p in pis])
    zeros = jnp.zeros((S, lay.nb, 128), jnp.float32)
    state = CaviState(logits=logits, mu=zeros, eta=zeros, q=zeros)
    hyper = Hyper(sigma_eps=jnp.full(S, 0.7, jnp.float32),
                  tau_beta=jnp.asarray(pis * lay.m / 0.3, jnp.float32),
                  pi=jnp.asarray(pis, jnp.float32),
                  lambda_min=jnp.zeros(S, jnp.float32))
    return ld, lay, state, hyper, sb, nf


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
class TestSharding:

    def test_sharded_matches_single_device(self):
        ld, lay, state, hyper, sb, nf = _problem()
        S = 4
        fix = updates.FixMask(sigma_eps=jnp.zeros(S, bool),
                              tau_beta=jnp.zeros(S, bool),
                              pi=jnp.ones(S, bool))
        kw = dict(n_sample=2000.0, m_total=float(lay.m),
                  init_elbo=jnp.zeros(S, jnp.float64),
                  active0=jnp.ones(S, bool), max_iter=30,
                  f_abs_tol=0.0, x_abs_tol=0.0)

        res_single = em_loop.em_fit(ld, state, sb, nf, hyper, fix, **kw)

        mesh = make_mesh(4, 2)
        ld_s, state_s, sb_s, nf_s = shard_problem(mesh, ld, state, sb, nf)
        res_shard = em_loop.em_fit(ld_s, state_s, sb_s, nf_s, hyper, fix, **kw)

        np.testing.assert_allclose(np.asarray(res_shard.final_elbo),
                                   np.asarray(res_single.final_elbo),
                                   rtol=5e-4)
        # padded blocks stay zero:
        eta_s = np.asarray(res_shard.state.eta)
        assert eta_s.shape[1] >= ld.nb
        assert np.all(eta_s[:, ld.nb:] == 0)

    def test_pad_blocks(self):
        ld, *_ = _problem()
        ld_p = pad_blocks(ld, 8)
        assert ld_p.nb % 8 == 0
        assert np.all(np.asarray(ld_p.mask[ld.nb:]) == 0)

    def test_grid_axis_sharding(self):
        """S sharded over the grid mesh axis."""
        ld, lay, state, hyper, sb, nf = _problem(S=8)
        mesh = make_mesh(2, 4)
        ld_s, state_s, sb_s, nf_s = shard_problem(mesh, ld, state, sb, nf)
        fix = updates.FixMask(sigma_eps=jnp.zeros(8, bool),
                              tau_beta=jnp.zeros(8, bool),
                              pi=jnp.ones(8, bool))
        res = em_loop.em_fit(ld_s, state_s, sb_s, nf_s, hyper, fix,
                             n_sample=2000.0, m_total=float(lay.m),
                             init_elbo=jnp.zeros(8, jnp.float64),
                             active0=jnp.ones(8, bool), max_iter=10)
        assert np.isfinite(np.asarray(res.final_elbo)).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
class TestModelMesh:
    """The PRODUCT multi-device path: VIPRS/VIPRSGrid/VIPRSMix accept (and by
    default auto-create) a ('blocks', 'grid') mesh — the analog of
    the reference CLI's --n-jobs fan-out (bin/viprs_fit:1079-1086)."""

    @pytest.fixture(scope='class')
    def dataset(self):
        from viprs_tpu.data.dataset import SummaryStatsDataset
        sim = simulate_sumstats_blocks(n=3000, block_sizes=(250, 200, 300),
                                       h2=0.35, prop_causal=0.04, seed=21)
        return SummaryStatsDataset.from_dense_blocks(
            sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'],
            block_size=256)

    def test_viprs_auto_mesh_matches_single_device(self, dataset):
        from viprs_tpu.model import VIPRS
        np.random.seed(1)
        m1 = VIPRS(dataset, mesh='off')
        m1.fit(max_iter=200)
        np.random.seed(1)
        m2 = VIPRS(dataset)            # mesh='auto' -> 8 devices on 'blocks'
        assert m2.mesh is not None and m2.mesh.shape['blocks'] == 8
        assert m2._ld.nb % 8 == 0
        m2.fit(max_iter=200)
        assert m2.optim_result.success, m2.optim_result.message
        # same fixed point at f32 tolerance (iteration paths may differ: the
        # block-sharded f64 reductions sum in a different order):
        e1 = np.concatenate([m1.post_mean_beta[c] for c in m1.chromosomes])
        e2 = np.concatenate([m2.post_mean_beta[c] for c in m2.chromosomes])
        np.testing.assert_allclose(e1, e2, atol=5e-4)
        assert abs(m1.history['ELBO'][-1] - m2.history['ELBO'][-1]) < 0.05

    def test_grid_mesh_matches_single_device(self, dataset):
        from viprs_tpu.model import VIPRSGrid
        from viprs_tpu.gridsearch import (HyperparameterGrid,
                                          bayesian_model_average)
        np.random.seed(2)
        grid = HyperparameterGrid(pi_steps=4, sigma_epsilon_steps=2,
                                  n_snps=dataset.m, h2_est=0.3, h2_se=0.05)
        g1 = VIPRSGrid(dataset, grid, mesh='off')
        g1.fit(max_iter=200)
        np.random.seed(2)
        g2 = VIPRSGrid(dataset, grid)
        g2.fit(max_iter=200)
        np.testing.assert_allclose(
            np.asarray(g2.validation_result['ELBO'], float),
            np.asarray(g1.validation_result['ELBO'], float), rtol=1e-6)
        bayesian_model_average(g2)
        assert np.isfinite(g2.get_heritability())

    def test_grid_2d_mesh(self, dataset):
        """Explicit blocks x grid mesh: S=8 sharded 2-ways over 'grid'."""
        from viprs_tpu.model import VIPRSGrid
        from viprs_tpu.gridsearch import HyperparameterGrid
        np.random.seed(2)
        grid = HyperparameterGrid(pi_steps=4, sigma_epsilon_steps=2,
                                  n_snps=dataset.m, h2_est=0.3, h2_se=0.05)
        g1 = VIPRSGrid(dataset, grid, mesh='off')
        g1.fit(max_iter=150)
        np.random.seed(2)
        g3 = VIPRSGrid(dataset, grid, mesh='4x2')
        assert g3.mesh.shape == {'blocks': 4, 'grid': 2}
        g3.fit(max_iter=150)
        np.testing.assert_allclose(
            np.asarray(g3.validation_result['ELBO'], float),
            np.asarray(g1.validation_result['ELBO'], float), rtol=1e-6)

    def test_mix_mesh_matches_single_device(self, dataset):
        from viprs_tpu.model import VIPRSMix
        np.random.seed(3)
        x1 = VIPRSMix(dataset, K=2, mesh='off')
        x1.fit(max_iter=100)
        np.random.seed(3)
        x2 = VIPRSMix(dataset, K=2)
        x2.fit(max_iter=100)
        assert abs(x1.get_heritability() - x2.get_heritability()) < 1e-3
        e1 = np.concatenate([x1.post_mean_beta[c] for c in x1.chromosomes])
        e2 = np.concatenate([x2.post_mean_beta[c] for c in x2.chromosomes])
        np.testing.assert_allclose(e1, e2, atol=5e-4)

    def test_mesh_validation(self, dataset):
        from viprs_tpu.model import VIPRS, VIPRSMix
        with pytest.raises(ValueError, match="mesh"):
            VIPRS(dataset, mesh='bogus')
        with pytest.raises(ValueError, match="blocks"):
            VIPRSMix(dataset, K=2, mesh='4x2')

    def test_grid_mesh_indivisible_s(self, dataset):
        """S not divisible by the 'grid' axis replicates the model axis
        instead of erroring (e.g. the S=1 post-selection refit on a 2D mesh)."""
        from viprs_tpu.model import VIPRSGrid
        from viprs_tpu.gridsearch import HyperparameterGrid, select_best_model
        np.random.seed(4)
        grid = HyperparameterGrid(pi_steps=3, n_snps=dataset.m,
                                  h2_est=0.3, h2_se=0.05)
        g = VIPRSGrid(dataset, grid, mesh='4x2')   # S=3: replicated over grid
        g.fit(max_iter=100)
        assert np.isfinite(
            np.asarray(g.validation_result['ELBO'], float)).all()
        select_best_model(g, criterion='ELBO')     # S=1 refit on the 2D mesh
        assert np.isfinite(g.get_heritability())
