"""VIPRSMix — sparse Gaussian-mixture prior (K slab components + null spike).

Parity with viprs/model/VIPRSMix.py: (M, K) variational parameters, softmax
responsibilities over K+1 components, prior-variance multipliers d, renormalized
pi updates, clipped tau_beta updates. The e-step runs the blocked mixture kernel
(ops/cavi_mix.py); the EM loop is host-stepped with the same convergence ladder
as VIPRS.
"""

import logging

import numpy as np
import jax.numpy as jnp

from .base import BayesPRSModel
from ..ops.cavi_mix import (MixState, MixHyper, cavi_sweep_mixture,
                            mix_var_tau, mix_stats)
from ..utils.optimize import OptimizeResult, IterationConditionCounter

logger = logging.getLogger(__name__)

F32 = jnp.float32


class VIPRSMix(BayesPRSModel):
    """
    :ivar K: number of non-null mixture components.
    :ivar d: prior-variance multipliers, length K.
    """

    def __init__(self, dataset, K=1, prior_multipliers=None,
                 fix_params=None, float_precision='float32', tile=128,
                 lambda_min=None, mesh='auto', **kwargs):
        super().__init__(dataset, float_precision=float_precision)

        assert K > 0
        self.K = K
        if prior_multipliers is not None:
            assert len(prior_multipliers) == K
            self.d = np.asarray(prior_multipliers, dtype=np.float64)
        else:
            self.d = 2.0 ** np.linspace(-min(K - 1, 7), 0, K)

        self.fix_params = dict(fix_params or {})
        self.tile = tile
        self.lambda_min = float(lambda_min or 0.0)

        from ..parallel.mesh import resolve_mesh
        self.mesh = resolve_mesh(mesh)
        if self.mesh is not None and self.mesh.shape['grid'] != 1:
            raise ValueError("VIPRSMix shards over the 'blocks' axis only; "
                             "use a mesh with grid-axis size 1.")
        self._ld = self.dataset.ld_for_mesh(self.mesh)

        self._state = None
        self._hyper = None   # MixHyper in float64 numpy
        self._sigma_g = 0.0
        self.optim_result = OptimizeResult()
        self.history = {}

        self._std_beta_flat = None
        self._n_flat = None
        self._refresh_inputs()

    def _refresh_inputs(self):
        """(Re)build the flat device inputs from the current std_beta /
        n_per_snp dicts (these change under PUMAS splitting). Untouched
        dataset views come from the dataset's shared device cache (see
        VIPRS._refresh_inputs)."""
        from .viprs import VIPRS
        if VIPRS._inputs_are_dataset_views(self):
            self._std_beta_flat, self._n_flat = \
                self.dataset.device_inputs(self.mesh)
            return
        lay = self.dataset.layout
        sb = jnp.asarray(
            lay.to_flat(self.std_beta).reshape(lay.nb, lay.block_size), F32)
        nf = jnp.asarray(
            lay.to_flat(self.n_per_snp).reshape(lay.nb, lay.block_size), F32)
        if self.mesh is not None:
            from ..parallel.mesh import shard_flat
            sb = shard_flat(self.mesh, sb, self._ld.nb)
            nf = shard_flat(self.mesh, nf, self._ld.nb)
        self._std_beta_flat = sb
        self._n_flat = nf

    def initialize_input_data_arrays(self):
        super().initialize_input_data_arrays()
        self._refresh_inputs()

    # ------------------------------------------------------------ initialization
    def initialize(self, theta_0=None, param_0=None):
        self.initialize_theta(theta_0)
        self.initialize_variational_parameters(param_0)
        self.history = {'ELBO': []}
        self.optim_result.reset()

    def initialize_theta(self, theta_0=None):
        """Reference logic (VIPRSMix.py:61-167)."""
        theta_0 = dict(theta_0 or {})
        theta_0.update(self.fix_params)
        m = self.n_snps

        if 'pis' in theta_0:
            pi = np.asarray(theta_0['pis'], dtype=np.float64)
        else:
            if 'pi' in theta_0:
                overall_pi = float(theta_0['pi'])
            else:
                overall_pi = float(np.random.uniform(max(0.005, 1.0 / m), 0.1))
            pi = overall_pi * np.random.dirichlet(np.ones(self.K))

        if 'sigma_epsilon' not in theta_0:
            if 'tau_betas' in theta_0:
                tau_beta = np.asarray(theta_0['tau_betas'], dtype=np.float64)
                sigma_eps = float(np.clip(1.0 - np.dot(1.0 / tau_beta, pi),
                                          1e-4, 1.0 - 1e-4))
            elif 'tau_beta' in theta_0:
                tau_beta = float(theta_0['tau_beta']) * self.d
                h2g_estimate = (m * pi / tau_beta).sum()
                sigma_eps = float(np.clip(1.0 - h2g_estimate, 1e-4, 1.0 - 1e-4))
            else:
                try:
                    from ..data.ldsc import simple_ldsc
                    naive_h2g = float(np.clip(simple_ldsc(self.dataset),
                                              1e-3, 1.0 - 1e-3))
                except Exception:
                    naive_h2g = float(np.random.uniform(0.001, 0.999))
                sigma_eps = 1.0 - naive_h2g
                global_tau = m * np.dot(1.0 / self.d, pi) / naive_h2g
                tau_beta = self.d * global_tau
        else:
            sigma_eps = float(theta_0['sigma_epsilon'])
            if 'tau_betas' in theta_0:
                tau_beta = np.asarray(theta_0['tau_betas'], dtype=np.float64)
            elif 'tau_beta' in theta_0:
                tau_beta = np.repeat(float(theta_0['tau_beta']), self.K)
            else:
                global_tau = m * np.dot(1.0 / self.d, pi) / (1.0 - sigma_eps)
                tau_beta = self.d * global_tau

        self._hyper = MixHyper(
            sigma_eps=np.float64(sigma_eps),
            tau_beta=np.asarray(tau_beta, dtype=np.float64),
            pi=np.asarray(pi, dtype=np.float64),
            lambda_min=np.float64(self.fix_params.get('lambda_min', self.lambda_min)))
        self._sigma_g = 0.0

    def initialize_variational_parameters(self, param_0=None):
        lay = self.dataset.layout
        nb, B = self._ld.nb, lay.block_size
        K = self.K
        pi = np.asarray(self._hyper.pi)
        gamma = jnp.broadcast_to(
            jnp.asarray(pi.astype(np.float32))[:, None, None], (K, nb, B))
        mu = jnp.zeros((K, nb, B), F32)
        eta = jnp.zeros((nb, B), F32)
        q = jnp.zeros((nb, B), F32)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh_k = NamedSharding(self.mesh, P(None, 'blocks', None))
            sh_b = NamedSharding(self.mesh, P('blocks', None))
            import jax
            gamma = jax.device_put(gamma, sh_k)
            mu = jax.device_put(mu, sh_k)
            eta = jax.device_put(eta, sh_b)
            q = jax.device_put(q, sh_b)
        self._state = MixState(gamma=gamma, mu=mu, eta=eta, q=q)

    # -------------------------------------------------------------- accessors
    def _hyper_f32(self):
        return MixHyper(sigma_eps=jnp.asarray(self._hyper.sigma_eps, F32),
                        tau_beta=jnp.asarray(self._hyper.tau_beta, F32),
                        pi=jnp.asarray(self._hyper.pi, F32),
                        lambda_min=jnp.asarray(self._hyper.lambda_min, F32))

    @property
    def pi(self):
        return np.asarray(self._hyper.pi)

    @property
    def tau_beta(self):
        return np.asarray(self._hyper.tau_beta)

    @property
    def sigma_epsilon(self):
        return float(self._hyper.sigma_eps)

    def get_null_pi(self, chrom=None):
        return 1.0 - float(np.sum(self._hyper.pi))

    def get_proportion_causal(self):
        return float(np.sum(self._hyper.pi))

    def get_average_effect_size_variance(self):
        return float(np.sum(self.pi / self.tau_beta))

    def get_heritability(self):
        return float(self._sigma_g / (self._sigma_g + self.sigma_epsilon))

    def _dict_view(self, arr, k_axis=False):
        lay = self.dataset.layout
        arr = np.asarray(arr)
        if not k_axis:
            return lay.from_flat(arr.reshape(-1))
        per_k = [lay.from_flat(arr[k].reshape(-1)) for k in range(arr.shape[0])]
        return {c: np.stack([pk[c] for pk in per_k], axis=1)
                for c in self.chromosomes}

    @property
    def var_gamma(self):
        return self._dict_view(self._state.gamma, k_axis=True)

    @property
    def var_mu(self):
        return self._dict_view(self._state.mu, k_axis=True)

    @property
    def eta(self):
        return self._dict_view(self._state.eta)

    @property
    def q(self):
        return self._dict_view(self._state.q)

    def q_dict(self):
        return self.q

    def compute_pip(self):
        pip = np.asarray(self._state.gamma).sum(axis=0)
        return self._dict_view(pip)

    def update_posterior_moments(self):
        vt = np.asarray(mix_var_tau(self._n_flat, self._hyper_f32()))
        g = np.asarray(self._state.gamma)
        mu = np.asarray(self._state.mu)
        zeta = (g * (mu ** 2 + 1.0 / vt)).sum(axis=0)
        eta = np.asarray(self._state.eta)
        self.pip = self._dict_view(g.sum(axis=0))
        self.post_mean_beta = self._dict_view(eta)
        self.post_var_beta = self._dict_view(zeta - eta ** 2)

    def _materialize_posterior_moments(self, means_only=False):
        """Lazy host materialization of the posterior moments (see
        BayesPRSModel: fits leave the posterior device-side)."""
        if self._state is None:
            return
        if means_only:
            if self._post_mean_beta is None:
                self.post_mean_beta = self.eta
        elif self._pip is None or self._post_var_beta is None:
            self.update_posterior_moments()

    # ------------------------------------------------------------------- elbo
    def _elbo_and_stats(self, stats=None):
        h = self._hyper
        if stats is None:
            vt = mix_var_tau(self._n_flat, self._hyper_f32())
            stats = {k: np.asarray(v) for k, v in
                     mix_stats(self._state, vt, self._std_beta_flat,
                               self._ld.mask).items()}
        sig_e = float(h.sigma_eps)
        tau_b = np.asarray(h.tau_beta)
        pi = np.asarray(h.pi)
        n = float(self.n)

        sigma_eps_fixed = 'sigma_epsilon' in self.fix_params
        quad = (1.0 / sig_e) * (1.0 - 2.0 * stats['sum_beta_eta'] + self._sigma_g)
        fit_term = quad if sigma_eps_fixed else 1.0
        e = 0.5 * n * (-np.log(2 * np.pi * sig_e) - fit_term)

        e -= stats['sum_g_logg'] - float(np.dot(stats['sum_gamma_k'], np.log(pi)))
        null_pi = max(1.0 - pi.sum(), 1e-12)
        e -= stats['sum_ng_logng'] - stats['sum_null_g'] * np.log(null_pi)
        e += 0.5 * (float(np.dot(stats['sum_gamma_k'], 1.0 + np.log(tau_b)))
                    - stats['sum_g_logvt'].sum())
        e -= 0.5 * float(np.dot(tau_b, stats['sum_zeta_k']))
        return float(e), stats

    def elbo(self):
        return self._elbo_and_stats()[0]

    def objective(self):
        return self.elbo()

    def mse(self, stats=None):
        if stats is None:
            stats = self._elbo_and_stats()[1]
        return float(1.0 - 2.0 * stats['sum_beta_eta'] + self._sigma_g
                     - stats['sum_zeta_k'].sum() + stats['sum_eta_sq'])

    # ELBO decomposition on the mixture posterior — the reference inherits
    # these generically from VIPRS (VIPRS.py:583-678); here they are expressed
    # in the (K,)-reduced statistics the fused loop already computes:
    def loglikelihood(self, stats=None):
        """E_q[log p(data | beta)] (reference VIPRS.py:615-628)."""
        if stats is None:
            stats = self._elbo_and_stats()[1]
        sig_e = float(self._hyper.sigma_eps)
        return float(-0.5 * self.n * (
            np.log(2.0 * np.pi * sig_e)
            + (1.0 / sig_e) * (1.0 - 2.0 * stats['sum_beta_eta']
                               + self._sigma_g)))

    def log_prior(self, stats=None):
        """E_q[log p(beta | theta)] (reference VIPRS.py:630-678, K-mixture
        instantiation)."""
        if stats is None:
            stats = self._elbo_and_stats()[1]
        pi = np.asarray(self._hyper.pi, dtype=np.float64)
        tau_b = np.asarray(self._hyper.tau_beta, dtype=np.float64)
        null_pi = max(1.0 - pi.sum(), np.finfo(np.float64).resolution)
        lp = 0.5 * float(np.dot(stats['sum_gamma_k'], np.log(tau_b)))
        lp += float(np.dot(stats['sum_gamma_k'], np.log(pi)))
        lp += float(stats['sum_null_g']) * np.log(null_pi)
        lp -= 0.5 * float(np.dot(tau_b, stats['sum_zeta_k']))
        return lp - 0.5 * self.n_snps * np.log(2.0 * np.pi)

    def entropy(self, stats=None):
        """Entropy of the variational distribution (reference
        VIPRS.py:583-613)."""
        if stats is None:
            stats = self._elbo_and_stats()[1]
        ent = -float(stats['sum_g_logg']) - float(stats['sum_ng_logng'])
        ent -= 0.5 * float(stats['sum_g_logvt'].sum())
        return ent + 0.5 * self.n_snps * (np.log(2.0 * np.pi) + 1.0)

    def complete_loglikelihood(self):
        return self.loglikelihood() + self.log_prior()

    # -------------------------------------------------------------------- fit
    def _m_step(self, stats):
        h = self._hyper
        m = float(self.m)
        pi = np.asarray(h.pi).copy()
        tau_beta = np.asarray(h.tau_beta).copy()

        if 'pis' not in self.fix_params:
            pi_estimate = stats['sum_gamma_k'].copy()
            if 'pi' in self.fix_params:
                pi_estimate = self.fix_params['pi'] * pi_estimate / pi_estimate.sum()
            else:
                pi_estimate = pi_estimate / m
            pi = pi_estimate

        if 'tau_betas' not in self.fix_params:
            zetas = stats['sum_zeta_k']
            tau_est = np.sum(pi) * m / np.dot(self.d, zetas)
            tau_beta = np.clip(self.d * tau_est, 1.0, None)

        lam = float(h.lambda_min)
        sigma_g = float((1.0 + lam) * stats['sum_zeta_k'].sum() + stats['sum_q_eta'])
        if 'sigma_epsilon' in self.fix_params:
            sigma_eps = float(h.sigma_eps)
        else:
            sigma_eps = float(1.0 - 2.0 * stats['sum_beta_eta'] + sigma_g)

        self._hyper = MixHyper(sigma_eps=np.float64(sigma_eps),
                               tau_beta=tau_beta, pi=pi,
                               lambda_min=h.lambda_min)
        self._sigma_g = sigma_g

    def fit(self, max_iter=1000, theta_0=None, param_0=None, continued=False,
            min_iter=3, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10,
            max_restarts=1, fused=True, **kwargs):
        """Mixture EM fit. ``fused=True`` (default) runs the whole loop on
        device (ops/mix_em_loop.py); ``fused=False`` falls back to the
        host-stepped loop (needed for exotic per-iteration tracking).
        Keyword-only (via kwargs): ``inner_steps``, and ``compile_only``
        (lower + compile the fused dispatch into the persistent cache, run
        nothing). The sweep is always the XLA tile loop of
        ``ops/cavi_mix.py``."""
        inner_steps = kwargs.pop('inner_steps', 8)
        compile_only = kwargs.pop('compile_only', False)
        self._refresh_inputs()
        if fused:
            return self._fit_fused(max_iter, theta_0, param_0, continued,
                                   min_iter, f_abs_tol, x_abs_tol, patience,
                                   max_restarts, inner_steps=inner_steps,
                                   compile_only=compile_only)
        assert not compile_only, "compile_only requires the fused path"

        if not continued:
            self.initialize(theta_0, param_0)

        self.history.setdefault('ELBO', [])
        self.history['ELBO'].append(self.elbo())
        prev_elbo = self.history['ELBO'][-1]
        prev_sigma_g = self._sigma_g
        sig_icc = IterationConditionCounter()
        div_icc = IterationConditionCounter()
        restarts = 0

        for i in range(1, max_iter + 1):
            h32 = self._hyper_f32()
            state, eta_diff = cavi_sweep_mixture(
                self._ld, self._state, self._std_beta_flat, self._n_flat,
                h32, tile=self.tile)
            vt = mix_var_tau(self._n_flat, h32)
            stats = {k: np.asarray(v) for k, v in
                     mix_stats(state, vt, self._std_beta_flat,
                               self._ld.mask).items()}
            self._state = state
            self._m_step(stats)

            curr_elbo, _ = self._elbo_and_stats(stats)
            curr_mse = self.mse(stats)
            max_ed = float(np.max(np.abs(np.asarray(eta_diff))))
            self.history['ELBO'].append(curr_elbo)

            sig_icc.update((i > min_iter)
                           and abs(self._sigma_g - prev_sigma_g) <= x_abs_tol
                           and max_ed < 10 * x_abs_tol, i)
            div_icc.update((curr_elbo < prev_elbo)
                           and not np.isclose(curr_elbo, prev_elbo,
                                              atol=1e3 * f_abs_tol, rtol=1e-4), i)
            h2 = self.get_heritability()

            if curr_mse < 0:
                if 'sigma_epsilon' not in self.fix_params and restarts < max_restarts:
                    restarts += 1
                    logger.info("Iteration %d | MSE negative; restarting with "
                                "fixed sigma_epsilon.", i)
                    self.initialize_theta(theta_0)
                    self.fix_params['sigma_epsilon'] = 0.95
                    self._hyper = self._hyper._replace(sigma_eps=np.float64(0.95))
                    self.initialize_variational_parameters(param_0)
                    continue
                self.optim_result.update(curr_elbo, stop_iteration=True, success=False,
                                         message=f'The MSE is negative ({curr_mse:.6f}).')
            elif not np.isfinite(curr_elbo):
                self.optim_result.update(curr_elbo, stop_iteration=True, success=False,
                                         message='Objective (ELBO) is undefined.')
            elif self.sigma_epsilon < 0:
                self.optim_result.update(curr_elbo, stop_iteration=True, success=False,
                                         message='Residual variance estimate is negative.')
            elif h2 > 1 or h2 < 0:
                self.optim_result.update(curr_elbo, stop_iteration=True, success=False,
                                         message='Estimated heritability is out of bounds.')
            elif i > min_iter and np.isclose(prev_elbo, curr_elbo, atol=f_abs_tol, rtol=0.):
                self.optim_result.update(curr_elbo, stop_iteration=True, success=True,
                                         message='Objective (ELBO) converged successfully.')
            elif i > min_iter and max_ed < x_abs_tol:
                self.optim_result.update(curr_elbo, stop_iteration=True, success=True,
                                         message='Variational parameters converged successfully.')
            elif sig_icc.counter > patience:
                self.optim_result.update(
                    curr_elbo, stop_iteration=True, success=True,
                    message='LD-weighted variational parameters converged successfully.')
            elif div_icc.counter > patience:
                self.optim_result.update(curr_elbo, stop_iteration=True, success=False,
                                         message='The objective (ELBO) is decreasing.')
            else:
                self.optim_result.update(curr_elbo)

            prev_elbo = curr_elbo
            prev_sigma_g = self._sigma_g
            if self.optim_result.stop_iteration:
                break

        if not self.optim_result.stop_iteration:
            self.optim_result.update(self.history['ELBO'][-1], stop_iteration=True,
                                     success=False,
                                     message="Maximum iterations reached without convergence.\n"
                                             "You may need to run the model for more iterations.",
                                     increment=False)

        # moments materialize lazily on first access (see BayesPRSModel):
        self.pip = self.post_mean_beta = self.post_var_beta = None
        return self

    def _mix_fix(self):
        import jax.numpy as jnp
        from ..ops.mix_em_loop import MixFix
        return MixFix(
            sigma_eps=jnp.asarray('sigma_epsilon' in self.fix_params),
            tau_betas=jnp.asarray('tau_betas' in self.fix_params),
            pis=jnp.asarray('pis' in self.fix_params),
            total_pi=jnp.asarray(float(self.fix_params.get('pi', 0.0)),
                                 jnp.float64))

    def _fit_fused(self, max_iter, theta_0, param_0, continued, min_iter,
                   f_abs_tol, x_abs_tol, patience, max_restarts,
                   inner_steps=8, compile_only=False):
        import jax.numpy as jnp
        from ..ops.mix_em_loop import mix_em_fit

        if not continued:
            self.initialize(theta_0, param_0)
        self.history.setdefault('ELBO', [])

        restarts = 0
        while True:
            # the initial objective (history slot 0) is computed IN-GRAPH by
            # the dispatch (init_elbo=None) — no pre-dispatch ELBO sync:
            call_args = (self._ld, self._state, self._std_beta_flat,
                         self._n_flat, self._hyper_f32(), self._mix_fix(),
                         jnp.asarray(self.d, jnp.float32))
            call_kw = dict(
                n_sample=float(self.n), m_total=float(self.m),
                init_elbo=None, max_iter=max_iter, min_iter=min_iter,
                f_abs_tol=f_abs_tol, x_abs_tol=x_abs_tol, patience=patience,
                tile=self.tile, inner_steps=inner_steps,
                sigma_g0=float(self._sigma_g))
            if compile_only:
                with self._mesh_context():
                    mix_em_fit.lower(*call_args, **call_kw).compile()
                return self
            with self._mesh_context():
                res = mix_em_fit(*call_args, **call_kw)

            self._state = res.state
            self._hyper = MixHyper(
                sigma_eps=np.float64(np.asarray(res.hyper.sigma_eps)),
                tau_beta=np.asarray(res.hyper.tau_beta, dtype=np.float64),
                pi=np.asarray(res.hyper.pi, dtype=np.float64),
                lambda_min=np.float64(np.asarray(res.hyper.lambda_min)))
            self._sigma_g = float(np.asarray(res.sigma_g))
            code = int(np.asarray(res.status))

            if (code == 4  # MSE_NEGATIVE
                    and 'sigma_epsilon' not in self.fix_params
                    and restarts < max_restarts):
                restarts += 1
                logger.info("MSE negative; restarting mixture fit with fixed "
                            "sigma_epsilon (reference behavior).")
                self.initialize_theta(theta_0)
                self.fix_params['sigma_epsilon'] = 0.95
                self._hyper = self._hyper._replace(sigma_eps=np.float64(0.95))
                self.initialize_variational_parameters(param_0)
                continue
            break

        hist = np.asarray(res.elbo_hist)
        nit = int(np.asarray(res.nit))
        self.history['ELBO'] = [v for v in hist[:nit + 1].tolist()]
        from ..utils.optimize import OptimizeResult
        self.optim_result = OptimizeResult.from_status(
            code, float(np.asarray(res.final_elbo)), nit)
        if not self.optim_result.success:
            logger.warning("\t%s", self.optim_result.message)
        self.pip = self.post_mean_beta = self.post_var_beta = None
        return self

    def write_inferred_theta(self, f_name, sep="\t"):
        self.to_theta_table().to_csv(f_name, sep=sep, index=False)

    def to_history_table(self):
        import pandas as pd
        return pd.DataFrame(self.history)

    def to_theta_table(self):
        import pandas as pd
        rows = [
            {'Parameter': 'ELBO', 'Value': self.elbo()},
            {'Parameter': 'Residual_variance', 'Value': self.sigma_epsilon},
            {'Parameter': 'Heritability', 'Value': self.get_heritability()},
            {'Parameter': 'Proportion_causal', 'Value': self.get_proportion_causal()},
            {'Parameter': 'Average_effect_variance',
             'Value': self.get_average_effect_size_variance()},
        ]
        for i, t in enumerate(np.atleast_1d(self.tau_beta)):
            rows.append({'Parameter': f'tau_beta_{i + 1}', 'Value': t})
        for i, p in enumerate(np.atleast_1d(self.pi)):
            rows.append({'Parameter': f'pi_{i + 1}', 'Value': p})
        return pd.DataFrame(rows)
