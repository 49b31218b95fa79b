"""VIPRSMixGrid — fit a grid of VIPRSMix models simultaneously.

The reference fits ANY model class across grid rows in parallel worker
processes (viprs/model/gridsearch/HyperparameterSearch.py:197-351, one
``fit_model_fixed_params`` worker per row). Here the mixture model gets the
same treatment as VIPRSGrid: the grid is a leading batch axis S of the
variational state, all settings advance in one fused loop
(ops/mix_em_loop.py:mix_em_fit_batch) with converged-lane masking and the
oscillation/stall damping ladder, and selection collapses the winner back to
a plain VIPRSMix.
"""

import logging

import numpy as np
import jax
import jax.numpy as jnp

from .mix import VIPRSMix
from ..ops.cavi_mix import MixState, MixHyper, mix_var_tau
from ..utils import optimize as opt
from ..utils.optimize import OptimizeResult, summarize_statuses

logger = logging.getLogger(__name__)

F32 = jnp.float32
_GRID_KEYS = ('sigma_epsilon', 'tau_beta', 'pi', 'lambda_min')


class VIPRSMixGrid(VIPRSMix):
    """
    :ivar grid_table: {hyperparameter: (n_models,) array} settings.
    :ivar validation_result: {column: (n_models,) array} per-model fit
        outcomes (``to_validation_table()`` gives it as a DataFrame).
    :ivar optim_results: list of OptimizeResult, one per model.
    :ivar n_models: number of grid points.
    """

    def __init__(self, dataset, grid, K=1, **kwargs):
        from ..gridsearch.grid import grid_columns
        self.grid_table = grid_columns(grid)
        self.n_models = len(next(iter(self.grid_table.values())))
        self._n_grid_rows = self.n_models
        assert self.n_models >= 1
        self.validation_result = None
        self.optim_results = []
        super().__init__(dataset, K=K, **kwargs)

    # --------------------------------------------------------------- statuses
    @property
    def converged_models(self):
        return np.array([r.success for r in self.optim_results])

    @property
    def terminated_models(self):
        return np.array([r.stop_iteration for r in self.optim_results])

    @property
    def valid_terminated_models(self):
        return np.array([r.valid_optim_result for r in self.optim_results])

    @property
    def models_to_keep(self):
        return np.logical_or(~self.terminated_models, self.converged_models)

    def to_validation_table(self):
        if self.validation_result is None or len(self.validation_result) < 1:
            raise ValueError("Validation result is not set!")
        import pandas as pd
        return pd.DataFrame(self.validation_result)

    def write_validation_result(self, v_filename, sep="\t"):
        self.to_validation_table().to_csv(v_filename, index=False, sep=sep)

    # ----------------------------------------------------------- initialization
    def initialize_theta(self, theta_0=None):
        """Base VIPRSMix initialization per lane, with grid-row overrides.

        Per-lane semantics mirror the reference worker's
        ``fix_params=dict(grid row)`` (HyperparameterSearch.py:104-111): a
        gridded ``pi`` is the TOTAL proportion-causal (renormalized in the
        M-step, VIPRSMix.py:234-238), ``tau_beta`` scales the multiplier
        vector d, ``sigma_epsilon``/``lambda_min`` pin the scalars.
        """
        if self.n_models == 1:
            return super().initialize_theta(theta_0)
        S, K, m = self.n_models, self.K, self.n_snps
        theta_0 = dict(theta_0 or {})
        theta_0.update(self.fix_params)
        cols = self.grid_table

        if 'pi' in cols:
            total_pi = self.grid_table['pi']
        elif 'pi' in theta_0:
            total_pi = np.full(S, float(theta_0['pi']))
        else:
            total_pi = np.random.uniform(max(0.005, 1.0 / m), 0.1, size=S)
        # per-lane Dirichlet split over the K components (VIPRSMix.py:77-86):
        pi = total_pi[:, None] * np.random.dirichlet(np.ones(K), size=S)

        if 'sigma_epsilon' in cols:
            sigma_eps = self.grid_table['sigma_epsilon']
        elif 'sigma_epsilon' in theta_0:
            sigma_eps = np.full(S, float(theta_0['sigma_epsilon']))
        else:
            try:
                from ..data.ldsc import simple_ldsc
                naive_h2g = float(np.clip(simple_ldsc(self.dataset),
                                          1e-3, 1.0 - 1e-3))
            except Exception:
                naive_h2g = float(np.random.uniform(0.001, 0.999))
            sigma_eps = np.full(S, 1.0 - naive_h2g)

        h2_lane = np.clip(1.0 - sigma_eps, 1e-3, 1.0 - 1e-3)
        if 'tau_beta' in cols:
            tau_beta = self.grid_table['tau_beta'][:, None] * self.d[None]
        elif 'tau_betas' in theta_0:
            tau_beta = np.tile(np.asarray(theta_0['tau_betas'],
                                          dtype=np.float64), (S, 1))
        else:
            global_tau = m * (pi @ (1.0 / self.d)) / h2_lane
            tau_beta = self.d[None] * global_tau[:, None]

        if 'lambda_min' in cols:
            lam = self.grid_table['lambda_min']
        else:
            lam = np.full(S, float(self.fix_params.get('lambda_min',
                                                       self.lambda_min)))

        self._hyper = MixHyper(sigma_eps=sigma_eps, tau_beta=tau_beta,
                               pi=pi, lambda_min=lam)
        self._sigma_g = np.zeros(S)

    def initialize_variational_parameters(self, param_0=None):
        if self.n_models == 1:
            return super().initialize_variational_parameters(param_0)
        S, K = self.n_models, self.K
        nb, B = self._ld.nb, self.dataset.layout.block_size
        gamma = jnp.broadcast_to(
            jnp.asarray(np.asarray(self._hyper.pi, dtype=np.float32))
            [:, :, None, None], (S, K, nb, B))
        mu = jnp.zeros((S, K, nb, B), F32)
        eta = jnp.zeros((S, nb, B), F32)
        q = jnp.zeros((S, nb, B), F32)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh_k = NamedSharding(self.mesh, P(None, None, 'blocks', None))
            sh_b = NamedSharding(self.mesh, P(None, 'blocks', None))
            gamma = jax.device_put(gamma, sh_k)
            mu = jax.device_put(mu, sh_k)
            eta = jax.device_put(eta, sh_b)
            q = jax.device_put(q, sh_b)
        self._state = MixState(gamma=gamma, mu=mu, eta=eta, q=q)

    def _batch_hyper_f32(self):
        return MixHyper(*(jnp.asarray(np.asarray(x), F32)
                          for x in self._hyper))

    def _batch_fix(self):
        from ..ops.mix_em_loop import MixFixBatch
        S = self.n_models
        cols = self.grid_table
        se_fixed = ('sigma_epsilon' in cols) or \
            ('sigma_epsilon' in self.fix_params)
        tb_fixed = ('tau_beta' in cols) or ('tau_betas' in self.fix_params)
        if 'pi' in cols:
            total_pi = self.grid_table['pi']
        else:
            total_pi = np.full(S, float(self.fix_params.get('pi', 0.0)))
        return MixFixBatch(
            sigma_eps=jnp.full(S, se_fixed, bool),
            tau_betas=jnp.full(S, tb_fixed, bool),
            pis=jnp.full(S, 'pis' in self.fix_params, bool),
            total_pi=jnp.asarray(total_pi, jnp.float64))

    # ----------------------------------------------------------------- fit
    def fit(self, max_iter=1000, theta_0=None, param_0=None, continued=False,
            min_iter=3, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10,
            max_restarts=1, chunk_iters=None, **kwargs):
        if self.n_models == 1:
            return super().fit(max_iter=max_iter, theta_0=theta_0,
                               param_0=param_0, continued=continued,
                               min_iter=min_iter, f_abs_tol=f_abs_tol,
                               x_abs_tol=x_abs_tol, patience=patience,
                               max_restarts=max_restarts, **kwargs)
        from ..ops import mix_em_loop as mel

        self._refresh_inputs()
        if not continued:
            self.initialize(theta_0, param_0)
        self.history.setdefault('ELBO', [])
        S = self.n_models

        # Chunked fused loop with lane compaction (the same driver shape as
        # VIPRS.fit): most lanes converge early; re-running only the
        # survivors at the next power-of-2 width keeps the straggler tail
        # from costing full-width sweeps. Ladder counters carry across
        # chunks, so the trajectory equals one fused dispatch.
        if chunk_iters is None:
            chunk_iters = min(100, max_iter) if S >= 8 else max_iter
        chunk_iters = max(1, min(chunk_iters, max_iter))

        inner_steps = kwargs.pop('inner_steps', 8)

        restarts = 0
        active = np.ones(S, bool)
        statuses = np.full(S, opt.MAX_ITER, dtype=np.int32)
        nit_acc = np.zeros(S, dtype=np.int32)
        final_elbo = np.zeros(S, dtype=np.float64)
        counters = mel.init_mix_counters(S)
        init_elbo = None       # None => the chunk computes it in-graph
        last_elbo = None       # last known full-width objectives (history fill)
        it_done = 0
        S_run = S

        def sub_fix(fx, sel_dev):
            from ..ops.mix_em_loop import MixFixBatch
            return MixFixBatch(*(jnp.take(jnp.asarray(x), sel_dev, axis=0)
                                 for x in fx))

        while it_done < max_iter:
            this_chunk = min(chunk_iters, max_iter - it_done)
            n_act = int(active.sum())

            bucket = min(S, 1 << max(0, int(np.ceil(np.log2(max(n_act, 1))))))
            if last_elbo is None:
                bucket = S      # nothing to back-fill history from yet
            if bucket > S_run:
                S_run = bucket
            elif S >= 8 and bucket <= S_run // 2:
                # compact on any power-of-2 shrink: mixture grids are narrow
                # (S ~ 20) and the straggler tail dominates, so halving the
                # width pays for the (persistently cached) extra compiles
                S_run = bucket
            compact = S_run < S

            fix_full = self._batch_fix()
            if compact:
                sel = np.nonzero(active)[0]
                sel_pad = np.concatenate(
                    [sel, np.full(S_run - n_act, sel[0])]).astype(np.int64)
                sel_dev = jnp.asarray(sel_pad)

                def sub(x):
                    return jnp.take(jnp.asarray(x), sel_dev, axis=0)
                state_in = MixState(*(sub(x) for x in self._state))
                hyper_in = MixHyper(*(sub(x)
                                      for x in self._batch_hyper_f32()))
                fix_in = sub_fix(fix_full, sel_dev)
                counters_in = mel.MixCounters(*(sub(x) for x in counters))
                # post-restart chunks pass None: the restarted lanes' initial
                # objective is computed in-graph for the compacted subset
                init_elbo_in = (None if init_elbo is None
                                else init_elbo[sel_pad])
                active_in = jnp.asarray(np.arange(S_run) < n_act)
                sigma_g_in = np.atleast_1d(self._sigma_g)[sel_pad]
            else:
                state_in, hyper_in = self._state, self._batch_hyper_f32()
                fix_in, counters_in = fix_full, counters
                init_elbo_in = init_elbo
                active_in = jnp.asarray(active)
                sigma_g_in = np.atleast_1d(self._sigma_g)

            with self._mesh_context():
                res = mel.mix_em_fit_batch(
                    self._ld, state_in, self._std_beta_flat, self._n_flat,
                    hyper_in, fix_in, jnp.asarray(self.d, F32),
                    n_sample=float(self.n), m_total=float(self.m),
                    max_iter=this_chunk, min_iter=min_iter,
                    f_abs_tol=f_abs_tol, x_abs_tol=x_abs_tol,
                    patience=patience, tile=self.tile,
                    inner_steps=inner_steps,
                    active0=active_in,
                    sigma_g0=jnp.asarray(sigma_g_in, jnp.float64),
                    i0=it_done, counters0=counters_in,
                    init_elbo=init_elbo_in)

            (hyper_np, sg_np, status_np, nit_np, n_total_np, fe_np,
             hist_dev) = jax.device_get(
                (res.hyper, res.sigma_g, res.status, res.nit,
                 res.n_iter_total, res.final_elbo, res.elbo_hist))
            n_in_chunk = int(n_total_np)
            it_done += n_in_chunk

            if compact:
                sel_j = jnp.asarray(sel)
                fill = init_elbo if init_elbo is not None else last_elbo

                def scat(full, part):
                    return jnp.asarray(full).at[sel_j].set(part[:n_act])
                self._state = MixState(
                    *(scat(f, p) for f, p in zip(self._state, res.state)))
                hyper_host = {f: np.asarray(getattr(self._hyper, f),
                                            dtype=np.float64).copy()
                              for f in self._hyper._fields}
                for i, f in enumerate(self._hyper._fields):
                    hyper_host[f][sel] = np.asarray(
                        hyper_np[i], dtype=np.float64)[:n_act]
                self._hyper = MixHyper(**hyper_host)
                sg = np.atleast_1d(np.asarray(self._sigma_g,
                                              dtype=np.float64)).copy()
                sg[sel] = np.asarray(sg_np, dtype=np.float64)[:n_act]
                self._sigma_g = sg
                counters = mel.MixCounters(
                    *(scat(f, p) for f, p in zip(counters, res.counters)))
                statuses = statuses.copy()
                statuses[sel] = status_np[:n_act]
                nit_acc[sel] = nit_np[:n_act]
                fe = fill.copy()
                fe[sel] = np.asarray(fe_np, dtype=np.float64)[:n_act]
                for row in np.asarray(hist_dev)[1:n_in_chunk + 1]:
                    full_row = fill.copy()
                    full_row[sel] = row[:n_act]
                    self.history['ELBO'].append(full_row)
                init_elbo = fe
            else:
                self._state = res.state
                self._hyper = MixHyper(*(np.asarray(x, dtype=np.float64)
                                         for x in hyper_np))
                self._sigma_g = np.asarray(sg_np, dtype=np.float64)
                counters = res.counters
                statuses = statuses.copy()
                statuses[active] = status_np[active]
                nit_acc[active] = nit_np[active]
                hist = np.asarray(hist_dev)
                if init_elbo is None and not self.history['ELBO']:
                    self.history['ELBO'].append(hist[0].copy())
                self.history['ELBO'].extend(list(hist[1:n_in_chunk + 1]))
                init_elbo = np.asarray(fe_np, dtype=np.float64)
            last_elbo = init_elbo
            final_elbo = init_elbo

            restart_mask = (statuses == opt.MSE_NEGATIVE) \
                & ~np.asarray(fix_full.sigma_eps) \
                & (restarts < max_restarts)
            if restart_mask.any():
                restarts += 1
                logger.info("MSE negative on %d grid lanes; restarting them "
                            "with sigma_epsilon fixed at 0.95 (reference "
                            "behavior).", int(restart_mask.sum()))
                self._restart_lanes(restart_mask, theta_0)
                fresh = mel.init_mix_counters(S)
                mask_dev = jnp.asarray(restart_mask)
                counters = mel.MixCounters(
                    *(jnp.where(mask_dev, f, c)
                      for f, c in zip(fresh, counters)))
                active = restart_mask | (statuses == opt.MAX_ITER)
                init_elbo = None    # restarted lanes: recompute in-graph
                continue

            active = statuses == opt.MAX_ITER
            if not active.any():
                break

        self._final_elbo = final_elbo
        self._nit = nit_acc

        self.optim_results = summarize_statuses(statuses, self._final_elbo,
                                                self._nit)
        self.optim_result = OptimizeResult()
        self.optim_result.nit = int(self._nit.max())
        self.optim_result.fun = float(np.max(self._final_elbo))
        self.optim_result.stop_iteration = True
        self.optim_result.success = bool(
            np.any([r.success for r in self.optim_results]))
        self.optim_result.error_on_termination = \
            not bool(np.any(self.valid_terminated_models))
        self.optim_result.message = (
            'Grid fit complete.' if not self.optim_result.error_on_termination
            else 'All grid points terminated with errors: '
                 + '; '.join(sorted({r.message for r in self.optim_results})))

        self.validation_result = dict(self.grid_table)
        self.validation_result['ELBO'] = self._final_elbo
        self.validation_result['Converged'] = self.converged_models
        self.validation_result['Optimization_message'] = \
            [r.message for r in self.optim_results]

        self.pip = self.post_mean_beta = self.post_var_beta = None
        return self

    def _restart_lanes(self, mask, theta_0):
        """Reset the masked lanes with sigma_epsilon pinned at 0.95
        (VIPRS.py:1025-1038 applied per grid lane)."""
        S, K = self.n_models, self.K
        h = {f: np.asarray(getattr(self._hyper, f), dtype=np.float64).copy()
             for f in self._hyper._fields}
        h['sigma_eps'][mask] = 0.95
        self.fix_params['sigma_epsilon'] = 0.95
        self._hyper = MixHyper(**h)
        self._sigma_g = np.where(mask, 0.0, np.atleast_1d(self._sigma_g))

        mask_dev = jnp.asarray(mask)
        fresh_gamma = jnp.broadcast_to(
            jnp.asarray(h['pi'].astype(np.float32))[:, :, None, None],
            self._state.gamma.shape)
        st = self._state
        self._state = MixState(
            gamma=jnp.where(mask_dev[:, None, None, None], fresh_gamma,
                            st.gamma),
            mu=jnp.where(mask_dev[:, None, None, None], 0.0, st.mu).astype(F32),
            eta=jnp.where(mask_dev[:, None, None], 0.0, st.eta).astype(F32),
            q=jnp.where(mask_dev[:, None, None], 0.0, st.q).astype(F32))

    # -------------------------------------------------------------- accessors
    def elbo(self):
        if self.n_models == 1:
            return super().elbo()
        return np.asarray(self._final_elbo)

    def objective(self):
        return self.elbo()

    def get_heritability(self):
        if self.n_models == 1:
            return super().get_heritability()
        sg = np.atleast_1d(self._sigma_g)
        return sg / (sg + np.asarray(self._hyper.sigma_eps))

    def _dict_view_s(self, flat_sx):
        """(S, NB, B) -> {chrom: (m_c, S)} (the grid layout of VIPRSGrid)."""
        lay = self.dataset.layout
        arr = np.asarray(flat_sx)
        per_model = [lay.from_flat(arr[s].reshape(-1))
                     for s in range(arr.shape[0])]
        return {c: np.stack([pm[c] for pm in per_model], axis=1)
                for c in self.chromosomes}

    def update_posterior_moments(self):
        if self.n_models == 1:
            return super().update_posterior_moments()
        vt = np.asarray(jax.vmap(
            lambda h: mix_var_tau(self._n_flat, h))(self._batch_hyper_f32()))
        g = np.asarray(self._state.gamma)                  # (S,K,NB,B)
        mu = np.asarray(self._state.mu)
        zeta = (g * (mu ** 2 + 1.0 / vt)).sum(axis=1)      # (S,NB,B)
        eta = np.asarray(self._state.eta)
        self.pip = self._dict_view_s(g.sum(axis=1))
        self.post_mean_beta = self._dict_view_s(eta)
        self.post_var_beta = self._dict_view_s(zeta - eta ** 2)

    def pseudo_validate(self, test_gdl=None):
        """Per-lane pseudo-R^2 using the cached q (pseudo_metrics.py:130-152)."""
        if self.n_models == 1 or test_gdl is not None \
                or self.validation_std_beta is None or self._state is None:
            return super().pseudo_validate(test_gdl)
        from ..ops import updates
        lay = self.dataset.layout
        r = jnp.asarray(
            lay.to_flat(self.validation_std_beta).reshape(lay.nb,
                                                          lay.block_size), F32)
        if self.mesh is not None:
            from ..parallel.mesh import shard_flat
            r = shard_flat(self.mesh, r, self._ld.nb)
        mask = self._ld.mask
        eta = self._state.eta                              # (S,NB,B)
        ldw = self._state.q + eta
        rb = updates.masked_sum(eta * r[None], mask)
        bsb = updates.masked_sum(eta * ldw, mask)
        return np.asarray(rb) ** 2 / np.asarray(bsb)

    # ------------------------------------------------------------- collapsing
    def collapse_to_model(self, idx):
        """Slice every per-model quantity down to grid point ``idx`` — the
        collapsed object behaves exactly like a fitted VIPRSMix."""
        idx = int(idx)
        self._state = MixState(*(x[idx] for x in self._state))
        self._hyper = MixHyper(
            sigma_eps=np.float64(np.asarray(self._hyper.sigma_eps)[idx]),
            tau_beta=np.asarray(self._hyper.tau_beta)[idx],
            pi=np.asarray(self._hyper.pi)[idx],
            lambda_min=np.float64(np.asarray(self._hyper.lambda_min)[idx]))
        self._sigma_g = float(np.atleast_1d(self._sigma_g)[idx])
        row = {k: float(v[idx]) for k, v in self.grid_table.items()}
        self.fix_params.update({k: v for k, v in row.items()
                                if k in _GRID_KEYS})
        self.optim_result = self.optim_results[idx]
        self.n_models = 1
        self.pip = self.post_mean_beta = self.post_var_beta = None
