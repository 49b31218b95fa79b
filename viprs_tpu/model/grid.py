"""VIPRSGrid — fit a grid of VIPRS models over hyperparameter settings.

The reference fits grid points either serially/pathwise (VIPRSGrid.py:128-226)
or simultaneously via the ``e_step_grid`` kernel with (M, n_models) matrices and
an active-model index (e_step.hpp:555-647). Here the simultaneous mode is the
natural one — the grid axis S is the batch axis of the blocked CAVI kernel and
converged models are masked out in-graph — and is the default here.
``pathwise=True`` reproduces the reference's warm-started serial schedule.
"""

import logging

import numpy as np
import jax.numpy as jnp

from . import _dispatch
from .viprs import VIPRS, _logit
from ..ops.cavi_jax import CaviState, Hyper
from ..ops.updates import FixMask
from ..utils import optimize as opt
from ..utils.optimize import OptimizeResult, summarize_statuses

logger = logging.getLogger(__name__)

_GRID_KEYS = ('sigma_epsilon', 'tau_beta', 'pi', 'lambda_min')
_HYPER_FIELD = {'sigma_epsilon': 'sigma_eps', 'tau_beta': 'tau_beta',
                'pi': 'pi', 'lambda_min': 'lambda_min'}


class VIPRSGrid(VIPRS):
    """
    :ivar grid_table: {hyperparameter: (n_models,) array} settings.
    :ivar validation_result: {column: (n_models,) array} per-model fit
        outcomes (``to_validation_table()`` gives it as a DataFrame).
    :ivar optim_results: list of OptimizeResult, one per model.
    :ivar n_models: number of grid points.
    """

    def __init__(self, dataset, grid, **kwargs):
        from ..gridsearch.grid import grid_columns
        self.grid_table = grid_columns(grid)
        self.n_models = len(next(iter(self.grid_table.values())))
        self._n_grid_rows = self.n_models
        assert self.n_models >= 1
        self.validation_result = None
        self.optim_results = []

        super().__init__(dataset, **kwargs)
        self._S = self.n_models

    # ------------------------------------------------------------- grid status
    @property
    def models_to_keep(self):
        return np.logical_or(~self.terminated_models, self.converged_models)

    @property
    def converged_models(self):
        return np.array([r.success for r in self.optim_results])

    @property
    def terminated_models(self):
        return np.array([r.stop_iteration for r in self.optim_results])

    @property
    def valid_terminated_models(self):
        return np.array([r.valid_optim_result for r in self.optim_results])

    def to_validation_table(self):
        if self.validation_result is None or len(self.validation_result) < 1:
            raise ValueError("Validation result is not set!")
        import pandas as pd
        return pd.DataFrame(self.validation_result)

    def write_validation_result(self, v_filename, sep="\t"):
        self.to_validation_table().to_csv(v_filename, index=False, sep=sep)

    # ---------------------------------------------------------- initialization
    def initialize_theta(self, theta_0=None):
        """Base initialization, then per-model overrides from the grid rows."""
        if self._S != self._n_grid_rows:
            # collapsed to a single model (post-selection/BMA refits): the
            # winning hyperparameters live in fix_params now.
            return super().initialize_theta(theta_0)
        pi, sigma_eps, tau_beta = self._resolve_theta0(theta_0)
        lam = float(self.fix_params.get('lambda_min', self.lambda_min))
        S = self._S
        h = {'sigma_eps': np.full(S, sigma_eps), 'tau_beta': np.full(S, tau_beta),
             'pi': np.full(S, pi), 'lambda_min': np.full(S, lam)}
        for key in _GRID_KEYS:
            if key in self.grid_table:
                h[_HYPER_FIELD[key]] = self.grid_table[key].copy()
        self._hyper = Hyper(**h)
        self._sigma_g = np.zeros(S)
        self._update_fix_mask()

    def _update_fix_mask(self):
        S = self._S
        if S != self._n_grid_rows:
            return self._update_fix_mask_single()
        gridded = set(k for k in _GRID_KEYS if k in self.grid_table)
        fixed = gridded | set(self.fix_params)
        # host numpy (driver-side reads must not block on the device queue):
        self._fix_mask = FixMask(
            sigma_eps=np.full(S, 'sigma_epsilon' in fixed, bool),
            tau_beta=np.full(S, 'tau_beta' in fixed, bool),
            pi=np.full(S, 'pi' in fixed, bool))

    # -------------------------------------------------------------------- fit
    def fit(self, pathwise=False, **fit_kwargs):
        """Fit the grid. ``pathwise=False`` (default): all models advance
        simultaneously with converged-model masking. ``pathwise=True``: serial
        warm-started fits (the reference default schedule, VIPRSGrid.py:194-226).
        """
        if self.n_models == 1:
            # collapsed model (post-selection refit): plain VIPRS fit
            # (reference VIPRSGrid.py:145-146).
            return VIPRS.fit(self, **fit_kwargs)
        if pathwise:
            return self._fit_pathwise(**fit_kwargs)

        super().fit(**fit_kwargs)
        if fit_kwargs.get('compile_only'):
            return self    # viprs_warmup path: nothing was run
        self._populate_grid_results()
        return self

    def _populate_optim_result(self, res):
        self.optim_results = summarize_statuses(
            np.asarray(res.status), np.asarray(res.final_elbo), np.asarray(res.nit))
        # Aggregate result (for the base-class API):
        self.optim_result = OptimizeResult()
        self.optim_result.nit = int(np.asarray(res.nit).max())
        self.optim_result.fun = float(np.asarray(res.final_elbo).max())
        self.optim_result.stop_iteration = True
        self.optim_result.success = bool(np.any([r.success for r in self.optim_results]))
        # Grid-level error (drives the CLI's gated lambda_min retry): every
        # grid point terminated with a hard error.
        self.optim_result.error_on_termination = \
            not bool(np.any(self.valid_terminated_models))
        self.optim_result.message = (
            'Grid fit complete.' if not self.optim_result.error_on_termination
            else 'All grid points terminated with errors: '
                 + '; '.join(sorted({r.message for r in self.optim_results})))

    def _finalize_history(self, res):
        hist = np.asarray(res.elbo_hist)
        n_total = int(np.asarray(res.n_iter_total))
        self.history['ELBO'] = [row for row in hist[:n_total + 1]]

    def _populate_grid_results(self):
        self.validation_result = dict(self.grid_table)
        self.validation_result['ELBO'] = np.asarray(self._last_result.final_elbo)
        self.validation_result['Converged'] = self.converged_models
        self.validation_result['Optimization_message'] = \
            [r.message for r in self.optim_results]

    def _fit_pathwise(self, **fit_kwargs):
        """Serial warm-started schedule: model i starts from model i-1's state."""
        S = self._S
        self.initialize(fit_kwargs.pop('theta_0', None), fit_kwargs.pop('param_0', None))
        self._refresh_inputs()

        logits = np.asarray(self._state.logits).copy()
        mu = np.asarray(self._state.mu).copy()
        eta = np.asarray(self._state.eta).copy()
        qv = np.asarray(self._state.q).copy()
        hyper = {f: np.atleast_1d(np.asarray(getattr(self._hyper, f))).copy()
                 for f in self._hyper._fields}
        sigma_g = np.zeros(S)
        elbos = np.zeros(S)
        nits = np.zeros(S, int)
        statuses = np.zeros(S, int)
        self.optim_results = []

        # run S sequential single-model fits, warm-starting each from the last:
        import viprs_tpu.ops.em_loop as em
        prev = None
        for s in range(S):
            warm = prev if prev is not None else (logits[s], mu[s], eta[s], qv[s])
            st = CaviState(logits=jnp.asarray(warm[0])[None],
                           mu=jnp.asarray(warm[1])[None],
                           eta=jnp.asarray(warm[2])[None],
                           q=jnp.asarray(warm[3])[None])
            h1 = Hyper(*(jnp.asarray(hyper[f][s:s + 1], jnp.float32)
                         for f in self._hyper._fields))
            f1 = FixMask(*(jnp.asarray(np.asarray(x)[s:s + 1])
                           for x in self._fix_mask))
            res = em.em_fit(self._ld, st, self._std_beta_flat, self._n_flat,
                            h1, f1, n_sample=float(self.n), m_total=float(self.m),
                            init_elbo=jnp.zeros(1, jnp.float64),
                            active0=jnp.ones(1, bool),
                            max_iter=fit_kwargs.get('max_iter', 1000),
                            min_iter=fit_kwargs.get('min_iter', 3),
                            f_abs_tol=fit_kwargs.get('f_abs_tol', 1e-6),
                            x_abs_tol=fit_kwargs.get('x_abs_tol', 1e-6),
                            patience=fit_kwargs.get('patience', 10),
                            tile=self.tile,
                            sweep=_dispatch.select_sweep_impl(
                                1, self.mesh, fit_kwargs.get('sweep_impl'),
                                block_size=self._ld.block_size,
                                tile=self.tile))
            logits[s] = np.asarray(res.state.logits[0])
            mu[s] = np.asarray(res.state.mu[0])
            eta[s] = np.asarray(res.state.eta[0])
            qv[s] = np.asarray(res.state.q[0])
            for f in self._hyper._fields:
                hyper[f][s] = float(np.asarray(getattr(res.hyper, f))[0])
            sigma_g[s] = float(np.asarray(res.sigma_g)[0])
            elbos[s] = float(np.asarray(res.final_elbo)[0])
            nits[s] = int(np.asarray(res.nit)[0])
            statuses[s] = int(np.asarray(res.status)[0])
            self.optim_results.append(OptimizeResult.from_status(
                statuses[s], elbos[s], nits[s]))
            prev = (logits[s], mu[s], eta[s], qv[s])

        self._state = CaviState(logits=jnp.asarray(logits), mu=jnp.asarray(mu),
                                eta=jnp.asarray(eta), q=jnp.asarray(qv))
        self._hyper = Hyper(**{f: hyper[f] for f in self._hyper._fields})
        self._sigma_g = sigma_g
        self.update_posterior_moments()

        self.validation_result = dict(self.grid_table)
        self.validation_result['ELBO'] = elbos
        self.validation_result['Converged'] = self.converged_models
        self.validation_result['Optimization_message'] = \
            [r.message for r in self.optim_results]

        self.optim_result = OptimizeResult()
        self.optim_result.nit = int(nits.sum())
        self.optim_result.stop_iteration = True
        self.optim_result.success = bool(self.converged_models.any())
        self.optim_result.error_on_termination = \
            not bool(np.any(self.valid_terminated_models))
        self.optim_result.fun = float(elbos.max())
        self.optim_result.message = (
            'Grid fit complete.' if not self.optim_result.error_on_termination
            else 'All grid points terminated with errors: '
                 + '; '.join(sorted({r.message for r in self.optim_results})))
        return self

    # ------------------------------------------------------------- collapsing
    def collapse_to_model(self, idx):
        """Slice every per-model quantity down to grid point ``idx``
        (used by select_best_model, reference grid_utils.py:68-114)."""
        idx = int(idx)
        self._state = CaviState(*(x[idx:idx + 1] for x in self._state))
        self._hyper = Hyper(*(np.atleast_1d(np.asarray(x))[idx:idx + 1]
                              for x in self._hyper))
        self._sigma_g = np.atleast_1d(self._sigma_g)[idx:idx + 1]
        self._S = 1
        self.n_models = 1
        self.set_fixed_params({k: float(v[idx])
                               for k, v in self.grid_table.items()
                               if k in _GRID_KEYS})
        self._update_fix_mask_single()
        self.update_posterior_moments()

    def _update_fix_mask_single(self):
        self._fix_mask = FixMask(
            sigma_eps=np.full(1, 'sigma_epsilon' in self.fix_params, bool),
            tau_beta=np.full(1, 'tau_beta' in self.fix_params, bool),
            pi=np.full(1, 'pi' in self.fix_params, bool))
