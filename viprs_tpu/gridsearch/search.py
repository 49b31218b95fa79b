"""Post-fit model selection and combination over a fitted grid.

Parity with the reference's gridsearch/grid_utils.py (select_best_model over
{ELBO, validation, pseudo_validation} criteria; ELBO-softmax Bayesian model
averaging) and a `GridSearch` facade covering HyperparameterSearch.py's role —
here the "process-parallel grid search" is simply the simultaneous vmapped
grid fit, so `GridSearch` wraps VIPRSGrid + selection.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)


def select_best_model(viprs_grid_model, validation_gdl=None, criterion='ELBO'):
    """Select the best grid point and collapse the model to it.

    :param criterion: one of ('ELBO', 'validation', 'pseudo_validation').
    """
    assert criterion in ('ELBO', 'validation', 'pseudo_validation')

    if criterion == 'validation':
        assert validation_gdl is not None, \
            "A validation dataset must be provided for the validation criterion."
    elif (criterion == 'pseudo_validation' and validation_gdl is None
          and viprs_grid_model.validation_std_beta is None):
        raise ValueError("A validation dataset or validation standardized betas "
                         "are required for the pseudo_validation criterion.")

    models_converged = viprs_grid_model.valid_terminated_models
    if np.sum(models_converged) < 2:
        raise ValueError("Less than two models converged successfully. "
                         "Cannot perform model selection.")

    if criterion == 'ELBO':
        scores = np.array(viprs_grid_model.elbo(), dtype=np.float64)
        scores[~models_converged] = -np.inf
        best_idx = int(np.argmax(scores))
    elif criterion == 'validation':
        from ..eval.continuous import r2
        prs = viprs_grid_model.predict(test_gdl=validation_gdl)
        phenotype = validation_gdl.phenotype
        scores = np.array([r2(phenotype, prs[:, i])
                           for i in range(viprs_grid_model.n_models)])
        scores[~models_converged] = -np.inf
        viprs_grid_model.validation_result['Validation_R2'] = scores
        best_idx = int(np.argmax(scores))
    else:
        scores = np.array(viprs_grid_model.pseudo_validate(validation_gdl))
        scores[~models_converged] = -np.inf
        viprs_grid_model.validation_result['Pseudo_Validation_R2'] = scores
        best_idx = int(np.argmax(np.nan_to_num(scores, nan=0., neginf=0., posinf=0.)))

    logger.info("> Based on the %s criterion, selected model: %d", criterion, best_idx)

    viprs_grid_model.collapse_to_model(best_idx)
    return viprs_grid_model


def bayesian_model_average(viprs_grid_model, normalization='softmax'):
    """ELBO-weighted averaging of the variational parameters across valid grid
    points, followed by an unconstrained M-step refresh of the hyperparameters
    (reference grid_utils.py:121-193).
    """
    if viprs_grid_model.n_models < 2:
        return viprs_grid_model

    valid = viprs_grid_model.valid_terminated_models
    if np.sum(valid) < 1:
        raise ValueError("No models converged successfully. Cannot average models.")
    keep = np.where(valid)[0]

    elbos = np.asarray(viprs_grid_model.elbo(), dtype=np.float64)

    # Normalize over the KEPT models only: softmax over the full vector
    # followed by renormalization is mathematically identical, but underflows
    # to 0/0 when an *invalid* model's ELBO dominates the max by >~700 nats
    # (negative-MSE lanes can report much higher ELBOs than the converged
    # ones — seen in the multi-host grid scenario).
    if normalization == 'softmax':
        from scipy.special import softmax
        weights_keep = softmax(elbos[keep])
    elif normalization == 'sum':
        weights_keep = elbos[keep] - elbos[keep].min() + 1.
        weights_keep /= weights_keep.sum()
    else:
        raise KeyError("Normalization scheme not recognized. "
                       "Valid options are: `softmax`, `sum`. Got: {}".format(normalization))

    logger.info("Averaging PRS models with weights: %s", weights_keep)

    import jax
    import jax.numpy as jnp
    from ..ops.cavi_jax import CaviState, Hyper
    from ..ops import updates

    st = viprs_grid_model._state
    w_full = np.zeros(len(elbos))
    w_full[keep] = weights_keep

    # Device-side averaging + unconstrained M-step (grid_utils.py:163-184) —
    # only the collapsed S=1 state and four scalars leave the device.
    @jax.jit
    def _bma(st: CaviState, w, var_tau, sb, mask, lam):
        wbc = w[:, None, None].astype(jnp.float32)
        gamma_avg = (st.gamma * wbc).sum(axis=0)
        mu_avg = (st.mu * wbc).sum(axis=0)
        q_avg = (st.q * wbc).sum(axis=0)
        var_tau_avg = (var_tau * wbc).sum(axis=0)
        eta_avg = gamma_avg * mu_avg
        zeta_avg = gamma_avg * (mu_avg ** 2 + 1.0 / var_tau_avg)

        m_total = mask.sum().astype(jnp.float64)
        pi_new = (gamma_avg * mask).sum().astype(jnp.float64) / m_total
        tau_new = pi_new * m_total / (zeta_avg * mask).sum().astype(jnp.float64)
        sigma_g = (((1.0 + lam) * zeta_avg + q_avg * eta_avg)
                   * mask).sum().astype(jnp.float64)
        sig_e = 1.0 - 2.0 * (sb * eta_avg * mask).sum().astype(jnp.float64) \
            + sigma_g

        g_clip = jnp.clip(gamma_avg, 1e-8, 1.0 - 1e-8)
        new_state = CaviState(
            logits=(jnp.log(g_clip) - jnp.log1p(-g_clip)).astype(jnp.float32)[None],
            mu=mu_avg[None], eta=eta_avg[None], q=q_avg[None])
        return new_state, pi_new, tau_new, sigma_g, sig_e

    h32 = viprs_grid_model._hyper_f32()
    var_tau_dev = updates.compute_var_tau(viprs_grid_model._n_flat, h32)
    lam = float(np.atleast_1d(viprs_grid_model._hyper.lambda_min)[keep[0]])
    new_state, pi_j, tau_j, sg_j, se_j = _bma(
        st, jnp.asarray(w_full), var_tau_dev, viprs_grid_model._std_beta_flat,
        viprs_grid_model._ld.mask, lam)

    pi_new = float(np.asarray(pi_j))
    tau_beta_new = float(np.asarray(tau_j))
    sigma_g = float(np.asarray(sg_j))
    sigma_eps_new = float(np.asarray(se_j))
    viprs_grid_model._state = new_state
    viprs_grid_model._hyper = Hyper(
        sigma_eps=np.array([sigma_eps_new]), tau_beta=np.array([tau_beta_new]),
        pi=np.array([pi_new]), lambda_min=np.array([lam]))
    viprs_grid_model._sigma_g = np.array([sigma_g])
    viprs_grid_model._S = 1
    viprs_grid_model.n_models = 1
    viprs_grid_model._update_fix_mask_single()
    viprs_grid_model.update_posterior_moments()

    return viprs_grid_model


class GridSearch:
    """Facade replicating the reference's process-parallel `GridSearch`
    (HyperparameterSearch.py:197-351): here the grid is fit simultaneously
    (the vmapped model axis) for grid-capable models, then the best model is
    selected by the criterion.

    Like the reference — whose search fans out *any* PRS model with
    `fix_params` set per grid row (HyperparameterSearch.py:16-64,104-111) —
    every built-in model class fits its grid SIMULTANEOUSLY: VIPRS via
    VIPRSGrid, VIPRSMix via VIPRSMixGrid (the batched mixture loop,
    ops/mix_em_loop.py:mix_em_fit_batch). Unknown model classes fall back to
    one fit per grid row with the row pinned via ``fix_params``, scored under
    the same criterion.
    """

    def __init__(self, dataset, grid, criterion='ELBO', validation_gdl=None,
                 model_class=None, **model_kwargs):
        assert criterion in ('ELBO', 'training_objective', 'validation',
                             'pseudo_validation')
        from ..model.grid import VIPRSGrid
        from ..model.mix import VIPRSMix
        from ..model.mix_grid import VIPRSMixGrid
        self.criterion = 'ELBO' if criterion == 'training_objective' else criterion
        self.validation_gdl = validation_gdl
        cls = model_class or VIPRSGrid
        if isinstance(cls, type) and issubclass(cls, VIPRSMix) \
                and not issubclass(cls, VIPRSMixGrid):
            cls = VIPRSMixGrid
        self._simultaneous = isinstance(cls, type) and \
            issubclass(cls, (VIPRSGrid, VIPRSMixGrid))
        if self._simultaneous:
            self.model = cls(dataset, grid, **model_kwargs)
        else:
            self.model = None
            self._dataset = dataset
            self._grid = grid
            self._model_class = cls
            self._model_kwargs = model_kwargs
        self.validation_result = None

    def _score(self, model):
        if self.criterion == 'ELBO':
            return float(model.objective())
        if self.criterion == 'validation':
            from ..eval.continuous import r2
            prs = np.asarray(model.predict(test_gdl=self.validation_gdl)).reshape(-1)
            return float(r2(self.validation_gdl.phenotype, prs))
        return float(model.pseudo_validate(self.validation_gdl))

    def _fit_pathwise(self, **fit_kwargs):
        import pandas as pd

        rows = self._grid.combine_grids()
        fitted, scores = [], []
        for i, row in enumerate(rows):
            m = self._model_class(self._dataset, fix_params=dict(row),
                                  **self._model_kwargs)
            try:
                m.fit(**fit_kwargs)
                score = self._score(m)
            except Exception as e:
                # mirrors the reference worker's skip-on-failure semantics
                # (HyperparameterSearch.py:50-53)
                logger.warning("Grid row %d failed: %s", i, e)
                m, score = None, -np.inf
            fitted.append(m)
            scores.append(score)

        if not any(m is not None for m in fitted):
            raise ValueError("No grid row produced a successfully fitted model.")

        self.validation_result = pd.DataFrame(rows)
        self.validation_result[
            {'ELBO': 'ELBO', 'validation': 'Validation_R2',
             'pseudo_validation': 'Pseudo_Validation_R2'}[self.criterion]
        ] = scores
        best_idx = int(np.argmax(np.nan_to_num(scores, nan=-np.inf)))
        logger.info("> Based on the %s criterion, selected model: %d",
                    self.criterion, best_idx)
        self.model = fitted[best_idx]
        return self.model

    def fit(self, **fit_kwargs):
        if not self._simultaneous:
            return self._fit_pathwise(**fit_kwargs)
        self.model.fit(**fit_kwargs)
        best = select_best_model(self.model, validation_gdl=self.validation_gdl,
                                 criterion=self.criterion)
        self.validation_result = self.model.to_validation_table()
        return best
