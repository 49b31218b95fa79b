"""BayesPRSModel — base class for summary-statistics Bayesian PRS models.

API parity with the reference's viprs/model/BayesPRSModel.py (construction from a
harmonized dataset, posterior slots, prediction, allele-aware harmonization of
external effect tables, table I/O, PUMAS splitting, pseudo-validation), adapted to
this framework's SummaryStatsDataset.
"""

import logging
import os.path as osp

import numpy as np

from ..data.dataset import SummaryStatsDataset
from ..utils.compute import expand_column_names, dict_max, dict_concat

logger = logging.getLogger(__name__)


class BayesPRSModel:
    """Base class holding the harmonized dataset and posterior summaries.

    :ivar dataset: a SummaryStatsDataset (or a GWADataLoader, which is converted).
    :ivar pip: {chrom: array} posterior inclusion probabilities (after fit).
    :ivar post_mean_beta: {chrom: array} posterior mean effect sizes.
    :ivar post_var_beta: {chrom: array} posterior variances.
    """

    def __init__(self, dataset, float_precision='float32'):
        if not isinstance(dataset, SummaryStatsDataset):
            to_ds = getattr(dataset, 'to_summary_dataset', None)
            if to_ds is None:
                raise TypeError(
                    "dataset must be a SummaryStatsDataset or expose .to_summary_dataset()")
            dataset = to_ds()

        self.dataset = dataset
        self.float_precision = float_precision
        self.float_eps = np.finfo(float_precision).eps
        self.shapes = dict(dataset.shapes)

        self.n_per_snp = {c: np.asarray(v, dtype=np.float64)
                          for c, v in dataset.n_per_snp.items()}
        self.std_beta = {c: np.asarray(v, dtype=np.float64)
                         for c, v in dataset.std_beta.items()}
        self.validation_std_beta = None
        self._sample_size = dict_max(self.n_per_snp)

        self._pip = None
        self._post_mean_beta = None
        self._post_var_beta = None

    def _mesh_context(self):
        """Context manager activating this model's device mesh for jitted
        calls (no-op for single-device models / models without a mesh)."""
        import contextlib
        mesh = getattr(self, 'mesh', None)
        if mesh is None:
            return contextlib.nullcontext()
        import jax
        return jax.set_mesh(mesh)

    # --------------------------------------------------------------- properties
    # pip / post_mean_beta / post_var_beta are lazy: fits keep the posterior
    # on device and materialize host copies on first access (one fused device
    # computation + one transfer), so fit() itself never pays the transfer.
    # Internal fast paths that only need the means check the backing fields
    # (``_post_mean_beta``) to preserve the means-only materialization.
    @property
    def pip(self):
        if self._pip is None:
            self._materialize_posterior_moments()
        return self._pip

    @pip.setter
    def pip(self, value):
        self._pip = value

    @property
    def post_mean_beta(self):
        if self._post_mean_beta is None:
            self._materialize_posterior_moments()
        return self._post_mean_beta

    @post_mean_beta.setter
    def post_mean_beta(self, value):
        self._post_mean_beta = value

    @property
    def post_var_beta(self):
        if self._post_var_beta is None:
            self._materialize_posterior_moments()
        return self._post_var_beta

    @post_var_beta.setter
    def post_var_beta(self, value):
        self._post_var_beta = value

    @property
    def gdl(self):
        """Alias retained for users migrating from the reference API."""
        return self.dataset

    @property
    def chromosomes(self):
        return sorted(self.shapes.keys())

    @property
    def m(self) -> int:
        return int(sum(self.shapes.values()))

    @property
    def n(self):
        return self._sample_size

    @property
    def n_snps(self) -> int:
        return self.m

    # --------------------------------------------------------------- input data
    def initialize_input_data_arrays(self):
        """(Re)build the marginal-statistics inputs (``std_beta``,
        ``n_per_snp``) from the attached dataset
        (reference BayesPRSModel.py:118-142)."""
        logger.debug("> Initializing the input data arrays (marginal statistics).")
        self.n_per_snp = {c: np.asarray(v, dtype=np.float64)
                          for c, v in self.dataset.n_per_snp.items()}
        self.std_beta = {c: np.asarray(v, dtype=np.float64)
                         for c, v in self.dataset.std_beta.items()}
        self._sample_size = dict_max(self.n_per_snp)

    def set_validation_sumstats(self, sumstats):
        """Attach validation summary statistics for pseudo-validation.

        (The reference stubs this out, BayesPRSModel.py:144-149; here it is
        implemented.) Accepts either a {chrom: standardized-beta array} dict
        aligned with this model's variants, or a SumstatsTable / DataFrame with
        SNP/A1/A2 columns to be allele-aware harmonized (flips change sign,
        missing variants contribute 0).
        """
        if isinstance(sumstats, dict):
            for c, sz in self.shapes.items():
                if c not in sumstats or len(sumstats[c]) != sz:
                    raise ValueError(
                        f"validation std_beta for chromosome {c} is missing or "
                        f"has the wrong length")
            self.validation_std_beta = {c: np.asarray(sumstats[c], np.float64)
                                        for c in self.shapes}
            return self

        from ..data.harmonize import merge_snp_tables

        table = getattr(sumstats, 'table', sumstats).copy()
        if 'STD_BETA' not in table.columns:
            get_corr = getattr(sumstats, 'get_snp_pseudo_corr', None)
            if get_corr is None:
                raise ValueError("validation sumstats need a STD_BETA column "
                                 "or a get_snp_pseudo_corr() method")
            table['STD_BETA'] = get_corr()
        snp_tables = (self.dataset.snp_table
                      if self.dataset.snp_table is not None
                      else self.dataset.default_snp_table())
        out = {}
        for c, tab in snp_tables.items():
            merged = merge_snp_tables(tab[['SNP', 'A1', 'A2']], table,
                                      how='left', signed_statistics=['STD_BETA'])
            out[c] = merged['STD_BETA'].fillna(0.).values
        self.validation_std_beta = out
        return self

    # ----------------------------------------------------------------- splitting
    def split_gwas_sumstats(self, prop_train=0.8, seed=None, **kwargs):
        """PUMAS-style summary-statistics train/validation split
        (reference BayesPRSModel.py:151-187)."""
        from ..data.split import sumstats_train_test_split

        logger.debug("> Splitting GWAS summary statistics (PUMAS), "
                     f"prop_train={prop_train}")
        split = sumstats_train_test_split(self.dataset, prop_train=prop_train,
                                          seed=seed, **kwargs)
        self.std_beta = {c: split[c]['train_beta'] for c in self.chromosomes}
        self.n_per_snp = {c: self.n_per_snp[c] * prop_train for c in self.chromosomes}
        self.validation_std_beta = {c: split[c]['test_beta'] for c in self.chromosomes}

    def restore_full_sumstats(self):
        """Undo a PUMAS split (the CLI refits the selected model on the full
        statistics; reference bin/viprs_fit:557-570)."""
        self.std_beta = {c: np.asarray(v, dtype=np.float64)
                         for c, v in self.dataset.std_beta.items()}
        self.n_per_snp = {c: np.asarray(v, dtype=np.float64)
                          for c, v in self.dataset.n_per_snp.items()}
        self.validation_std_beta = None

    # ------------------------------------------------------------------- fitting
    def fit(self, *args, **kwargs):
        raise NotImplementedError

    def get_proportion_causal(self):
        raise NotImplementedError

    def get_heritability(self):
        raise NotImplementedError

    # ---------------------------------------------------------------- posteriors
    def get_pip(self):
        return self.pip

    def get_posterior_mean_beta(self):
        return self.post_mean_beta

    def get_posterior_variance_beta(self):
        return self.post_var_beta

    def _materialize_posterior_moments(self, means_only=False):
        """Hook for subclasses that defer posterior-moment materialization
        (e.g. simultaneous grid fits keep the (S, M) state device-side until a
        consumer actually needs host arrays). Default: no-op."""

    # ---------------------------------------------------------------- prediction
    def predict(self, test_gdl=None):
        """Linear scoring (genotype . beta) on the training or new samples."""
        if self._post_mean_beta is None:
            self._materialize_posterior_moments(means_only=True)
        if self._post_mean_beta is None:
            raise ValueError("The posterior means for BETA are not set. Call `.fit()` first.")

        if test_gdl is None:
            test_gdl = self.dataset
            post_mean_beta = self.post_mean_beta
        else:
            _, post_mean_beta, _ = self.harmonize_data(gdl=test_gdl)

        score = getattr(test_gdl, 'score', None) or getattr(test_gdl, 'predict', None)
        if score is None:
            raise ValueError("The provided data object does not support scoring "
                             "(no genotype data attached).")
        return score(post_mean_beta)

    # ------------------------------------------------------------- harmonization
    def harmonize_data(self, gdl=None, parameter_table=None):
        """Align posterior effect sizes with another dataset's variant table,
        handling allele flips (reference BayesPRSModel.py:252-331)."""
        from ..data.harmonize import merge_snp_tables

        if gdl is None and parameter_table is None:
            return None

        if gdl is None:
            gdl = self.dataset

        if parameter_table is None:
            parameter_table = self.to_table(per_chromosome=True)
        else:
            parameter_table = {c: parameter_table.loc[parameter_table['CHR'] == c]
                               for c in parameter_table['CHR'].unique()}

        snp_tables = (gdl.snp_table if getattr(gdl, 'snp_table', None) is not None
                      else gdl.default_snp_table())

        pip, post_mean_beta, post_var_beta = {}, {}, {}
        common = sorted(set(snp_tables).intersection(parameter_table))

        for c in common:
            ptab = parameter_table[c]
            pip_cols = [col for col in ptab.columns if 'PIP' in col]
            var_cols = [col for col in ptab.columns if 'VAR_BETA' in col]
            mean_cols = [col for col in ptab.columns
                         if 'BETA' in col and col not in var_cols]

            c_df = merge_snp_tables(snp_tables[c][['SNP', 'A1', 'A2']], ptab,
                                    how='left', signed_statistics=mean_cols)
            if len(c_df) < len(snp_tables[c]):
                raise ValueError(
                    "The parameter table could not be aligned with the reference SNP "
                    "table; check reference vs. alternative allele assignments.")

            post_mean_beta[c] = c_df[mean_cols].fillna(0.).values.squeeze()
            if set(pip_cols) & set(c_df.columns):
                pip[c] = c_df[pip_cols].fillna(0.).values.squeeze()
            if set(var_cols) & set(c_df.columns):
                post_var_beta[c] = c_df[var_cols].fillna(0.).values.squeeze()

        return (pip or None, post_mean_beta, post_var_beta or None)

    # ---------------------------------------------------------------- table I/O
    def to_table(self, col_subset=('CHR', 'SNP', 'POS', 'A1', 'A2'),
                 per_chromosome=False):
        """Posterior estimates as (per-chromosome) DataFrames
        (reference BayesPRSModel.py:333-373)."""
        if self._post_mean_beta is None:
            self._materialize_posterior_moments()
        if self._post_mean_beta is None:
            raise RuntimeError("The posterior means for BETA are not set. Call `.fit()` first.")

        snp_tables = (self.dataset.snp_table if self.dataset.snp_table is not None
                      else self.dataset.default_snp_table())
        tables = {}
        for c in self.chromosomes:
            base = snp_tables[c]
            cols = [col for col in col_subset if col in base.columns]
            tab = base[cols].copy().reset_index(drop=True)
            if 'CHR' not in tab.columns:
                tab.insert(0, 'CHR', c)

            pm = np.atleast_2d(np.asarray(self.post_mean_beta[c]).T).T
            for i, name in enumerate(expand_column_names('BETA', pm.shape)):
                tab[name] = pm[:, i]
            if self.pip is not None:
                pp = np.atleast_2d(np.asarray(self.pip[c]).T).T
                for i, name in enumerate(expand_column_names('PIP', pp.shape)):
                    tab[name] = pp[:, i]
            if self.post_var_beta is not None:
                pv = np.atleast_2d(np.asarray(self.post_var_beta[c]).T).T
                for i, name in enumerate(expand_column_names('VAR_BETA', pv.shape)):
                    tab[name] = pv[:, i]
            tables[c] = tab

        if per_chromosome:
            return tables
        import pandas as pd
        return pd.concat([tables[c] for c in self.chromosomes], ignore_index=True)

    # ----------------------------------------------------------- pseudo metrics
    def pseudo_validate(self, test_gdl=None):
        """Summary-statistics-only R^2 (reference BayesPRSModel.py:375-410)."""
        from ..eval.pseudo import pseudo_r2, _streamlined_pseudo_r2

        if self._post_mean_beta is None:
            self._materialize_posterior_moments(means_only=True)
        assert self._post_mean_beta is not None, \
            "The posterior means for BETA are not set. Call `.fit()` first."
        assert self.validation_std_beta is not None or test_gdl is not None, (
            "Provide a validation dataset or run split_gwas_sumstats() first.")

        if test_gdl is not None:
            return pseudo_r2(test_gdl, self.to_table(per_chromosome=False))

        if hasattr(self, 'q_dict'):
            q = self.q_dict()
            ldw_prs = {c: np.asarray(q[c]) + np.asarray(self.post_mean_beta[c])
                       for c in self.shapes}
        else:
            from ..ops.cavi_jax import compute_q
            import jax.numpy as jnp
            lay = self.dataset.layout
            beta_flat = lay.to_flat(self.post_mean_beta)
            qf = compute_q(self.dataset.ld,
                           jnp.asarray(beta_flat.reshape(1, lay.nb, lay.block_size),
                                       jnp.float32))
            q = lay.from_flat(np.asarray(qf).reshape(-1))
            ldw_prs = {c: q[c] + np.asarray(self.post_mean_beta[c]) for c in self.shapes}

        return _streamlined_pseudo_r2(
            dict_concat(self.validation_std_beta),
            dict_concat(self.post_mean_beta),
            dict_concat(ldw_prs))

    # ------------------------------------------------------------- parameter I/O
    def set_model_parameters(self, parameter_table):
        self.pip, self.post_mean_beta, self.post_var_beta = \
            self.harmonize_data(parameter_table=parameter_table)

    def read_inferred_parameters(self, f_names, sep=r"\s+"):
        import pandas as pd
        if isinstance(f_names, str):
            f_names = [f_names]
        tables = [pd.read_csv(f, sep=sep) for f in f_names]
        if not tables:
            raise FileNotFoundError
        self.set_model_parameters(pd.concat(tables))

    def write_inferred_parameters(self, f_name, per_chromosome=False, sep="\t"):
        tables = self.to_table(per_chromosome=per_chromosome)
        ext = '' if '.fit' in f_name else '.fit'
        if per_chromosome:
            for c, tab in tables.items():
                tab.to_csv(osp.join(f_name, f'chr_{c}.fit'), sep=sep, index=False)
        else:
            tables.to_csv(f_name + ext, sep=sep, index=False)
