"""LDPred-inf: the infinitesimal (ridge) baseline model.

Reference: viprs/model/LDPredInf.py — solves (D + lam I) beta = beta_hat with
lam = M/(N h2) via scipy minres/lsqr over a CSR block-diagonal matrix. Here the
solve is conjugate-gradient on device, with the matrix-vector product expressed
through the blocked LD operator (one batched matmul per iteration).

Operates on standardized effect sizes (the framework's canonical scale).
"""

import logging

import numpy as np
import jax
import jax.numpy as jnp

from .base import BayesPRSModel
from ..ops.cavi_jax import compute_q

logger = logging.getLogger(__name__)


class LDPredInf(BayesPRSModel):

    def __init__(self, dataset, h2=None, float_precision='float32'):
        """
        :param dataset: SummaryStatsDataset with blocked LD.
        :param h2: heritability estimate; inferred via simple LDSC if omitted.
        """
        super().__init__(dataset, float_precision=float_precision)
        if h2 is None:
            from ..data.ldsc import simple_ldsc
            h2 = float(np.clip(simple_ldsc(dataset), 1e-3, 1 - 1e-3))
        self.h2 = h2

    def get_heritability(self):
        return self.h2

    def get_proportion_causal(self):
        return 1.0  # infinitesimal model: every variant is causal

    def fit(self, solver='cg', tol=1e-6, maxiter=500, **solver_kwargs):
        """Solve the ridge system (R + lam I) beta = std_beta on device."""
        assert solver in ('cg',), "only the 'cg' solver is supported."

        lam = self.n_snps / (self.n * self.h2)
        lay = self.dataset.layout
        ld = self.dataset.ld

        # Solve in float64: mixed f32/f64 promotion destabilizes the CG carry
        # under x64 mode, and the baseline solve is not performance-critical.
        b = jnp.asarray(
            lay.to_flat(self.std_beta).reshape(1, lay.nb, lay.block_size),
            jnp.float64)
        mask = ld.mask[None].astype(jnp.float64)

        def matvec(x):
            # R x + lam x, restricted to real variant lanes:
            return (compute_q(ld, x).astype(jnp.float64)
                    + (1.0 + lam) * x) * mask

        x, _ = jax.scipy.sparse.linalg.cg(matvec, b * mask, tol=tol,
                                          maxiter=maxiter, **solver_kwargs)

        self.post_mean_beta = lay.from_flat(np.asarray(x).reshape(-1))
        return self
