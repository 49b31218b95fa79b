"""Every float32 product on the fit path is pinned to full precision.

A backend may lower a float32 dot at its default precision as TF32 (about
three decimal digits); the fit converges at 1e-6. This walks the jaxpr of
each fit-path program, into every nested loop, cond and call, and asserts
that each ``dot_general`` with a float32 operand carries
``Precision.HIGHEST`` on both sides.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import lax
from jax.extend.core import ClosedJaxpr, Jaxpr

from viprs_tpu.ops.block_ld import pack_dense_blocks
from viprs_tpu.ops.cavi_jax import (CaviState, Hyper, cavi_sweep, compute_q,
                                    refresh_q)
from viprs_tpu.ops import em_loop, mix_em_loop, updates
from viprs_tpu.ops.cavi_mix import MixState, MixHyper, cavi_sweep_mixture
from viprs_tpu.data.simulate import simulate_sumstats_blocks

HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, Jaxpr):
                yield x


def f32_dots(jaxpr):
    """(precision, operand dtypes) of every float32 dot_general, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == 'dot_general':
            dts = [v.aval.dtype for v in eqn.invars]
            if any(d == jnp.float32 for d in dts):
                out.append((eqn.params['precision'], dts))
        for sub in _sub_jaxprs(eqn):
            out.extend(f32_dots(sub))
    return out


@pytest.fixture(scope='module')
def problem():
    # the 300-variant block spans three 128-tiles: coupling tiles exist, so
    # _off_contrib / refresh_q are traced too
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(100, 300), h2=0.3,
                                   prop_causal=0.05, seed=4)
    ld, lay = pack_dense_blocks(sim['ld_blocks'], block_size=128,
                                quantize=True)
    assert ld.n_off > 0
    nb, B = ld.nb, ld.block_size
    sb = jnp.asarray(lay.to_flat(sim['std_beta']).reshape(nb, B), jnp.float32)
    nf = jnp.asarray(lay.to_flat(sim['n_per_snp']).reshape(nb, B),
                     jnp.float32)
    return ld, lay, sb, nf


def _state(S, nb, B):
    z = jnp.zeros((S, nb, B), jnp.float32)
    return CaviState(logits=z - 3.0, mu=z, eta=z, q=z)


def _hyper(S):
    f = lambda v: jnp.full((S,), v, jnp.float32)  # noqa: E731
    return Hyper(sigma_eps=f(0.7), tau_beta=f(100.0), pi=f(0.05),
                 lambda_min=f(0.0))


def _programs(problem):
    ld, lay, sb, nf = problem
    nb, B = ld.nb, ld.block_size
    fix = updates.FixMask(*(jnp.zeros(1, bool) for _ in range(3)))
    K = 2
    mz = jnp.zeros((K, nb, B), jnp.float32)
    mstate = MixState(gamma=mz + 0.01, mu=mz,
                      eta=jnp.zeros((nb, B), jnp.float32),
                      q=jnp.zeros((nb, B), jnp.float32))
    mhyper = MixHyper(sigma_eps=jnp.float32(0.7),
                      tau_beta=jnp.asarray([100.0, 1000.0], jnp.float32),
                      pi=jnp.asarray([0.01, 0.02], jnp.float32),
                      lambda_min=jnp.float32(0.0))
    mfix = mix_em_loop.MixFix(sigma_eps=jnp.asarray(False),
                              tau_betas=jnp.asarray(False),
                              pis=jnp.asarray(False),
                              total_pi=jnp.asarray(0.0, jnp.float64))
    return {
        'cavi_sweep_S1': lambda: cavi_sweep(
            ld, _state(1, nb, B), sb, nf, _hyper(1), jnp.ones(1)),
        'cavi_sweep_S4': lambda: cavi_sweep(
            ld, _state(4, nb, B), sb, nf, _hyper(4), jnp.ones(4)),
        'compute_q_dense': lambda: compute_q(
            ld, jnp.ones((2, nb, B), jnp.float32), chunked=False),
        'compute_q_scanned': lambda: compute_q(
            ld, jnp.ones((2, nb, B), jnp.float32), chunked=True),
        'refresh_q': lambda: refresh_q(
            ld, jnp.zeros((1, nb, B), jnp.float32),
            jnp.ones((1, nb, B), jnp.float32)),
        'em_fit': lambda: em_loop.em_fit(
            ld, _state(1, nb, B), sb, nf, _hyper(1), fix, n_sample=2000.0,
            m_total=float(lay.m), init_elbo=None, active0=jnp.ones(1, bool),
            max_iter=3, max_restarts=1, restart_hyper=_hyper(1),
            restart_logits=jnp.zeros(1, jnp.float32)),
        'cavi_sweep_mixture': lambda: cavi_sweep_mixture(
            ld, mstate, sb, nf, mhyper),
        'mix_em_fit': lambda: mix_em_loop.mix_em_fit(
            ld, mstate, sb, nf, mhyper, mfix, jnp.asarray([1.0, 0.1], jnp.float32),
            n_sample=2000.0, m_total=float(lay.m), init_elbo=None,
            max_iter=3),
    }


PROGRAMS = ['cavi_sweep_S1', 'cavi_sweep_S4', 'compute_q_dense',
            'compute_q_scanned', 'refresh_q', 'em_fit', 'cavi_sweep_mixture',
            'mix_em_fit']


@pytest.mark.parametrize('name', PROGRAMS)
def test_every_f32_dot_is_highest(problem, name, monkeypatch):
    # force the coupling-tile scan as well as the dense contraction:
    if name == 'compute_q_scanned':
        monkeypatch.setattr('viprs_tpu.ops.cavi_jax.off_scan_threshold_bytes',
                            lambda: 0.0)
    jaxpr = jax.make_jaxpr(_programs(problem)[name])().jaxpr
    dots = f32_dots(jaxpr)
    assert dots, f"{name}: no float32 dot traced — test lost its subject"
    bad = [d for d in dots if tuple(d[0] or ()) != HIGHEST]
    assert not bad, f"{name}: f32 dots below HIGHEST: {bad}"


def test_detector_sees_default_precision():
    """The walker flags an unpinned f32 dot (inside a loop, too)."""
    def f(x):
        return lax.fori_loop(0, 2, lambda i, y: jnp.dot(y, y), x)
    dots = f32_dots(jax.make_jaxpr(f)(jnp.ones((4, 4), jnp.float32)).jaxpr)
    assert len(dots) == 1 and tuple(dots[0][0] or ()) != HIGHEST


def test_ldpred_inf_cg_operator_is_highest(problem, monkeypatch):
    """LDpred-inf's CG operator (R + lam I) x, captured from its fit."""
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.model import ldpred_inf
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(100, 300), h2=0.3,
                                   prop_causal=0.05, seed=4)
    ds = SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128,
        quantize=True)
    seen = {}
    real_cg = jax.scipy.sparse.linalg.cg

    def spy(matvec, b, **kw):
        seen['jaxpr'] = jax.make_jaxpr(matvec)(b).jaxpr
        return real_cg(matvec, b, **kw)

    monkeypatch.setattr(ldpred_inf.jax.scipy.sparse.linalg, 'cg', spy)
    ldpred_inf.LDPredInf(ds, h2=0.3).fit(maxiter=5)
    dots = f32_dots(seen['jaxpr'])
    assert dots and all(tuple(p or ()) == HIGHEST for p, _ in dots)


def test_gibbs_sweep_has_no_unpinned_dot(problem):
    """The Gibbs sweep updates q elementwise; nothing in it may be an f32
    dot below HIGHEST."""
    from viprs_tpu.model.sampler import GibbsState, _gibbs_sweep
    ld, lay, sb, nf = problem
    nb, B = ld.nb, ld.block_size
    z = jnp.zeros((2, nb, B), jnp.float32)
    st = GibbsState(beta=z, gamma=z, q=z, key=jax.random.PRNGKey(0))
    f = lambda: _gibbs_sweep(ld, st, sb, nf, 0.7, 100.0, 0.05, 0.0,  # noqa
                             1.0)
    dots = f32_dots(jax.make_jaxpr(f)().jaxpr)
    assert all(tuple(p or ()) == HIGHEST for p, _ in dots)
