"""Parity of the fused Pallas sweep (ops/cavi_fused.py) with the XLA tile
loop (ops/cavi_jax.cavi_sweep).

On the CPU the kernel runs in the Pallas interpreter; the ``gpu`` tests run
the Triton-compiled kernel and skip where there is no card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from viprs_tpu.ops.block_ld import pack_dense_blocks
from viprs_tpu.ops.cavi_jax import CaviState, Hyper, cavi_sweep
from viprs_tpu.ops.cavi_fused import cavi_sweep_fused
from viprs_tpu.ops import em_loop, updates
from viprs_tpu.data.simulate import simulate_sumstats_blocks

#: One sweep: the tolerances the fused kernel is held to on the card.
ATOL = {'eta': 1e-5, 'mu': 1e-5, 'gamma': 1e-5, 'q': 1e-4}


def _problem(block_sizes, B, quantize, seed=13):
    sim = simulate_sumstats_blocks(n=3000, block_sizes=block_sizes, h2=0.4,
                                   prop_causal=0.05, seed=seed)
    ld, lay = pack_dense_blocks({22: sim['ld_blocks'][22]}, block_size=B,
                                quantize=quantize)
    nb = ld.nb
    sb = jnp.asarray(lay.to_flat(sim['std_beta']).reshape(nb, B), jnp.float32)
    nf = jnp.asarray(lay.to_flat(sim['n_per_snp']).reshape(nb, B),
                     jnp.float32)
    return ld, lay, sb, nf


def _state(S, nb, B, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    mu = rng.normal(0, 0.01, (S, nb, B))
    return CaviState(logits=f32(rng.normal(-3, 1, (S, nb, B))), mu=f32(mu),
                     eta=f32(0.5 * mu), q=f32(np.zeros((S, nb, B))))


def _hyper(S):
    ramp = np.linspace(1.0, 1.5, S)
    f = lambda v: jnp.asarray(v * ramp, jnp.float32)  # noqa: E731
    return Hyper(sigma_eps=f(0.6), tau_beta=f(500.0), pi=f(0.04),
                 lambda_min=f(0.0))


def _compare(a, b, atol=ATOL):
    for k, tol in atol.items():
        np.testing.assert_allclose(np.asarray(getattr(b, k)),
                                   np.asarray(getattr(a, k)), atol=tol,
                                   err_msg=k)


# block sizes (3 LD blocks -> NB ragged w.r.t. lane groups and tiles; the
# 300-variant block spans two tiles at B=256 so coupling tiles exist)
CASES = [
    # (S, B, tile, quantize, relax)
    (1, 256, 64, True, True),
    (1, 256, 128, True, True),
    (1, 256, 64, False, True),
    (1, 256, 64, True, False),
    (1, 128, 128, False, False),
    (3, 256, 64, True, True),
    (3, 256, 128, False, True),
    (16, 256, 64, True, True),
    (17, 128, 64, False, True),
    (17, 256, 128, True, False),
]


@pytest.mark.parametrize('S,B,tile,quantize,relax', CASES)
def test_fused_matches_xla_interpret(S, B, tile, quantize, relax):
    ld, _, sb, nf = _problem((140, 130, 300), B, quantize)
    st = _state(S, ld.nb, B, seed=S)
    hy = _hyper(S)
    act = jnp.ones(S, jnp.float32)
    a, da = cavi_sweep(ld, st, sb, nf, hy, act, tile=tile, relax=relax,
                       inner_steps=3)
    b, db = cavi_sweep_fused(ld, st, sb, nf, hy, act, tile=tile, relax=relax,
                             inner_steps=3, interpret=True)
    _compare(a, b)
    np.testing.assert_allclose(np.asarray(db), np.asarray(da), atol=1e-5)


@pytest.mark.parametrize('S', [1, 4, 18])
def test_fused_active_lane_mask_interpret(S):
    """Inactive lanes (active == 0) and padded lanes never move; fractional
    activity damps like the XLA loop."""
    ld, _, sb, nf = _problem((140, 130, 90), 128, True, seed=5)
    st = _state(S, ld.nb, 128, seed=7)
    hy = _hyper(S)
    act = np.ones(S, np.float32)
    act[0] = 0.0
    if S > 2:
        act[-1] = 0.5
    act = jnp.asarray(act)
    a, _ = cavi_sweep(ld, st, sb, nf, hy, act, tile=64, inner_steps=2)
    b, db = cavi_sweep_fused(ld, st, sb, nf, hy, act, tile=64,
                             inner_steps=2, interpret=True)
    _compare(a, b)
    np.testing.assert_array_equal(np.asarray(b.eta[0]), np.asarray(st.eta[0]))
    assert not np.any(np.asarray(db[0]))


def test_fused_em_fit_interpret(monkeypatch):
    """A whole fused EM run with the fused sweep reaches the XLA run's fixed
    point (same iterations, ELBO and state)."""
    from viprs_tpu.ops import cavi_fused
    orig = cavi_fused.cavi_sweep_fused
    monkeypatch.setattr(
        cavi_fused, 'cavi_sweep_fused',
        lambda *a, **k: orig(*a, interpret=True, **k))
    ld, lay, sb, nf = _problem((140, 130, 120), 128, True, seed=3)
    st = _state(1, ld.nb, 128, seed=0)._replace(
        mu=jnp.zeros((1, ld.nb, 128), jnp.float32),
        eta=jnp.zeros((1, ld.nb, 128), jnp.float32))
    hy = Hyper(*(jnp.asarray([v], jnp.float32)
                 for v in (0.7, 0.05 * lay.m / 0.4, 0.05, 0.0)))
    fix = updates.FixMask(*(jnp.zeros(1, bool) for _ in range(3)))
    kw = dict(n_sample=3000.0, m_total=float(lay.m), init_elbo=None,
              active0=jnp.ones(1, bool), max_iter=60, tile=64)
    rx = em_loop.em_fit(ld, st, sb, nf, hy, fix, sweep='xla', **kw)
    rf = em_loop.em_fit(ld, st, sb, nf, hy, fix, sweep='fused', **kw)
    assert int(rf.nit[0]) == int(rx.nit[0])
    np.testing.assert_allclose(float(rf.final_elbo[0]),
                               float(rx.final_elbo[0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(rf.state.eta),
                               np.asarray(rx.state.eta), atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('S', [1, 16, 100])
def test_fused_compiled_matches_xla(gpu, S):
    """The Triton-compiled kernel on the card, held like chip_smoke's phase
    f: eta and q against the float32 loop; at S=1 mu and gamma against the
    float64 sweep wherever the float32 loop meets the tolerance."""
    import chip_smoke
    ld, _, sb, nf = _problem((700, 900, 1000, 400), 1024, True)
    err, _ = chip_smoke._sweep_parity(ld, _state(S, ld.nb, 1024, seed=S),
                                      sb, nf, _hyper(S), interpret=False)
    assert all(chip_smoke._kernel_ok(err, S).values()), err


@pytest.mark.parametrize('B,tile', [(384, 128), (192, 64), (768, 256)])
def test_fused_refuses_shapes_triton_cannot_lower(B, tile):
    """A block size or tile count that is not a power of two is refused
    before lowering, with the reason, in every mode."""
    ld, _, sb, nf = _problem((140, 130), B, True)
    with pytest.raises(ValueError, match='power-of-two'):
        cavi_sweep_fused(ld, _state(1, ld.nb, B, seed=0), sb, nf, _hyper(1),
                         jnp.ones(1, jnp.float32), tile=tile, interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize('B,sweep', [(384, 'xla'), (512, 'fused')])
def test_fit_on_card_at_block_size(gpu, B, sweep):
    """A default S=1 fit on the card at a block size of the CLI's range:
    the policy picks the kernel where Triton lowers it and the XLA loop
    elsewhere, and the fit converges either way."""
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.model import VIPRS
    sim = simulate_sumstats_blocks(n=3000, block_sizes=(700, 900, 400),
                                   h2=0.4, prop_causal=0.05, seed=2)
    ds = SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=B,
        quantize=True)
    np.random.seed(0)
    m = VIPRS(ds, mesh='off')
    m.fit(max_iter=500)
    assert m._chunk_trace == [(1, sweep)]
    assert m.optim_result.valid_optim_result
    assert 0.0 < float(m.get_heritability()) < 1.0
