"""chip_smoke.py's phases at a tiny size on the CPU, its four-card path on
four virtual CPU devices, and its refusal to report anything off a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def problem():
    np.random.seed(0)
    return cs.make_problem(m_target=12_000, block_size=256, seed=1)


def test_problem_is_the_seeded_int8_panel(problem):
    again = cs.make_problem(m_target=12_000, block_size=256, seed=1)
    assert problem.ld.diag.dtype == np.int8
    assert problem.layout.block_size == 256
    assert len(problem.layout.chromosomes) == 22
    np.testing.assert_array_equal(np.asarray(problem.ld.diag),
                                  np.asarray(again.ld.diag))


@pytest.mark.parametrize('tile', [64, 128])
def test_phase_sweep_within_reference_tolerance(problem, tile):
    err = cs.phase_sweep(problem, n_blocks=3, tile=tile)
    assert set(err) == set(cs.SWEEP_ATOL)
    assert all(err[k] <= cs.SWEEP_ATOL[k] for k in err)


def test_phase_sweep_fails_loudly(problem, monkeypatch):
    """A sweep that disagrees with the reference raises (nothing is caught
    and passed over)."""
    from viprs_tpu.ops import cavi_jax
    real = cavi_jax.cavi_sweep

    def off_by_a_bit(*a, **k):
        st, d = real(*a, **k)
        return st._replace(eta=st.eta + 1e-3), d

    monkeypatch.setattr(cavi_jax, 'cavi_sweep', off_by_a_bit)
    with pytest.raises(AssertionError, match='reference'):
        cs.phase_sweep(problem, n_blocks=2)


def test_phase_fit(problem):
    r = cs.phase_fit(problem, mesh='off', max_iter=300)
    assert r['nit'] > 3 and 0.0 < r['h2'] < 1.0 and np.isfinite(r['elbo'])
    assert r['cold_s'] > 0 and r['warm_s'] > 0


def test_phase_grid(problem):
    r = cs.phase_grid(problem, pi_steps=3, sigma_epsilon_steps=2,
                      max_iter=200, mesh='off')
    assert r['lanes'] == 6 and 0 <= r['converged'] <= 6
    assert np.isfinite(r['bma_h2'])


def test_phase_mixtures(problem):
    r = cs.phase_mixtures(problem, K=2, pi_steps=2, max_iter=100)
    assert np.isfinite(r['mix']['elbo']) and r['mix_grid']['lanes'] == 2


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Let the dispatch accept the fused kernel here, run in the Pallas
    interpreter."""
    from viprs_tpu.model import _dispatch
    from viprs_tpu.ops import cavi_fused
    real = cavi_fused.cavi_sweep_fused
    monkeypatch.setattr(_dispatch, 'FUSED_BACKENDS', ('cpu',))
    monkeypatch.setattr(cavi_fused, 'cavi_sweep_fused',
                        lambda *a, **k: real(*a, **{**k, 'interpret': True}))


@pytest.mark.parametrize('lanes', [(1,), (10,)])
def test_phase_kernel_interpret(problem, lanes, fused_on_cpu):
    rows, fit = cs.phase_kernel(problem, lanes=lanes, warm_sweeps=1,
                                interpret=True, max_iter=300)
    assert [(r['S'], r['after']) for r in rows] == \
        [(lanes[0], 0), (lanes[0], 1)]
    for r in rows:
        assert all(cs._kernel_ok(r, r['S']).values())
        assert set(r['xla_vs_f64']) == set(cs.KERNEL_ATOL)
    assert fit['d_eta'] <= cs.FIT_ETA_ATOL and fit['d_h2'] <= cs.FIT_H2_ATOL


def _parity(vs_xla, settled, flipped=0, excluded=0, live=1_000_000):
    return {'vs_xla': vs_xla, 'settled_vs_f64': settled, 'flipped': flipped,
            'live': live, 'excluded': {'mu': excluded, 'gamma': excluded}}


def test_kernel_ok_criterion():
    """eta and q are held everywhere against the float32 loop; mu and
    gamma against float64 where settled."""
    tol = dict(cs.KERNEL_ATOL)
    settled = {'mu': tol['mu'], 'gamma': tol['gamma']}
    ok = _parity({**tol, 'gamma': 1.0}, settled)
    assert all(cs._kernel_ok(ok).values())
    eta_off = _parity({**tol, 'eta': 2 * tol['eta']}, settled)
    gamma_off = _parity(tol, {**settled, 'gamma': 2 * tol['gamma']})
    for S in (1, 100):
        assert not all(cs._kernel_ok(eta_off, S).values())
    # with grid lanes single-sweep gamma is reported, not held:
    assert not all(cs._kernel_ok(gamma_off, 1).values())
    assert all(cs._kernel_ok(gamma_off, 100).values())


@pytest.mark.parametrize('live,n,held', [
    (1_000_000, 100, True), (1_000_000, 101, False),
    (3_000, 10, True), (3_000, 11, False)])
@pytest.mark.parametrize('what', ['flipped', 'excluded'])
def test_kernel_ok_caps_left_out_coordinates(live, n, held, what):
    """Wide exclusion fails: at most 10 coordinates or 0.01% of the live
    ones may differ in the keep decision (any S) or be left out of the mu
    and gamma check (S=1)."""
    tol = dict(cs.KERNEL_ATOL)
    e = _parity(tol, {'mu': 0.0, 'gamma': 0.0}, live=live,
                **{what: n})
    assert cs.max_excluded(live) == max(10, live // 10_000)
    assert all(cs._kernel_ok(e, 1).values()) == held
    assert all(cs._kernel_ok(e, 100).values()) == (held or what == 'excluded')


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit, match='no gpu device'):
        cs.phase_device('gpu')
    platform, kind, count, smi = cs.phase_device('cpu')
    assert platform == 'cpu' and count >= 1 and smi == []


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_compare_fits_tolerances():
    single = {'h2': 0.2, 'elbo': -1e5, 'nit': 50}
    ok = cs._compare_fits({'h2': 0.20005, 'elbo': -1e5 * (1 + 5e-7),
                           'nit': 52}, single, 'x')
    assert ok['d_nit'] == 2
    for bad in ({'h2': 0.2002, 'elbo': -1e5, 'nit': 50},
                {'h2': 0.2, 'elbo': -1e5 * (1 + 2e-6), 'nit': 50},
                {'h2': 0.2, 'elbo': -1e5, 'nit': 53}):
        with pytest.raises(AssertionError, match='differ'):
            cs._compare_fits(bad, single, 'x')


_FOUR = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, viprs_tpu, chip_smoke as cs
ds = cs.make_problem(m_target=12_000, block_size=256, seed=1)
r = cs.phase_four_cards(ds, n_cards=4, lanes=4, max_iter=300)
print("RESULT", json.dumps(r))
'''


def test_four_card_path_on_virtual_devices(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS='cpu', VIPRS_TPU_COMPILE_CACHE='0',
               XLA_FLAGS='--xla_force_host_platform_device_count=4')
    res = subprocess.run([sys.executable, '-c', _FOUR, REPO],
                         capture_output=True, text=True, timeout=900,
                         cwd=str(tmp_path), env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    r = json.loads(res.stdout.split('RESULT', 1)[1])
    assert r['fit']['d_h2'] <= cs.MESH_H2_ATOL
    assert r['grid']['d_elbo_rel'] <= cs.MESH_ELBO_RTOL


def test_script_alone_fails_without_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo, the
    script exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('PYTHONPATH', None)
    res = subprocess.run([sys.executable, 'chip_smoke.py'],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
