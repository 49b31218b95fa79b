"""What the package needs from its environment: the optional host libraries
the fit path must not import, where the compile cache goes, and the device
memory plan."""

import json
import os
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A fit of one model class in a process where pandas, psutil, sklearn and
# tqdm cannot be imported.
_BLOCKED_FIT = r'''
import importlib.abc, sys
BLOCK = ('pandas', 'psutil', 'sklearn', 'tqdm')

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCK:
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, _Block())
import numpy as np
from viprs_tpu.data.dataset import SummaryStatsDataset
from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.gridsearch import HyperparameterGrid, bayesian_model_average
from viprs_tpu import model as M

sim = simulate_sumstats_blocks(n=2000, block_sizes=(100, 90), h2=0.3,
                               prop_causal=0.05, seed=7)
ds = SummaryStatsDataset.from_dense_blocks(
    sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128)
grid = HyperparameterGrid(pi_steps=3, n_snps=ds.m)
which = sys.argv[1]
np.random.seed(0)
if which == 'VIPRS':
    m = M.VIPRS(ds, mesh='off').fit(max_iter=30)
elif which == 'VIPRSGrid':
    m = M.VIPRSGrid(ds, grid, mesh='off').fit(max_iter=30)
    bayesian_model_average(m)
elif which == 'VIPRSMix':
    m = M.VIPRSMix(ds, K=2, mesh='off').fit(max_iter=30)
elif which == 'VIPRSMixGrid':
    m = M.VIPRSMixGrid(ds, grid, K=2, mesh='off').fit(max_iter=30)
elif which == 'LDPredInf':
    m = M.LDPredInf(ds, h2=0.3).fit(maxiter=20)
h2 = float(np.max(np.atleast_1d(m.get_heritability())))
assert not set(BLOCK) & {k.split('.')[0] for k in sys.modules}
print("H2", h2)
'''


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    env.update(extra)
    return env


@pytest.mark.parametrize('model', ['VIPRS', 'VIPRSGrid', 'VIPRSMix',
                                   'VIPRSMixGrid', 'LDPredInf'])
def test_fit_without_optional_host_libraries(model, tmp_path):
    res = subprocess.run(
        [sys.executable, '-c', _BLOCKED_FIT, model], capture_output=True,
        text=True, cwd=str(tmp_path), timeout=600,
        env=_env(VIPRS_TPU_COMPILE_CACHE='0'))
    assert res.returncode == 0, res.stderr[-3000:]
    h2 = float(res.stdout.split('H2')[-1])
    assert 0.0 < h2 < 1.0


_CACHE_PROBE = r'''
import json, jax, viprs_tpu
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir,
                  "default": viprs_tpu.COMPILE_CACHE_DIR}))
'''


def _probe_cache(tmp_path, **extra):
    res = subprocess.run([sys.executable, '-c', _CACHE_PROBE],
                         capture_output=True, text=True, cwd=str(tmp_path),
                         timeout=300, env=_env(**extra))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_compile_cache_env_set_is_left_alone(tmp_path):
    """JAX_COMPILATION_CACHE_DIR is JAX's own setting: the package neither
    replaces it nor creates anything there at import."""
    target = tmp_path / 'jaxcache'
    got = _probe_cache(tmp_path, JAX_COMPILATION_CACHE_DIR=str(target))
    assert got['dir'] == str(target)
    assert not target.exists()


def test_compile_cache_default_is_in_checkout(tmp_path):
    got = _probe_cache(tmp_path)
    assert got['dir'] == got['default']
    assert got['default'] == os.path.join(REPO, '.cache', 'jax')
    with open(os.path.join(REPO, '.gitignore')) as f:
        assert '.cache/' in f.read().split()


def test_compile_cache_disabled(tmp_path):
    got = _probe_cache(tmp_path, VIPRS_TPU_COMPILE_CACHE='0')
    assert not got['dir']


@pytest.mark.parametrize('environ,expected', [
    ({'VIPRS_TPU_COMPILE_CACHE': '0'}, None),
    ({'JAX_COMPILATION_CACHE_DIR': '/elsewhere'}, '/elsewhere'),
])
def test_configure_compile_cache_returns_directory(environ, expected):
    import viprs_tpu
    assert viprs_tpu._configure_compile_cache(environ) == expected


# ----------------------------------------------------------- memory plan

class _Dev:
    def __init__(self, platform, stats, kind='Card'):
        self.platform, self._stats, self.device_kind = platform, stats, kind

    def memory_stats(self):
        return self._stats


def test_memory_plan_gpu_stats():
    from viprs_tpu.ops import memory
    dev = _Dev('gpu', {'bytes_limit': 64 * 2 ** 30})
    assert memory.device_memory_bytes(dev) == 64 * 2 ** 30
    assert memory.chunk_threshold_bytes(dev) == 16 * 2 ** 30
    assert memory.off_scan_threshold_bytes(dev) == 4 * 2 ** 30


@pytest.mark.parametrize('stats', [None, {}, {'bytes_in_use': 5}])
def test_memory_plan_gpu_without_stats_is_an_error(stats):
    from viprs_tpu.ops import memory
    with pytest.raises(RuntimeError, match='no memory limit'):
        memory.device_memory_bytes(_Dev('gpu', stats))


def test_memory_plan_cpu_is_none():
    from viprs_tpu.ops import memory
    dev = _Dev('cpu', {'bytes_limit': 1})
    assert memory.device_memory_bytes(dev) is None
    assert memory.chunk_threshold_bytes(dev) == float('inf')
    assert memory.off_scan_threshold_bytes() == float('inf')  # this host


def _budget(monkeypatch, gb, dev, n_dev=1):
    import jax
    from viprs_tpu.cli import fit as cli_fit
    monkeypatch.setattr(jax, 'devices', lambda *a: [dev] * n_dev)
    return cli_fit._device_budget_bytes(types.SimpleNamespace(
        device_memory_gb=gb))


def test_streaming_budget_explicit_gb(monkeypatch):
    assert _budget(monkeypatch, 10.0, _Dev('cpu', None), n_dev=2) == \
        pytest.approx(0.65 * 10e9 * 2)


def test_streaming_budget_from_gpu_stats(monkeypatch):
    dev = _Dev('gpu', {'bytes_limit': 60e9})
    assert _budget(monkeypatch, None, dev, n_dev=4) == \
        pytest.approx(0.65 * 60e9 * 4)


def test_streaming_budget_cpu_is_none(monkeypatch):
    assert _budget(monkeypatch, None, _Dev('cpu', None)) is None


def test_streaming_budget_gpu_without_stats_raises(monkeypatch):
    with pytest.raises(RuntimeError, match='device-memory-gb'):
        _budget(monkeypatch, None, _Dev('gpu', {}))
