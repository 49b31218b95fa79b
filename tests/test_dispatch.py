"""Decision-table tests for the sweep-dispatch policy
(viprs_tpu/model/_dispatch.py).

The hazard this guards: a fit on a multi-device mesh must NOT route
GSPMD-sharded state into ``pl.pallas_call`` — Pallas kernels have no SPMD
partitioning rule — and the fused kernel must never be chosen where it cannot
compile (no GPU, or a block size / tile width that Triton cannot lower). The
policy is a pure function, so the full (S, mesh, backend, shape, override)
table is asserted here; the model drivers (VIPRS.fit incl. its compacted
re-decision) route through it.
"""

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from viprs_tpu.model._dispatch import (
    select_sweep_impl, fused_allowed, FUSED_LANES, SWEEP_IMPLS)
from viprs_tpu.ops.cavi_fused import shape_supported


@pytest.fixture(scope='module')
def dataset():
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.data.simulate import simulate_sumstats_blocks
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(100, 90), h2=0.3,
                                   prop_causal=0.05, seed=7)
    return SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128)


def _mesh():
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    return Mesh(devs, ('blocks', 'grid'))


def _select(S, mesh, impl, backend, block_size=1024, tile=128):
    return select_sweep_impl(S, mesh, impl, backend, block_size=block_size,
                             tile=tile)


LANES = [1, 2, 8, 16, 100]
BACKENDS = ['cpu', 'gpu']
MESHES = [None, 'mesh']
#: (block size, tile): the CLI's --block-size is any multiple of 128 and the
#: tile any divisor of it; Triton lowers only power-of-two shapes.
SHAPES_OK = [(128, 128), (256, 64), (512, 128), (1024, 128), (2048, 256)]
SHAPES_BAD = [(384, 128), (768, 256), (1536, 512), (1152, 128), (1024, 96),
              (640, 128)]


def _expected_default(S, mesh, backend):
    if backend == 'gpu' and mesh is None and S in FUSED_LANES:
        return 'fused'
    return 'xla'


class TestDefaultPolicy:
    """sweep_impl=None — the measured policy with both guards."""

    @pytest.mark.parametrize('mesh', MESHES)
    @pytest.mark.parametrize('backend', BACKENDS)
    @pytest.mark.parametrize('S', LANES)
    def test_table(self, S, backend, mesh):
        m = _mesh() if mesh else None
        got = _select(S, m, None, backend)
        assert got == _expected_default(S, mesh, backend)
        if m is not None or backend != 'gpu':
            assert got == 'xla'       # the guards, whatever the lane range

    def test_fused_lanes_is_measured_range(self):
        # the policy's lane range is contiguous and starts at one model:
        assert isinstance(FUSED_LANES, range) and FUSED_LANES.step == 1
        assert FUSED_LANES.start >= 1

    @pytest.mark.parametrize('backend', BACKENDS)
    def test_fused_allowed(self, backend):
        assert fused_allowed(None, 1024, 128, backend) == (backend == 'gpu')
        assert not fused_allowed(_mesh(), 1024, 128, backend)

    def test_default_backend_is_jax_default(self):
        assert select_sweep_impl(1, None, block_size=1024, tile=128) == \
            _select(1, None, None, jax.default_backend())

    @pytest.mark.parametrize('B,tile', SHAPES_OK)
    def test_power_of_two_shapes_take_the_kernel(self, B, tile):
        assert shape_supported(B, tile)
        assert fused_allowed(None, B, tile, 'gpu')
        assert _select(1, None, None, 'gpu', B, tile) == 'fused'

    @pytest.mark.parametrize('B,tile', SHAPES_BAD)
    def test_other_shapes_run_the_xla_loop(self, B, tile):
        assert not shape_supported(B, tile)
        assert not fused_allowed(None, B, tile, 'gpu')
        assert _select(1, None, None, 'gpu', B, tile) == 'xla'


class TestExplicitOverride:
    """sweep_impl='xla'|'fused' — explicit requests, hard errors."""

    @pytest.mark.parametrize('mesh', MESHES)
    @pytest.mark.parametrize('backend', BACKENDS)
    @pytest.mark.parametrize('S', LANES)
    def test_xla_always_allowed(self, S, backend, mesh):
        m = _mesh() if mesh else None
        assert _select(S, m, 'xla', backend) == 'xla'

    @pytest.mark.parametrize('S', LANES)
    def test_fused_on_gpu_without_mesh(self, S):
        assert _select(S, None, 'fused', 'gpu') == 'fused'

    @pytest.mark.parametrize('S', LANES)
    def test_fused_off_gpu_raises(self, S):
        with pytest.raises(ValueError, match='GPU'):
            _select(S, None, 'fused', 'cpu')

    @pytest.mark.parametrize('backend', BACKENDS)
    @pytest.mark.parametrize('S', LANES)
    def test_fused_under_mesh_raises(self, S, backend):
        with pytest.raises(ValueError, match='mesh|GPU'):
            _select(S, _mesh(), 'fused', backend)

    @pytest.mark.parametrize('impl', ['skip', 'pallas', 'hybrid', 'cuda',
                                      'Fused'])
    def test_unknown_impl_raises(self, impl):
        assert impl not in SWEEP_IMPLS
        with pytest.raises(ValueError, match='sweep_impl'):
            _select(8, None, impl, 'gpu')

    @pytest.mark.parametrize('B,tile', SHAPES_BAD)
    def test_fused_at_other_shapes_raises(self, B, tile):
        with pytest.raises(ValueError, match='power-of-two'):
            _select(1, None, 'fused', 'gpu', B, tile)


class TestDriverIntegration:
    """The model drivers actually consult the policy (not a re-derivation)."""

    def test_viprs_fit_rejects_fused_under_mesh(self, dataset):
        from viprs_tpu.model import VIPRS
        m = VIPRS(dataset)          # mesh='auto' -> 8-device CPU mesh
        assert m.mesh is not None
        with pytest.raises(ValueError, match='mesh|GPU'):
            m.fit(max_iter=2, sweep_impl='fused')

    def test_viprs_fit_mesh_off_cpu_rejects_fused(self, dataset):
        from viprs_tpu.model import VIPRS
        m = VIPRS(dataset, mesh='off')
        with pytest.raises(ValueError, match='GPU'):
            m.fit(max_iter=2, sweep_impl='fused')

    def test_viprs_chunk_trace_records_policy(self, dataset):
        from viprs_tpu.model import VIPRS
        np.random.seed(0)
        m = VIPRS(dataset, mesh='off')
        m.fit(max_iter=10)
        assert m._chunk_trace == [
            (1, _select(1, None, None, jax.default_backend(), 128, m.tile))]


class TestMixtureFits:
    """Mixture fits always run the XLA loop: the CLI's --sweep-impl applies
    to VIPRS and VIPRSGrid only."""

    @staticmethod
    def _args(*extra):
        from viprs_tpu.cli.fit import build_parser, check_args
        return check_args(build_parser().parse_args(
            ['-l', 'ld', '-s', 'ss', '--output-file', 'out', *extra]))

    @pytest.mark.parametrize('impl', ['xla', 'fused'])
    def test_cli_rejects_sweep_impl_for_mixtures(self, impl):
        with pytest.raises(AssertionError, match='VIPRSMix'):
            self._args('-m', 'VIPRSMix', '--sweep-impl', impl)

    @pytest.mark.parametrize('model', ['VIPRS', 'VIPRSGrid', 'VIPRSMix'])
    def test_cli_sweep_impl_default_is_auto(self, model):
        assert self._args('-m', model).sweep_impl == 'auto'
