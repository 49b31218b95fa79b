"""Test configuration.

By default the tests run on a virtual 8-device CPU platform, so that the
sharding tests run anywhere. ``VIPRS_TEST_PLATFORM=gpu`` leaves the platform
to JAX instead; the tests marked ``gpu`` (compiled GPU kernels) then run on
the card:

    VIPRS_TEST_PLATFORM=gpu python -m pytest tests/test_fused.py -m gpu

The platform is forced through jax.config as well as the environment, before
any backend initializes.
"""

import os
import sys

import pytest

if os.environ.get('VIPRS_TEST_PLATFORM', 'cpu') == 'cpu':
    _flags = os.environ.get('XLA_FLAGS', '')
    if 'xla_force_host_platform_device_count' not in _flags:
        os.environ['XLA_FLAGS'] = (
            _flags + ' --xla_force_host_platform_device_count=8').strip()
    os.environ['JAX_PLATFORMS'] = 'cpu'

    import jax  # noqa: E402

    jax.config.update('jax_platforms', 'cpu')

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: runs a kernel compiled for an NVIDIA GPU; skips '
                   'where JAX has no GPU (see tests/conftest.py)')


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU; decided per test."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        pytest.skip(f"needs an NVIDIA GPU (JAX platform: {dev.platform}); "
                    f"run with VIPRS_TEST_PLATFORM=gpu on a machine with one")
    return dev
