"""Multi-host execution test (SURVEY.md §2.4/P7).

Spawns 2 real processes, each owning 4 virtual CPU devices, joined through
``jax.distributed`` with a localhost coordinator. Both run the sharded fused
EM loop over the global 8-device ('blocks', 'grid') mesh and must agree with
each other and with a single-process 8-device run of the identical problem —
exercising viprs_tpu/parallel/distributed.py + mesh.py across a real process
boundary (the reference has nothing here; multi-host is a first-class
deliverable of the framework).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'multihost_worker.py')


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_two_process_em_matches_single_process(tmp_path):
    port = _free_port()
    n_proc = 2
    outs = [str(tmp_path / f'proc{i}.json') for i in range(n_proc)]

    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop('XLA_FLAGS', None)  # worker sets its own 4-device flag
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), str(n_proc), str(port), outs[i]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n_proc)]
    results = []
    for p, out in zip(procs, outs):
        stdout, stderr = p.communicate(timeout=540)
        assert p.returncode == 0, f"worker failed:\n{stdout}\n{stderr}"
        with open(out) as f:
            results.append(json.load(f))

    assert all(r['n_global_devices'] == 8 for r in results)
    e0, e1 = (np.asarray(r['elbos']) for r in results)
    assert np.all(np.isfinite(e0))
    # both processes observe the identical global optimization:
    np.testing.assert_array_equal(e0, e1)
    assert results[0]['nits'] == results[1]['nits']

    # single-process ground truth on this process's own 8 virtual devices
    # (conftest forces xla_force_host_platform_device_count=8):
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    import multihost_worker
    single_elbos, single_nits = multihost_worker.run()
    # different GSPMD partitionings reorder f32 accumulations; agreement is
    # within float32 round-off over the run, not bitwise:
    np.testing.assert_allclose(e0, single_elbos, rtol=1e-6)
    assert results[0]['nits'] == list(np.asarray(single_nits))


def test_deployment_shape_grid_fit_with_compaction_and_restart(tmp_path):
    """A multi-host deployment scaled down: 4 processes x 2 devices on a
    2D ('blocks', 'grid') mesh, driving the FULL policy layer across the
    process boundary — an S=16 grid fit whose staggered
    lane convergence forces the chunked driver's power-of-2 lane compaction,
    Bayesian model averaging over the surviving lanes, and a
    restart-on-negative-MSE that fires on every process in lockstep."""
    port = _free_port()
    n_proc = 4
    outs = [str(tmp_path / f'gproc{i}.json') for i in range(n_proc)]

    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop('XLA_FLAGS', None)  # worker sets its own 2-device flag
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, 'tests',
                                      'multihost_grid_worker.py'),
         str(i), str(n_proc), str(port), outs[i]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n_proc)]
    results = []
    for p, out in zip(procs, outs):
        stdout, stderr = p.communicate(timeout=540)
        assert p.returncode == 0, f"worker failed:\n{stdout}\n{stderr}"
        with open(out) as f:
            results.append(json.load(f))

    assert all(r['n_global_devices'] == 8 for r in results)

    # every process observes the identical global optimization, bitwise:
    r0 = results[0]
    for r in results[1:]:
        assert r['grid_elbos'] == r0['grid_elbos']
        assert r['chunk_trace'] == r0['chunk_trace']
        assert r['bma_h2'] == r0['bma_h2']
        assert r['restart_elbo'] == r0['restart_elbo']

    # the policy layer actually exercised what this test exists for:
    widths = [t[0] for t in r0['chunk_trace']]
    assert any(w < 16 for w in widths), (
        f"lane compaction never fired across the process boundary: {widths}")
    assert all(impl == 'xla' for _, impl in r0['chunk_trace']), (
        "a mesh-sharded chunk was routed off the XLA tile loop")
    assert r0['restart_fired'], "restart ladder did not fire"
    assert np.isfinite(r0['bma_h2'])

    # single-process ground truth (8 local virtual devices via conftest):
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    import multihost_grid_worker
    single = multihost_grid_worker.run()
    np.testing.assert_allclose(np.asarray(r0['grid_elbos']),
                               np.asarray(single['grid_elbos']), rtol=1e-6)
    assert r0['chunk_trace'] == [list(t) for t in single['chunk_trace']]
    assert r0['restart_fired'] == single['restart_fired']
    np.testing.assert_allclose(r0['bma_h2'], single['bma_h2'], rtol=1e-6)
