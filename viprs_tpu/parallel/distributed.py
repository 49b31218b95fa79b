"""Multi-host execution support.

The reference has no distributed backend (its only cross-process mechanism is
POSIX shared memory for grid search, SURVEY.md §2.4/P7). On several hosts the
same program spans them: each host runs this code under ``jax.distributed``,
arrays are sharded over the global ('blocks', 'grid') mesh, and XLA routes the
M-step/ELBO reductions over the device interconnect (the network between hosts
is only touched by the host-side data loading).
"""

import logging

import jax

logger = logging.getLogger(__name__)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize multi-host JAX (no-op on a single host).

    Where no cluster environment is detected, pass the coordinator address,
    process count and process id explicitly (see jax.distributed.initialize).
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        logger.info("jax.distributed initialized: process %d of %d, %d local "
                    "/ %d global devices", jax.process_index(),
                    jax.process_count(), jax.local_device_count(),
                    jax.device_count())
    except Exception as e:  # single host or already initialized
        logger.debug("jax.distributed not initialized (%s); continuing "
                     "single-host.", e)
    return jax.process_index() if jax.process_count() > 1 else 0


def global_mesh(n_grid_axis=1):
    """A ('blocks', 'grid') mesh over all global devices."""
    from .mesh import make_mesh
    return make_mesh(n_grid_axis=n_grid_axis)


def fetch(x):
    """``jax.device_get`` that also works for multi-process global arrays.

    Fully-addressable (single-process) or fully-replicated arrays go through
    plain ``device_get``; an array spanning non-addressable devices (state
    sharded over a multi-host mesh) is gathered with
    ``multihost_utils.process_allgather``. That gather is a collective —
    every process must reach it in lockstep, which holds for the
    deterministic host drivers here (same np.random seed, same chunk
    decisions on every process).
    """
    import numpy as np

    def one(a):
        if not hasattr(a, 'sharding'):
            return np.asarray(a)
        if (getattr(a, 'is_fully_addressable', True)
                or getattr(a, 'is_fully_replicated', False)):
            return jax.device_get(a)
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(a, tiled=True))

    return jax.tree_util.tree_map(one, x)
