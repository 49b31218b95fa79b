"""Device-memory plan: every size threshold of the fit path, taken from the
memory the device itself reports.

On an accelerator, ``memory_stats()['bytes_limit']`` is the memory JAX may
use on that device. An accelerator that reports no limit is an error: a
guessed size would either waste the device or run it out of memory. The CPU
backend has no device memory of its own; there the plan returns None and the
fit keeps its dense (unchunked) paths.
"""

import jax

#: Above this share of one device's memory, the diagonal LD tiles are
#: reduced block by block (``compute_q``, LD scores): a dense reduction's
#: float32 view of the int8 tiles is 4x their size.
CHUNK_SHARE = 1 / 4

#: Above this share, the coupling tiles are contracted one tile at a time
#: (``cavi_jax._off_contrib``): their float32 view feeds two einsums, so XLA
#: materializes it whole.
OFF_SCAN_SHARE = 1 / 16


def device_memory_bytes(device=None):
    """Memory limit of ``device`` (default: the first device) in bytes, or
    None on the CPU backend.

    :raises RuntimeError: an accelerator that reports no memory limit.
    """
    device = device if device is not None else jax.devices()[0]
    if device.platform == 'cpu':
        return None
    stats = device.memory_stats() or {}
    limit = stats.get('bytes_limit')
    if not limit:
        raise RuntimeError(
            f"{device.device_kind} ({device.platform}) reports no memory "
            f"limit (memory_stats()={stats!r}); pass the budget explicitly "
            f"(viprs_fit --device-memory-gb).")
    return int(limit)


def chunk_threshold_bytes(device=None):
    """Diagonal-tile bytes per device above which reductions go block by
    block; ``inf`` on the CPU backend."""
    mem = device_memory_bytes(device)
    return float('inf') if mem is None else CHUNK_SHARE * mem


def off_scan_threshold_bytes(device=None):
    """Coupling-tile bytes above which ``_off_contrib`` contracts one tile at
    a time; ``inf`` on the CPU backend."""
    mem = device_memory_bytes(device)
    return float('inf') if mem is None else OFF_SCAN_SHARE * mem
