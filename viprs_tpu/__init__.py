"""
viprs_tpu — a JAX framework for Variational Inference of Polygenic Risk Scores.

A from-scratch JAX/XLA re-design with the capabilities of the reference
``viprs`` package (summary-statistics Bayesian PRS via coordinate-ascent variational
inference), built for accelerators: blocked dense LD tiles as matrix products, a
model-grid batch axis, fused on-device EM loops, and block-sharded multi-device
execution.

See DESIGN.md at the repository root for the architecture.
"""

import os as _os

import jax

# Full-framework requirement: ELBO convergence is measured at 1e-6 absolute on
# objectives of magnitude ~1e5-1e6 (reference defaults, viprs/model/VIPRS.py:909-919),
# which requires float64 scalar accumulation. State arrays remain explicitly float32.
jax.config.update("jax_enable_x64", True)

# Honor the JAX_PLATFORMS env var even when a backend default was pinned by
# an earlier config update, so `JAX_PLATFORMS=cpu viprs_fit ...` behaves as
# documented.
if _os.environ.get("JAX_PLATFORMS"):
    try:
        jax.config.update("jax_platforms", _os.environ["JAX_PLATFORMS"])
    except Exception:  # pragma: no cover - backend already initialized
        pass

#: Root of the on-disk caches kept inside the checkout (listed in .gitignore).
CACHE_ROOT = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".cache")

#: Persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is unset.
COMPILE_CACHE_DIR = _os.path.join(CACHE_ROOT, "jax")


def _configure_compile_cache(environ=_os.environ):
    """Persistent compilation cache: the fused EM loop takes tens of seconds
    to compile, and caching it across processes makes repeated fits start at
    once. ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and
    is left alone; otherwise the cache goes to :data:`COMPILE_CACHE_DIR`.
    ``VIPRS_TPU_COMPILE_CACHE=0`` disables it. Returns the directory in use,
    or None."""
    if environ.get("VIPRS_TPU_COMPILE_CACHE", "1") == "0":
        return None
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    _os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return COMPILE_CACHE_DIR


_configure_compile_cache()

__version__ = "0.1.0"

def __getattr__(name):
    """Lazy top-level exports (avoids importing heavy modules for ops-only use)."""
    _model_exports = {'VIPRS', 'VIPRSMix', 'VIPRSGrid', 'BayesPRSModel', 'LDPredInf'}
    _grid_exports = {'HyperparameterGrid', 'select_best_model', 'bayesian_model_average'}
    if name in _model_exports:
        from . import model
        return getattr(model, name)
    if name in _grid_exports:
        from . import gridsearch
        return getattr(gridsearch, name)
    raise AttributeError(f"module 'viprs_tpu' has no attribute {name!r}")
