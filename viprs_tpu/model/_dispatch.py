"""Sweep-dispatch policy — the single source of truth for which e-step sweep
implementation a fused fit runs.

- ``'xla'``: the batched tile loop of ``ops/cavi_jax.py``. Plain JAX that
  compiles for every backend and that GSPMD partitions under a device mesh.
- ``'fused'``: the per-block Pallas kernel of ``ops/cavi_fused.py``, compiled
  through Triton. It needs a GPU backend, NO device mesh (``pallas_call``
  has no SPMD partitioning rule, so sharded state must stay on the XLA loop)
  and a block size and tile width that Triton can lower
  (``cavi_fused.shape_supported``: powers of two).

Every driver (VIPRS.fit including its compacted re-decision) calls
:func:`select_sweep_impl` instead of making this decision inline, and
``tests/test_dispatch.py`` asserts the decision table. Mixture fits always
run the XLA loop of ``ops/cavi_mix.py``.
"""

import jax

#: Sweep implementations a caller may request.
SWEEP_IMPLS = ('xla', 'fused')

#: Backends on which the fused kernel compiles (Pallas through Triton).
FUSED_BACKENDS = ('gpu',)

#: Lane counts S for which the measured policy picks the fused kernel. On
#: an H100 it took 1.9 ms per sweep against the XLA loop's 4.3 ms at S=1,
#: and 134 ms against 73 ms at S=100, where one program per (block, lane)
#: re-reads each block's LD per lane (PERF.md).
FUSED_LANES = range(1, 2)


def fused_allowed(mesh, block_size, tile, backend=None):
    """True iff the fused kernel may run at all: a GPU backend, no mesh, and
    a block size and tile width the kernel compiles for."""
    from ..ops.cavi_fused import shape_supported
    if backend is None:
        backend = jax.default_backend()
    return (backend in FUSED_BACKENDS and mesh is None
            and shape_supported(block_size, tile))


def select_sweep_impl(S, mesh, sweep_impl=None, backend=None, *, block_size,
                      tile):
    """Decide the sweep implementation for a fused fit.

    :param S: lane count of the fit (grid width; 1 for a single model).
    :param mesh: the model's ``jax.sharding.Mesh`` or None.
    :param sweep_impl: None (measured policy) or an explicit member of
        :data:`SWEEP_IMPLS`. Requesting ``'fused'`` off a GPU, under a mesh
        or for a block size / tile the kernel cannot compile is an error,
        not a silent fallback.
    :param backend: JAX backend name; defaults to ``jax.default_backend()``.
    :param block_size: the LD block size B of the fit.
    :param tile: the CAVI tile width of the fit.
    :returns: the implementation name.
    """
    from ..ops.cavi_fused import shape_supported
    if backend is None:
        backend = jax.default_backend()
    if sweep_impl not in (None,) + SWEEP_IMPLS:
        raise ValueError(f"sweep_impl must be None or one of {SWEEP_IMPLS}; "
                         f"got {sweep_impl!r}")
    if sweep_impl == 'fused':
        if backend not in FUSED_BACKENDS:
            raise ValueError(
                f"sweep_impl='fused' is a GPU kernel, but the active JAX "
                f"backend is {backend!r}; use sweep_impl='xla' (or None).")
        if mesh is not None:
            raise ValueError(
                f"sweep_impl='fused' cannot consume the GSPMD-sharded state "
                f"of the device mesh {tuple(mesh.shape.items())}; use "
                f"sweep_impl='xla' (or None) under a mesh.")
        if not shape_supported(block_size, tile):
            raise ValueError(
                f"sweep_impl='fused' needs a power-of-two tile and tile "
                f"count (Triton lowers only power-of-two shapes); got block "
                f"size {block_size}, tile {tile}; use sweep_impl='xla' "
                f"(or None).")
        return 'fused'
    if sweep_impl is None and S in FUSED_LANES \
            and fused_allowed(mesh, block_size, tile, backend):
        return 'fused'
    return 'xla'
