"""Multi-chip sharding of the blocked CAVI problem.

The reference's "distributed" axes are joblib processes over chromosomes and
shared-memory processes over grid points (SURVEY.md §2.4). Here both collapse
into array sharding over a device mesh:

- axis ``blocks``: the NB (LD-block) axis of every array — chromosomes are just
  block ranges, so this subsumes the per-chromosome fan-out. Blocks are
  independent in the e-step (block-diagonal LD) or couple only through the
  banded q-refresh, which XLA lowers to neighbor collective-permutes.
- axis ``grid``: the model axis S (grid points), the analog of the reference's
  process-parallel grid search.

Because the e-step sweep is already expressed as batched ops over (S, NB, B)
arrays inside one ``jit``, GSPMD partitions it automatically once the inputs
carry NamedShardings; the M-step/ELBO reductions become cross-device psums
inserted by XLA. No communication code is needed here — only
placement.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.block_ld import BlockLD
from ..ops.cavi_jax import CaviState


def make_mesh(n_blocks_axis=None, n_grid_axis=1, devices=None):
    """Create a ('blocks', 'grid') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_blocks_axis is None:
        n_blocks_axis = n // n_grid_axis
    assert n_blocks_axis * n_grid_axis == n, \
        f"mesh {n_blocks_axis}x{n_grid_axis} != {n} devices"
    dev_array = np.asarray(devices).reshape(n_blocks_axis, n_grid_axis)
    return Mesh(dev_array, ('blocks', 'grid'))


def resolve_mesh(mesh='auto'):
    """Resolve a user-facing mesh spec into a ('blocks', 'grid') Mesh or None.

    This is the product knob replacing the reference CLI's ``--n-jobs``
    process fan-out (bin/viprs_fit:1079-1086): here the fan-out is array
    sharding over the device mesh, not processes.

    :param mesh: one of
        - ``'auto'``: all visible devices on the ``blocks`` axis when there is
          more than one device; ``None`` (single-device) otherwise;
        - ``None`` / ``'off'`` / ``False``: single-device execution;
        - a ``jax.sharding.Mesh`` with axes ('blocks', 'grid'): used as-is;
        - a string ``'<NB>x<NG>'`` (e.g. ``'4x2'``): explicit axis sizes.
    """
    if mesh is None or mesh is False or mesh == 'off':
        return None
    if isinstance(mesh, Mesh):
        assert set(mesh.axis_names) == {'blocks', 'grid'}, \
            f"mesh must have axes ('blocks', 'grid'); got {mesh.axis_names}"
        return mesh
    if mesh == 'auto':
        n = len(jax.devices())
        return make_mesh(n, 1) if n > 1 else None
    if isinstance(mesh, str) and 'x' in mesh:
        nb_ax, g_ax = (int(v) for v in mesh.split('x', 1))
        return make_mesh(nb_ax, g_ax)
    raise ValueError(f"Cannot resolve mesh spec {mesh!r}; expected 'auto', "
                     f"'off', '<NB>x<NG>', or a jax Mesh.")


def shard_ld(mesh: Mesh, ld: BlockLD) -> BlockLD:
    """Pad the NB axis to the mesh's blocks-axis size and place the LD tiles
    block-sharded (coupling tiles are few and stay replicated)."""
    ld = pad_blocks(ld, mesh.shape['blocks'])
    sh = lambda spec: NamedSharding(mesh, spec)  # noqa: E731
    return BlockLD(
        diag=jax.device_put(ld.diag, sh(P('blocks', None, None))),
        off_data=jax.device_put(ld.off_data, sh(P(None, None, None))),
        off_src=jax.device_put(ld.off_src, sh(P(None))),
        off_dst=jax.device_put(ld.off_dst, sh(P(None))),
        mask=jax.device_put(ld.mask, sh(P('blocks', None))),
        scale=ld.scale)


def shard_flat(mesh: Mesh, x, target_nb: int):
    """Pad an (NB, B) per-variant input to target_nb blocks and block-shard."""
    x = _pad_axis(jnp.asarray(x), 0, target_nb)
    return jax.device_put(x, NamedSharding(mesh, P('blocks', None)))


def shard_state(mesh: Mesh, state: CaviState, target_nb: int) -> CaviState:
    """Pad an (S, NB, B) CaviState to target_nb blocks and place it with
    ('grid', 'blocks') sharding on the (S, NB) axes."""
    state = CaviState(*(_pad_axis(jnp.asarray(x), 1, target_nb) for x in state))
    sh = NamedSharding(mesh, P('grid', 'blocks', None))
    return CaviState(*(jax.device_put(x, sh) for x in state))


def pad_blocks(ld: BlockLD, multiple: int) -> BlockLD:
    """Pad the NB axis with empty blocks to a multiple (for even sharding)."""
    nb = ld.nb
    target = ((nb + multiple - 1) // multiple) * multiple
    if target == nb:
        return ld
    pad = target - nb
    diag = jnp.concatenate(
        [ld.diag, jnp.zeros((pad,) + ld.diag.shape[1:], ld.diag.dtype)], axis=0)
    mask = jnp.concatenate(
        [ld.mask, jnp.zeros((pad, ld.block_size), ld.mask.dtype)], axis=0)
    # coupling-tile indices remain valid (padding appends blocks at the end):
    return BlockLD(diag=diag, off_data=ld.off_data, off_src=ld.off_src,
                   off_dst=ld.off_dst, mask=mask, scale=ld.scale)


def _pad_axis(x, axis, target):
    pad = target - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def shard_problem(mesh: Mesh, ld: BlockLD, state: CaviState,
                  std_beta, n_per_snp):
    """Place the problem arrays on the mesh with block/grid shardings.

    Pads NB (and S) to multiples of the respective mesh axis sizes; padded
    blocks carry mask=0 so they contribute nothing to updates or reductions.

    :returns: (ld, state, std_beta, n_per_snp) device-placed.
    """
    s_mult = mesh.shape['grid']

    ld = shard_ld(mesh, ld)
    target_nb = ld.nb
    S = state.logits.shape[0]
    target_s = ((S + s_mult - 1) // s_mult) * s_mult

    state = CaviState(*(_pad_axis(x, 0, target_s) for x in state))
    state = shard_state(mesh, state, target_nb)
    std_beta = shard_flat(mesh, std_beta, target_nb)
    n_per_snp = shard_flat(mesh, n_per_snp, target_nb)

    return ld, state, std_beta, n_per_snp
