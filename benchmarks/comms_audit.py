#!/usr/bin/env python3
"""Communication audit for the mesh-sharded EM fit.

Compiles the production ``em_loop.em_fit`` over a ('blocks', 'grid') mesh on
the virtual CPU platform and COUNTS the collectives in the compiled HLO —
total ops, element counts, and bytes — separating the while-loop body
(per-EM-iteration cost) from one-time setup. The claim being audited: one EM
iteration communicates only O(S) scalars (the M-step/ELBO partial reductions
psum'd across the 'blocks' axis).

Usage:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python benchmarks/comms_audit.py [S]
"""

import os
import re
import sys
from pathlib import Path

_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8').strip()
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


DTYPE_BYTES = {'f64': 8, 'f32': 4, 'f16': 2, 'bf16': 2, 's64': 8, 's32': 4,
               'u64': 8, 'u32': 4, 'pred': 1, 's8': 1, 'u8': 1}

_SHAPE_RE = re.compile(r'(\w+)\[([\d,]*)\]')


_COLL_RE = re.compile(r'\b(all-reduce|all-gather|reduce-scatter|'
                      r'collective-permute|all-to-all)(?:-start)?\(')


def _op_bytes(line, op):
    """Sum output-shape bytes of an HLO collective line (incl. tuples)."""
    try:
        shapes = line.split('= ', 1)[1].split(f' {op}', 1)[0]
    except IndexError:
        return 0, 0
    total_b = total_e = 0
    for dt, dims in _SHAPE_RE.findall(shapes):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(','):
            if d:
                n *= int(d)
        total_e += n
        total_b += n * DTYPE_BYTES[dt]
    if not total_e and dt_pred_scalar(shapes):
        total_e, total_b = 1, 1
    return total_e, total_b


def dt_pred_scalar(shapes):
    return 'pred[]' in shapes or re.search(r'\b\w+\[\]', shapes)


def audit(S=4):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    import viprs_tpu  # noqa: F401
    from viprs_tpu.data.simulate import simulate_sumstats_blocks
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.model import VIPRSGrid, VIPRS
    from viprs_tpu.gridsearch import HyperparameterGrid
    from viprs_tpu.parallel.mesh import make_mesh
    from viprs_tpu.ops import em_loop
    from viprs_tpu.ops.updates import FixMask
    from viprs_tpu.ops.cavi_jax import CaviState, Hyper

    sim = simulate_sumstats_blocks(n=1500, block_sizes=(96, 80, 150, 120),
                                   h2=0.3, prop_causal=0.05, seed=0)
    ds = SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128)

    n_grid = 2 if S > 1 else 1
    mesh = make_mesh(len(jax.devices()) // n_grid, n_grid)
    if S > 1:
        grid = HyperparameterGrid(pi_steps=S, n_snps=ds.m,
                                  h2_est=0.3, h2_se=0.05)
        model = VIPRSGrid(ds, grid, mesh=mesh)
    else:
        model = VIPRS(ds, mesh=mesh)
    np.random.seed(0)
    model.initialize()
    model._refresh_inputs()

    # lower + compile the production em_fit under the mesh:
    kw = dict(n_sample=float(model.n), m_total=float(model.m),
              init_elbo=None, active0=jnp.ones(model._S, bool),
              max_iter=50, min_iter=1, f_abs_tol=1e-6, x_abs_tol=1e-6,
              patience=10, tile=model.tile, i0=0, counters0=em_loop.init_counters(model._S),
              sigma_g0=jnp.zeros(model._S, jnp.float64))
    with model._mesh_context():
        lowered = em_loop.em_fit.lower(
            model._ld, model._state, model._std_beta_flat, model._n_flat,
            model._hyper_f32(), model._fix_mask, **kw)
        compiled = lowered.compile()
    hlo = compiled.as_text()

    # classify per-iteration vs one-time via the op_name metadata XLA
    # attaches (ops inside the fused loop carry ".../while/body/..."):
    rows = {'body': {}, 'cond': {}, 'setup': {}}
    for line in hlo.splitlines():
        s = line.strip()
        mm = _COLL_RE.search(s)
        if not mm or '=' not in s:
            continue
        op = mm.group(1)
        e, b = _op_bytes(s, op)
        if '/while/body/' in s:
            sect = rows['body']
        elif '/while/cond/' in s:
            sect = rows['cond']
        else:
            sect = rows['setup']
        n, te, tb = sect.get(op, (0, 0, 0))
        sect[op] = (n + 1, te + e, tb + b)

    print(f"mesh: {dict(mesh.shape)}  S={model._S}  M={ds.m} "
          f"NB={ds.layout.nb}", file=sys.stderr)
    for sect in ('body', 'cond', 'setup'):
        tag = {'body': 'per EM iteration (while-loop body)',
               'cond': 'per EM iteration (loop condition)',
               'setup': 'one-time (outside the loop)'}[sect]
        print(f"--- collectives {tag} ---", file=sys.stderr)
        if not rows[sect]:
            print("  (none)", file=sys.stderr)
        tot_b = 0
        for op, (n, e, b) in sorted(rows[sect].items()):
            print(f"  {op:20s} x{n:3d}  {e:8d} elements  {b:8d} bytes",
                  file=sys.stderr)
            tot_b += b
        print(f"  TOTAL {tot_b} bytes", file=sys.stderr)
    body_bytes = sum(b for _, _, b in rows['body'].values())
    import json
    print(json.dumps({"metric": "psum_bytes_per_em_iteration",
                      "value": body_bytes, "unit": "bytes",
                      "S": model._S, "mesh": dict(mesh.shape)}))


if __name__ == '__main__':
    audit(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
