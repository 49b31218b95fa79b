#!/usr/bin/env python3
"""Full-scale (1.1M-variant) fixed-point parity vs the REFERENCE's own
compiled kernel.

Round 2 established, on the identical genome-scale problem, that the
reference's compiled ``e_step`` restarts on negative MSE at iteration 7 (this
framework: 8) — ladder parity. This harness closes the remaining gap: it runs
the reference's compiled C++ kernel (built from the read-only mount by
tests/golden_kernel.py) under a float64 M-step/ELBO/ladder driver — the
reference Python layer's exact arithmetic (viprs/model/VIPRS.py:909-1124),
including the restart-with-sigma_eps-0.95 — to ITS fixed point, and compares
the post-restart final state against this framework's production fit on the
byte-identical int8 LD:

  - heritability, sigma_eps, pi, final ELBO
  - posterior correlation (eta, PIP) and max absolute differences

Both sides consume the SAME int8-quantized LD (quantize once, feed the tiles
verbatim to pack_dense_blocks and the banded reference layout) and the SAME
explicit theta_0 (drawn once with the framework's initialize_theta formulas),
so any disagreement is algorithmic, not data or initialization noise.

Usage: python benchmarks/golden_fullscale.py [--m M] [--max-iter N]
One JSON line on stdout; narrative to stderr. Wall-clock is dominated by the
single-threaded reference kernel (~2-5 s/iteration at 1.1M).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'tests'))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_banded_int8(blocks_per_chrom):
    """Block-diagonal genome -> the reference's banded symmetric layout.

    Every dense block's full rows become banded rows (left bound = block
    start); int8 tiles pass through verbatim, so the bytes match the BlockLD
    tiles exactly.
    """
    data_parts, left_parts, row_lens = [], [], []
    offset = 0
    for c in sorted(blocks_per_chrom):
        for blk in blocks_per_chrom[c]:
            m_i = blk.shape[0]
            data_parts.append(np.ascontiguousarray(blk).reshape(-1))
            left_parts.append(np.full(m_i, offset, np.int32))
            row_lens.append(np.full(m_i, m_i, np.int64))
            offset += m_i
    data = np.concatenate(data_parts)
    indptr = np.concatenate([[0], np.cumsum(np.concatenate(row_lens))])
    left = np.concatenate(left_parts)
    return (np.ascontiguousarray(data),
            np.asarray(indptr, np.int64),
            np.ascontiguousarray(left, np.int32))


def reference_fit(kern, banded, std_beta, n_per_snp, theta0, restart_theta,
                  max_iter=1000, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10,
                  dq_scale=1.0 / 127.0):
    """The reference's EM driver in float64 around its compiled kernel:
    e_step (compiled, sequential/1-thread) + closed-form M-step + ELBO +
    the health ladder incl. one restart-on-negative-MSE
    (viprs/model/VIPRS.py:909-1124, 1025-1038)."""
    import reference_impl as ri

    M = len(std_beta)
    n = float(n_per_snp.max())
    pi, sigma_eps, tau_beta = theta0
    fix_sigma_eps = None
    gamma = np.full(M, pi)
    mu = np.zeros(M)
    eta = np.zeros(M)
    q = np.zeros(M)
    sigma_g = 0.0
    prev_elbo = None
    restarted = False
    restart_iter = None
    sigg_streak = 0
    message = 'max_iter'
    history = []

    t0 = time.time()
    for it in range(1, max_iter + 1):
        eta_before = eta.copy()
        var_tau, _ = kern.e_step(banded, std_beta, n_per_snp, gamma, mu, eta,
                                 q, sigma_eps, tau_beta, pi,
                                 dq_scale=dq_scale)
        prev_sigma_g = sigma_g
        pi, tau_beta, sigma_g, sigma_eps, zeta = ri.m_step(
            std_beta, gamma, mu, eta, q, var_tau, 0.0,
            fix_sigma_eps=fix_sigma_eps)
        e = ri.elbo(std_beta, n, gamma, eta, zeta, var_tau, pi, tau_beta,
                    sigma_eps, sigma_g,
                    sigma_eps_fixed=fix_sigma_eps is not None)
        history.append(e)
        mse = 1.0 - 2.0 * std_beta.dot(eta) + sigma_g - zeta.sum() \
            + (eta ** 2).sum()
        max_ed = np.max(np.abs(eta - eta_before))
        h2 = sigma_g / (sigma_g + sigma_eps)
        if it % 10 == 0 or it < 12:
            log(f"  [ref] it {it}: elbo={e:.2f} h2={h2:.4f} mse={mse:.4f} "
                f"max|d_eta|={max_ed:.2e} ({time.time() - t0:.0f}s)")

        # ---- ladder (VIPRS.py:1022-1097) ----
        if mse < 0.0 and not restarted:
            log(f"  [ref] MSE negative at iteration {it}; restarting with "
                f"sigma_eps fixed at 0.95")
            restarted, restart_iter = True, it
            pi, sigma_eps, tau_beta = restart_theta
            fix_sigma_eps = sigma_eps
            gamma = np.full(M, pi)
            mu = np.zeros(M)
            eta = np.zeros(M)
            q = np.zeros(M)
            sigma_g, prev_elbo, sigg_streak = 0.0, None, 0
            continue
        if not np.isfinite(e) or sigma_eps < 0 or not (0.0 <= h2 <= 1.0):
            message = 'pathological'
            break
        if prev_elbo is not None and it > 3:
            if abs(e - prev_elbo) <= f_abs_tol:
                message = 'converged_f'
                break
            if max_ed < x_abs_tol:
                message = 'converged_x'
                break
        if (it > 3 and abs(sigma_g - prev_sigma_g) <= x_abs_tol
                and max_ed < 10 * x_abs_tol):
            sigg_streak += 1
            if sigg_streak > patience:
                message = 'converged_sigma_g'
                break
        else:
            sigg_streak = 0
        prev_elbo = e

    return dict(gamma=gamma, mu=mu, eta=eta, q=q, pi=pi, tau_beta=tau_beta,
                sigma_eps=sigma_eps, sigma_g=sigma_g, elbo=history[-1],
                h2=sigma_g / (sigma_g + sigma_eps), n_iter=it,
                restart_iter=restart_iter, message=message,
                seconds=time.time() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--m', type=int, default=1_100_000)
    ap.add_argument('--max-iter', type=int, default=1000)
    args = ap.parse_args()

    import viprs_tpu  # noqa: F401
    import bench
    import golden_kernel
    from viprs_tpu.data.dataset import SummaryStatsDataset
    from viprs_tpu.model import VIPRS
    from viprs_tpu.ops.block_ld import quantize_int8

    t0 = time.time()
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(m_target=args.m)
    # quantize ONCE; both sides consume these exact int8 bytes:
    ld_q = {c: [quantize_int8(b) for b in blocks]
            for c, blocks in ld_blocks.items()}
    del ld_blocks
    log(f"synthesis+quantize: {time.time() - t0:.1f}s")

    ds = SummaryStatsDataset.from_dense_blocks(
        ld_q, std_beta, n_per_snp, block_size=1024, quantize=True)

    # one explicit theta_0 for both sides (framework initialize_theta math,
    # reference VIPRS.py:245-316), and the restart theta at sigma_eps=0.95:
    np.random.seed(0)
    probe = VIPRS(ds)
    pi0, se0, tb0 = probe._resolve_theta0(None)
    theta_0 = {'pi': pi0, 'sigma_epsilon': se0, 'tau_beta': tb0}
    r_pi, r_se, r_tau = probe._resolve_theta0(
        {**theta_0, 'sigma_epsilon': 0.95})
    log(f"theta_0: pi={pi0:.6g} sigma_eps={se0:.6g} tau_beta={tb0:.6g}; "
        f"restart: sigma_eps={r_se}")

    # ---- this framework's production fit ----
    np.random.seed(0)
    t0 = time.time()
    model = VIPRS(ds)
    model.fit(max_iter=args.max_iter, theta_0=theta_0)
    ours_seconds = time.time() - t0
    ours_restarted = model.fix_params.get('sigma_epsilon') == 0.95
    eta_ours = np.concatenate(
        [model.post_mean_beta[c] for c in sorted(model.post_mean_beta)])
    pip_ours = np.concatenate([model.pip[c] for c in sorted(model.pip)])
    h2_ours = float(model.get_heritability())
    elbo_ours = float(np.atleast_1d(model.history['ELBO'][-1])[0])
    log(f"[ours] {ours_seconds:.1f}s, {model.optim_result.nit} iters, "
        f"h2={h2_ours:.4f}, elbo={elbo_ours:.2f}, restarted={ours_restarted}")

    # ---- the reference's compiled kernel + f64 driver ----
    t0 = time.time()
    banded = build_banded_int8(ld_q)
    log(f"banded build: {time.time() - t0:.1f}s "
        f"({banded[0].nbytes / 1e9:.2f} GB int8, "
        f"nnz={len(banded[0]):,})")
    sb_cat = np.concatenate([std_beta[c] for c in sorted(std_beta)])
    n_cat = np.concatenate([n_per_snp[c] for c in sorted(n_per_snp)])
    kern = golden_kernel.RefKernel()
    ref = reference_fit(kern, banded, sb_cat, n_cat,
                        (pi0, se0, tb0), (r_pi, r_se, r_tau),
                        max_iter=args.max_iter)
    log(f"[ref] {ref['seconds']:.0f}s, {ref['n_iter']} iters "
        f"({ref['message']}), h2={ref['h2']:.4f}, elbo={ref['elbo']:.2f}, "
        f"restart at {ref['restart_iter']}")

    # ---- cross fixed-point check ----
    # The sharpest parity statement at a multi-modal genome-scale objective
    # is NOT trajectory identity (the late inclusion-flip phase lands in
    # equivalent modes) but stationarity: OUR solution must be a (near-)
    # fixed point of the REFERENCE'S OWN compiled kernel. Run 5 reference
    # sweeps from our final state at our final hyperparameters and measure
    # the drift.
    mu_ours_d = {}
    q_ours_d = {}
    st = model._state
    lay = ds.layout
    mu_ours_d = lay.from_flat(np.asarray(st.mu[0], dtype=np.float64)
                              .reshape(-1))
    q_ours_d = lay.from_flat(np.asarray(st.q[0], dtype=np.float64)
                             .reshape(-1))
    mu_cat = np.concatenate([mu_ours_d[c] for c in sorted(mu_ours_d)])
    q_cat = np.concatenate([q_ours_d[c] for c in sorted(q_ours_d)])
    g_x = pip_ours.astype(np.float64).copy()
    mu_x = mu_cat.copy()
    eta_x = eta_ours.astype(np.float64).copy()
    q_x = q_cat.copy()
    h = model._hyper
    se_f = float(np.atleast_1d(h.sigma_eps)[0])
    tb_f = float(np.atleast_1d(h.tau_beta)[0])
    pi_f = float(np.atleast_1d(h.pi)[0])
    drifts = []
    for _ in range(5):
        eta_prev = eta_x.copy()
        kern.e_step(banded, sb_cat, n_cat, g_x, mu_x, eta_x, q_x,
                    se_f, tb_f, pi_f, dq_scale=1.0 / 127.0)
        drifts.append(float(np.max(np.abs(eta_x - eta_prev))))
    drift_corr = float(np.corrcoef(eta_x, eta_ours)[0, 1])
    log(f"cross fixed-point: max|d_eta| per reference sweep from our "
        f"solution: {['%.2e' % d for d in drifts]}; eta corr after 5 "
        f"sweeps: {drift_corr:.6f}")

    # ---- comparison ----
    eta_ref = ref['eta']
    pip_ref = ref['gamma']
    eta_corr = float(np.corrcoef(eta_ours, eta_ref)[0, 1])
    pip_corr = float(np.corrcoef(pip_ours, pip_ref)[0, 1])
    sel_a = pip_ours > 0.5
    sel_b = pip_ref > 0.5
    out = {
        "metric": "golden_fullscale_parity",
        "m_variants": int(len(sb_cat)),
        "ours": {"h2": round(h2_ours, 6), "elbo": round(elbo_ours, 2),
                 "nit": int(model.optim_result.nit),
                 "restarted": bool(ours_restarted),
                 "seconds": round(ours_seconds, 1)},
        "reference_kernel": {"h2": round(ref['h2'], 6),
                             "elbo": round(float(ref['elbo']), 2),
                             "nit": int(ref['n_iter']),
                             "restart_iter": ref['restart_iter'],
                             "message": ref['message'],
                             "seconds": round(ref['seconds'], 1)},
        "agreement": {
            "h2_abs_diff": round(abs(h2_ours - ref['h2']), 6),
            "elbo_rel_diff": round(
                abs(elbo_ours - ref['elbo']) / abs(ref['elbo']), 8),
            "eta_corr": round(eta_corr, 6),
            "pip_corr": round(pip_corr, 6),
            "eta_max_abs_diff": round(
                float(np.max(np.abs(eta_ours - eta_ref))), 8),
            "n_selected_ours": int(sel_a.sum()),
            "n_selected_ref": int(sel_b.sum()),
            "selection_overlap": int((sel_a & sel_b).sum()),
        },
        "cross_fixed_point": {
            "ref_sweep_drift_from_ours": [round(d, 8) for d in drifts],
            "eta_corr_after_5_ref_sweeps": round(drift_corr, 6),
        },
    }
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
