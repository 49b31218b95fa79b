"""viprs_fit — fit variational PRS models to GWAS summary statistics.

CLI parity with the reference's bin/viprs_fit (EM / grid-search / BMA modes,
hyperparameter grid flags, PUMAS splitting, validation-based selection,
profiler metrics, logging), restructured for the accelerator execution model: all
chromosomes are fit jointly as sharded block ranges (the reference's
``--genomewide`` semantics are the default; per-chromosome process fan-out has
no accelerator analog).
"""

import argparse
import json
import logging
import os
import os.path as osp
import sys
import time

import numpy as np

logger = logging.getLogger("viprs_fit")


def build_parser():
    parser = argparse.ArgumentParser(
        prog='viprs_fit',
        description="Fit variational Bayesian PRS models (viprs in JAX).")

    # ------------------------------ data ------------------------------
    parser.add_argument('-l', '--ld-panel', dest='ld_dir', required=True,
                        help="Path (or glob) to the LD store directory/directories.")
    parser.add_argument('-s', '--sumstats', dest='sumstats_path', required=True,
                        help="Path (or glob) to the GWAS summary statistics file(s).")
    parser.add_argument('--sumstats-format', dest='sumstats_format',
                        default='magenpy',
                        choices=['plink1.9', 'plink2', 'cojo', 'magenpy', 'fastgwa',
                                 'ssf', 'gwas-ssf', 'gwascatalog', 'saige', 'custom'])
    parser.add_argument('--custom-sumstats-mapper', dest='custom_mapper', default=None,
                        help="Comma-separated file_col=canonical_col pairs for "
                             "--sumstats-format custom.")
    parser.add_argument('--custom-sumstats-sep', dest='custom_sep', default=None,
                        help="Field separator for custom-format sumstats.")
    parser.add_argument('--gwas-sample-size', dest='gwas_n', type=float, default=None,
                        help="Fallback GWAS sample size when the file lacks N.")
    parser.add_argument('--extract', dest='extract_file', default=None,
                        help="File with variant IDs to restrict the analysis to.")
    parser.add_argument('--exclude-lrld', dest='exclude_lrld', action='store_true',
                        help="Exclude long-range LD regions.")
    parser.add_argument('--block-size', dest='block_size', type=int, default=1024,
                        help="LD tile size (multiple of 128).")
    parser.add_argument('--dequantize-on-the-fly', dest='dequantize',
                        action='store_true',
                        help="Keep LD int8-quantized in HBM, dequantize in-kernel.")

    # ------------------------------ model -----------------------------
    parser.add_argument('-m', '--model', dest='model', default='VIPRS',
                        choices=['VIPRS', 'VIPRSMix', 'VIPRSGrid'])
    parser.add_argument('--n-components', dest='n_components', type=int, default=3,
                        help="Number of slab components for VIPRSMix.")
    parser.add_argument('--hyp-search', dest='hyp_search', default='EM',
                        choices=['EM', 'GS', 'BMA'],
                        help="EM: learn hyperparameters; GS: grid search; "
                             "BMA: Bayesian model averaging over the grid.")
    parser.add_argument('--grid-metric', dest='grid_metric', default='ELBO',
                        choices=['ELBO', 'validation', 'pseudo_validation'])
    parser.add_argument('--pathwise', dest='pathwise', action='store_true',
                        help="Serial warm-started grid schedule instead of the "
                             "simultaneous vmapped fit.")
    parser.add_argument('--grid-search-mode', dest='grid_search_mode',
                        default=None, choices=['pathwise', 'simultaneous'],
                        help="Alias for --pathwise (reference flag).")

    # grid specification:
    parser.add_argument('--pi-grid', dest='pi_grid', default=None,
                        help="Comma-separated grid values for pi.")
    parser.add_argument('--pi-steps', dest='pi_steps', type=int, default=None)
    parser.add_argument('--sigma-epsilon-grid', dest='sigma_epsilon_grid', default=None)
    parser.add_argument('--sigma-epsilon-steps', dest='sigma_epsilon_steps',
                        type=int, default=None)
    parser.add_argument('--tau-beta-grid', dest='tau_beta_grid', default=None)
    parser.add_argument('--tau-beta-steps', dest='tau_beta_steps', type=int,
                        default=None)
    parser.add_argument('--lambda-min-steps', dest='lambda_min_steps', type=int,
                        default=None)
    parser.add_argument('--h2-est', dest='h2_est', type=float, default=None)
    parser.add_argument('--h2-se', dest='h2_se', type=float, default=None)

    # fixed hyperparameters:
    parser.add_argument('--fix-pi', dest='fix_pi', type=float, default=None)
    parser.add_argument('--fix-sigma-epsilon', dest='fix_sigma_epsilon',
                        type=float, default=None)
    parser.add_argument('--fix-tau-beta', dest='fix_tau_beta', type=float,
                        default=None)
    parser.add_argument('--lambda-min', dest='lambda_min', default=None,
                        help="Numeric value or 'infer'.")

    # ---------------------------- validation --------------------------
    parser.add_argument('--validation-bed', '--validation-bfile',
                        dest='validation_bed', default=None,
                        help="BED fileset with individual-level validation data "
                             "(for --grid-metric validation).")
    parser.add_argument('--validation-pheno', dest='validation_pheno', default=None)
    parser.add_argument('--validation-keep', dest='validation_keep', default=None)
    parser.add_argument('--validation-sumstats', dest='validation_sumstats',
                        default=None,
                        help="Independent sumstats for pseudo-validation.")
    parser.add_argument('--validation-sumstats-format',
                        dest='validation_sumstats_format', default=None,
                        help="Format of the validation sumstats (defaults to "
                             "--sumstats-format).")
    parser.add_argument('--validation-custom-sumstats-mapper',
                        dest='validation_custom_mapper', default=None,
                        help="Comma-separated file_col=canonical_col pairs for "
                             "custom-format validation sumstats "
                             "(reference bin/viprs_fit --validation-custom-"
                             "sumstats-mapper).")
    parser.add_argument('--validation-custom-sumstats-sep',
                        dest='validation_custom_sep', default=None,
                        help="Field separator for custom-format validation "
                             "sumstats.")
    parser.add_argument('--validation-gwas-sample-size',
                        dest='validation_gwas_n', type=float, default=None)
    parser.add_argument('--validation-ld-panel', dest='validation_ld_panel',
                        default=None,
                        help="Accepted for reference compatibility; the "
                             "training LD panel is reused for pseudo-validation.")
    parser.add_argument('--prop-train', dest='prop_train', type=float, default=0.8,
                        help="PUMAS training proportion when splitting sumstats.")

    # ------------------------------- fit ------------------------------
    parser.add_argument('--max-iter', dest='max_iter', type=int, default=1000)
    parser.add_argument('--min-iter', dest='min_iter', type=int, default=3)
    parser.add_argument('--f-abs-tol', dest='f_abs_tol', type=float, default=1e-6)
    parser.add_argument('--x-abs-tol', dest='x_abs_tol', type=float, default=1e-6)
    parser.add_argument('--patience', dest='patience', type=int, default=10)
    parser.add_argument('--float-precision', dest='float_precision',
                        default='float32', choices=['float32', 'float64'])
    parser.add_argument('--sweep-impl', dest='sweep_impl', default='auto',
                        choices=['auto', 'xla', 'fused'],
                        help="E-step sweep implementation of VIPRS and "
                             "VIPRSGrid. 'auto' (default) applies the "
                             "measured dispatch policy "
                             "(model/_dispatch.py); an explicit value "
                             "overrides it.")
    parser.add_argument('--threads', dest='threads', type=int, default=1,
                        help="Accepted for compatibility; device execution ignores it.")
    parser.add_argument('--n-jobs', dest='n_jobs', type=int, default=1,
                        help="Accepted for compatibility; chromosomes are fit "
                             "jointly on the device (see --mesh for the "
                             "parallelism knob).")
    parser.add_argument('--device-memory-gb', dest='device_memory_gb',
                        type=float, default=None,
                        help="Per-device HBM budget for the LD capacity "
                             "planner. When the packed LD exceeds ~65%% of "
                             "the total budget (devices x this), the fit "
                             "streams over chromosome groups (the exact "
                             "analog of the reference's per-chromosome mode, "
                             "bin/viprs_fit:232-238). Default: auto-detected "
                             "from the accelerator's memory limit; no streaming "
                             "on the CPU.")
    parser.add_argument('--mesh', dest='mesh', default='auto',
                        help="Multi-device placement: 'auto' (default: shard "
                             "LD blocks over all visible devices), 'off' "
                             "(single device), or explicit '<NB>x<NG>' "
                             "('blocks' x 'grid') axis sizes. The "
                             "replacement for the reference's --n-jobs "
                             "process fan-out.")
    parser.add_argument('--genomewide', dest='genomewide', action='store_true',
                        help="Accepted for compatibility (always genome-wide).")
    parser.add_argument('--backend', dest='backend', default='xarray',
                        help="Accepted for compatibility; data IO is native.")
    parser.add_argument('--temp-dir', dest='temp_dir', default='temp',
                        help="Accepted for compatibility.")
    parser.add_argument('--use-symmetric-ld', dest='use_symmetric_ld',
                        action='store_true',
                        help="Accepted for compatibility; the dense LD tiles "
                             "are symmetric by construction.")

    # ------------------------------ output ----------------------------
    parser.add_argument('--output-file', dest='output_file', default=None,
                        help="Output prefix (writes <prefix>.fit.gz etc.).")
    parser.add_argument('--output-dir', dest='output_dir', default=None,
                        help="Output directory (reference-style; combine with "
                             "--output-file-prefix).")
    parser.add_argument('--output-file-prefix', dest='output_prefix',
                        default='VIPRS',
                        help="Output file prefix when using --output-dir.")
    parser.add_argument('--output-profiler-metrics', dest='profiler',
                        action='store_true')
    parser.add_argument('--log-level', dest='log_level', default='WARNING')
    parser.add_argument('--seed', dest='seed', type=int, default=None)

    return parser


def _parse_grid_values(s):
    return np.array([float(v) for v in s.split(',')]) if s else None


def check_args(args):
    if args.output_file is None:
        assert args.output_dir, "Provide --output-file or --output-dir."
        import os.path as _osp
        args.output_file = _osp.join(args.output_dir, args.output_prefix)
    if args.grid_search_mode == 'pathwise':
        args.pathwise = True
    if args.hyp_search in ('GS', 'BMA') and args.model != 'VIPRSGrid':
        args.model = 'VIPRSGrid'
    if args.model == 'VIPRSGrid' and args.hyp_search == 'EM':
        args.hyp_search = 'GS'
    if args.model == 'VIPRSGrid':
        has_grid = any([args.pi_grid, args.pi_steps, args.sigma_epsilon_grid,
                        args.sigma_epsilon_steps, args.tau_beta_grid,
                        args.tau_beta_steps, args.lambda_min_steps])
        if not has_grid:
            args.pi_steps = 10
    assert args.sweep_impl == 'auto' or args.model != 'VIPRSMix', \
        "--sweep-impl applies to VIPRS and VIPRSGrid; VIPRSMix always runs " \
        "the XLA tile loop."
    if args.grid_metric == 'validation':
        assert args.validation_bed and args.validation_pheno, \
            "--grid-metric validation requires --validation-bed and --validation-pheno"
    return args


def init_data(args):
    from ..data.loader import GWADataLoader

    extract = None
    if args.extract_file:
        import pandas as pd
        extract = pd.read_csv(args.extract_file, header=None).iloc[:, 0].tolist()

    kwargs = {}
    if args.custom_mapper:
        kwargs['column_map'] = dict(kv.split('=') for kv in args.custom_mapper.split(','))
    if args.custom_sep:
        kwargs['sep'] = args.custom_sep

    loader = GWADataLoader(
        ld_store_files=args.ld_dir,
        sumstats_files=args.sumstats_path,
        sumstats_format=args.sumstats_format,
        n=args.gwas_n,
        block_size=args.block_size,
        quantize_ld=args.dequantize,
        **kwargs)

    if extract is not None:
        loader.filter_snps(extract)
    if args.exclude_lrld:
        loader.filter_long_range_ld_regions()

    validation_gdl = None
    if args.validation_bed:
        keep = None
        if args.validation_keep:
            import pandas as pd
            keep = set(pd.read_csv(args.validation_keep, sep=r'\s+',
                                   header=None).iloc[:, -1].astype(str))
        validation_gdl = GWADataLoader(
            bed_files=args.validation_bed,
            phenotype_file=args.validation_pheno,
            keep_samples=keep)

    validation_ss = None
    if args.validation_sumstats:
        from ..data.sumstats import read_sumstats
        vkwargs = {}
        if args.validation_custom_mapper:
            vkwargs['column_map'] = dict(
                kv.split('=') for kv in args.validation_custom_mapper.split(','))
        if args.validation_custom_sep:
            vkwargs['sep'] = args.validation_custom_sep
        validation_ss = read_sumstats(
            args.validation_sumstats,
            sumstats_format=args.validation_sumstats_format or args.sumstats_format,
            n=args.validation_gwas_n or args.gwas_n,
            **vkwargs)

    return loader, validation_gdl, validation_ss


def prepare_model(args, dataset):
    from ..model import VIPRS, VIPRSMix, VIPRSGrid
    from ..gridsearch import HyperparameterGrid

    fix_params = {}
    if args.fix_pi is not None:
        fix_params['pi'] = args.fix_pi
    if args.fix_sigma_epsilon is not None:
        fix_params['sigma_epsilon'] = args.fix_sigma_epsilon
    if args.fix_tau_beta is not None:
        fix_params['tau_beta'] = args.fix_tau_beta

    lam = args.lambda_min
    if lam is not None and lam != 'infer':
        lam = float(lam)

    common = dict(fix_params=fix_params, lambda_min=lam,
                  float_precision=args.float_precision,
                  mesh=getattr(args, 'mesh', 'auto'))

    if args.model == 'VIPRS':
        return VIPRS(dataset, **common)
    if args.model == 'VIPRSMix':
        common.pop('float_precision', None)
        return VIPRSMix(dataset, K=args.n_components,
                        fix_params=fix_params,
                        lambda_min=None if lam == 'infer' else lam,
                        mesh=getattr(args, 'mesh', 'auto'))

    from ..data.ldsc import simple_ldsc
    try:
        h2_est = args.h2_est or float(np.clip(simple_ldsc(dataset), 0.01, 0.99))
    except Exception:
        h2_est = 0.1
    grid = HyperparameterGrid(
        sigma_epsilon_grid=_parse_grid_values(args.sigma_epsilon_grid),
        sigma_epsilon_steps=args.sigma_epsilon_steps,
        tau_beta_grid=_parse_grid_values(args.tau_beta_grid),
        tau_beta_steps=args.tau_beta_steps,
        pi_grid=_parse_grid_values(args.pi_grid),
        pi_steps=args.pi_steps,
        lambda_min_steps=args.lambda_min_steps,
        h2_est=h2_est, h2_se=args.h2_se,
        n_snps=dataset.m)
    return VIPRSGrid(dataset, grid, **common)


def fit_model(args, model, validation_gdl, validation_ss):
    from ..gridsearch import select_best_model, bayesian_model_average

    pumas_split = (args.model == 'VIPRSGrid'
                   and args.grid_metric == 'pseudo_validation'
                   and validation_gdl is None and validation_ss is None)
    if pumas_split:
        logger.info("> No validation data provided; splitting the GWAS summary "
                    "statistics (PUMAS).")
        model.split_gwas_sumstats(prop_train=args.prop_train, seed=args.seed)

    fit_kwargs = dict(max_iter=args.max_iter, min_iter=args.min_iter,
                      f_abs_tol=args.f_abs_tol,
                      x_abs_tol=args.x_abs_tol, patience=args.patience,
                      # live ELBO progress on interactive runs (reference tqdm
                      # behavior); quiet in pipelines/captured output:
                      disable_pbar=not sys.stderr.isatty())
    if args.sweep_impl != 'auto':
        fit_kwargs['sweep_impl'] = args.sweep_impl
    if args.model == 'VIPRSGrid':
        fit_kwargs['pathwise'] = args.pathwise

    t0 = time.time()
    model.fit(**fit_kwargs)
    if model.optim_result.error_on_termination:
        # The reference's one automatic retry is gated on a specific divergence
        # signature: sigma_g < 0 with no spectral regularization applied
        # (bin/viprs_fit:509-521). Anything else is a hard error — do NOT
        # blanket-catch exceptions here, real bugs must surface as their own
        # tracebacks.
        if (np.any(np.atleast_1d(model.sigma_g) < 0)
                and np.all(np.atleast_1d(model.lambda_min) == 0.0)):
            logger.warning("> Optimization diverged; retrying with inferred "
                           "lambda_min (reference behavior).")
            model.set_fixed_params({'lambda_min': model.infer_lambda_min()})
            model.fit(**fit_kwargs)
        else:
            raise RuntimeError(model.optim_result.message)
    fit_time = time.time() - t0

    if args.model == 'VIPRSGrid':
        if args.hyp_search == 'BMA':
            bayesian_model_average(model)
        else:
            vgdl = validation_gdl
            if args.grid_metric == 'pseudo_validation' and validation_ss is not None:
                # harmonize external validation sumstats into the model's dataset:
                model.set_validation_sumstats(validation_ss)
                vgdl = None
            select_best_model(model, validation_gdl=vgdl,
                              criterion=args.grid_metric)
            if pumas_split:
                logger.info("> Restoring full summary statistics and refitting "
                            "the selected model.")
                model.restore_full_sumstats()
                refit_kwargs = {k: v for k, v in fit_kwargs.items()
                                if k != 'pathwise'}
                model.fit(**refit_kwargs)

    return model, fit_time


def _device_budget_bytes(args):
    """Total accelerator memory budget for the packed LD (65% headroom for
    state/workspace), from ``--device-memory-gb`` or the device's own memory
    limit (ops/memory.py). None on the CPU backend without an explicit
    budget: no streaming."""
    import jax
    from ..ops.memory import device_memory_bytes
    per_dev = args.device_memory_gb
    if per_dev is None:
        limit = device_memory_bytes()
        if limit is None:
            return None
        per_dev = limit / 1e9
    return 0.65 * per_dev * 1e9 * max(1, len(jax.devices()))


def _plan_streaming(args, loader):
    """Returns chromosome groups when the packed LD exceeds the device
    budget; None for the (default) single genome-wide fit."""
    budget = _device_budget_bytes(args)
    if budget is None or loader.ld_snp_tables is None:
        return None
    try:
        per_chrom = loader.estimate_packed_bytes()
    except Exception as e:  # planner is best-effort; fall back to one fit
        logger.debug("capacity estimate failed: %s", e)
        return None
    total = sum(per_chrom.values())
    if total <= budget:
        return None
    groups = loader.plan_chromosome_groups(budget)
    logger.warning(
        "> Packed LD (~%.2f GB) exceeds the device budget (%.2f GB); "
        "streaming the fit over %d chromosome groups (reference "
        "per-chromosome semantics). Use more devices (--mesh) for a joint "
        "genome-wide fit.", total / 1e9, budget / 1e9, len(groups))
    return groups


def _run_streamed(args, loader, groups, validation_gdl, validation_ss,
                  t_start, data_time):
    """Sequential per-group fits with one group's LD resident at a time;
    outputs are the concatenation of per-group tables (exactly the
    reference's joblib-over-chromosomes output shape, bin/viprs_fit:1093-1140).
    """
    import gc
    import pandas as pd

    fit_tables, hyp_tables, val_tables = [], [], []
    fit_time = 0.0
    total_iters = 0
    for gi, (group, dataset) in enumerate(
            loader.iter_group_datasets(groups)):
        logger.info("> [group %d/%d] chromosomes %s (%d variants)",
                    gi + 1, len(groups), group, dataset.m)
        model = prepare_model(args, dataset)
        model, ft = fit_model(args, model, validation_gdl, validation_ss)
        fit_time += ft
        total_iters += int(getattr(model.optim_result, 'nit', 0) or 0)
        fit_tables.append(model.to_table())
        ht = model.to_theta_table()
        ht.insert(0, 'Chromosomes', ','.join(str(c) for c in group))
        hyp_tables.append(ht)
        if getattr(model, 'validation_result', None) is not None:
            vt = model.to_validation_table()
            vt.insert(0, 'Chromosomes', ','.join(str(c) for c in group))
            val_tables.append(vt)
        del model, dataset
        gc.collect()

    out_prefix = args.output_file
    out_dir = osp.dirname(out_prefix)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    pd.concat(fit_tables, ignore_index=True).to_csv(
        out_prefix + '.fit.gz', sep="\t", index=False, compression='gzip')
    pd.concat(hyp_tables, ignore_index=True).to_csv(
        out_prefix + '.hyp', sep="\t", index=False)
    if val_tables:
        pd.concat(val_tables, ignore_index=True).to_csv(
            out_prefix + '.validation', sep="\t", index=False)
    if args.profiler:
        prof = {'DataPrep_Time': round(data_time, 3),
                'Fit_time': round(fit_time, 3),
                'Total_Iterations': total_iters,
                'Total_WallClockTime': round(time.time() - t_start, 3),
                'Streamed_Groups': len(groups)}
        pd.DataFrame([prof]).to_csv(out_prefix + '.prof', sep="\t",
                                    index=False)
    logger.info("> Done (streamed over %d groups). Outputs written with "
                "prefix %s", len(groups), out_prefix)
    print(f"viprs_fit finished in {time.time() - t_start:.2f}s "
          f"(streamed over {len(groups)} chromosome groups); "
          f"outputs: {out_prefix}.fit.gz")
    return 0


def main(argv=None):
    args = check_args(build_parser().parse_args(argv))

    # per-run log file next to the outputs (reference bin/viprs_fit:1021-1039):
    from ..utils.system import setup_logger
    setup_logger(modules=['viprs_fit', 'viprs_tpu'],
                 log_file=args.output_file + '.log',
                 log_level=args.log_level)
    logger.info("> Parsed arguments: %s", vars(args))
    if args.seed is not None:
        np.random.seed(args.seed)

    t_start = time.time()
    logger.info("> Loading and harmonizing data...")
    loader, validation_gdl, validation_ss = init_data(args)

    # ---- LD capacity plan: when the packed LD exceeds
    # the device budget, stream the fit over chromosome groups — chromosomes
    # are independent LD blocks, so per-group fits are exact per group (the
    # reference's default per-chromosome mode, bin/viprs_fit:232-238). ----
    groups = _plan_streaming(args, loader)
    data_time = time.time() - t_start

    if groups is not None:
        return _run_streamed(args, loader, groups, validation_gdl,
                             validation_ss, t_start, data_time)

    dataset = loader.to_summary_dataset()
    data_time = time.time() - t_start

    logger.info("> Preparing model (%s / %s)...", args.model, args.hyp_search)
    model = prepare_model(args, dataset)

    model, fit_time = fit_model(args, model, validation_gdl, validation_ss)

    # ------------------------------ outputs ------------------------------
    out_prefix = args.output_file
    out_dir = osp.dirname(out_prefix)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    tab = model.to_table()
    tab.to_csv(out_prefix + '.fit.gz', sep="\t", index=False, compression='gzip')

    model.write_inferred_theta(out_prefix + '.hyp')

    if getattr(model, 'validation_result', None) is not None:
        model.write_validation_result(out_prefix + '.validation')

    if args.profiler:
        total_iters = getattr(model.optim_result, 'nit', None)
        prof = {
            'DataPrep_Time': round(data_time, 3),
            'Fit_time': round(fit_time, 3),
            'Total_Iterations': total_iters,
            'Total_WallClockTime': round(time.time() - t_start, 3),
        }
        try:
            import psutil
            prof['Peak_Memory_MB'] = round(
                psutil.Process().memory_info().rss / 1024 ** 2, 2)
        except Exception:
            pass
        import pandas as pd
        pd.DataFrame([prof]).to_csv(out_prefix + '.prof', sep="\t", index=False)

    logger.info("> Done. Outputs written with prefix %s", out_prefix)
    print(f"viprs_fit finished in {time.time() - t_start:.2f}s; "
          f"outputs: {out_prefix}.fit.gz")
    return 0


if __name__ == '__main__':
    sys.exit(main())
