"""End-to-end CLI pipeline test (the analog of the reference's tests/test_cli.sh):
simulate genotypes -> GWAS -> LD store -> viprs_fit (EM + GS) -> viprs_score ->
viprs_evaluate; assert output artifacts exist and are well-formed."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=None):
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    res = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                         cwd=cwd or REPO, env=env, timeout=900)
    assert res.returncode == 0, f"command failed:\n{res.stdout}\n{res.stderr}"
    return res


@pytest.fixture(scope='module')
def pipeline_data(tmp_path_factory):
    """Simulated BED + sumstats + LD store on disk."""
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from plink_utils import write_plink_bed
    from viprs_tpu.data.genotype import GenotypeMatrix
    from viprs_tpu.data.loader import GWADataLoader
    from viprs_tpu.data import ld_store

    tmp = tmp_path_factory.mktemp('cli')
    rng = np.random.default_rng(42)
    n, m = 500, 200
    maf = rng.uniform(0.1, 0.5, m)
    dosages = rng.binomial(2, maf, size=(n, m)).astype(np.float64)
    alleles = rng.choice(['A', 'C'], size=m)
    bim = pd.DataFrame({'CHR': 21, 'SNP': [f'rs{i}' for i in range(m)],
                        'CM': 0.0, 'POS': np.arange(1, m + 1) * 1000,
                        'A1': alleles, 'A2': np.where(alleles == 'A', 'G', 'T')})
    beta = np.zeros(m)
    causal = rng.random(m) < 0.1
    beta[causal] = rng.standard_normal(causal.sum()) * 0.25
    x_std = (dosages - dosages.mean(0)) / np.maximum(dosages.std(0), 1e-9)
    y = x_std @ beta + rng.standard_normal(n)
    fam = pd.DataFrame({'FID': [f'F{i}' for i in range(n)],
                        'IID': [f'I{i}' for i in range(n)],
                        'father': 0, 'mother': 0, 'sex': 1, 'PHENO': y})
    prefix = str(tmp / 'geno')
    write_plink_bed(prefix, dosages, bim, fam)

    g = GenotypeMatrix(prefix)
    ss = g.perform_gwas(y)
    ss_file = str(tmp / 'sumstats.txt')
    ss.table.to_csv(ss_file, sep="\t", index=False)

    loader = GWADataLoader(bed_files=prefix)
    loader.compute_ld(estimator='block', max_block_size=64)
    store = str(tmp / 'ld_store')
    ld_store.save_ld_store(store, loader.ld_blocks, loader.ld_snp_tables,
                           quantize=False)

    pheno_file = str(tmp / 'pheno.txt')
    fam[['FID', 'IID', 'PHENO']].to_csv(pheno_file, sep="\t", header=False,
                                        index=False)
    return dict(tmp=tmp, bed=prefix, sumstats=ss_file, store=store,
                pheno=pheno_file)


def test_fit_em_score_evaluate(pipeline_data):
    tmp = pipeline_data['tmp']
    out = str(tmp / 'em' / 'output')

    _run(['bin/viprs_fit', '-l', pipeline_data['store'],
          '-s', pipeline_data['sumstats'],
          '--output-file', out, '--block-size', '128', '--max-iter', '200',
          '--seed', '7'])
    assert os.path.exists(out + '.fit.gz')
    assert os.path.exists(out + '.hyp')
    fit_tab = pd.read_csv(out + '.fit.gz', sep="\t")
    assert {'CHR', 'SNP', 'A1', 'A2', 'BETA', 'PIP'} <= set(fit_tab.columns)
    assert len(fit_tab) == 200

    prs_out = str(tmp / 'em' / 'prs')
    _run(['bin/viprs_score', '-f', out + '.fit.gz',
          '--bed-files', pipeline_data['bed'],
          '--output-file', prs_out])
    assert os.path.exists(prs_out + '.prs')
    prs_tab = pd.read_csv(prs_out + '.prs', sep="\t")
    assert {'FID', 'IID', 'PRS'} <= set(prs_tab.columns)
    assert prs_tab['PRS'].std() > 0

    eval_out = str(tmp / 'em' / 'eval')
    _run(['bin/viprs_evaluate', '--prs-file', prs_out + '.prs',
          '--phenotype-file', pipeline_data['pheno'],
          '--output-file', eval_out])
    assert os.path.exists(eval_out + '.eval')
    etab = pd.read_csv(eval_out + '.eval', sep="\t")
    r2_row = etab.loc[etab['Metric'] == 'R2']
    assert len(r2_row) == 1 and 0 <= float(r2_row['Value'].iloc[0]) <= 1


def test_fit_gs_pseudo_validation(pipeline_data):
    tmp = pipeline_data['tmp']
    out = str(tmp / 'gs' / 'output')
    _run(['bin/viprs_fit', '-l', pipeline_data['store'],
          '-s', pipeline_data['sumstats'],
          '--output-file', out, '--block-size', '128',
          '--hyp-search', 'GS', '--pi-steps', '4',
          '--grid-metric', 'pseudo_validation',
          '--max-iter', '150', '--seed', '7'])
    assert os.path.exists(out + '.fit.gz')
    assert os.path.exists(out + '.validation')
    vtab = pd.read_csv(out + '.validation', sep="\t")
    assert len(vtab) == 4 and 'ELBO' in vtab.columns


def test_fit_gs_validation_criterion(pipeline_data):
    """End-to-end GS with individual-level validation selection
    (reference bin/viprs_fit --grid-metric validation)."""
    tmp = pipeline_data['tmp']
    out = str(tmp / 'gsv' / 'output')
    _run(['bin/viprs_fit', '-l', pipeline_data['store'],
          '-s', pipeline_data['sumstats'],
          '--output-file', out, '--block-size', '128',
          '--hyp-search', 'GS', '--pi-steps', '4',
          '--grid-metric', 'validation',
          '--validation-bed', pipeline_data['bed'],
          '--validation-pheno', pipeline_data['pheno'],
          '--max-iter', '150', '--seed', '7'])
    assert os.path.exists(out + '.validation')
    vtab = pd.read_csv(out + '.validation', sep="\t")
    assert 'Validation_R2' in vtab.columns
    assert np.isfinite(vtab['Validation_R2']).any()
    fit_tab = pd.read_csv(out + '.fit.gz', sep="\t")
    assert np.isfinite(fit_tab['BETA']).all()


def test_fit_bma(pipeline_data):
    tmp = pipeline_data['tmp']
    out = str(tmp / 'bma' / 'output')
    _run(['bin/viprs_fit', '-l', pipeline_data['store'],
          '-s', pipeline_data['sumstats'],
          '--output-file', out, '--block-size', '128',
          '--hyp-search', 'BMA', '--pi-steps', '4',
          '--max-iter', '150', '--seed', '7'])
    fit_tab = pd.read_csv(out + '.fit.gz', sep="\t")
    assert np.isfinite(fit_tab['BETA']).all()


def test_fit_mixture_model(pipeline_data):
    tmp = pipeline_data['tmp']
    out = str(tmp / 'mix' / 'output')
    _run(['bin/viprs_fit', '-l', pipeline_data['store'],
          '-s', pipeline_data['sumstats'],
          '--output-file', out, '--block-size', '128',
          '-m', 'VIPRSMix', '--n-components', '2',
          '--max-iter', '150', '--seed', '7'])
    assert os.path.exists(out + '.fit.gz')
    hyp = pd.read_csv(out + '.hyp', sep="\t")
    assert any(hyp['Parameter'].str.startswith('pi_'))


def test_fit_mesh_flag_end_to_end(pipeline_data):
    """--mesh auto (the default: 8 virtual devices on the 'blocks' axis here)
    produces the same posterior as --mesh off at f32 tolerance, end-to-end
    through the CLI — the product multi-device path (the analog of the
    reference's --n-jobs fan-out, bin/viprs_fit:1079-1086)."""
    tmp = pipeline_data['tmp']
    out_off = str(tmp / 'mesh_off' / 'output')
    out_auto = str(tmp / 'mesh_auto' / 'output')
    common = ['-l', pipeline_data['store'], '-s', pipeline_data['sumstats'],
              '--block-size', '128', '--max-iter', '200', '--seed', '7']
    _run(['bin/viprs_fit', '--output-file', out_off, '--mesh', 'off'] + common)
    _run(['bin/viprs_fit', '--output-file', out_auto, '--mesh', 'auto'] + common)
    t_off = pd.read_csv(out_off + '.fit.gz', sep="\t")
    t_auto = pd.read_csv(out_auto + '.fit.gz', sep="\t")
    assert (t_off['SNP'] == t_auto['SNP']).all()
    np.testing.assert_allclose(t_auto['BETA'], t_off['BETA'], atol=5e-4)
    np.testing.assert_allclose(t_auto['PIP'], t_off['PIP'], atol=1e-2)


def test_fit_streams_when_ld_exceeds_budget(tmp_path):
    """LD-larger-than-HBM capacity plan: with a tiny simulated device budget
    the fit streams over chromosome groups (the reference's per-chromosome
    mode, bin/viprs_fit:232-238) and the merged outputs cover every variant."""
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from plink_utils import write_plink_bed
    from viprs_tpu.data.genotype import GenotypeMatrix
    from viprs_tpu.data.loader import GWADataLoader
    from viprs_tpu.data import ld_store

    rng = np.random.default_rng(5)
    n, m = 400, 240
    maf = rng.uniform(0.1, 0.5, m)
    dosages = rng.binomial(2, maf, size=(n, m)).astype(np.float64)
    alleles = rng.choice(['A', 'C'], size=m)
    bim = pd.DataFrame({'CHR': np.repeat([19, 20, 21], m // 3),
                        'SNP': [f'rs{i}' for i in range(m)],
                        'CM': 0.0, 'POS': np.tile(np.arange(1, m // 3 + 1) * 1000, 3),
                        'A1': alleles, 'A2': np.where(alleles == 'A', 'G', 'T')})
    beta = np.where(rng.random(m) < 0.1, rng.standard_normal(m) * 0.25, 0.0)
    x_std = (dosages - dosages.mean(0)) / np.maximum(dosages.std(0), 1e-9)
    y = x_std @ beta + rng.standard_normal(n)
    fam = pd.DataFrame({'FID': [f'F{i}' for i in range(n)],
                        'IID': [f'I{i}' for i in range(n)],
                        'father': 0, 'mother': 0, 'sex': 1, 'PHENO': y})
    prefix = str(tmp_path / 'geno')
    write_plink_bed(prefix, dosages, bim, fam)
    g = GenotypeMatrix(prefix)
    ss_file = str(tmp_path / 'sumstats.txt')
    g.perform_gwas(y).table.to_csv(ss_file, sep="\t", index=False)
    loader = GWADataLoader(bed_files=prefix)
    loader.compute_ld(estimator='block', max_block_size=40)
    store = str(tmp_path / 'ld')
    ld_store.save_ld_store(store, loader.ld_blocks, loader.ld_snp_tables)

    out = str(tmp_path / 'stream' / 'output')
    res = _run(['bin/viprs_fit', '-l', store, '-s', ss_file,
                '--output-file', out, '--block-size', '128',
                '--max-iter', '200', '--seed', '7',
                '--device-memory-gb', '2e-5',
                '--output-profiler-metrics'])
    assert 'streamed over' in res.stdout
    fit_tab = pd.read_csv(out + '.fit.gz', sep="\t")
    assert len(fit_tab) == m
    assert set(fit_tab['CHR']) == {19, 20, 21}
    hyp = pd.read_csv(out + '.hyp', sep="\t")
    assert 'Chromosomes' in hyp.columns
    prof = pd.read_csv(out + '.prof', sep="\t")
    assert int(prof['Streamed_Groups'].iloc[0]) >= 2

    # posterior matches the unstreamed fit loosely (per-group fits
    # re-estimate hyperparameters per group — reference per-chromosome
    # semantics):
    out2 = str(tmp_path / 'stream' / 'ref')
    _run(['bin/viprs_fit', '-l', store, '-s', ss_file,
          '--output-file', out2, '--block-size', '128',
          '--max-iter', '200', '--seed', '7'])
    ref_tab = pd.read_csv(out2 + '.fit.gz', sep="\t")
    merged = fit_tab.merge(ref_tab, on='SNP', suffixes=('_s', '_r'))
    assert len(merged) == m
    assert np.corrcoef(merged['BETA_s'], merged['BETA_r'])[0, 1] > 0.9


def test_internal_errors_surface_unmasked(pipeline_data):
    """A bug inside model selection must surface as its own traceback, NOT be
    swallowed by the automatic lambda_min retry — the retry is gated on the
    reference's specific divergence signature (reference
    bin/viprs_fit:509-521), not on a blanket except."""
    tmp = pipeline_data['tmp']
    out = str(tmp / 'unmask' / 'output')
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "import viprs_tpu.gridsearch as gridsearch\n"
        "def boom(*a, **k): raise ZeroDivisionError('deliberate-bug-sentinel')\n"
        "gridsearch.select_best_model = boom\n"
        "gridsearch.search.select_best_model = boom\n"
        "import viprs_tpu.cli.fit as fit\n"
        "sys.exit(fit.main())\n" % REPO
    )
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, '-c', script,
         '-l', pipeline_data['store'], '-s', pipeline_data['sumstats'],
         '--output-file', out, '--block-size', '128',
         '--hyp-search', 'GS', '--pi-steps', '4',
         '--grid-metric', 'pseudo_validation',
         '--max-iter', '50', '--seed', '7'],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=900)
    assert res.returncode != 0
    combined = res.stdout + res.stderr
    assert 'deliberate-bug-sentinel' in combined and 'ZeroDivisionError' in combined
    # and it must NOT have been re-routed through the divergence retry:
    assert 'retrying with inferred' not in combined.lower()


def test_warmup_precompiles_the_fit_program(pipeline_data, tmp_path):
    """viprs_warmup compiles the exact em_fit program a later fit dispatches:
    after a warmup into a FRESH persistent cache, the fit process adds no new
    cache entries (cold-start mitigation)."""
    cache = str(tmp_path / 'jaxcache')

    def run_with_cache(args):
        env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO,
                   JAX_COMPILATION_CACHE_DIR=cache)
        res = subprocess.run([sys.executable] + args, capture_output=True,
                             text=True, cwd=REPO, env=env, timeout=900)
        assert res.returncode == 0, f"failed:\n{res.stdout}\n{res.stderr}"
        return res

    run_with_cache(['bin/viprs_warmup', '-l', pipeline_data['store'],
                    '--block-size', '128', '--max-iter', '300',
                    '--grid-widths', '4'])
    entries_after_warm = set(os.listdir(cache))
    assert entries_after_warm, "warmup produced no persistent-cache entries"

    out = str(tmp_path / 'warmed' / 'out')
    run_with_cache(['bin/viprs_fit', '-l', pipeline_data['store'],
                    '-s', pipeline_data['sumstats'],
                    '--output-file', out, '--block-size', '128',
                    '--max-iter', '300', '--seed', '3'])
    new = set(os.listdir(cache)) - entries_after_warm
    # the fit may add small helper programs (posterior moments etc.) but the
    # expensive fused loop must have been served from the warmed cache — no
    # entry anywhere near the em_fit program's size should appear:
    big_new = [f for f in new
               if os.path.getsize(os.path.join(cache, f)) >
               0.5 * max(os.path.getsize(os.path.join(cache, f2))
                         for f2 in entries_after_warm)]
    assert not big_new, (
        f"fit recompiled large programs after warmup: {big_new} "
        f"(new={sorted(new)})")
    assert os.path.exists(out + '.fit.gz')


def test_sweep_impl_flag(pipeline_data):
    """--sweep-impl plumbs through to the fused fit: an explicit 'xla' run
    reproduces the default policy's output on CPU (where the policy resolves
    to the XLA tile loop), and a fused-kernel request off a GPU surfaces the
    dispatch policy's error rather than silently falling back."""
    tmp = pipeline_data['tmp']
    out_default = str(tmp / 'sweep' / 'default')
    out_xla = str(tmp / 'sweep' / 'xla')
    base = ['bin/viprs_fit', '-l', pipeline_data['store'],
            '-s', pipeline_data['sumstats'],
            '--block-size', '128', '--max-iter', '100', '--seed', '7']
    _run(base + ['--output-file', out_default])
    _run(base + ['--output-file', out_xla, '--sweep-impl', 'xla'])
    t0 = pd.read_csv(out_default + '.fit.gz', sep="\t")
    t1 = pd.read_csv(out_xla + '.fit.gz', sep="\t")
    assert np.allclose(t0['BETA'], t1['BETA'])
    assert np.allclose(t0['PIP'], t1['PIP'])

    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable] + base + ['--output-file', str(tmp / 'sweep' / 'fu'),
                                   '--sweep-impl', 'fused'],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=900)
    assert res.returncode != 0
    assert "sweep_impl='fused' is a GPU kernel" in (res.stdout + res.stderr)
