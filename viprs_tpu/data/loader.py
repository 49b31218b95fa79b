"""GWADataLoader — the user-facing data integration facade.

Owns the role of magenpy's GWADataLoader in the reference (constructed from LD
stores + BED genotypes + summary-statistics files; harmonization across sources;
scoring; GWAS; SURVEY.md §2.6), producing the device-facing
:class:`~viprs_tpu.data.dataset.SummaryStatsDataset` for the models.
"""

import glob as _glob
import logging
import os.path as osp

import numpy as np
import pandas as pd

from .dataset import SummaryStatsDataset
from .genotype import GenotypeMatrix
from .harmonize import merge_snp_tables
from .sumstats import read_sumstats, SumstatsTable
from . import ld_store as ld_store_mod
from . import ld_estimators

logger = logging.getLogger(__name__)

# Long-range LD regions (hg19/GRCh37; Price et al. 2008 AJHG) as
# (chrom, start_mb, stop_mb):
LONG_RANGE_LD_REGIONS = [
    (1, 48, 52), (2, 86, 100.5), (2, 134.5, 138), (2, 183, 190),
    (3, 47.5, 50), (3, 83.5, 87), (3, 89, 97.5), (5, 44.5, 50.5),
    (5, 98, 100.5), (5, 129, 132), (5, 135.5, 138.5), (6, 25.5, 33.5),
    (6, 57, 64), (6, 140, 142.5), (7, 55, 66), (8, 8, 12), (8, 43, 50),
    (8, 112, 115), (10, 37, 43), (11, 46, 57), (11, 87.5, 90.5),
    (12, 33, 40), (12, 109.5, 112), (20, 32, 34.5),
]


def get_filenames(path_or_pattern):
    """Expand a path / glob pattern / list into a sorted file list.

    ``hf://`` paths (the reference's cloud-streamable LD panels,
    docs/download_ld.md:20-55) resolve through huggingface_hub: matching
    remote files download into the local HF cache and their local paths are
    returned, so the zip-archive Zarr reader sees ordinary files.
    """
    if path_or_pattern is None:
        return []
    if isinstance(path_or_pattern, (list, tuple)):
        out = []
        for p in path_or_pattern:
            out.extend(get_filenames(p))
        return out
    if str(path_or_pattern).startswith('hf://'):
        from ..utils.system import _expand_hf_path
        return _expand_hf_path(str(path_or_pattern))
    matches = sorted(_glob.glob(str(path_or_pattern)))
    return matches if matches else [str(path_or_pattern)]


class GWADataLoader:
    """
    :ivar genotype: GenotypeMatrix or None.
    :ivar sumstats_table: {chrom: SumstatsTable} after harmonization.
    :ivar ld_blocks: {chrom: [dense LD blocks]} (host-side, pre-packing;
        int8 at scale 1/127 when materialized from a quantized store —
        packing and save_ld_store consume that verbatim).
    :ivar ld_snp_tables: {chrom: DataFrame} variant tables aligned with ld_blocks.
    :ivar phenotype_likelihood: 'gaussian' | 'binomial'.
    """

    def __init__(self,
                 bed_files=None,
                 ld_store_files=None,
                 sumstats_files=None,
                 sumstats_format='magenpy',
                 keep_samples=None,
                 extract_snps=None,
                 phenotype_file=None,
                 phenotype_likelihood='infer',
                 n=None,
                 block_size=1024,
                 quantize_ld=False,
                 temp_dir='temp',
                 **sumstats_kwargs):

        self.block_size = block_size
        self.quantize_ld = quantize_ld
        self.temp_dir = temp_dir

        # ---------------- genotype ----------------
        self.genotype = None
        if bed_files:
            import re
            from .genotype import open_genotypes
            beds = sorted({re.sub(r'\.(bed|bim|fam)$', '', f)
                           for f in get_filenames(bed_files)})
            self.genotype = open_genotypes(beds, keep_samples=keep_samples,
                                           extract_snps=extract_snps)

        # ---------------- LD store ----------------
        # LD data loads LAZILY: construction reads only the (small) variant
        # tables; the GB-scale LD data is read on first use — and never at
        # all when the packed-BlockLD disk cache hits (data/pack_cache.py).
        self.ld_blocks = None
        self.ld_snp_tables = None
        self._ld_sources = None      # [(kind, path)] for lazy loads + cache key
        self._ld_source_chroms = []  # parallel to _ld_sources: chroms per store
        self._ld_present = None      # {chrom: bool mask in STORE order}
        if ld_store_files:
            stores = get_filenames(ld_store_files)
            self.ld_snp_tables = {}
            self._ld_sources = []
            eager_blocks = {}
            for store in stores:
                if not osp.exists(store):
                    raise FileNotFoundError(f"LD store not found: {store}")
                if osp.isdir(store) and any(
                        f.startswith('chr_') for f in __import__('os').listdir(store)):
                    _, tables = ld_store_mod.load_ld_store(store,
                                                           tables_only=True)
                    if tables:
                        self.ld_snp_tables.update(tables)
                        self._ld_sources.append(('native', store))
                        self._ld_source_chroms.append(set(tables))
                    else:
                        # store without variant tables: nothing to harmonize
                        # against lazily; load the blocks now (int8 stays
                        # int8 — same pass-through as _load_source_blocks):
                        blocks, _ = ld_store_mod.load_ld_store(
                            store, dequantize=False)
                        eager_blocks.update(blocks)
                else:
                    # magenpy Zarr store (the published UKB panels' format):
                    tables = ld_store_mod.load_magenpy_zarr_tables(store)
                    if tables:
                        self.ld_snp_tables.update(tables)
                        self._ld_sources.append(('zarr', store))
                        self._ld_source_chroms.append(set(tables))
                    else:
                        banded, _ = ld_store_mod.load_magenpy_zarr(store)
                        for c, (data, indptr, left) in banded.items():
                            # keep_quantized: a quantized store must not be
                            # inflated 8x to float64 here either (same fix as
                            # _load_source_blocks' lazy path):
                            eager_blocks[c] = ld_store_mod.banded_to_blocks(
                                data, indptr, left, keep_quantized=True)
            if eager_blocks and self._ld_sources:
                # mixed table-less + tabled stores: fall back to fully eager
                # (the lazy/cache path assumes every block is re-derivable
                # from recorded sources).
                for kind, store in self._ld_sources:
                    eager_blocks.update(self._load_source_blocks(kind, store))
                self._ld_sources = []
            if eager_blocks:
                self.ld_blocks = eager_blocks
            if not self.ld_snp_tables:
                self.ld_snp_tables = None

        # ---------------- summary statistics ----------------
        self.sumstats_table = None
        self._raw_sumstats = None
        if sumstats_files:
            files = get_filenames(sumstats_files)
            tables = [read_sumstats(f, sumstats_format=sumstats_format, n=n,
                                    **sumstats_kwargs).table for f in files]
            self._raw_sumstats = SumstatsTable(pd.concat(tables, ignore_index=True))

        # ---------------- phenotype ----------------
        self.phenotype = None
        self.phenotype_likelihood = None
        if phenotype_file:
            self.read_phenotype(phenotype_file, likelihood=phenotype_likelihood)
        elif self.genotype is not None and self.genotype.fam['PHENO'].nunique() > 1:
            self._set_phenotype(self.genotype.fam['PHENO'].values,
                                phenotype_likelihood)

        self._dataset = None
        if self._raw_sumstats is not None and (
                self._ld_blocks is not None or self._ld_sources):
            self.harmonize_data()

    # -------------------------------------------------------------- phenotype
    def read_phenotype(self, phenotype_file, likelihood='infer', pheno_col=2):
        df = pd.read_csv(phenotype_file, sep=r'\s+', header=None)
        df.columns = ['FID', 'IID'] + [f'c{i}' for i in range(df.shape[1] - 2)]
        if self.genotype is not None:
            merged = self.genotype.fam[['FID', 'IID']].astype(str).merge(
                df.astype({'FID': str, 'IID': str}), on=['FID', 'IID'], how='left')
            vals = merged.iloc[:, pheno_col].values.astype(np.float64)
        else:
            vals = df.iloc[:, pheno_col].values.astype(np.float64)
        self._set_phenotype(vals, likelihood)

    def _set_phenotype(self, vals, likelihood='infer'):
        vals = np.asarray(vals, dtype=np.float64)
        if likelihood == 'infer' or likelihood is None:
            uniq = set(np.unique(vals[~np.isnan(vals)]))
            if uniq <= {0.0, 1.0} or uniq <= {1.0, 2.0}:
                likelihood = 'binomial'
                if uniq <= {1.0, 2.0} and 2.0 in uniq:
                    vals = vals - 1.0  # plink 1/2 coding -> 0/1
            else:
                likelihood = 'gaussian'
        self.phenotype = vals
        self.phenotype_likelihood = likelihood

    @property
    def sample_table(self):
        if self.genotype is None:
            return None
        tab = self.genotype.fam.copy()
        if self.phenotype is not None:
            tab['PHENO'] = self.phenotype
        tab_ns = tab
        tab_ns.phenotype = self.phenotype  # attribute-style access compat
        return tab_ns

    # ---------------------------------------------------------------- LD / GWAS
    def compute_ld(self, estimator='block', ldetect_blocks=None,
                   block_file=None, **kwargs):
        """Estimate LD from the attached genotype (reference compute_ld surface)."""
        assert self.genotype is not None, "No genotype data attached."
        if block_file is not None and ldetect_blocks is None:
            ldetect_blocks = ld_estimators.read_ldetect_blocks(block_file)
        func = ld_estimators.ESTIMATORS[estimator]
        if estimator in ('block', 'shrinkage'):
            self.ld_blocks = func(self.genotype, ldetect_blocks, **kwargs)
        else:
            self.ld_blocks = func(self.genotype, **kwargs)
        bim = self.genotype.bim
        self.ld_snp_tables = {
            c: bim.loc[bim['CHR'] == c,
                       ['CHR', 'SNP', 'POS', 'A1', 'A2']].reset_index(drop=True)
            for c in self.genotype.chromosomes}
        self._dataset = None
        return self

    def perform_gwas(self, **kwargs):
        assert self.genotype is not None and self.phenotype is not None
        self._raw_sumstats = self.genotype.perform_gwas(self.phenotype, **kwargs)
        if self._ld_blocks is not None or self._ld_sources:
            self.harmonize_data()
        return self._raw_sumstats

    def read_summary_statistics(self, sumstats_files, sumstats_format='magenpy',
                                **kwargs):
        files = get_filenames(sumstats_files)
        tables = [read_sumstats(f, sumstats_format=sumstats_format, **kwargs).table
                  for f in files]
        self._raw_sumstats = SumstatsTable(pd.concat(tables, ignore_index=True))
        if self._ld_blocks is not None or self._ld_sources:
            self.harmonize_data()
        return self._raw_sumstats

    # ------------------------------------------------------------ harmonization
    # ------------------------------------------------------ lazy LD plumbing
    @staticmethod
    def _load_source_blocks(kind, store, chromosomes=None):
        """Read the LD blocks of one recorded store source.

        Quantized stores come back as int8 blocks (scale 1/127) — packing
        consumes them verbatim (ops/block_ld.py), so the genome is never
        inflated to float64 in host RAM (8x the bytes at 18M variants)."""
        if kind == 'native':
            blocks, _ = ld_store_mod.load_ld_store(store,
                                                   chromosomes=chromosomes,
                                                   dequantize=False)
            return blocks
        banded, _ = ld_store_mod.load_magenpy_zarr(store)
        return {c: ld_store_mod.banded_to_blocks(data, indptr, left,
                                                 keep_quantized=True)
                for c, (data, indptr, left) in banded.items()
                if chromosomes is None or c in chromosomes}

    @staticmethod
    def _slice_blocks(blocks, present):
        """Filter a chromosome's block list to the ``present`` store-order
        mask; returns (blocks, kept_row_indices)."""
        out, kept_rows = [], []
        offset = 0
        for blk in blocks:
            m_b = blk.shape[0]
            sel = np.where(present[offset:offset + m_b])[0]
            if len(sel):
                out.append(np.ascontiguousarray(blk[np.ix_(sel, sel)]))
                kept_rows.extend(offset + sel)
            offset += m_b
        return out, np.asarray(kept_rows, dtype=np.int64)

    @property
    def ld_blocks(self):
        """Per-chromosome LD block lists; store-backed loaders materialize
        them on first access (harmonization and pack-cache hits never do)."""
        if self._ld_blocks is None and self._ld_sources:
            self._ensure_ld_blocks()
        return self._ld_blocks

    @ld_blocks.setter
    def ld_blocks(self, value):
        self._ld_blocks = value

    def _ensure_ld_blocks(self):
        """Materialize the LD blocks from the recorded sources (lazy path),
        applying any accumulated variant-subset masks."""
        if self._ld_blocks is not None or not self._ld_sources:
            return self._ld_blocks
        chroms = set(self.ld_snp_tables or {})
        blocks = {}
        src_chroms = self._ld_source_chroms \
            or [None] * len(self._ld_sources)
        for (kind, store), known in zip(self._ld_sources, src_chroms):
            if chroms and known is not None and not (chroms & known):
                continue  # nothing wanted from this store — skip the read
            loaded = self._load_source_blocks(kind, store,
                                              chromosomes=chroms or None)
            for c, blks in loaded.items():
                if c in chroms or not chroms:
                    blocks[c] = blks
        if self._ld_present is not None:
            sliced = {}
            for c, blks in blocks.items():
                if c not in self._ld_present:
                    continue
                sub, _ = self._slice_blocks(blks, self._ld_present[c])
                if sub:
                    sliced[c] = sub
            blocks = sliced
        self._ld_blocks = blocks
        return self._ld_blocks

    def harmonize_data(self):
        """Intersect & allele-align summary statistics with the LD variant
        tables, filtering LD blocks to the common variants. The LD store's
        variant order defines the block structure. Pure table work — the LD
        data itself is only sliced when (and if) it materializes."""
        assert self._raw_sumstats is not None, "No summary statistics loaded."
        if self.ld_snp_tables is None:
            raise ValueError("The LD store has no variant tables; cannot harmonize.")
        assert self._ld_blocks is not None or self._ld_sources, \
            "No LD data loaded."

        ss = self._raw_sumstats.table
        self.sumstats_table = {}
        new_blocks, new_tables = {}, {}
        lazy = self._ld_blocks is None
        self._ld_present = {} if lazy else None

        for c, ld_tab in self.ld_snp_tables.items():
            merged = merge_snp_tables(ld_tab[['SNP', 'A1', 'A2']], ss, how='left',
                                      signed_statistics=[col for col in
                                                         ('BETA', 'Z') if col in ss.columns])
            present = merged['Z'].notna().values if 'Z' in merged.columns else \
                merged['BETA'].notna().values
            if not present.any():
                continue

            if lazy:
                self._ld_present[c] = present
                kept = np.where(present)[0]
            else:
                blocks, kept = self._slice_blocks(self.ld_blocks[c], present)
                if not blocks:
                    continue
                new_blocks[c] = blocks

            keep_tab = ld_tab.iloc[kept].reset_index(drop=True)
            if 'CHR' not in keep_tab.columns:
                keep_tab.insert(0, 'CHR', c)
            new_tables[c] = keep_tab

            sub = merged.iloc[kept].reset_index(drop=True)
            sub = sub.assign(CHR=c, POS=keep_tab['POS'].values
                             if 'POS' in keep_tab.columns else np.arange(len(sub)))
            self.sumstats_table[c] = SumstatsTable(sub)

        if not lazy:
            self._ld_blocks = new_blocks
        self.ld_snp_tables = new_tables
        self._dataset = None
        return self

    def filter_snps(self, extract_snps, chromosome=None):
        """Subset to the given variants (reference GWADataLoader.filter_snps)."""
        snpset = set(extract_snps)
        lazy = self._ld_blocks is None and self._ld_sources
        for c in list(self.ld_snp_tables or {}):
            if chromosome is not None and c != chromosome:
                continue
            tab = self.ld_snp_tables[c]
            keep = tab['SNP'].isin(snpset).values
            if lazy:
                # compose into the store-order mask; the LD data is sliced
                # once, at materialization:
                if self._ld_present is None:
                    self._ld_present = {}
                if c in self._ld_present:
                    mask = self._ld_present[c].copy()
                    mask[np.where(mask)[0]] &= keep
                    self._ld_present[c] = mask
                else:
                    self._ld_present[c] = keep.copy()
                kept = np.where(keep)[0]
            else:
                blocks, kept = self._slice_blocks(self.ld_blocks[c], keep)
                self.ld_blocks[c] = blocks
            self.ld_snp_tables[c] = tab.iloc[np.asarray(kept, int)].reset_index(drop=True)
            if self.sumstats_table and c in self.sumstats_table:
                st = self.sumstats_table[c].table
                self.sumstats_table[c] = SumstatsTable(
                    st.iloc[np.asarray(kept, int)].reset_index(drop=True))
        self._dataset = None
        return self

    def filter_long_range_ld_regions(self):
        """Drop variants in known long-range LD regions (hg19 coordinates;
        reference use-site bin/viprs_fit:216-218)."""
        if self.ld_snp_tables is None:
            return self
        keep_snps = []
        for c, tab in self.ld_snp_tables.items():
            pos_mb = tab['POS'].values / 1e6
            mask = np.ones(len(tab), dtype=bool)
            for chrom, start, stop in LONG_RANGE_LD_REGIONS:
                if str(chrom) == str(c):
                    mask &= ~((pos_mb >= start) & (pos_mb <= stop))
            keep_snps.extend(tab['SNP'].values[mask])
        return self.filter_snps(keep_snps)

    # ------------------------------------------------------------------- views
    @property
    def chromosomes(self):
        if self.sumstats_table is not None:
            return sorted(self.sumstats_table.keys())
        if self.ld_snp_tables is not None:
            return sorted(self.ld_snp_tables.keys())
        if self.genotype is not None:
            return self.genotype.chromosomes
        return []

    @property
    def shapes(self):
        if self.sumstats_table is not None:
            return {c: len(t) for c, t in self.sumstats_table.items()}
        if self.ld_snp_tables is not None:
            return {c: len(t) for c, t in self.ld_snp_tables.items()}
        if self.genotype is not None:
            bim = self.genotype.bim
            return {c: int((bim['CHR'] == c).sum()) for c in self.genotype.chromosomes}
        return {}

    @property
    def m(self):
        return int(sum(self.shapes.values()))

    @property
    def n_snps(self):
        return self.m

    @property
    def n(self):
        if self.genotype is not None:
            return self.genotype.n
        if self.sumstats_table is not None:
            return float(max(t.n_per_snp.max() for t in self.sumstats_table.values()))
        return None

    @property
    def snps(self):
        return {c: t['SNP'].values for c, t in (self.ld_snp_tables or {}).items()}

    def default_snp_table(self):
        """Per-chromosome variant tables (LD-store tables when present, BED bim
        otherwise) — the surface BayesPRSModel.harmonize_data consumes when
        aligning posterior effect tables with this loader's variants."""
        return self.to_snp_table(per_chromosome=True)

    def to_snp_table(self, col_subset=None, per_chromosome=False):
        tables = {}
        source = self.ld_snp_tables
        if source is None and self.genotype is not None:
            bim = self.genotype.bim
            source = {c: bim.loc[bim['CHR'] == c].reset_index(drop=True)
                      for c in self.genotype.chromosomes}
        for c, tab in (source or {}).items():
            t = tab.copy()
            if 'CHR' not in t.columns:
                t.insert(0, 'CHR', c)
            if col_subset:
                t = t[[col for col in col_subset if col in t.columns]]
            tables[c] = t
        if per_chromosome:
            return tables
        return pd.concat(list(tables.values()), ignore_index=True) if tables else None

    def to_summary_statistics_table(self, col_subset=None, per_chromosome=False):
        assert self.sumstats_table is not None
        tables = {c: t.to_table(col_subset=col_subset)
                  for c, t in self.sumstats_table.items()}
        if per_chromosome:
            return tables
        return pd.concat(list(tables.values()), ignore_index=True)

    def to_individual_table(self):
        assert self.genotype is not None
        return self.genotype.fam[['FID', 'IID']].copy()

    def to_phenotype_table(self):
        tab = self.to_individual_table()
        tab['phenotype'] = self.phenotype
        return tab

    # ----------------------------------------------------------------- scoring
    def score(self, beta):
        assert self.genotype is not None, "No genotype data for scoring."
        if isinstance(beta, dict):
            # align chromosome dict with genotype bim order:
            flat_parts = []
            for c in self.genotype.chromosomes:
                flat_parts.append(np.asarray(beta[c]))
            beta = np.concatenate([p.reshape(len(p), -1) for p in flat_parts], axis=0)
        return self.genotype.score(beta)

    predict = score

    # ----------------------------------------------------------------- dataset
    def to_summary_dataset(self, block_size=None, quantize=None) -> SummaryStatsDataset:
        """Pack the harmonized data into the device-facing dataset.

        When the LD came from on-disk stores, the packed BlockLD is cached on
        disk keyed on (store signature, kept-variant subset, block_size,
        quantize) — repeated fits on the same panel skip ingestion + packing
        entirely (data/pack_cache.py)."""
        if self._dataset is not None:
            return self._dataset
        assert self.sumstats_table is not None and \
            (self._ld_blocks is not None or self._ld_sources), \
            "Loader must have harmonized summary statistics and LD."

        block_size = block_size or self.block_size
        quantize = self.quantize_ld if quantize is None else quantize

        std_beta = {c: t.get_snp_pseudo_corr() for c, t in self.sumstats_table.items()}
        n_per_snp = {c: t.n_per_snp for c, t in self.sumstats_table.items()}
        snp_tables = {}
        for c, tab in self.ld_snp_tables.items():
            t = tab.copy()
            if 'CHR' not in t.columns:
                t.insert(0, 'CHR', c)
            snp_tables[c] = t

        key = None
        if self._ld_sources:
            from . import pack_cache
            if pack_cache.cache_root() is not None:
                key = pack_cache.compute_key(
                    [s for _, s in self._ld_sources],
                    {c: t['SNP'].values for c, t in self.ld_snp_tables.items()},
                    block_size, quantize)
                hit = pack_cache.load_packed(key)
                if hit is not None:
                    logger.info("Packed-LD cache hit (%s...)", key[:12])
                    ld, layout = hit
                    self._dataset = SummaryStatsDataset(
                        ld=ld, layout=layout, std_beta=std_beta,
                        n_per_snp=n_per_snp, snp_table=snp_tables,
                        phenotype_likelihood=self.phenotype_likelihood
                        or 'gaussian')
                    self._dataset._check_shapes()
                    return self._dataset

        self._ensure_ld_blocks()
        self._dataset = SummaryStatsDataset.from_dense_blocks(
            self.ld_blocks, std_beta, n_per_snp, snp_table=snp_tables,
            block_size=block_size, quantize=quantize,
            phenotype_likelihood=self.phenotype_likelihood or 'gaussian')
        if key is not None:
            from . import pack_cache
            pack_cache.save_packed(key, self._dataset.ld, self._dataset.layout)
        return self._dataset

    # ------------------------------------------------------------- streaming
    def estimate_packed_bytes(self, block_size=None, quantize=None):
        """{chrom: packed BlockLD bytes} without reading any LD data —
        block sizes come from .npz member headers / Zarr boundary metadata.

        Conservative: uses the store's raw block sizes (harmonization only
        shrinks them). The capacity planner for LD-larger-than-HBM streaming
        (reference analog: per-chromosome fits, bin/viprs_fit:232-238).
        """
        from ..ops.block_ld import estimate_packed_bytes
        block_size = block_size or self.block_size
        quantize = self.quantize_ld if quantize is None else quantize
        sizes = {}
        if self._ld_sources:
            for kind, store in self._ld_sources:
                if kind == 'native':
                    sizes.update(ld_store_mod.native_store_block_sizes(store))
                else:
                    sizes.update(ld_store_mod.magenpy_zarr_block_sizes(store))
        elif self._ld_blocks is not None:
            sizes = {c: [b.shape[0] for b in blks]
                     for c, blks in self._ld_blocks.items()}
        keep = set(self.ld_snp_tables or sizes)
        return {c: estimate_packed_bytes({c: s}, block_size=block_size,
                                         quantize=quantize)
                for c, s in sizes.items() if c in keep}

    def plan_chromosome_groups(self, budget_bytes, block_size=None,
                               quantize=None):
        """Group chromosomes so each group's packed LD fits the budget.

        Chromosomes are independent LD blocks, so a sequential per-group fit
        is exact per group (the reference's default per-chromosome mode,
        bin/viprs_fit:232-238). Returns a list of chromosome lists.
        """
        per_chrom = self.estimate_packed_bytes(block_size, quantize)
        groups, cur, cur_bytes = [], [], 0
        for c in sorted(per_chrom, key=str):
            b = per_chrom[c]
            if b > budget_bytes:
                logger.warning(
                    "Chromosome %s alone packs to %.2f GB (> budget %.2f GB);"
                    " it forms its own group and may not fit on one device — "
                    "use a multi-device mesh to shard its blocks.",
                    c, b / 1e9, budget_bytes / 1e9)
            if cur and cur_bytes + b > budget_bytes:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(c)
            cur_bytes += b
        if cur:
            groups.append(cur)
        return groups

    def subset_loader(self, chromosomes):
        """A lazy view of this loader restricted to the given chromosomes
        (shares sources and masks; materializes only that subset's LD)."""
        chroms = set(chromosomes)
        sub = GWADataLoader.__new__(GWADataLoader)
        sub.__dict__.update(self.__dict__)
        sub.ld_snp_tables = {c: t for c, t in (self.ld_snp_tables or {}).items()
                             if c in chroms} or None
        sub.sumstats_table = ({c: t for c, t in self.sumstats_table.items()
                               if c in chroms}
                              if self.sumstats_table else None)
        if self._ld_blocks is not None:
            sub.ld_blocks = {c: b for c, b in self._ld_blocks.items()
                             if c in chroms}
        if self._ld_present is not None:
            sub._ld_present = {c: m for c, m in self._ld_present.items()
                               if c in chroms}
        sub._dataset = None
        return sub

    def iter_group_datasets(self, groups, block_size=None, quantize=None):
        """Yield (chromosome_group, SummaryStatsDataset) per planned group,
        materializing (and then releasing) one group's LD at a time."""
        for group in groups:
            sub = self.subset_loader(group)
            ds = sub.to_summary_dataset(block_size=block_size,
                                        quantize=quantize)
            yield group, ds
            sub.cleanup()
            del sub, ds

    # ------------------------------------------------------------------- misc
    def split_by_chromosome(self):
        """Per-chromosome shallow copies (API compatibility; the framework
        fits all chromosomes jointly as sharded block ranges)."""
        out = {}
        for c in self.chromosomes:
            sub = GWADataLoader.__new__(GWADataLoader)
            sub.__dict__.update(self.__dict__)
            sub.ld_blocks = ({c: self._ld_blocks[c]}
                             if self._ld_blocks else None)
            if self._ld_present is not None and c in self._ld_present:
                sub._ld_present = {c: self._ld_present[c]}
            sub.ld_snp_tables = {c: self.ld_snp_tables[c]} if self.ld_snp_tables else None
            sub.sumstats_table = ({c: self.sumstats_table[c]}
                                  if self.sumstats_table else None)
            sub._dataset = None
            out[c] = sub
        return out

    def cleanup(self):
        self._dataset = None
