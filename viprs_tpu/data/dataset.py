"""The canonical device-facing dataset: harmonized summary statistics + blocked LD.

This is the boundary between the (host, file-format-aware) data layer and the
(device, shape-static) compute layer. The reference passes a magenpy
``GWADataLoader`` into every model (BayesPRSModel.py:37-80); here models consume a
:class:`SummaryStatsDataset`, which the loader machinery (data/loader.py) builds
from files, and which can also be constructed directly from arrays (simulations,
tests, notebooks).
"""

import dataclasses
from typing import Dict, Optional, List

import numpy as np
import jax.numpy as jnp

from ..ops.block_ld import BlockLD, BlockLayout, pack_dense_blocks, pack_banded


@dataclasses.dataclass
class SummaryStatsDataset:
    """Harmonized GWAS summary statistics with block-packed LD.

    :ivar ld: BlockLD device operator.
    :ivar layout: host-side block layout (chromosome <-> flat index mapping).
    :ivar std_beta: {chrom: (m_c,)} standardized marginal betas
        (pseudo-correlations z/sqrt(n + z^2); the reference's
        ``SumstatsTable.get_snp_pseudo_corr``, BayesPRSModel.py:135).
    :ivar n_per_snp: {chrom: (m_c,)} per-variant GWAS sample sizes.
    :ivar snp_table: {chrom: DataFrame[SNP, POS, A1, A2]} variant metadata
        (optional; required for table I/O and harmonization with other data).
    :ivar ld_scores: optional {chrom: (m_c,)} LD scores (for LDSC h2 init).
    """
    ld: BlockLD
    layout: BlockLayout
    std_beta: Dict
    n_per_snp: Dict
    snp_table: Optional[Dict] = None
    ld_scores: Optional[Dict] = None
    phenotype_likelihood: str = 'gaussian'
    _mesh_ld_cache: Dict = dataclasses.field(default_factory=dict, repr=False,
                                             compare=False)

    # ------------------------------------------------------------------ props
    @property
    def chromosomes(self):
        return list(self.layout.chromosomes)

    @property
    def shapes(self):
        return {c: s for c, s in zip(self.layout.chromosomes, self.layout.chrom_sizes)}

    @property
    def m(self) -> int:
        return self.layout.m

    @property
    def n_snps(self) -> int:
        return self.m

    @property
    def n(self) -> float:
        return float(max(np.max(v) for v in self.n_per_snp.values()))

    # ------------------------------------------------------------- flat views
    def std_beta_flat(self):
        return jnp.asarray(
            self.layout.to_flat(self.std_beta).reshape(self.layout.nb, self.layout.block_size),
            dtype=jnp.float32)

    def n_per_snp_flat(self):
        return jnp.asarray(
            self.layout.to_flat(self.n_per_snp).reshape(self.layout.nb, self.layout.block_size),
            dtype=jnp.float32)

    def device_inputs(self, mesh=None):
        """Cached (std_beta_flat, n_per_snp_flat) device arrays, padded and
        block-sharded for ``mesh``. Shared across models over this dataset —
        a fresh model otherwise re-uploads ~9 MB per fit on remote
        transports (PUMAS-split models build their own; see
        VIPRS._refresh_inputs)."""
        key = ('inputs', mesh)
        if key not in self._mesh_ld_cache:
            sb = self.std_beta_flat()
            nf = self.n_per_snp_flat()
            if mesh is not None:
                from ..parallel.mesh import shard_flat
                nb = self.ld_for_mesh(mesh).nb
                sb = shard_flat(mesh, sb, nb)
                nf = shard_flat(mesh, nf, nb)
            self._mesh_ld_cache[key] = (sb, nf)
        return self._mesh_ld_cache[key]

    def ld_for_mesh(self, mesh):
        """Block-sharded (and NB-padded) view of the LD for a device mesh.

        Cached per mesh so that several models over the same dataset (e.g. the
        CLI's EM fit followed by a grid search) share one HBM-resident copy —
        the genome-scale LD store is GBs.
        """
        if mesh is None:
            return self.ld
        if mesh not in self._mesh_ld_cache:
            from ..parallel.mesh import shard_ld
            self._mesh_ld_cache[mesh] = shard_ld(mesh, self.ld)
        return self._mesh_ld_cache[mesh]

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_dense_blocks(cls, ld_blocks: Dict, std_beta: Dict, n_per_snp: Dict,
                          snp_table: Optional[Dict] = None,
                          block_size: int = 1024, quantize: bool = False,
                          **kwargs):
        """Build from per-chromosome lists of dense LD blocks (LDetect-style)."""
        ld, layout = pack_dense_blocks(ld_blocks, block_size=block_size,
                                       quantize=quantize)
        ds = cls(ld=ld, layout=layout, std_beta=std_beta, n_per_snp=n_per_snp,
                 snp_table=snp_table, **kwargs)
        ds._check_shapes()
        return ds

    @classmethod
    def from_banded(cls, banded: Dict, std_beta: Dict, n_per_snp: Dict,
                    snp_table: Optional[Dict] = None,
                    block_size: int = 1024, quantize: bool = False, **kwargs):
        """Build from per-chromosome banded LD arrays (the reference's on-disk
        layout: {data, indptr, left_bound}, VIPRS.py:167-172)."""
        ld, layout = pack_banded(banded, block_size=block_size, quantize=quantize)
        ds = cls(ld=ld, layout=layout, std_beta=std_beta, n_per_snp=n_per_snp,
                 snp_table=snp_table, **kwargs)
        ds._check_shapes()
        return ds

    def _check_shapes(self):
        for c, sz in self.shapes.items():
            assert len(self.std_beta[c]) == sz, \
                f"std_beta for chromosome {c} has wrong length"
            assert len(self.n_per_snp[c]) == sz

    # ------------------------------------------------------------------ misc
    def default_snp_table(self):
        """Synthesize a minimal SNP table when none was provided."""
        if self.snp_table is not None:
            return self.snp_table
        import pandas as pd
        tables = {}
        for c, sz in self.shapes.items():
            tables[c] = pd.DataFrame({
                'CHR': c,
                'SNP': [f'rs_{c}_{i}' for i in range(sz)],
                'POS': np.arange(sz, dtype=np.int64),
                'A1': 'A', 'A2': 'G',
            })
        return tables

    def compute_ld_scores(self):
        """LD scores l_j = sum_k r_jk^2 from the blocked LD (for LDSC init).

        Computed on device in float32 — the genome-scale LD store is GBs, so
        a host float64 materialization would be prohibitive.
        """
        if self.ld_scores is not None:
            return self.ld_scores
        import jax
        import jax.numpy as jnp
        from jax import lax
        from ..ops.memory import chunk_threshold_bytes

        @jax.jit
        def _scores(diag, off_data, off_src, off_dst):
            scale2 = jnp.float32(self.ld.scale) ** 2

            def sq_sum(x, axis):
                xf = x.astype(jnp.float32)
                return (xf * xf).sum(axis=axis) * scale2

            scores = sq_sum(diag, 2)                       # (NB, B)
            if off_data.shape[0]:
                scores = scores.at[off_src].add(sq_sum(off_data, 2))
                scores = scores.at[off_dst].add(sq_sum(off_data, 1))
            return scores

        def _scores_chunked():
            # Capacity scale: the dense reduction materializes the full 4x
            # f32 conversion of the tiles (40 GB at 9.6M) on top of the
            # resident LD. Host-driven chunks keep the peak temp at one
            # chunk (the slice + its f32 view).
            scale2 = np.float32(self.ld.scale) ** 2
            B = self.ld.block_size

            @jax.jit
            def chunk_diag(d):
                f = d.astype(jnp.float32)
                return (f * f).sum(axis=2) * scale2

            @jax.jit
            def chunk_off(o):
                f = o.astype(jnp.float32)
                return (f * f).sum(axis=2) * scale2, \
                    (f * f).sum(axis=1) * scale2

            # chunk sized so slice (int8) + its f32 view stay ~0.6 GB
            ch = max(1, int(1.25e8 // (B * B)))
            nb = self.ld.diag.shape[0]
            scores = np.concatenate(
                [np.asarray(chunk_diag(lax.slice_in_dim(
                    self.ld.diag, i, min(i + ch, nb), axis=0)))
                 for i in range(0, nb, ch)])                  # (NB, B)
            n_off = self.ld.off_data.shape[0]
            if n_off:
                rows, cols = [], []
                for i in range(0, n_off, ch):
                    r, c = chunk_off(lax.slice_in_dim(
                        self.ld.off_data, i, min(i + ch, n_off), axis=0))
                    rows.append(np.asarray(r))
                    cols.append(np.asarray(c))
                off_src = np.asarray(self.ld.off_src)
                off_dst = np.asarray(self.ld.off_dst)
                np.add.at(scores, off_src, np.concatenate(rows))
                np.add.at(scores, off_dst, np.concatenate(cols))
            return scores

        big = (self.ld.diag.nbytes + self.ld.off_data.nbytes) \
            > chunk_threshold_bytes()
        if big:
            scores = _scores_chunked()
        else:
            scores = _scores(self.ld.diag, self.ld.off_data,
                             self.ld.off_src, self.ld.off_dst)
        self.ld_scores = self.layout.from_flat(np.asarray(scores).reshape(-1))
        return self.ld_scores
