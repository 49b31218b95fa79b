"""On-disk LD matrix stores.

Native format: one ``chr_<c>.npz`` per chromosome holding the dense LD blocks
(float32 or int8-quantized, block-diagonal layout) plus a ``chr_<c>.snps.csv``
variant table — directly re-packable into the device BlockLD tiles.

Ingestion of the reference ecosystem's stores (magenpy Zarr-backed banded
matrices, int8-quantized; consumed surface at SURVEY.md §2.6) is provided via
:func:`load_magenpy_zarr`, built on the dependency-free Zarr v2 reader in
:mod:`viprs_tpu.data.zarr_v2` (no ``zarr`` package needed); the inverse
:func:`save_magenpy_zarr` exports native data back into that layout.
"""

import json
import logging
import os
import os.path as osp

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)

_SNP_COLS = ['CHR', 'SNP', 'POS', 'A1', 'A2']


def save_ld_store(path, chrom_blocks, snp_tables=None, quantize=True):
    """Write per-chromosome LD blocks (+ variant tables) to ``path``.

    Blocks may be float (correlations in [-1, 1]) or already-quantized int8
    (scale 1/127, e.g. from a store-backed loader's ``ld_blocks``) — int8
    input is written verbatim when ``quantize=True``."""
    os.makedirs(path, exist_ok=True)
    meta = {'quantized': bool(quantize), 'chromosomes': []}
    for c, blocks in chrom_blocks.items():
        arrays = {}
        for i, blk in enumerate(blocks):
            blk = np.asarray(blk)
            if quantize:
                arrays[f'block_{i:05d}'] = blk if blk.dtype == np.int8 else \
                    np.clip(np.rint(blk * 127.0), -127, 127).astype(np.int8)
            elif blk.dtype == np.int8:
                arrays[f'block_{i:05d}'] = blk.astype(np.float32) / 127.0
            else:
                arrays[f'block_{i:05d}'] = blk.astype(np.float32)
        np.savez_compressed(osp.join(path, f'chr_{c}.npz'), **arrays)
        if snp_tables is not None and c in snp_tables:
            snp_tables[c].to_csv(osp.join(path, f'chr_{c}.snps.csv'), index=False)
        meta['chromosomes'].append(str(c))
    with open(osp.join(path, 'metadata.json'), 'w') as f:
        json.dump(meta, f)
    return path


def _parse_chrom(name):
    c = name.replace('chr_', '').replace('.npz', '')
    try:
        return int(c)
    except ValueError:
        return c


def load_ld_store(path, chromosomes=None, tables_only=False, dequantize=True):
    """Load a native LD store.

    :param tables_only: read only the per-chromosome variant tables (cheap);
        ``chrom_blocks`` comes back as None. Used by the lazy ingestion path —
        harmonization needs tables only, and a pack-cache hit never touches
        the LD data at all.
    :param dequantize: inflate int8 store blocks to float64 (/127). The
        fitting path passes False: packing consumes int8 verbatim (same 1/127
        scale), so an 18M-variant store streams through host RAM at 1 byte
        per element instead of 8.
    :returns: (chrom_blocks {c: [float64 blocks]} or None — int8 blocks when
               ``dequantize=False`` and the store is quantized,
               snp_tables {c: DataFrame} or None)
    """
    files = [f for f in os.listdir(path) if f.startswith('chr_') and f.endswith('.npz')]
    assert files, f"No LD store files found under {path}"

    chrom_blocks, snp_tables = {}, {}
    for f in sorted(files):
        c = _parse_chrom(f)
        if chromosomes is not None and c not in chromosomes:
            continue
        if not tables_only:
            npz = np.load(osp.join(path, f))
            blocks = []
            for key in sorted(npz.files):
                blk = npz[key]
                if blk.dtype == np.int8:
                    if dequantize:
                        blk = blk.astype(np.float64) / 127.0
                else:
                    blk = np.asarray(blk, dtype=np.float64)
                blocks.append(blk)
            chrom_blocks[c] = blocks
        snp_path = osp.join(path, f.replace('.npz', '.snps.csv'))
        if osp.exists(snp_path):
            snp_tables[c] = pd.read_csv(snp_path)

    return (None if tables_only else chrom_blocks), (snp_tables or None)


def native_store_block_sizes(path, chromosomes=None):
    """Per-chromosome LD block sizes of a native store, read from the .npz
    member headers only (no array data is decompressed) — the capacity
    planner's input for streamed fitting."""
    import zipfile
    from numpy.lib import format as npf

    files = [f for f in os.listdir(path)
             if f.startswith('chr_') and f.endswith('.npz')]
    out = {}
    for f in sorted(files):
        c = _parse_chrom(f)
        if chromosomes is not None and c not in chromosomes:
            continue
        sizes = {}
        with zipfile.ZipFile(osp.join(path, f)) as zf:
            for name in zf.namelist():
                with zf.open(name) as member:
                    version = npf.read_magic(member)
                    shape, _, _ = npf._read_array_header(member, version)
                sizes[name] = shape[0]
        out[c] = [sizes[k] for k in sorted(sizes)]
    return out


def magenpy_zarr_block_sizes(path):
    """{chrom: [block sizes]} of a magenpy Zarr store, from the (small)
    indptr + boundary metadata only — matrix/data is never opened."""
    from . import zarr_v2

    g = zarr_v2.open_group(path)
    indptr = np.asarray(g['matrix/indptr'][...])
    attrs = dict(g.attrs)
    chrom = attrs.get('Chromosome', 0)
    try:
        chrom = int(chrom)
    except (TypeError, ValueError):
        pass
    m = len(indptr) - 1
    bounds = _read_meta_array(g, ('ld_boundaries', 'LD boundaries', 'ldb'))
    if bounds is None:
        raise ValueError(f"{path}: no LD-boundary metadata; cannot plan.")
    bounds = np.asarray(bounds)
    widths = np.diff(indptr)
    j = np.arange(m)
    if np.array_equal(widths, bounds[1] - bounds[0]):
        # symmetric rows: [bounds[0], bounds[1]) per row
        cuts = _band_cut_points_from_edges(bounds[0].astype(np.int64),
                                           bounds[1].astype(np.int64), m)
    else:
        # upper-triangular rows: row j spans (j, bounds[1, j})
        cuts = _band_cut_points_from_edges(j.astype(np.int64),
                                           bounds[1].astype(np.int64), m)
    return {chrom: [hi - lo for lo, hi in zip(cuts[:-1], cuts[1:])]}


def _band_cut_points_from_edges(left, right_excl, m):
    runmax = np.maximum.accumulate(right_excl)
    cuts = [0]
    cut_points = np.nonzero(runmax[:-1] <= np.arange(1, m))[0] + 1
    cuts.extend(int(c) for c in cut_points)
    cuts.append(m)
    return sorted(set(cuts))


def banded_to_blocks(data, indptr, left_bound, max_dense_block=20000,
                     keep_quantized=False):
    """Cut a banded symmetric LD matrix into exact dense diagonal blocks at
    points where no stored entry crosses the boundary (LDetect-style block
    stores pinch off at every block edge, so this is lossless for them).

    :param data, indptr, left_bound: symmetric-row banded arrays (diagonal
        included; rows may cover the full window or only the upper triangle).
    :param max_dense_block: guard — a segment wider than this (a windowed
        estimator's band never pinches off) raises instead of materializing a
        huge dense block.
    :param keep_quantized: with int8 input (a quantized magenpy Zarr store,
        scale 1/127), emit int8 blocks instead of inflating to float64 —
        packing consumes them verbatim, so an 18M-variant UKB store streams
        through host RAM at 1 byte per element.
    :returns: list of dense (m_i, m_i) blocks — float64, or int8 when
        ``keep_quantized`` applies.
    """
    data = np.asarray(data)
    int8_out = keep_quantized and data.dtype == np.int8
    if data.dtype == np.int8 and not int8_out:
        data = data.astype(np.float64) / 127.0
    indptr = np.asarray(indptr)
    left = np.asarray(left_bound)
    m = len(indptr) - 1
    widths = np.diff(indptr)
    right = left + widths                       # exclusive right edge per row
    runmax = np.maximum.accumulate(right)

    cuts = [0]
    cut_points = np.nonzero(runmax[:-1] <= np.arange(1, m))[0] + 1
    cuts.extend(int(c) for c in cut_points)
    cuts.append(m)
    cuts = sorted(set(cuts))

    # vectorized entry coordinates (row, col) for every stored element —
    # row-by-row Python would crawl on the 18M-variant UKB stores:
    rows_all = np.repeat(np.arange(m), widths)
    offs = np.arange(len(data)) - np.repeat(indptr[:-1].astype(np.int64),
                                            widths)
    cols_all = np.repeat(left.astype(np.int64), widths) + offs

    blocks = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        width = hi - lo
        if width > max_dense_block:
            raise ValueError(
                f"LD band segment [{lo}, {hi}) is {width} variants wide and "
                f"never pinches off — this looks like a windowed (non-block) "
                f"LD estimator. Pack it block-banded via "
                f"SummaryStatsDataset.from_banded instead of densifying.")
        seg = slice(int(indptr[lo]), int(indptr[hi]))
        r = rows_all[seg] - lo
        c = cols_all[seg] - lo
        v = data[seg]
        sel = (c >= r) & (c < width)   # upper triangle; symmetry fills the rest
        if int8_out:
            # assignment-based symmetrization (blk + blk.T would overflow
            # int8); the diagonal is exactly 127 (= 1.0 at scale 1/127):
            blk = np.zeros((width, width), dtype=np.int8)
            blk[r[sel], c[sel]] = v[sel]
            blk[c[sel], r[sel]] = v[sel]
            np.fill_diagonal(blk, 127)
        else:
            blk = np.zeros((width, width))
            blk[r[sel], c[sel]] = v[sel]
            blk = blk + blk.T - np.diag(np.diag(blk))
            np.fill_diagonal(blk, 1.0)
        blocks.append(blk)
    return blocks


def _read_meta_array(g, names):
    """Read the first present metadata array among alias ``names``."""
    for name in names:
        key = f'metadata/{name}'
        if key in g:
            return np.asarray(g[key][...])
    return None


def load_magenpy_zarr_tables(path):
    """Read ONLY the variant metadata of a magenpy Zarr LD store (cheap: the
    metadata arrays are a few MB; ``matrix/data`` — the GB-scale banded LD —
    is never opened). Returns ``snp_tables`` as in :func:`load_magenpy_zarr`.
    """
    from . import zarr_v2

    g = zarr_v2.open_group(path)
    if 'matrix/data' not in g or 'matrix/indptr' not in g:
        raise ValueError(
            f"{path}: not a magenpy LD store (missing matrix/data or "
            f"matrix/indptr Zarr arrays).")
    attrs = dict(g.attrs)
    chrom = attrs.get('Chromosome', 0)
    try:
        chrom = int(chrom)
    except (TypeError, ValueError):
        pass
    snps = _read_meta_array(g, ('snps', 'snp', 'SNP'))
    if snps is None:
        return None
    return {chrom: _zarr_snp_table(g, chrom, np.asarray(snps))}


def _zarr_snp_table(g, chrom, snps):
    m = len(snps)
    a1 = _read_meta_array(g, ('a1', 'A1'))
    a2 = _read_meta_array(g, ('a2', 'A2'))
    bp = _read_meta_array(g, ('bp', 'BP', 'pos'))
    tab = {'CHR': chrom, 'SNP': snps.astype(str),
           'POS': (np.asarray(bp, dtype=np.int64) if bp is not None
                   else np.arange(m, dtype=np.int64))}
    if a1 is not None:
        tab['A1'] = np.asarray(a1).astype(str)
    if a2 is not None:
        tab['A2'] = np.asarray(a2).astype(str)
    for extra in ('maf', 'cm', 'ldscore'):
        vals = _read_meta_array(g, (extra,))
        if vals is not None:
            tab[extra.upper() if extra != 'ldscore' else 'LDSCORE'] = \
                np.asarray(vals)
    return pd.DataFrame(tab)


def load_magenpy_zarr(path):
    """Ingest a magenpy-format Zarr LD store (banded, int8/int16-quantized).

    Layout (magenpy LDMatrix; reference use-site viprs/model/VIPRS.py:147-207):
    a Zarr v2 group with ``matrix/data`` (concatenated banded rows) and
    ``matrix/indptr`` (CSR-like row pointers), a ``metadata`` group with
    per-variant arrays including the LD boundaries, and root attributes
    (``Chromosome``, ``Sample size``, ...). Read with the built-in
    dependency-free Zarr v2 reader (:mod:`viprs_tpu.data.zarr_v2`) — no
    ``zarr`` package needed.

    LAYOUT PROVENANCE AUDIT — magenpy itself is not vendored here, so every
    assumed key name is traced to the consuming surface in the reference
    (hard-validated below; unknown layouts are errors, never guesses):

    - ``matrix/data`` / ``matrix/indptr``: the CSR-like banded pair the
      reference unpacks from ``LDMatrix.load(...)`` as
      ``ld_lop.ld_data`` / ``ld_lop.ld_indptr``
      (/root/reference/viprs/model/VIPRS.py:167-172) and feeds to the C++
      kernel (VIPRS.py:408-414). magenpy's Zarr group nests them under
      ``matrix/`` (magenpy LDMatrix docs; store is Zarr v2).
    - ``metadata/ld_boundaries`` (aliases ``LD boundaries``, ``ldb``): the
      (2, M) [start, end) window bounds behind ``ld_lop.leftmost_idx``
      (VIPRS.py:172) and ``LDMatrix.window_size``
      (/root/reference/benchmarks/benchmark_e_step.py:312-317). Validated
      against the indptr row widths for BOTH row semantics the reference
      loads: symmetric (``return_symmetric=True``) and upper-triangular
      low-memory rows (VIPRS.py:156-167, e_step.hpp:423-441).
    - ``metadata/snps``, ``a1``, ``a2``, ``bp``, ``maf``, ``cm``,
      ``ldscore``: the per-variant table surface the reference consumes via
      ``to_snp_table`` / ``merge_snp_tables`` allele-alignment
      (/root/reference/viprs/model/BayesPRSModel.py:252-331) and LD-score
      access for ``simple_ldsc`` (VIPRS.py:284-292).
    - attrs ``Chromosome`` / ``Sample size``: chromosome labeling of the
      per-chromosome stores (bin/viprs_fit:232-238 splits by chromosome) and
      the LD panel's sample size.
    - int8/int16 quantized storage with scale ``1/iinfo(dtype).max``:
      VIPRS.py:156-166 & 201-207 (``stored_dtype`` + dequantize-on-the-fly).
    - chromosome-level **zip archives** of these stores are the published
      distribution form (hf://datasets/shz9/ukb-ld,
      /root/reference/docs/download_ld.md:20-55).

    Row semantics are *validated, never guessed*: the LD-boundary metadata must
    be present and consistent with the indptr row widths, identifying the store
    as either symmetric (row j spans ``[bounds[0, j], bounds[1, j])``) or
    upper-triangular/low-memory (row j spans ``(j, bounds[1, j})``, diagonal
    excluded; magenpy ``load(return_symmetric=False)``). Anything else is a
    hard error — a mis-read band would silently corrupt every downstream
    posterior.

    :returns: (banded {chrom: (data, indptr, left_bound)} with symmetric-row
        semantics and the diagonal included, snp_tables {chrom: DataFrame} or
        None). Integer data other than int8 is dequantized to float32.
    """
    from . import zarr_v2

    g = zarr_v2.open_group(path)
    if 'matrix/data' not in g or 'matrix/indptr' not in g:
        raise ValueError(
            f"{path}: not a magenpy LD store (missing matrix/data or "
            f"matrix/indptr Zarr arrays).")
    data = np.asarray(g['matrix/data'][...])
    indptr = np.asarray(g['matrix/indptr'][...])
    attrs = dict(g.attrs)
    chrom = attrs.get('Chromosome', 0)
    try:
        chrom = int(chrom)
    except (TypeError, ValueError):
        pass

    m = len(indptr) - 1
    widths = np.diff(indptr)

    bounds = _read_meta_array(g, ('ld_boundaries', 'LD boundaries', 'ldb'))
    if bounds is None:
        raise ValueError(
            f"{path}: the LD store has no LD-boundary metadata "
            f"(metadata/ld_boundaries). Row start positions cannot be "
            f"inferred from row widths without silently corrupting the "
            f"matrix; refusing to load. If this store was produced by an "
            f"unsupported magenpy version, re-export it with boundaries.")
    bounds = np.asarray(bounds)
    if bounds.shape != (2, m):
        raise ValueError(
            f"{path}: LD-boundary metadata has shape {bounds.shape}; "
            f"expected (2, {m}) [start, end) per variant.")

    j = np.arange(m)
    if np.array_equal(widths, bounds[1] - bounds[0]):
        # symmetric rows starting at the left boundary (incl. diagonal):
        left_bound = bounds[0].astype(np.int64)
        if np.any(left_bound > j):
            raise ValueError(f"{path}: symmetric-row left boundary exceeds "
                             f"the diagonal for some variants; store corrupt?")
    elif np.array_equal(widths, np.maximum(bounds[1] - (j + 1), 0)):
        # upper-triangular (low-memory) rows: (j, end); re-prepend the
        # diagonal so downstream packing sees symmetric-row semantics:
        if np.issubdtype(data.dtype, np.integer):
            diag_val = np.iinfo(data.dtype).max
        else:
            diag_val = 1.0
        new_indptr = np.zeros(m + 1, dtype=np.int64)
        new_indptr[1:] = np.cumsum(widths + 1)
        new_data = np.empty(int(new_indptr[-1]), dtype=data.dtype)
        new_data[new_indptr[:-1]] = diag_val
        # vectorized scatter of the stored entries one slot after each
        # row's new diagonal element:
        offs = np.arange(len(data)) - np.repeat(indptr[:-1].astype(np.int64),
                                                widths)
        new_data[np.repeat(new_indptr[:-1], widths) + 1 + offs] = data
        data, indptr = new_data, new_indptr
        left_bound = j.astype(np.int64)
    else:
        raise ValueError(
            f"{path}: indptr row widths match neither symmetric "
            f"(end-start) nor upper-triangular (end-j-1) LD-boundary "
            f"semantics; refusing to guess the row layout.")

    # Dequantize non-int8 integer storage (the packer handles int8 natively;
    # reference dequantization scale is 1/iinfo(dtype).max, VIPRS.py:201-207):
    if np.issubdtype(data.dtype, np.integer) and data.dtype != np.int8:
        data = data.astype(np.float32) / np.iinfo(data.dtype).max

    snps = _read_meta_array(g, ('snps', 'snp', 'SNP'))
    snp_tables = None
    if snps is not None:
        snp_tables = {chrom: _zarr_snp_table(g, chrom, np.asarray(snps))}

    return {chrom: (data, indptr, left_bound)}, snp_tables


def save_magenpy_zarr(path, data, indptr, left_bound, snp_table=None,
                      chrom=0, sample_size=None, triangular=False):
    """Export banded LD (symmetric-row semantics, diagonal included) as a
    magenpy-layout Zarr v2 store — the inverse of :func:`load_magenpy_zarr`.

    Used to build byte-real test fixtures and to hand results back to the
    reference ecosystem.

    :param triangular: write the low-memory (upper-triangular, diagonal
        excluded) row layout instead of symmetric rows.
    """
    from . import zarr_v2

    data = np.asarray(data)
    indptr = np.asarray(indptr, dtype=np.int64)
    left_bound = np.asarray(left_bound, dtype=np.int64)
    m = len(indptr) - 1
    widths = np.diff(indptr)
    bounds = np.stack([left_bound, left_bound + widths]).astype(np.int64)

    if triangular:
        j = np.arange(m)
        tri_parts, tri_indptr = [], np.zeros(m + 1, dtype=np.int64)
        for row in range(m):
            vals = data[indptr[row]:indptr[row + 1]]
            cols = np.arange(left_bound[row], left_bound[row] + len(vals))
            keep = cols > row
            tri_parts.append(vals[keep])
            tri_indptr[row + 1] = tri_indptr[row] + keep.sum()
        out_data = (np.concatenate(tri_parts) if tri_parts
                    else np.zeros(0, data.dtype))
        out_indptr = tri_indptr
        # boundaries keep the *symmetric* window semantics (start, end):
        bounds = np.stack([left_bound, np.maximum(bounds[1], j + 1)])
    else:
        out_data, out_indptr = data, indptr

    zarr_v2.write_group_attrs(path, {
        'Chromosome': int(chrom) if np.isreal(chrom) else str(chrom),
        'Sample size': sample_size,
        'LD estimator': 'block',
        'Store format': 'viprs_tpu-export'})
    chunk = max(1, min(len(out_data), 1 << 20))
    zarr_v2.write_array(path, 'matrix/data', out_data, chunks=(chunk,))
    zarr_v2.write_array(path, 'matrix/indptr', out_indptr,
                        chunks=(len(out_indptr),))
    zarr_v2.write_array(path, 'metadata/ld_boundaries', bounds,
                        chunks=bounds.shape)
    if snp_table is not None:
        zarr_v2.write_array(path, 'metadata/snps',
                            np.asarray(snp_table['SNP'], dtype=object))
        for col, key in (('A1', 'a1'), ('A2', 'a2'), ('POS', 'bp'),
                         ('MAF', 'maf')):
            if col in snp_table.columns:
                vals = snp_table[col].values
                if vals.dtype == object or vals.dtype.kind in 'US':
                    vals = np.asarray(vals, dtype=object)
                zarr_v2.write_array(path, f'metadata/{key}', vals)
    return path
