"""Block-banded dense-tile LD representation — the device LD format.

The reference stores LD as banded CSR-like arrays ``{ld_data, ld_indptr,
ld_left_bound}`` (viprs/model/VIPRS.py:147-207, magenpy LDMatrix). Here LD lives
as dense (B x B) tiles so that the CAVI rank-updates become matrix products:

- ``diag[b]`` = R[bB:(b+1)B, bB:(b+1)B]  — (NB, B, B) diagonal tiles;
- ``off_data[o]`` = R[src_o B:(src_o+1)B, dst_o B:(dst_o+1)B] — a *compact* list
  of the non-zero inter-tile coupling blocks (upper triangle: src < dst), with
  index vectors ``off_src``/``off_dst``. Only LD blocks wider than B produce
  coupling tiles, so this list is short and the common block-diagonal case pays
  nothing for it.

R is symmetric, so sub-diagonal couplings are transposes of ``off_data``. int8
storage with a global dequantization ``scale`` reproduces the reference's int8
quantized stores with dequantize-on-the-fly (``dq_scale``, e_step.hpp /
VIPRS.py:201-207).
"""

import dataclasses
from functools import partial
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp


INT8_SCALE = 1.0 / 127.0


@partial(jax.tree_util.register_dataclass,
         data_fields=['diag', 'off_data', 'off_src', 'off_dst', 'mask'],
         meta_fields=['scale'])
@dataclasses.dataclass(frozen=True)
class BlockLD:
    """Device-side blocked LD operator.

    :ivar diag: (NB, B, B) diagonal tiles (int8 or float).
    :ivar off_data: (n_off, B, B) compact inter-tile coupling blocks
        (upper triangle; (0, B, B)-shaped when there is no coupling).
    :ivar off_src: (n_off,) int32 — row-tile index of each coupling block.
    :ivar off_dst: (n_off,) int32 — column-tile index (src < dst).
    :ivar mask: (NB, B) float32 — 1.0 for real variant lanes, 0.0 for padding.
    :ivar scale: static python float — dequantization multiplier applied to
        all tiles when accumulating (1.0 for float storage).
    """
    diag: jnp.ndarray
    off_data: jnp.ndarray
    off_src: jnp.ndarray
    off_dst: jnp.ndarray
    mask: jnp.ndarray
    scale: float

    @property
    def nb(self) -> int:
        return self.diag.shape[0]

    @property
    def block_size(self) -> int:
        return self.diag.shape[1]

    @property
    def n_off(self) -> int:
        return self.off_data.shape[0]

    @property
    def m_padded(self) -> int:
        return self.nb * self.block_size

    def astype_storage(self, dtype):
        """Cast the LD storage (e.g. to float32 for small problems)."""
        if dtype == self.diag.dtype:
            return self
        if jnp.issubdtype(dtype, jnp.integer):
            raise ValueError("Re-quantization not supported here; build from source data.")
        diag = (self.diag.astype(dtype) * self.scale).astype(dtype)
        off_data = (self.off_data.astype(dtype) * self.scale).astype(dtype)
        return BlockLD(diag=diag, off_data=off_data, off_src=self.off_src,
                       off_dst=self.off_dst, mask=self.mask, scale=1.0)


def make_block_ld(diag, off_tiles, mask, scale):
    """Assemble a BlockLD from a {(src, dst): (B, B) array} coupling dict."""
    items = sorted(off_tiles.items())
    if items:
        off_data = np.stack([v for _, v in items])
        off_src = np.asarray([k[0] for k, _ in items], np.int32)
        off_dst = np.asarray([k[1] for k, _ in items], np.int32)
    else:
        B = diag.shape[1]
        off_data = np.zeros((0, B, B), dtype=diag.dtype)
        off_src = np.zeros(0, np.int32)
        off_dst = np.zeros(0, np.int32)
    return BlockLD(diag=jnp.asarray(diag), off_data=jnp.asarray(off_data),
                   off_src=jnp.asarray(off_src), off_dst=jnp.asarray(off_dst),
                   mask=jnp.asarray(mask), scale=scale)


@dataclasses.dataclass
class BlockLayout:
    """Host-side map between the original (per-chromosome) variant order and the
    padded flat block order.

    :ivar chromosomes: ordered chromosome labels.
    :ivar chrom_sizes: number of real variants per chromosome.
    :ivar chrom_block_range: per chromosome, (first_block, last_block_exclusive).
    :ivar flat_index: (M,) int — for each real variant (in chromosome-sorted
        order), its index in the padded flat space of size NB*B.
    """
    chromosomes: list
    chrom_sizes: list
    chrom_block_range: list
    flat_index: np.ndarray
    block_size: int
    nb: int

    @property
    def m(self) -> int:
        return int(sum(self.chrom_sizes))

    @property
    def m_padded(self) -> int:
        return self.nb * self.block_size

    def to_flat(self, per_chrom: dict, fill=0.0, dtype=np.float32, trailing_shape=()):
        """Scatter chromosome-keyed arrays into one padded flat array."""
        out = np.full((self.m_padded,) + tuple(trailing_shape), fill, dtype=dtype)
        vals = np.concatenate([np.asarray(per_chrom[c]) for c in self.chromosomes], axis=0)
        out[self.flat_index] = vals
        return out

    def from_flat(self, flat: np.ndarray) -> dict:
        """Gather a padded flat array back into chromosome-keyed arrays."""
        flat = np.asarray(flat)
        vals = flat[self.flat_index]
        out = {}
        start = 0
        for c, sz in zip(self.chromosomes, self.chrom_sizes):
            out[c] = vals[start:start + sz]
            start += sz
        return out

    def mask(self) -> np.ndarray:
        m = np.zeros(self.m_padded, dtype=np.float32)
        m[self.flat_index] = 1.0
        return m.reshape(self.nb, self.block_size)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def quantize_int8(x: np.ndarray) -> np.ndarray:
    """Symmetric int8 quantization of correlations in [-1, 1] (scale 1/127).

    Uses the native OpenMP kernel (native/viprs_native.cpp) when built."""
    try:
        from ..data.native import load_native
        lib = load_native()
    except Exception:
        lib = None
    if lib is not None and x.size >= 1 << 16:
        src = np.ascontiguousarray(x, dtype=np.float64)
        out = np.empty(x.shape, dtype=np.int8)
        lib.quantize_int8(src.ctypes.data_as(lib.f64p), src.size,
                          out.ctypes.data_as(lib.i8p))
        return out
    return np.clip(np.rint(x * 127.0), -127, 127).astype(np.int8)


def plan_layout(chrom_block_sizes: dict, block_size: int = 1024,
                greedy: bool = True):
    """Compute the packed layout from LD-block SIZES alone (no data needed).

    greedy=True: best-fit-decreasing bin packing of LD blocks into B-tiles
    within each chromosome (placement order decoupled from variant order;
    BlockLayout.flat_index keeps the variant-order mapping exact).

    :param chrom_block_sizes: {chrom: [m_i, ...]} per-chromosome LD block sizes.
    :returns: (layout, placements) with placements a list of
        (tile, offset, chrom, block_idx, m_i).
    """
    B = block_size
    chroms = sorted(chrom_block_sizes.keys())

    chrom_sizes, chrom_block_range = [], []
    placements = []         # (tile, offset, chrom, block_idx, m_i)
    flat_idx_by_block = {}  # (chrom, block_idx) -> flat index array
    tile_cursor = 0
    for c in chroms:
        c_first_tile = tile_cursor
        sizes = chrom_block_sizes[c]
        c_size = int(sum(sizes))

        order = range(len(sizes))
        if greedy:
            order = sorted(order, key=lambda i: -sizes[i])
        open_tiles = []  # list of [tile, used]

        for bi in order:
            m_i = int(sizes[bi])
            ntiles = _round_up(max(m_i, 1), B) // B
            if ntiles > 1 or not greedy:
                # multi-tile block: contiguous fresh tiles; tail stays open
                t0 = tile_cursor
                placements.append((t0, 0, c, bi, m_i))
                base = t0 * B
                tile_cursor += ntiles
                if greedy and m_i % B:
                    open_tiles.append([t0 + ntiles - 1, m_i % B])
            else:
                # best-fit: the open tile with the least remaining space that fits
                best = None
                for slot in open_tiles:
                    rem = B - slot[1]
                    if m_i <= rem and (best is None or rem < B - best[1]):
                        best = slot
                if best is None:
                    best = [tile_cursor, 0]
                    open_tiles.append(best)
                    tile_cursor += 1
                placements.append((best[0], best[1], c, bi, m_i))
                base = best[0] * B + best[1]
                best[1] += m_i
            flat_idx_by_block[(c, bi)] = np.arange(base, base + m_i,
                                                   dtype=np.int64)

        chrom_sizes.append(c_size)
        chrom_block_range.append((c_first_tile, tile_cursor))

    # flat indices in original variant order:
    flat_idx_parts = [flat_idx_by_block[(c, bi)]
                      for c in chroms for bi in range(len(chrom_block_sizes[c]))]
    nb = tile_cursor
    layout = BlockLayout(chromosomes=chroms,
                         chrom_sizes=chrom_sizes,
                         chrom_block_range=chrom_block_range,
                         flat_index=np.concatenate(flat_idx_parts) if flat_idx_parts
                         else np.zeros(0, np.int64),
                         block_size=B, nb=nb)
    return layout, placements


def estimate_packed_bytes(chrom_block_sizes: dict, block_size: int = 1024,
                          quantize: bool = True, greedy: bool = True):
    """Packed BlockLD size in bytes from LD-block sizes alone (the capacity
    planner for LD-larger-than-HBM streaming).

    Counts diagonal tiles from the actual bin-packing plan plus the compact
    coupling tiles of multi-tile blocks (upper-triangle pairs).
    """
    B = block_size
    layout, placements = plan_layout(chrom_block_sizes, block_size=B,
                                     greedy=greedy)
    n_off = 0
    for _, o, _, _, m_i in placements:
        if o == 0 and m_i > B:
            ntiles = _round_up(m_i, B) // B
            n_off += ntiles * (ntiles - 1) // 2
    itemsize = 1 if quantize else 4
    return (layout.nb + n_off) * B * B * itemsize


def pack_dense_blocks(chrom_blocks: dict,
                      block_size: int = 1024,
                      dtype=np.float32,
                      quantize: bool = False,
                      greedy: bool = True):
    """Pack per-chromosome lists of dense LD blocks (LDetect-style block-diagonal
    LD) into a :class:`BlockLD` + :class:`BlockLayout`.

    With ``greedy=True`` (default), several small LD blocks share one B-tile
    when they fit — exact, since the dense tile stores zeros between them —
    which removes most padding waste for B >> typical LDetect block size.
    LD blocks larger than B start at a fresh tile and span ``ceil(m_i/B)``
    tiles, requiring ``n_bands = max_i ceil(m_i/B) - 1`` coupling bands.

    :param chrom_blocks: {chrom: [dense (m_i, m_i) numpy arrays]}
    """
    B = block_size
    layout, placements = plan_layout(
        {c: [blk.shape[0] for blk in blocks]
         for c, blocks in chrom_blocks.items()},
        block_size=B, greedy=greedy)
    nb = layout.nb

    # ---- fill tiles ----
    store_dtype = np.int8 if quantize else dtype
    diag = np.zeros((nb, B, B), dtype=store_dtype)
    off_tiles = {}

    for tile_start, o, c, bi, m_i in placements:
        blk = chrom_blocks[c][bi]
        assert blk.shape == (m_i, m_i)
        # int8 input (an already-quantized store, scale 1/127) passes through
        # verbatim when quantizing — byte-identical to dequantize+requantize
        # (clip(rint((q/127)*127)) == q for integer q) without inflating the
        # genome to float64 in host RAM (load_ld_store(dequantize=False)):
        input_is_int8 = blk.dtype == np.int8
        if quantize:
            vals = blk if input_is_int8 else quantize_int8(blk)
        else:
            vals = blk.astype(dtype) * np.asarray(INT8_SCALE, dtype) \
                if input_is_int8 else blk.astype(dtype)
        if o > 0 or m_i <= B - o:
            diag[tile_start, o:o + m_i, o:o + m_i] = vals
            continue
        ntiles = _round_up(m_i, B) // B
        for ti in range(ntiles):
            r0, r1 = ti * B, min((ti + 1) * B, m_i)
            diag[tile_start + ti, :r1 - r0, :r1 - r0] = vals[r0:r1, r0:r1]
            for k in range(ti + 1, ntiles):
                c0, c1 = k * B, min((k + 1) * B, m_i)
                key = (tile_start + ti, tile_start + k)
                tileblk = off_tiles.setdefault(
                    key, np.zeros((B, B), dtype=store_dtype))
                tileblk[:r1 - r0, :c1 - c0] = vals[r0:r1, c0:c1]

    scale = INT8_SCALE if quantize else 1.0
    ld = make_block_ld(diag, off_tiles, layout.mask(), scale)
    return ld, layout


def pack_banded(chrom_banded: dict,
                block_size: int = 1024,
                dtype=np.float32,
                quantize: bool = False):
    """Pack per-chromosome *banded* LD (the reference's on-disk layout:
    ``{data, indptr, left_bound}`` with symmetric rows, VIPRS.py:167-172) into
    diagonal tiles + compact coupling tiles (exact for any bandwidth).

    :param chrom_banded: {chrom: (data, indptr, left_bound)} where row j of R holds
        ``data[indptr[j]:indptr[j+1]]`` starting at column ``left_bound[j]``.
        ``data`` may be int8 (values scaled by 127) or float.
    """
    B = block_size
    chroms = sorted(chrom_banded.keys())

    chrom_sizes, chrom_block_range, flat_idx_parts = [], [], []
    tile_cursor = 0
    max_bw = 0
    for c in chroms:
        data, indptr, left = chrom_banded[c]
        m_c = len(indptr) - 1
        widths_r = (np.asarray(indptr[1:]) - np.asarray(indptr[:-1]))
        # bandwidth to the right of the diagonal and to the left:
        j = np.arange(m_c)
        right = (np.asarray(left) + widths_r - 1) - j
        left_bw = j - np.asarray(left)
        if m_c:
            max_bw = max(max_bw, int(right.max(initial=0)), int(left_bw.max(initial=0)))
        ntiles = _round_up(max(m_c, 1), B) // B
        base = tile_cursor * B
        flat_idx_parts.append(np.arange(base, base + m_c, dtype=np.int64))
        chrom_sizes.append(m_c)
        chrom_block_range.append((tile_cursor, tile_cursor + ntiles))
        tile_cursor += ntiles

    nb = tile_cursor
    layout = BlockLayout(chromosomes=chroms, chrom_sizes=chrom_sizes,
                         chrom_block_range=chrom_block_range,
                         flat_index=np.concatenate(flat_idx_parts) if flat_idx_parts
                         else np.zeros(0, np.int64),
                         block_size=B, nb=nb)

    store_dtype = np.int8 if quantize else dtype
    diag = np.zeros((nb, B, B), dtype=store_dtype)
    off_tiles = {}

    for (c, (t0, t1)) in zip(chroms, chrom_block_range):
        data, indptr, left = chrom_banded[c]
        data = np.asarray(data)
        input_is_int8 = data.dtype == np.int8
        m_c = len(indptr) - 1
        for j in range(m_c):
            row = data[indptr[j]:indptr[j + 1]]
            if input_is_int8 and not quantize:
                row = row.astype(dtype) * INT8_SCALE
            elif not input_is_int8 and quantize:
                row = quantize_int8(row.astype(np.float64))
            cols = np.arange(left[j], left[j] + len(row))
            # keep only upper triangle incl. diagonal; symmetry fills the rest
            sel = cols >= j
            cols, row = cols[sel], row[sel]
            gj = t0 * B + j
            gcols = t0 * B + cols
            bj, oj = divmod(gj, B)
            bc = gcols // B
            oc = gcols - bc * B
            same = bc == bj
            diag[bj, oj, oc[same]] = row[same]
            diag[bj, oc[same], oj] = row[same]  # symmetric within tile
            for b2 in np.unique(bc[~same]):
                selk = bc == b2
                tileblk = off_tiles.setdefault(
                    (int(bj), int(b2)), np.zeros((B, B), dtype=store_dtype))
                tileblk[oj, oc[selk]] = row[selk]

    scale = INT8_SCALE if quantize else 1.0
    ld = make_block_ld(diag, off_tiles, layout.mask(), scale)
    return ld, layout


def blockld_to_dense(ld: BlockLD) -> np.ndarray:
    """Reconstruct the full dense (padded) LD matrix — for tests only."""
    nb, B = ld.nb, ld.block_size
    M = nb * B
    R = np.zeros((M, M), dtype=np.float64)
    diag = np.asarray(ld.diag, dtype=np.float64) * ld.scale
    off = np.asarray(ld.off_data, dtype=np.float64) * ld.scale
    src_i = np.asarray(ld.off_src)
    dst_i = np.asarray(ld.off_dst)
    for b in range(nb):
        R[b * B:(b + 1) * B, b * B:(b + 1) * B] = diag[b]
    for o in range(ld.n_off):
        b, b2 = int(src_i[o]), int(dst_i[o])
        R[b * B:(b + 1) * B, b2 * B:(b2 + 1) * B] = off[o]
        R[b2 * B:(b2 + 1) * B, b * B:(b + 1) * B] = off[o].T
    return R
