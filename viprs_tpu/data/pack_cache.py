"""On-disk cache of packed BlockLD operators.

Packing an LD panel (Zarr decompression, banded->block conversion,
harmonization slicing, int8 tile fill) costs tens of seconds at genome scale —
an order of magnitude more than the fit it feeds. The packed result
is a pure function of (LD store bytes, kept-variant subset, block_size,
quantize), so repeated ``viprs_fit`` invocations on the same panel can skip
the entire ingestion path and mmap the packed tiles straight from disk.

Layout: ``<root>/<key>/`` with ``diag.npy`` / ``off_data.npy`` /
``off_src.npy`` / ``off_dst.npy`` / ``mask.npy`` / ``layout.json`` (+
``flat_index.npy``). Root defaults to ``.cache/pack`` in the checkout and is
overridable via ``VIPRS_TPU_PACK_CACHE`` (set to ``0``/``off`` to disable).

The key hashes file signatures (path, size, mtime) rather than content — the
standard make-style trade: a touched-but-identical store re-packs (correct,
just slower); an edited-in-place store with a preserved mtime would stale-hit
(as would make).
"""

import hashlib
import json
import logging
import os
import os.path as osp

import numpy as np

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1


def cache_root():
    """Cache directory, or None when caching is disabled."""
    env = os.environ.get('VIPRS_TPU_PACK_CACHE')
    if env is not None:
        if env.strip().lower() in ('0', 'off', 'false', 'none', ''):
            return None
        return env
    from .. import CACHE_ROOT
    return osp.join(CACHE_ROOT, 'pack')


def file_signature(path):
    """(relname, size, mtime_ns) triples for a file or directory tree."""
    sigs = []
    if osp.isdir(path):
        for dirpath, _, files in sorted(os.walk(path)):
            for f in sorted(files):
                fp = osp.join(dirpath, f)
                st = os.stat(fp)
                sigs.append((osp.relpath(fp, path), st.st_size,
                             st.st_mtime_ns))
    else:
        st = os.stat(path)
        sigs.append((osp.basename(path), st.st_size, st.st_mtime_ns))
    return sigs


def compute_key(store_paths, kept_snps, block_size, quantize):
    """Cache key for a packed BlockLD.

    :param store_paths: LD store files/directories feeding the pack.
    :param kept_snps: {chrom: array of SNP ids} — the harmonized/filtered
        variant subset IN STORE ORDER (the packed tiles depend on exactly
        this subset and order).
    """
    h = hashlib.sha256()
    h.update(f'v{_FORMAT_VERSION};B={block_size};q={bool(quantize)}'.encode())
    for p in sorted(str(s) for s in store_paths):
        h.update(p.encode())
        for sig in file_signature(p):
            h.update(repr(sig).encode())
    for c in sorted(kept_snps, key=str):
        h.update(f'chr={c};'.encode())
        arr = np.asarray(kept_snps[c]).astype(str)
        h.update(str(len(arr)).encode())
        h.update('\x00'.join(arr.tolist()).encode())
    return h.hexdigest()


def save_packed(key, ld, layout, root=None):
    """Persist a packed (BlockLD, BlockLayout) under the cache key."""
    root = root if root is not None else cache_root()
    if root is None:
        return None
    d = osp.join(root, key)
    tmp = d + '.tmp'
    os.makedirs(tmp, exist_ok=True)
    try:
        np.save(osp.join(tmp, 'diag.npy'), np.asarray(ld.diag))
        np.save(osp.join(tmp, 'off_data.npy'), np.asarray(ld.off_data))
        np.save(osp.join(tmp, 'off_src.npy'), np.asarray(ld.off_src))
        np.save(osp.join(tmp, 'off_dst.npy'), np.asarray(ld.off_dst))
        np.save(osp.join(tmp, 'mask.npy'), np.asarray(ld.mask))
        np.save(osp.join(tmp, 'flat_index.npy'), layout.flat_index)
        meta = {
            'scale': float(ld.scale),
            'chromosomes': [[('i' if isinstance(c, (int, np.integer))
                              else 's'), str(c)]
                            for c in layout.chromosomes],
            'chrom_sizes': [int(s) for s in layout.chrom_sizes],
            'chrom_block_range': [[int(a), int(b)]
                                  for a, b in layout.chrom_block_range],
            'block_size': int(layout.block_size),
            'nb': int(layout.nb),
        }
        with open(osp.join(tmp, 'layout.json'), 'w') as f:
            json.dump(meta, f)
        os.replace(tmp, d)  # atomic publish
        return d
    except OSError as e:  # disk full etc. — cache is an optimization only
        logger.warning("pack cache write failed: %s", e)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        return None


def load_packed(key, root=None):
    """Load a packed (BlockLD, BlockLayout) by key; None on miss."""
    from ..ops.block_ld import BlockLD, BlockLayout
    import jax.numpy as jnp

    root = root if root is not None else cache_root()
    if root is None:
        return None
    d = osp.join(root, key)
    if not osp.exists(osp.join(d, 'layout.json')):
        return None
    try:
        with open(osp.join(d, 'layout.json')) as f:
            meta = json.load(f)
        ld = BlockLD(
            diag=jnp.asarray(np.load(osp.join(d, 'diag.npy'), mmap_mode='r')),
            off_data=jnp.asarray(np.load(osp.join(d, 'off_data.npy'),
                                         mmap_mode='r')),
            off_src=jnp.asarray(np.load(osp.join(d, 'off_src.npy'))),
            off_dst=jnp.asarray(np.load(osp.join(d, 'off_dst.npy'))),
            mask=jnp.asarray(np.load(osp.join(d, 'mask.npy'))),
            scale=meta['scale'])
        layout = BlockLayout(
            chromosomes=[int(v) if k == 'i' else v
                         for k, v in meta['chromosomes']],
            chrom_sizes=meta['chrom_sizes'],
            chrom_block_range=[tuple(t) for t in meta['chrom_block_range']],
            flat_index=np.load(osp.join(d, 'flat_index.npy')),
            block_size=meta['block_size'],
            nb=meta['nb'])
        return ld, layout
    except (OSError, KeyError, ValueError) as e:
        logger.warning("pack cache read failed for %s: %s", d, e)
        return None
