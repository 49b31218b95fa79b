"""Small host-side numeric helpers.

Covers the chromosome-keyed dict algebra of the reference
(viprs/utils/compute_utils.py) — retained at the *API surface* for users
migrating from the reference; internally the framework operates on flat
blocked arrays, so these only appear at host-side boundaries (table I/O,
initialization, eval glue). Implemented here as one generic two-level reducer
rather than a family of near-identical functions.
"""

import numpy as np


def fits_in_memory(alloc_size_mb, max_prop=0.9):
    """Check whether `alloc_size_mb` MB fits within available host memory."""
    import psutil

    avail_mb = psutil.virtual_memory().available / 2.0 ** 20
    return alloc_size_mb <= max_prop * avail_mb


def _reduce_two_level(op, d, axis=None, transform=None):
    """Reduce each chromosome's array with ``op``, then reduce the
    per-chromosome results with the same ``op`` (the semantics every
    dict_{max,mean,sum} shares)."""
    per_chrom = [op(v if transform is None else transform(v), axis=axis)
                 for v in d.values()]
    return op(np.asarray(per_chrom), axis=axis)


def dict_concat(d, axis=0):
    """Concatenate chromosome-keyed arrays in sorted-chromosome order."""
    if len(d) == 1:
        (only,) = d.values()
        return only
    return np.concatenate([d[c] for c in sorted(d)], axis=axis)


def dict_max(d, axis=None):
    return _reduce_two_level(np.max, d, axis=axis)


def dict_mean(d, axis=None):
    """Mean of per-chromosome means (the reference's convention — not the
    pooled mean when chromosomes differ in size)."""
    return _reduce_two_level(np.mean, d, axis=axis)


def dict_sum(d, axis=None, transform=None):
    return _reduce_two_level(np.sum, d, axis=axis, transform=transform)


def dict_elementwise_transform(d, transform):
    return {c: np.vectorize(transform)(v) for c, v in d.items()}


def dict_elementwise_dot(d1, d2):
    return {c: d1[c] * d2[c] for c in d1}


def dict_dot(d1, d2):
    """Global inner product across all chromosomes."""
    return sum(float(np.dot(np.asarray(d1[c]).ravel(),
                            np.asarray(d2[c]).ravel())) for c in d1)


def dict_set(d, value):
    """In-place fill of every chromosome array with ``value``."""
    for arr in d.values():
        arr[:] = value
    return d


def dict_repeat(value, shapes):
    """Constant-filled arrays matching a {chrom: shape} spec."""
    return {c: np.full(shp, float(value)) for c, shp in shapes.items()}


def expand_column_names(c_name, shape, sep='_'):
    """Column names for a matrix-valued parameter: BETA -> [BETA_0, BETA_1, ...].

    Vector-shaped (or single-column) parameters keep the bare name.
    Parity surface: viprs/utils/compute_utils.py:114-140.
    """
    n_cols = shape[1] if len(shape) > 1 else 1
    if n_cols == 1:
        return [c_name]
    return [sep.join((c_name, str(i))) for i in range(n_cols)]


def combine_coefficient_tables(coef_tables, coef_col='BETA'):
    """Merge per-model coefficient tables into one wide table
    (BETA_0, BETA_1, ...). Parity surface: compute_utils.py:143-169."""
    n_rows = {len(t) for t in coef_tables}
    if len(n_rows) != 1:
        raise ValueError("All coefficient tables must have the same number of rows.")
    missing = [i for i, t in enumerate(coef_tables) if coef_col not in t.columns]
    if missing:
        raise ValueError(f"Tables {missing} lack the coefficient column {coef_col!r}.")

    if len(coef_tables) == 1:
        return coef_tables[0]

    out = coef_tables[0].drop(columns=[coef_col]).copy()
    for i, t in enumerate(coef_tables):
        out[f'{coef_col}_{i}'] = t[coef_col].values
    return out
