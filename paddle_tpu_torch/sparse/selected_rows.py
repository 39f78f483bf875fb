"""SelectedRows: {rows, value, height} sparse tensor (counterpart of
paddle_tpu/sparse/selected_rows.py; numpy, as there).

reference: paddle/fluid/framework/selected_rows.h:32 — the currency of
sparse embedding gradients (lookup_table grad with is_sparse=True produces
one; optimizer ops consume it).
"""

from __future__ import annotations

import numpy as np


class SelectedRows:
    __slots__ = ("rows", "value", "height")

    def __init__(self, rows, value, height):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.value = value  # [len(rows), ...] array
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(np.asarray(self.value).shape[1:])

    def to_dense(self):
        dense = np.zeros(self.shape, dtype=np.asarray(self.value).dtype)
        np.add.at(dense, self.rows, np.asarray(self.value))
        return dense

    @staticmethod
    def merge(srs):
        """Merge duplicate rows by summation (reference
        math/selected_rows_functor MergeAdd)."""
        rows = np.concatenate([s.rows for s in srs])
        vals = np.concatenate([np.asarray(s.value) for s in srs])
        uniq, inv = np.unique(rows, return_inverse=True)
        out = np.zeros((len(uniq),) + vals.shape[1:], dtype=vals.dtype)
        np.add.at(out, inv, vals)
        return SelectedRows(uniq, out, srs[0].height)

    def __repr__(self):
        return f"SelectedRows(nnz={len(self.rows)}, height={self.height})"
