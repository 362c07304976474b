"""The least time the card could take for the scoring work of the reads
the window handed to the engine, and the peaks it is counted against.

The work is counted from the reads and the raw postings, never from the
program's layout, kernels or launches, so a later change that fuses,
replaces or removes a kernel is held to the same work:

* bytes: each batch's distinct k-mers that have postings (those of its
  clean windows and of the alternatives of its windows with one N), each
  counted once with every posting it holds at 8 bytes (a 4-byte edge id
  and a float32 delta: the configuration's precision); each read's bases
  at 2 bits; the wire out, ``keep_at_most`` candidates a read, each a
  float32 score and an edge id of 2 bytes (4 past 65,535 edge slots);
* operations: one addition per posting a window hits, and three (a
  power, an addition and a share of the mean's logarithm) per posting an
  ambiguous window's alternative hits.

A dense layout reads whole table rows instead of postings and keeps
accumulators of the batch's width: that is more than the work, so its
share of this roofline reads low, as it should.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 peak
#: outside the tensor cores (the scoring adds float32 scores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def batch_work(ref, mat: np.ndarray, lens: np.ndarray) -> tuple:
    """(bytes, operations) of one batch of ASCII reads ``mat`` (0xFF
    padded; rows of length 0 are padding) against ``ref``
    (:class:`portbench.reference.Reference`, whose ``keys`` and ``off``
    hold the merged postings)."""
    lens = np.asarray(lens, np.int64)
    live = lens > 0
    mat, lens = mat[live], lens[live]
    valid, n_amb, amb_at, idx = ref.windows(mat, lens)
    clean = idx[valid & (n_amb == 0)]
    one = valid & (n_amb == 1)
    alts = (idx[one][:, None] + np.arange(4)[None, :] *
            amb_at[one][:, None]).reshape(-1)
    counts = np.diff(ref.off)

    def postings(kidx):
        found, row = ref._rows(kidx)
        return found, counts[row] * found

    found_c, per_c = postings(clean)
    found_a, per_a = postings(alts)
    rows = np.unique(np.concatenate([clean[found_c], alts[found_a]]))
    _, row_counts = postings(rows)
    edge_bytes = 2 if ref.E <= 65535 else 4
    nbytes = (8 * int(row_counts.sum()) + int(((2 * lens + 7) // 8).sum()) +
              lens.size * ref.keep_at_most * (4 + edge_bytes))
    ops = int(per_c.sum()) + 3 * int(per_a.sum())
    return nbytes, ops


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of the bytes over the HBM bandwidth and the operations
    over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
