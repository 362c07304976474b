"""Multiple-sequence alignment model.

Vectorised (numpy byte-matrix) replacement for the reference's
``char[][]``-based ``alignement/Alignment.java``.
Reproduced behaviors:

* gap-column reduction: drop every column whose '-' proportion is
  ``>= ratio`` (``Alignment.java:269-314``; only '-' counts as gap);
* gap intervals: for every row, each maximal run of '-' starting at column
  j contributes its length to ``gap_intervals[j]`` (de-duplicated, kept in
  first-encounter order across rows; ``Alignment.java:111-185,229-260``);
* adding gap-only ghost rows recomputes proportions and intervals over ALL
  rows (``addAllSequences``, ``Alignment.java:386-424``);
* FASTA writer: 60-char wrapped; PHYLIP writer with the reference's
  PAML-compatible quirks (``Alignment.java:586-639``).
"""

from __future__ import annotations

import numpy as np

from rappas_tpu_torch.alphabet import Alphabet

GAP = ord("-")


class Alignment:
    """Rows of equal-length sequences stored as a uint8 byte matrix."""

    def __init__(self, alphabet: Alphabet, labels: list[str],
                 matrix: np.ndarray):
        if matrix.ndim != 2:
            raise ValueError("matrix must be 2-D")
        if len(labels) != matrix.shape[0]:
            raise ValueError("labels/rows mismatch")
        self.alphabet = alphabet
        self.labels = list(labels)
        self.matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        self._validate()

    @classmethod
    def from_records(cls, alphabet: Alphabet,
                     records: list[tuple[str, str]]) -> "Alignment":
        labels = [h for h, _ in records]
        if not records:
            raise ValueError("empty alignment")
        L = len(records[0][1])
        for h, s in records:
            if len(s) != L:
                raise ValueError(
                    f"sequence {h!r} length {len(s)} != {L} (first row)")
        m = np.zeros((len(records), L), np.uint8)
        for i, (_, s) in enumerate(records):
            m[i] = np.frombuffer(s.encode("ascii"), np.uint8)
        return cls(alphabet, labels, m)

    def _validate(self) -> None:
        """Reject non-IUPAC characters (Alignment.java:135-156)."""
        a = self.alphabet
        ok = a.char_to_code[self.matrix] != 255
        ok |= a.is_ambiguous_table[self.matrix]
        if not ok.all():
            i, j = np.argwhere(~ok)[0]
            raise ValueError(
                "alignment contains a non supported state "
                f"{chr(self.matrix[i, j])!r} (row {self.labels[i]!r}, "
                f"column {j})")

    # -------------------------------------------------------------- #
    @property
    def n_rows(self) -> int:
        return self.matrix.shape[0]

    @property
    def length(self) -> int:
        return self.matrix.shape[1]

    def gap_proportions(self) -> np.ndarray:
        """float64[L]: fraction of '-' per column (dots don't count,
        matching ``Alignment.java:160-166``)."""
        return (self.matrix == GAP).mean(axis=0)

    def gap_ratio(self) -> float:
        """sum(gap)/sum(non-gap) over columns, the activation metric for
        gap jumps (``Main_DBBUILD_3.java:246-253``)."""
        p = self.gap_proportions()
        non = (1.0 - p).sum()
        return float(p.sum() / non) if non else float("inf")

    # -------------------------------------------------------------- #
    def reduce(self, ratio: float) -> "Alignment":
        """Return a copy without columns whose gap proportion >= ratio."""
        keep = self.gap_proportions() < ratio
        return Alignment(self.alphabet, self.labels,
                         self.matrix[:, keep])

    def add_gap_rows(self, labels: list[str]) -> "Alignment":
        """Append all-gap ghost rows (for fake leaves X2/X3),
        mirroring ``addAllSequences`` (Alignment.java:386-424)."""
        extra = np.full((len(labels), self.length), GAP, np.uint8)
        return Alignment(self.alphabet, self.labels + list(labels),
                         np.concatenate([self.matrix, extra], axis=0))

    # -------------------------------------------------------------- #
    def gap_intervals(self) -> dict[int, list[int]]:
        """map(start column) -> lengths of maximal '-' runs starting there.

        Lengths are de-duplicated per start column and kept in
        first-encounter order scanning rows top to bottom, columns left to
        right -- identical to ``updateGapIntervals``
        (``Alignment.java:229-260``).  Runs touching the row end are
        included (closed at sequence end, ``Alignment.java:180-188``).
        """
        intervals: dict[int, list[int]] = {}
        is_gap = self.matrix == GAP
        L = self.length
        for i in range(self.n_rows):
            row = is_gap[i]
            if not row.any():
                continue
            d = np.diff(row.astype(np.int8))
            starts = np.flatnonzero(d == 1) + 1
            ends = np.flatnonzero(d == -1) + 1
            if row[0]:
                starts = np.concatenate([[0], starts])
            if row[-1]:
                ends = np.concatenate([ends, [L]])
            for s, e in zip(starts, ends):
                lst = intervals.setdefault(int(s), [])
                length = int(e - s)
                if length not in lst:
                    lst.append(length)
        return intervals

    # -------------------------------------------------------------- #
    def row(self, i: int) -> str:
        return self.matrix[i].tobytes().decode("ascii")

    def write_fasta(self, path, wrap: int = 60) -> None:
        with open(path, "w") as f:
            for i, label in enumerate(self.labels):
                f.write(f">{label}\n")
                s = self.row(i)
                for j in range(0, len(s), wrap):
                    f.write(s[j:j + wrap] + "\n")

    def write_phylip(self, path) -> None:
        """PHYLIP writer compatible with PhyML/PAML inputs.

        Reference format (``Alignment.java:603-639``): header
        ``"<rows> <cols>"``; each row is the label right-padded with
        spaces to 250 characters (truncated to 248 if longer), then the
        sequence on the same line with one space inserted every 250
        residues.
        """
        width = 250
        with open(path, "w") as f:
            f.write(f"{self.n_rows} {self.length}\n")
            for i, label in enumerate(self.labels):
                if len(label) > width:
                    label = label[:width - 2]
                f.write(label.ljust(width))
                s = self.row(i)
                chunks = [s[j:j + width] for j in range(0, len(s), width)]
                f.write(" ".join(chunks))
                f.write("\n")
