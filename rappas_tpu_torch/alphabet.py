"""Alphabet codecs (DNA / amino-acid) with IUPAC ambiguity handling.

Behavioral contract follows the reference state model
(``/root/reference/src/core/DNAStatesShifted.java``,
``/root/reference/src/core/AAStates.java``) but uses a TPU-friendly
*canonical* encoding:

* DNA: ``A=0, C=1, G=2, T=3`` so that a k-mer maps to the integer
  ``sum(code[i] * 4**(k-1-i))`` -- a direct row index into the dense
  phylo-kmer score table.  (The reference uses A=0,T=1,C=2,G=3 with
  little-endian 2-bit byte packing, ``DNAStatesShifted.java:33-34,115-143``;
  only the *text* level semantics must match, and they do: same alphabet,
  same IUPAC table, U->T folding.)
* AA: 20 states ``R=0..V=19`` in the reference's order
  (``AAStates.java:23-34``); k-mer index is base-20 big-endian.

Everything is vectorised numpy; no Python-per-character loops on hot paths.
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["Alphabet", "DNA", "AA", "get_alphabet"]


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """A residue alphabet with ambiguity expansion tables.

    Attributes
    ----------
    name: 'nucl' or 'amino'.
    letters: canonical state characters, index == state code.
    ambiguities: char -> tuple of state codes it can expand to
        (reference IUPAC table ``DNAStatesShifted.java:44-101`` /
        ``AAStates.java:95-115``).  Gap characters are included here, as in
        the reference (``'-'``/``'.'`` expand to all states).
    synonyms: char -> canonical char folding (case folding, U->T, ...).
    """

    name: str
    letters: str
    ambiguities: dict
    synonyms: dict

    # ------------------------------------------------------------------ #
    # derived lookup tables (built lazily, cached via __dict__ hack since
    # the dataclass is frozen)
    # ------------------------------------------------------------------ #
    @property
    def n_states(self) -> int:
        return len(self.letters)

    @property
    def char_to_code(self) -> np.ndarray:
        """uint8[256] mapping ASCII -> state code, 255 = unknown/ambiguous."""
        tab = self.__dict__.get("_char_to_code")
        if tab is None:
            tab = np.full(256, 255, dtype=np.uint8)
            for i, c in enumerate(self.letters):
                tab[ord(c)] = i
                tab[ord(c.lower())] = i
            for src, dst in self.synonyms.items():
                tab[ord(src)] = tab[ord(dst)]
            self.__dict__["_char_to_code"] = tab
        return tab

    @property
    def is_ambiguous_table(self) -> np.ndarray:
        """bool[256]: True for IUPAC ambiguity characters (incl. gaps)."""
        tab = self.__dict__.get("_is_ambiguous")
        if tab is None:
            tab = np.zeros(256, dtype=bool)
            for c in self.ambiguities:
                tab[ord(c)] = True
                tab[ord(c.lower())] = True
            self.__dict__["_is_ambiguous"] = tab
        return tab

    @property
    def code_to_char(self) -> np.ndarray:
        tab = self.__dict__.get("_code_to_char")
        if tab is None:
            tab = np.frombuffer(self.letters.encode(), dtype=np.uint8)
            self.__dict__["_code_to_char"] = tab
        return tab

    # ------------------------------------------------------------------ #
    # encode / decode
    # ------------------------------------------------------------------ #
    def encode(self, seq: str) -> np.ndarray:
        """Sequence -> int8 codes; ambiguity chars -> -1.

        Raises ValueError on characters that are neither states, synonyms
        nor known ambiguities (reference exits with "non supported state",
        ``AmbigSequenceKnife.java:120-128``).
        """
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        codes = self.char_to_code[raw].astype(np.int8)
        amb = self.is_ambiguous_table[raw]
        bad = (codes == -1) & ~amb  # 255 viewed as int8 is -1
        if bad.any():
            pos = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"non supported state {seq[pos]!r} at position {pos}")
        codes[amb] = -1
        return codes

    def decode(self, codes: np.ndarray) -> str:
        return self.code_to_char[np.asarray(codes)].tobytes().decode("ascii")

    def ambiguity_codes(self, c: str) -> np.ndarray:
        """Alternative state codes for an ambiguity char, reference order."""
        return np.array(self.ambiguities[c.upper() if c.upper() in
                                         self.ambiguities else c],
                        dtype=np.int8)

    # ------------------------------------------------------------------ #
    # k-mer indexing
    # ------------------------------------------------------------------ #
    def kmer_index(self, codes: np.ndarray, k: int) -> np.ndarray:
        """Big-endian base-S integer index of each k-mer row in ``codes``.

        codes: int array [..., k] of state codes (no ambiguities).
        """
        S = self.n_states
        weights = S ** np.arange(k - 1, -1, -1, dtype=np.int64)
        return np.asarray(codes, dtype=np.int64) @ weights

    def rolling_kmer_indices(self, codes: np.ndarray, k: int):
        """All overlapping k-mer indices of a 1-D code sequence.

        Returns (indices int64[L-k+1], valid bool[L-k+1]) where ``valid`` is
        False for windows containing an ambiguity (code < 0).  Matches the
        LINEAR sampling of the reference knife (``SequenceKnife.java:31-43``).
        """
        codes = np.asarray(codes)
        L = codes.shape[0]
        n = L - k + 1
        if n <= 0:
            return (np.zeros(0, np.int64), np.zeros(0, bool))
        S = self.n_states
        amb = codes < 0
        safe = np.where(amb, 0, codes).astype(np.int64)
        # rolling polynomial via cumulative trick: windowed matmul is fine
        # for moderate L; use stride tricks to avoid copies.
        win = np.lib.stride_tricks.sliding_window_view(safe, k)
        weights = S ** np.arange(k - 1, -1, -1, dtype=np.int64)
        idx = win @ weights
        amb_win = np.lib.stride_tricks.sliding_window_view(amb, k)
        valid = ~amb_win.any(axis=1)
        return idx, valid

    def kmer_to_string(self, index: int, k: int) -> str:
        S = self.n_states
        out = []
        for i in range(k):
            out.append(self.letters[(index // S ** (k - 1 - i)) % S])
        return "".join(out)


def _dna() -> Alphabet:
    # canonical codes: A=0 C=1 G=2 T=3
    A, C, G, T = 0, 1, 2, 3
    amb = {
        # purine / pyrimidine (DNAStatesShifted.java:62-65)
        "R": (A, G), "Y": (C, T),
        # strong / weak (:67-70)
        "S": (C, G), "W": (A, T),
        # keto / amino (:72-75)
        "K": (G, T), "M": (A, C),
        # not-A / not-C / not-G / not-T (:77-91)
        "B": (C, G, T), "D": (A, G, T), "H": (A, C, T), "V": (A, C, G),
        # any (:93-96) and gaps (:57-58)
        "N": (A, C, G, T), ".": (A, C, G, T), "-": (A, C, G, T),
    }
    return Alphabet(name="nucl", letters="ACGT", ambiguities=amb,
                    synonyms={"U": "T", "u": "T"})


def _aa() -> Alphabet:
    # reference order R=0..V=19 (AAStates.java:23-28)
    letters = "RHKDESTNQCGPAILMFWYV"
    codes = {c: i for i, c in enumerate(letters)}
    every = tuple(range(20))
    amb = {
        # AAStates.java:95-115
        "X": every, "-": every, "*": every, "!": every, ".": every,
        "B": (codes["D"], codes["N"]),
        "Z": (codes["E"], codes["Q"]),
        "J": (codes["I"], codes["L"]),
    }
    return Alphabet(name="amino", letters=letters, ambiguities=amb,
                    synonyms={})


DNA = _dna()
AA = _aa()
#: with --convertUO: U (selenocysteine) -> C, O (pyrrolysine) -> L
#: (AAStates.java:118-123); without the flag these characters are
#: unsupported, like the reference
AA_CONVERT_UO = dataclasses.replace(
    AA, synonyms={"U": "C", "u": "C", "O": "L", "o": "L"})


def get_alphabet(states: str, convert_uo: bool = False) -> Alphabet:
    if states in ("nucl", "dna", "DNA"):
        return DNA
    if states in ("amino", "aa", "AA", "protein"):
        return AA_CONVERT_UO if convert_uo else AA
    raise ValueError(f"unknown states {states!r}")
