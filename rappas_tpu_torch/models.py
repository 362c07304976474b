"""Substitution-model registry for the external AR programs.

Mirrors ``models/EvolModel.java``: the models RAPPAS
supports are the intersection of PhyML's and PAML's (7 nucleotide, 9
amino-acid), with string ids directly usable on the PhyML command line and
PAML equivalents (a baseml model number for DNA, a ``.dat`` rate-matrix
file for proteins, ``EvolModel.java:189-208``).
Defaults: GTR (nucl) / LG (amino); alpha=1.0, 4 gamma categories
(``EvolModel.java:57-59,68-77``).
"""

from __future__ import annotations

import dataclasses

NUCL_MODELS = ("JC69", "K80", "F81", "F84", "HKY85", "TN93", "GTR")
AA_MODELS = ("LG", "WAG", "JTT", "Dayhoff", "DCMut", "CpREV", "MtMam",
             "MtREV", "MtArt")

_PAML_EQUIV = {
    "JC69": "0", "K80": "1", "F81": "2", "HKY85": "4", "TN93": "6",
    "GTR": "7", "F84": "3",
    "LG": "lg.dat", "WAG": "wag.dat", "JTT": "jones.dat",
    "Dayhoff": "dayhoff.dat", "DCMut": "dayhoff-dcmut.dat",
    "CpREV": "cpREV10.dat", "MtMam": "mtmam.dat", "MtREV": "mtREV24.dat",
    "MtArt": "mtArt.dat",
}
# NOTE: the reference registry names DCMut/MtArt as "dayhoff_dimut.dat" /
# "mtart.dat" (EvolModel.java:199-207), which do not match the actual
# resource filenames it ships (dayhoff-dcmut.dat / mtArt.dat) -- those two
# models would fail there.  We fix the names; the 9 matrices are vendored
# in rappas_tpu_torch/ar/paml_dat/ (public PAML data, also shipped with PAML).

_CANON = {m.upper(): m for m in NUCL_MODELS + AA_MODELS}


@dataclasses.dataclass(frozen=True)
class EvolModel:
    name: str = "GTR"
    alpha: float = 1.0
    categories: int = 4

    @property
    def is_protein(self) -> bool:
        return self.name in AA_MODELS

    @property
    def paml_equivalent(self) -> str:
        return _PAML_EQUIV[self.name]

    @staticmethod
    def default(states: str) -> "EvolModel":
        return EvolModel("LG" if states == "amino" else "GTR")

    @staticmethod
    def from_string(name: str, alpha: float = 1.0,
                    categories: int = 4) -> "EvolModel":
        canon = _CANON.get(name.upper())
        if canon is None:
            raise ValueError(
                f"unknown model {name!r}; nucl: {NUCL_MODELS}, "
                f"amino: {AA_MODELS}")
        return EvolModel(canon, alpha, categories)
