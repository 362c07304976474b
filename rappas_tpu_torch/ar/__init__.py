"""External ancestral-reconstruction (AR) integration.

The AR programs (PhyML, RAxML-ng, PAML baseml/codeml) are independent
upstream tools invoked as subprocesses, exactly as the reference does
(``inputs/ARProcessLauncher.java``).  This package builds their inputs,
launches them, and parses their outputs into

* the **AR tree** (the extended tree as relabelled/rerooted by the AR
  program), and
* the **posterior tensor** ``P[node_id, site, state] float32`` holding
  log10 posterior state probabilities (clamped from below like the
  reference's ``sitePPThreshold``).
"""

from rappas_tpu_torch.ar.launcher import ARLauncher, detect_program
from rappas_tpu_torch.ar.results import ARResults, parse_ar_outputs

__all__ = ["ARLauncher", "ARResults", "detect_program", "parse_ar_outputs"]
