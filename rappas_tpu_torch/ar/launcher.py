"""Launch external AR programs (PhyML / RAxML-ng / PAML baseml/codeml).

Command-line construction mirrors the reference
(``inputs/ARProcessLauncher.java``):

* program detected from the binary file name (``:73-98``);
* PhyML: ``--ancestral --no_memory_check -i ALIGN -u TREE -m MODEL
  [-d aa] -c CATS -b 0 -v 0.0 -o r -a ALPHA -f e [--leave_duplicates]``
  (``:429-469``);
* RAxML-ng: ``--ancestral --msa ALIGN --tree TREE --threads N --redo
  --precision 9 --seed 1 --force msa --data-type DNA|AA
  --model MODEL+G{cats}{alpha}+IU{0}+FC --blopt nr_safe --opt-model on
  --opt-branches on`` (``:475-522``);
* PAML: a generated ``.ctl`` file (``:528-630``);
* stdout/stderr captured to ``AR_sdtout.txt`` / ``AR_sdterr.txt``
  (``:668-706``, reference typo preserved for drop-in workdir parity).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

from rappas_tpu_torch.models import EvolModel

AR_PHYML = "phyml"
AR_RAXMLNG = "raxml-ng"
AR_BASEML = "baseml"
AR_CODEML = "codeml"


def detect_program(binary: str) -> str:
    """Recognise the AR program from its binary name
    (``ARProcessLauncher.java:73-98``)."""
    name = Path(binary).name.lower()
    if "phyml" in name:
        return AR_PHYML
    if "raxml-ng" in name or "raxmlng" in name:
        return AR_RAXMLNG
    if "baseml" in name:
        return AR_BASEML
    if "codeml" in name:
        return AR_CODEML
    raise ValueError(
        f"cannot recognise AR program from binary name {binary!r} "
        "(expected phyml / raxml-ng / baseml / codeml)")


class ARLauncher:
    def __init__(self, binary: str, model: EvolModel,
                 ar_parameters: str | None = None, threads: int = 1,
                 phyml_accepts_duplicates: bool = True):
        self.binary = str(binary)
        self.program = detect_program(binary)
        self.model = model
        self.ar_parameters = ar_parameters
        self.threads = threads
        self.phyml_accepts_duplicates = phyml_accepts_duplicates

    # -------------------------------------------------------------- #
    def build_command(self, ar_dir: Path, align: Path,
                      tree: Path) -> list[str]:
        m = self.model
        if self.program == AR_PHYML:
            com = [self.binary, "--ancestral", "--no_memory_check",
                   "-i", str(align), "-u", str(tree)]
            if self.ar_parameters is None:
                com += ["-m", m.name]
                if m.is_protein:
                    com += ["-d", "aa"]
                com += ["-c", str(m.categories), "-b", "0", "-v", "0.0",
                        "-o", "r", "-a", str(m.alpha), "-f", "e"]
                if self.phyml_accepts_duplicates:
                    com += ["--leave_duplicates"]
            else:
                com += self.ar_parameters.split(" ")
            return com
        if self.program == AR_RAXMLNG:
            com = [self.binary, "--ancestral", "--msa", str(align),
                   "--tree", str(tree), "--threads", str(self.threads),
                   "--redo", "--precision", "9", "--seed", "1",
                   "--force", "msa"]
            if self.ar_parameters is None:
                com += ["--data-type", "AA" if m.is_protein else "DNA",
                        "--model",
                        f"{m.name}+G{m.categories}{{{m.alpha}}}+IU{{0}}+FC",
                        "--blopt", "nr_safe", "--opt-model", "on",
                        "--opt-branches", "on"]
            else:
                com += self.ar_parameters.split(" ")
            return com
        # PAML runs from a ctl file in ar_dir
        return [self.binary, str(ar_dir / "ar.ctl")]

    # -------------------------------------------------------------- #
    def write_paml_ctl(self, ar_dir: Path, align: Path, tree: Path) -> Path:
        """Generate the baseml/codeml control file
        (``ARProcessLauncher.java:528-630``)."""
        m = self.model
        ctl = ar_dir / "ar.ctl"
        out = ar_dir / "paml_output"
        if self.program == AR_BASEML:
            body = (
                f"seqfile = {align}\n"
                f"treefile = {tree}\n"
                f"outfile = {out}\n"
                "noisy = 3\n"
                "verbose = 2\n"
                "runmode = 0\n"
                f"model = {m.paml_equivalent}\n"
                "Mgene = 0\n"
                "clock = 0\n"
                "fix_kappa = 0\n"
                "kappa = 5\n"
                "fix_alpha = 1\n"
                f"alpha = {m.alpha}\n"
                "Malpha = 0\n"
                f"ncatG = {m.categories}\n"
                "nparK = 0\n"
                "nhomo = 0\n"
                "getSE = 0\n"
                "RateAncestor = 1\n"
                "Small_Diff = 7e-6\n"
                "cleandata = 0\n"
                "icode = 0\n"
                "fix_blength = 2\n"
                "method = 0\n")
        else:
            dat = self._find_paml_dat(m.paml_equivalent)
            body = (
                f"seqfile = {align}\n"
                f"treefile = {tree}\n"
                f"outfile = {out}\n"
                "noisy = 3\n"
                "verbose = 2\n"
                "runmode = 0\n"
                "seqtype = 2\n"
                "model = 2\n"
                f"aaRatefile = {dat}\n"
                "fix_alpha = 1\n"
                f"alpha = {m.alpha}\n"
                f"ncatG = {m.categories}\n"
                "getSE = 0\n"
                "RateAncestor = 1\n"
                "Small_Diff = 7e-6\n"
                "cleandata = 0\n"
                "fix_blength = 2\n"
                "method = 0\n")
        ctl.write_text(body)
        return ctl

    def _find_paml_dat(self, name: str) -> Path:
        """Locate a PAML amino-acid rate-matrix file (lg.dat, wag.dat,
        ...).  The 9 matrices the model registry references are vendored
        in ``rappas_tpu_torch/ar/paml_dat/`` (public PAML data files; the
        reference ships the same set as resources,
        ``EvolModel.java:199-207``), so a standalone deploy never needs
        an external search -- ``$PAML_DATA`` and the binary's directory
        are still honoured as overrides, checked first."""
        candidates = [Path(self.binary).parent / name,
                      Path(self.binary).parent / "dat" / name]
        if os.environ.get("PAML_DATA"):
            candidates.append(Path(os.environ["PAML_DATA"]) / name)
        candidates.append(Path(__file__).parent / "paml_dat" / name)
        for c in candidates:
            if c.exists():
                return c
        raise FileNotFoundError(
            f"PAML rate matrix {name!r} not found; set $PAML_DATA to the "
            "directory holding PAML's .dat files")

    # -------------------------------------------------------------- #
    def launch(self, ar_dir, align, tree) -> None:
        """Run the AR program, capturing stdout/stderr like the reference
        (``ARProcessLauncher.java:668-706``)."""
        ar_dir = Path(ar_dir)
        ar_dir.mkdir(parents=True, exist_ok=True)
        align = Path(align)
        tree = Path(tree)
        if self.program in (AR_BASEML, AR_CODEML):
            self.write_paml_ctl(ar_dir, align, tree)
        com = self.build_command(ar_dir, align, tree)
        res = self._run(ar_dir, com)
        if res.returncode != 0 and self.program == AR_PHYML and \
                self.phyml_accepts_duplicates:
            # older PhyML builds (< 3.3.2018) predate --leave_duplicates;
            # the reference gates the flag on a version whitelist
            # (ARProcessLauncher.java:737-797) -- we just retry without it
            err_text = (ar_dir / "AR_sdterr.txt").read_text()
            if "leave_duplicates" in err_text:
                self.phyml_accepts_duplicates = False
                com = self.build_command(ar_dir, align, tree)
                res = self._run(ar_dir, com)
        if res.returncode != 0:
            raise RuntimeError(
                f"AR program failed (exit {res.returncode}); see "
                f"{ar_dir / 'AR_sdterr.txt'}")
        self._relocate_outputs(ar_dir, align)
        self.check_outputs(ar_dir, align)

    def _run(self, ar_dir: Path, com: list[str]):
        with open(ar_dir / "AR_sdtout.txt", "w") as out, \
                open(ar_dir / "AR_sdterr.txt", "w") as err:
            return subprocess.run(com, stdout=out, stderr=err,
                                  cwd=str(ar_dir))

    def _relocate_outputs(self, ar_dir: Path, align: Path) -> None:
        """PhyML writes its outputs next to the input alignment; move them
        into the AR directory (``ARProcessLauncher.java:279-399``)."""
        if self.program != AR_PHYML:
            return
        src_dir = align.parent
        for suffix in ("_phyml_ancestral_seq.txt", "_phyml_ancestral_tree.txt",
                       "_phyml_stats.txt", "_phyml_tree.txt"):
            src = src_dir / (align.name + suffix)
            dst = ar_dir / (align.name + suffix)
            if src.exists() and src.resolve() != dst.resolve():
                shutil.move(str(src), str(dst))

    # -------------------------------------------------------------- #
    def output_paths(self, ar_dir, align) -> dict[str, Path]:
        ar_dir = Path(ar_dir)
        align = Path(align)
        if self.program == AR_PHYML:
            return {
                "tree": ar_dir / f"{align.name}_phyml_ancestral_tree.txt",
                "probas": ar_dir / f"{align.name}_phyml_ancestral_seq.txt",
            }
        if self.program == AR_RAXMLNG:
            return {
                "tree": ar_dir / f"{align.name}.raxml.ancestralTree",
                "probas": ar_dir / f"{align.name}.raxml.ancestralProbs",
            }
        rst = ar_dir / "rst"
        return {"tree": rst, "probas": rst}

    def check_outputs(self, ar_dir, align) -> None:
        for kind, p in self.output_paths(ar_dir, align).items():
            if not p.exists():
                raise FileNotFoundError(
                    f"expected AR output {kind} file missing: {p}")

    # -------------------------------------------------------------- #
    def validate_existing(self, ar_dir, align, expected_leaves: set,
                          expected_sites: int) -> None:
        """Consistency-check a reused ``--ardir`` against the CURRENT
        inputs before building a DB from it.

        The reference's ``loadExistingAR`` only tests that the output
        files exist and are readable (``ARProcessLauncher.java:158-212``),
        so a stale or mismatched AR directory silently builds a wrong DB
        there.  Here we additionally verify that

        * the AR tree's leaf-label set equals the current extended
          alignment's label set (catches: different reference tree,
          different ghost count, a different run's outputs), and
        * the AR posterior output covers exactly the current extended
          alignment's site count (catches: different alignment or a
          different ``--ratio-reduction``).

        Failures are fail-fast ``SystemExit`` with the mismatch spelled
        out, matching the reference's error style (SURVEY.md section 5).
        """
        self.check_outputs(ar_dir, align)
        paths = self.output_paths(ar_dir, align)
        from rappas_tpu_torch.ar.wrappers import parse_ar_tree, parse_paml_tree
        tree_text = paths["tree"].read_text()
        if self.program in (AR_BASEML, AR_CODEML):
            # a dummy alphabet arg is not needed for leaf labels
            ar_tree = parse_paml_tree(tree_text, None)
        else:
            ar_tree = parse_ar_tree(tree_text, reroot=False)
        ar_leaves = {n.label for n in ar_tree.nodes if n.is_leaf}
        if ar_leaves != set(expected_leaves):
            extra = sorted(ar_leaves - set(expected_leaves))[:3]
            missing = sorted(set(expected_leaves) - ar_leaves)[:3]
            raise SystemExit(
                f"--ardir {ar_dir} does not match the current inputs: the "
                f"AR tree has {len(ar_leaves)} leaves vs "
                f"{len(expected_leaves)} expected from the extended "
                f"alignment (AR-only: {extra}, missing: {missing}). "
                "Re-run ancestral reconstruction for these inputs or "
                "point --ardir at the matching outputs.")
        max_site, node_rows = self._scan_ar_sites(paths["probas"])
        if max_site != expected_sites:
            raise SystemExit(
                f"--ardir {ar_dir} does not match the current inputs: AR "
                f"posteriors cover {max_site} sites but the current "
                f"extended alignment has {expected_sites} columns (did "
                "the alignment or --ratio-reduction change?). Re-run "
                "ancestral reconstruction for these inputs.")
        # per-node coverage: a truncated output (disk full / killed AR
        # run) usually cuts a node's site block mid-way while the file
        # still reaches site ``expected_sites`` for earlier nodes
        short = {n: c for n, c in node_rows.items()
                 if c != expected_sites}
        if short:
            n, c = next(iter(short.items()))
            raise SystemExit(
                f"AR posterior output {paths['probas']} is truncated or "
                f"malformed: node {n!r} has {c} posterior rows, expected "
                f"{expected_sites} ({len(short)} node(s) affected). The "
                "AR run likely died mid-write (disk full / OOM); re-run "
                "ancestral reconstruction.")

    def _scan_ar_sites(self, probas_path: Path):
        """(max 1-based site index, rows-per-node) in the AR posterior
        output."""
        max_site = 0
        node_rows: dict[str, int] = {}
        with open(probas_path) as f:
            if self.program == AR_PHYML:
                for line in f:         # rows: site \t node \t p...
                    parts = line.split("\t", 3)
                    tok = parts[0].strip()
                    if tok.isdigit():
                        max_site = max(max_site, int(tok))
                        if len(parts) > 1:
                            node = parts[1].strip()
                            node_rows[node] = node_rows.get(node, 0) + 1
            elif self.program == AR_RAXMLNG:
                for line in f:         # rows: node \t site \t state...
                    parts = line.split("\t", 3)
                    if len(parts) > 1 and parts[1].strip().isdigit():
                        max_site = max(max_site, int(parts[1]))
                        node = parts[0].strip()
                        node_rows[node] = node_rows.get(node, 0) + 1
            else:                      # PAML rst marginal sections
                node = None
                for line in f:
                    if "Prob distribution at node" in line:
                        node = line.rsplit("node", 1)[1].split(",")[0] \
                            .strip()
                        continue
                    if line.startswith("(") or line.startswith(
                            "Best amino acids reconstructed"):
                        node = None
                        continue
                    if node is None:
                        continue
                    toks = line.split()
                    if toks and toks[0].isdigit() and "(" in line:
                        max_site = max(max_site, int(toks[0]))
                        node_rows[node] = node_rows.get(node, 0) + 1
        return max_site, node_rows
