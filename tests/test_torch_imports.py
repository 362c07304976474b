"""The port (``rappas_tpu_torch``) stands alone: it imports and runs with
``jax``, ``jaxlib`` and ``rappas_tpu`` blocked, no module of it imports
them, its entry points default to CUDA and refuse to run without it, and
the options whose code is not ported yet fail loudly."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rappas_tpu_torch import cli
from rappas_tpu_torch.alphabet import DNA
from rappas_tpu_torch.db import PhyloKmerDB, build_csr
from rappas_tpu_torch.place.engine import PlacementEngine
from rappas_tpu_torch.tree import parse_newick

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "rappas_tpu")


def _tiny_db(seed=0, k=5, n_edges=6, n_post=1200):
    rng = np.random.default_rng(seed)
    labels = ",".join(f"L{i}:0.{i + 1}" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, 4)
    codes = rng.integers(0, 4 ** k, n_post).astype(np.int64)
    edges = rng.integers(1, n_edges, n_post).astype(np.int32)
    scores = (thr + rng.random(n_post) * 2.5).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    return PhyloKmerDB(k=k, omega=1.5, alphabet=DNA, thr_log10=thr,
                       tree=tree, keys=keys, offsets=offsets, edges=e,
                       deltas=deltas)


_BLOCKED_RUN = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile, pathlib
    for name in list(sys.modules):
        if name.split(".")[0] in {blocked!r}:
            del sys.modules[name]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in {blocked!r}:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import rappas_tpu_torch
    names = ["rappas_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(rappas_tpu_torch.__path__,
                                              "rappas_tpu_torch.")]
    for n in names:
        importlib.import_module(n)
    from rappas_tpu_torch import cli
    from rappas_tpu_torch.alphabet import DNA
    from rappas_tpu_torch.db import PhyloKmerDB, build_csr
    from rappas_tpu_torch.tree import parse_newick
    rng = np.random.default_rng(0)
    tree = parse_newick("(L0:0.1,L1:0.2,L2:0.3)root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(5, 1.5, 4)
    codes = rng.integers(0, 4 ** 5, 600).astype(np.int64)
    edges = rng.integers(1, 4, 600).astype(np.int32)
    scores = (thr + rng.random(600) * 2).astype(np.float32)
    db = PhyloKmerDB(5, 1.5, DNA, thr, tree,
                     *build_csr(codes, edges, scores, thr))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        db.save(tmp / "db.rptpu")
        reads = ["".join("ACGT"[c] for c in rng.integers(0, 4, 30))
                 for _ in range(20)]
        reads[3] = reads[3][:7] + "N" + reads[3][8:]
        (tmp / "q.fasta").write_text(
            "".join(f">q{{i}}\\n{{s}}\\n" for i, s in enumerate(reads)))
        rc = cli.main(["-p", "p", "-d", str(tmp / "db.rptpu"),
                       "-q", str(tmp / "q.fasta"), "-w", str(tmp),
                       "--device", "cpu"])
        assert rc == 0
        assert (tmp / "placements_q.fasta.jplace").stat().st_size > 0
    leaked = sorted(n for n in sys.modules
                    if n.split(".")[0] in {blocked!r})
    assert not leaked, leaked
    print(len(names), "modules")
""").format(blocked=BLOCKED)


def test_port_imports_and_runs_with_jax_blocked():
    """Every module imports, and a CLI placement runs, while any import
    of jax / jaxlib / rappas_tpu raises."""
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "modules" in r.stdout


def _import_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*REPO.glob("rappas_tpu_torch/**/*.py"), REPO / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    bad = [m for m in _import_roots(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path.name} imports {bad}"


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = _tiny_db()
    with pytest.raises(RuntimeError, match="CUDA"):
        PlacementEngine(db)
    assert PlacementEngine(db, device="cpu").device.type == "cpu"


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _tiny_db().save(tmp_path / "db.rptpu")
    (tmp_path / "q.fasta").write_text(">q\nACGTACGTACGTAC\n")
    assert cli.build_parser().parse_args(
        ["-p", "p"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                  "-q", str(tmp_path / "q.fasta"), "-w", str(tmp_path)])


@pytest.mark.parametrize("extra, item", [
    (["--dp", "2"], "item 7"),
    (["--mp", "2"], "item 7"),
    (["--coordinator", "localhost:1234"], "item 7"),
    (["--num-hosts", "2"], "item 7"),
    (["--profile", "trace"], "item 8"),
    (["--precision", "u16"], "item 1"),
    (["--table", "compact"], "item 4"),
    (["--table", "postings"], "item 5"),
])
def test_cli_not_ported_options_exit_nonzero(tmp_path, capsys, extra, item):
    _tiny_db().save(tmp_path / "db.rptpu")
    (tmp_path / "q.fasta").write_text(">q\nACGTACGTACGTAC\n")
    rc = cli.main(["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                   "-q", str(tmp_path / "q.fasta"), "-w", str(tmp_path),
                   "--device", "cpu", *extra])
    assert rc == 2
    err = capsys.readouterr().err
    assert "not" in err and "ported" in err and f"queue 1 {item}" in err


def test_cli_build_phase_not_ported(capsys):
    assert cli.main(["-p", "b", "-r", "a.fasta", "-t", "t.tree"]) == 2
    assert "queue 1 item 2" in capsys.readouterr().err


@pytest.mark.parametrize("dp", ["0", "1"])
def test_cli_dp_auto_and_one_mean_one_device(tmp_path, dp):
    _tiny_db().save(tmp_path / "db.rptpu")
    (tmp_path / "q.fasta").write_text(">q\nACGTACGTACGTACGGT\n")
    assert cli.main(["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                     "-q", str(tmp_path / "q.fasta"), "-w", str(tmp_path),
                     "--device", "cpu", "--dp", dp]) == 0
