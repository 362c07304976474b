"""The port (``rappas_tpu_torch``) stands alone: it imports, places and
builds a DB with ``jax``, ``jaxlib`` and ``rappas_tpu`` blocked, no module
of it imports them, its entry points default to CUDA and refuse to run
without it, and the option whose code is not ported yet fails loudly."""

import ast
import json
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
    assert {{"rappas_tpu_torch.parallel." + m for m in (
        "mesh", "engine", "kmer_sharded", "postings_sharded",
        "distributed")}} <= set(names), names
    assert {{"rappas_tpu_torch." + m for m in (
        "build.pipeline", "build.explorer", "build.calibration",
        "ar.launcher", "ar.wrappers", "ar.results", "extend", "alignment",
        "models")}} <= set(names), names
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
        for table, precision in (("direct", "f32"), ("postings", "f32"),
                                 ("direct", "u16"), ("compact", "f32")):
            rc = cli.main(["-p", "p", "-d", str(tmp / "db.rptpu"),
                           "-q", str(tmp / "q.fasta"), "-w", str(tmp),
                           "--device", "cpu", "--table", table,
                           "--precision", precision])
            assert rc == 0
            assert (tmp / "placements_q.fasta.jplace").stat().st_size > 0
        # a (dp=2, mp=2) mesh that repeats the CPU
        (tmp / "placements_q.fasta.jplace").unlink()
        assert cli.main(["-p", "p", "-d", str(tmp / "db.rptpu"),
                         "-q", str(tmp / "q.fasta"), "-w", str(tmp),
                         "--device", "cpu", "--dp", "2", "--mp", "2"]) == 0
        assert (tmp / "placements_q.fasta.jplace").stat().st_size > 0
        # height-split tables (no CLI flag: the engine's constants), the
        # light table routed and the direct one split, placed by the CLI
        from rappas_tpu_torch.place.engine import PlacementEngine
        PlacementEngine.LIGHT_PART_BYTES = 4096
        PlacementEngine.DIRECT_PART_BYTES = 4096
        PlacementEngine.DIRECT_SPLIT_MIN = 0
        eng = PlacementEngine(db, device="cpu", table="postings")
        assert len(eng.light_parts) > 1 and eng._routed_windows
        eng = PlacementEngine(db, device="cpu", table="direct")
        assert len(eng.direct_parts) > 1 and eng.D is None
        for table in ("postings", "direct"):
            (tmp / "placements_q.fasta.jplace").unlink()
            assert cli.main(["-p", "p", "-d", str(tmp / "db.rptpu"),
                             "-q", str(tmp / "q.fasta"), "-w", str(tmp),
                             "--device", "cpu", "--table", table]) == 0
            assert (tmp / "placements_q.fasta.jplace").stat().st_size > 0
        # the native key probe of the postings layout's big key spaces
        from rappas_tpu_torch.native import probe_rows
        keys = np.arange(0, 4 ** 5, 3, dtype=np.int64)
        rows = probe_rows(np.zeros((2, 9), np.int8), np.full(2, 9, np.int32),
                          5, 4, keys, np.arange(keys.size, dtype=np.int32),
                          np.searchsorted(keys, np.arange(4 ** 5 + 1)
                                          ).astype(np.int32), 0, -1)
        assert rows.tolist() == [[0] * 5] * 2
        # -p b from the canned AR outputs (a copy: the build writes its
        # id mapping into the AR directory), the DB the fixture expects
        import shutil
        fx = pathlib.Path("tests/fixtures")
        shutil.copytree(fx / "raxmlng_ardir", tmp / "ar")
        assert cli.main(["-p", "b", "-r", str(fx / "tiny.fasta"),
                         "-t", str(fx / "tiny.tree"), "-b", "/fake/raxml-ng",
                         "--ardir", str(tmp / "ar"), "-w",
                         str(tmp / "build"), "--force-gap-jump"]) == 0
        built = PhyloKmerDB.load(tmp / "build" / "DB_k8_o1.5.rptpu")
        assert built.nnz > 0 and built.meta["gap_jumps"]
        assert cli.main(["-p", "b", "-r", str(fx / "tiny.fasta"),
                         "-t", str(fx / "tiny.tree"), "-b", "/fake/raxml-ng",
                         "--ardir", str(tmp / "ar"), "-w",
                         str(tmp / "build")]) == 0
        built = PhyloKmerDB.load(tmp / "build" / "DB_k8_o1.5.rptpu")
        expected = np.load(fx / "raxmlng_ardir" / "expected_db.npz")
        for key in ("keys", "offsets", "edges", "deltas"):
            assert np.array_equal(getattr(built, key).view(np.uint8),
                                  expected[key].view(np.uint8)), key
    leaked = sorted(n for n in sys.modules
                    if n.split(".")[0] in {blocked!r})
    assert not leaked, leaked
    print(len(names), "modules")
""").format(blocked=BLOCKED)


def test_port_imports_and_runs_with_jax_blocked():
    """Every module imports, CLI placements run (height-split tables
    included) and ``-p b --ardir`` builds the canned fixture's DB (with
    the native explorer too), while any import of jax / jaxlib /
    rappas_tpu raises."""
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


@pytest.mark.parametrize("extra", [
    ["--dp", "2"], ["--mp", "2"], ["--coordinator", "127.0.0.1:PORT"],
    ["--num-hosts", "2"]])
def test_cli_mesh_and_host_options_place(tmp_path, extra):
    """Multi-device and multi-host placement options place: a (dp, mp)
    mesh that repeats the CPU, a one-host gloo group at ``--coordinator``,
    and ``--num-hosts`` without a coordinator into this host's part of
    the jplace."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        extra = [x.replace("PORT", str(s.getsockname()[1])) for x in extra]
    _tiny_db().save(tmp_path / "db.rptpu")
    (tmp_path / "q.fasta").write_text(">q\nACGTACGTACGTAC\n")
    rc = cli.main(["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                   "-q", str(tmp_path / "q.fasta"), "-w", str(tmp_path),
                   "--device", "cpu", *extra])
    assert rc == 0
    out = tmp_path / ("placements_q.fasta.jplace" +
                      (".part0" if "--num-hosts" in extra else ""))
    assert json.loads(out.read_text())["placements"]


def test_cli_table_postings_runs(tmp_path):
    """``--table postings`` is ported: the CLI places with it."""
    _tiny_db().save(tmp_path / "db.rptpu")
    (tmp_path / "q.fasta").write_text(">q\nACGTACGTACNTACGGTTAC\n")
    assert cli.main(["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                     "-q", str(tmp_path / "q.fasta"), "-w", str(tmp_path),
                     "--device", "cpu", "--table", "postings"]) == 0
    assert (tmp_path / "placements_q.fasta.jplace").stat().st_size > 0


@pytest.mark.parametrize("extra", [["--precision", "u16"],
                                   ["--table", "compact"]],
                         ids=["u16", "compact"])
def test_cli_u16_and_compact_place(tmp_path, extra):
    """``--precision u16`` and ``--table compact`` are ported: the CLI
    places the read (``tests/test_torch_compact.py`` holds the jplace
    against the JAX CLI's)."""
    _tiny_db().save(tmp_path / "db.rptpu")
    (tmp_path / "q.fasta").write_text(">q\nACGTACGTACNTACGGTTAC\n")
    assert cli.main(["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                     "-q", str(tmp_path / "q.fasta"), "-w", str(tmp_path),
                     "--device", "cpu", *extra]) == 0
    jp = json.loads((tmp_path / "placements_q.fasta.jplace").read_text())
    assert len(jp["placements"]) == 1 and jp["placements"][0]["p"]


@pytest.mark.parametrize("dp", ["0", "1"])
def test_cli_dp_auto_and_one_mean_one_device(tmp_path, dp):
    _tiny_db().save(tmp_path / "db.rptpu")
    (tmp_path / "q.fasta").write_text(">q\nACGTACGTACGTACGGT\n")
    assert cli.main(["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                     "-q", str(tmp_path / "q.fasta"), "-w", str(tmp_path),
                     "--device", "cpu", "--dp", dp]) == 0
