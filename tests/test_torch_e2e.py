"""``-p p`` end to end: the port's CLI (``--device cpu``) against the JAX
CLI on a real DB, built by the JAX package from the canned RAxML-ng
``--ardir`` fixture (as ``tests/test_ardir.py`` builds it; no PhyML).

The parsed jplace files must match: tree, fields, placement order, edges
and ``nm`` identical; likelihood within 2e-4 and LWR within 1e-4
(``tests/test_engine.py:41-60``).  The TSV reports must match column by
column, PP* within 2e-4."""

import json

import numpy as np
import pytest

from rappas_tpu.build.pipeline import BuildConfig, build_database
from rappas_tpu.cli import main as jax_main
from rappas_tpu_torch.cli import main as port_main


@pytest.fixture(scope="module")
def db_path(tmp_path_factory, fixtures_dir):
    wd = tmp_path_factory.mktemp("e2e_db")
    cfg = BuildConfig(k=8, omega=1.5, states="nucl",
                      ar_binary="/fake/path/raxml-ng",
                      ar_dir=str(fixtures_dir / "raxmlng_ardir"))
    build_database(fixtures_dir / "tiny.fasta", fixtures_dir / "tiny.tree",
                   wd, cfg)
    return wd / "DB_k8_o1.5.rptpu"


def _variant(fixtures_dir, path, seed=0):
    """tiny_reads with N's, other IUPAC codes and duplicates mixed in."""
    rng = np.random.default_rng(seed)
    recs = [r.split("\n", 1) for r in
            (fixtures_dir / "tiny_reads.fasta").read_text().split(">")[1:]]
    recs = [(h, s.replace("\n", "")) for h, s in recs]
    out = []
    for i, (h, s) in enumerate(recs):
        if i % 3 == 0:
            pos = int(rng.integers(0, len(s)))
            s = s[:pos] + str(rng.choice(list("NNNRY"))) + s[pos + 1:]
        out.append((f"{h} v{i}", s))
    for j in rng.integers(0, len(out), 8):
        h, s = out[int(j)]
        out.append((f"dup{j}_{len(out)} copy", s))
    path.write_text("".join(f">{h}\n{s}\n" for h, s in out))
    return path


def _fastq(fasta, path):
    """``fasta``'s reads as FASTQ (constant qualities)."""
    recs = [r.split("\n", 1) for r in fasta.read_text().split(">")[1:]]
    path.write_text("".join(
        f"@{h}\n{s.replace(chr(10), '')}\n+\n"
        f"{'I' * len(s.replace(chr(10), ''))}\n" for h, s in recs))
    return path


def _messy(fixtures_dir, path):
    """tiny_reads with reads at the edges: lower case, mixed case with an
    N, shorter than k, all N, and one exactly k long."""
    recs = [r.split("\n", 1) for r in
            (fixtures_dir / "tiny_reads.fasta").read_text().split(">")[1:]]
    recs = [(h, s.replace("\n", "")) for h, s in recs]
    out = []
    for i, (h, s) in enumerate(recs):
        if i % 4 == 0:
            s = s.lower()
        elif i % 4 == 1:
            s = s[:10].lower() + "N" + s[11:]
        out.append((h, s))
    out += [("short1 below k", "ACGTA"), ("short2", recs[0][1][:7]),
            ("allN", "N" * 60), ("exactly_k", recs[1][1][:8])]
    path.write_text("".join(f">{h}\n{s}\n" for h, s in out))
    return path


def _run(main, db_path, queries, wd, extra):
    """One CLI run over the query files; per file its (jplace, TSV
    report, unplaced list)."""
    assert main(["-p", "p", "-d", str(db_path), "-q",
                 ",".join(str(q) for q in queries), "-w", str(wd),
                 "--batch-size", "16", *extra]) == 0
    outs = []
    for q in queries:
        name = q.name
        jp = json.loads((wd / f"placements_{name}.jplace").read_text())
        tsv = (wd / "logs" / f"placements_{name}.tsv").read_text()
        unplaced = (wd / "logs" / f"notplaced_{name}.tsv").read_text()
        outs.append((jp, tsv, unplaced))
    return outs


@pytest.mark.parametrize("reads, flags", [
    ("tiny", []), ("variant", []), ("variant", ["--ambwithmax"]),
    ("variant", ["--noamb"]), ("tiny", ["--guppy-compat"]),
    ("tiny", ["--table", "postings"]), ("variant", ["--table", "postings"]),
    ("variant", ["--table", "postings", "--ambwithmax"]),
    # the report flags, the read formats and the read kinds at the edges
    ("variant", ["--keep-at-most", "1"]), ("variant", ["--keep-at-most", "3"]),
    ("variant", ["--keep-factor", "0.5"]), ("variant", ["--nsbound", "-3"]),
    ("fastq", []), ("messy", []), ("messy", ["--table", "postings"]),
    ("messy", ["--table", "compact"]), ("messy", ["--precision", "u16"]),
    ("pair", []), ("variant", ["--dp", "2"])])
def test_port_cli_matches_jax_cli(tmp_path, fixtures_dir, db_path, reads,
                                  flags):
    e2e_case(tmp_path, fixtures_dir, db_path, reads, flags)


def _queries(reads, fixtures_dir, tmp_path):
    """The query files of a read set: ``tiny`` (the fixture), ``variant``
    (:func:`_variant`), ``fastq`` (the fixture as FASTQ), ``messy``
    (:func:`_messy`) or ``pair`` (tiny and variant, one comma-separated
    ``-q``)."""
    tiny = fixtures_dir / "tiny_reads.fasta"
    variant = tmp_path / "variant_reads.fasta"
    return {"tiny": lambda: [tiny],
            "variant": lambda: [_variant(fixtures_dir, variant)],
            "fastq": lambda: [_fastq(tiny, tmp_path / "tiny_reads.fastq")],
            "messy": lambda: [_messy(fixtures_dir,
                                     tmp_path / "messy_reads.fasta")],
            "pair": lambda: [tiny, _variant(fixtures_dir, variant)],
            }[reads]()


def e2e_case(tmp_path, fixtures_dir, db_path, reads, flags):
    """One read set through both CLIs with ``flags``; the outputs must
    match, file by file, as the module docstring says."""
    queries = _queries(reads, fixtures_dir, tmp_path)
    # --dp 1: the test session gives JAX 8 virtual CPU devices, and auto
    # dp would take the sharded engine (a --dp in ``flags`` comes later
    # and wins)
    jax_out = _run(jax_main, db_path, queries, tmp_path / "jax",
                   ["--dp", "1", *flags])
    port_out = _run(port_main, db_path, queries, tmp_path / "port",
                    ["--device", "cpu", *flags])
    for (t, t_tsv, t_un), (j, j_tsv, j_un) in zip(port_out, jax_out):
        _same_outputs(t, t_tsv, t_un, j, j_tsv, j_un)
    if reads == "messy":            # no window: unplaced, in both
        assert port_out[0][2].split() == ["short1", "below", "k", "short2",
                                          "allN"]


def _same_outputs(t, t_tsv, t_un, j, j_tsv, j_un):
    assert t["tree"] == j["tree"]
    assert t["fields"] == j["fields"] and t["version"] == j["version"]
    assert len(t["placements"]) == len(j["placements"]) > 0
    f = j["fields"]
    e_i, l_i, w_i = (f.index(n) for n in ("edge_num", "likelihood",
                                          "like_weight_ratio"))
    for pt, pj in zip(t["placements"], j["placements"]):
        assert pt["nm"] == pj["nm"]
        assert [r[e_i] for r in pt["p"]] == [r[e_i] for r in pj["p"]]
        for rt, rj in zip(pt["p"], pj["p"]):
            assert abs(rt[l_i] - rj[l_i]) <= 2e-4
            assert abs(rt[w_i] - rj[w_i]) <= 1e-4
            assert [x for i, x in enumerate(rt) if i not in (l_i, w_i)] \
                == [x for i, x in enumerate(rj) if i not in (l_i, w_i)]
    assert t_un == j_un
    t_rows = [r.split("\t") for r in t_tsv.splitlines()]
    j_rows = [r.split("\t") for r in j_tsv.splitlines()]
    assert t_rows[0] == j_rows[0] and len(t_rows) == len(j_rows)
    for rt, rj in zip(t_rows[1:], j_rows[1:]):
        assert rt[:-1] == rj[:-1]
        assert abs(float(rt[-1]) - float(rj[-1])) <= 2e-4
