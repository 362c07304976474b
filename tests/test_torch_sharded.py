"""The port's sharded engines (``rappas_tpu_torch.parallel``, on a mesh
that repeats the CPU: the kernels' plain versions) against the JAX
package's on its virtual 8-device CPU mesh (``tests/conftest.py``), the
port's single engine and the serial oracle; the CLI's ``--dp/--mp`` and
multi-host runs against the JAX CLI and the port's single run.

Tolerances as ``tests/test_engine.py:41-60``: ``|L|`` and edge sets
identical, scores within 2e-4, LWR within 1e-4.  Against JAX's sharded
engines on the same mesh shape the edge ORDER is identical too (the
merge of edge-range shards puts the lower shard first on an exact tie,
which the single engine need not do)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from rappas_tpu.parallel.engine import ShardedEngine as JaxShardedEngine
from rappas_tpu.parallel.kmer_sharded import \
    KmerShardedPlacement as JaxKmerSharded
from rappas_tpu.parallel.mesh import ShardedPlacement as JaxSharded
from rappas_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rappas_tpu.parallel.postings_sharded import \
    PostingsShardedPlacement as JaxPostingsSharded
from rappas_tpu.place.engine import PlacementEngine as JaxEngine
from rappas_tpu_torch.parallel.engine import ShardedEngine
from rappas_tpu_torch.parallel.kmer_sharded import KmerShardedPlacement
from rappas_tpu_torch.parallel.mesh import ShardedPlacement, make_mesh
from rappas_tpu_torch.parallel.postings_sharded import \
    PostingsShardedPlacement
from rappas_tpu_torch.place.engine import PlacementEngine
from test_engine import batch_of, compare, random_reads, synthetic_db
from test_torch_engine import port_db, same_as_jax
from test_torch_postings import random_reads as plain_reads
from test_torch_postings import skewed_db

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def db():
    return synthetic_db(seed=5, k=5, n_edges=10, n_kmers=700)


@pytest.fixture(scope="module")
def tdb(db):
    return port_db(db)


@pytest.fixture(scope="module")
def pdb():
    return skewed_db(n_edges=40, n_kmers=300)


@pytest.fixture(scope="module")
def tpdb(pdb):
    return port_db(pdb)


def meshes(dp, mp):
    """(the port's mesh repeating the CPU, JAX's mesh of virtual CPUs)."""
    return (make_mesh(["cpu"] * (dp * mp), dp=dp, mp=mp),
            jax_make_mesh(jax.devices()[:dp * mp], dp=dp, mp=mp))


def same_order(res_t, res_j):
    """``|L|``, edges in order, scores within 2e-4, LWR within 1e-4."""
    assert np.array_equal(res_t.n_matched, res_j.n_matched)
    assert res_t.top_edges.shape == res_j.top_edges.shape
    assert np.array_equal(res_t.top_edges, res_j.top_edges)
    v = res_t.top_edges >= 0
    np.testing.assert_allclose(res_t.top_scores[v], res_j.top_scores[v],
                               atol=2e-4)
    np.testing.assert_allclose(res_t.top_lwr[v], res_j.top_lwr[v],
                               atol=1e-4)


def encode(tdb, reads):
    mat, lens = batch_of(reads)
    return PlacementEngine(tdb, device="cpu").encode_batch(mat), lens, mat


@pytest.mark.parametrize("dp, mp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_placement_matches_jax(db, tdb, dp, mp):
    """K2 per column shard, the all-gather and K3 (``mesh.py:44-96``)."""
    m_t, m_j = meshes(dp, mp)
    reads = random_reads(2 * dp * 4, np.random.default_rng(40 + dp),
                         with_amb=0.3)
    codes, lens, mat = encode(tdb, reads)
    got = ShardedPlacement(tdb, m_t).score(codes, lens)
    same_order(got, JaxSharded(db, m_j).score(codes, lens))
    single = PlacementEngine(tdb, device="cpu", treat_ambiguities=False)
    same_as_jax(got, single.score(mat, lens))


@pytest.mark.parametrize("dp, mp", [(4, 2), (2, 4), (1, 8)])
def test_kmer_sharded_placement_matches_jax(db, tdb, dp, mp):
    """C3 per k-mer range, the psum and K3 (``kmer_sharded.py:84``)."""
    m_t, m_j = meshes(dp, mp)
    reads = random_reads(8 * dp, np.random.default_rng(50 + mp),
                         with_amb=0.3)
    codes, lens, mat = encode(tdb, reads)
    got = KmerShardedPlacement(tdb, m_t).score(codes, lens)
    same_order(got, JaxKmerSharded(db, m_j).score(codes, lens))
    single = PlacementEngine(tdb, device="cpu", treat_ambiguities=False)
    same_as_jax(got, single.score(mat, lens))


@pytest.mark.parametrize("dp, mp", [(2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("amb", [False, True], ids=["pure", "ambiguous"])
def test_postings_sharded_placement_matches_jax(pdb, tpdb, dp, mp, amb):
    """P1, P2 and P3 per edge-range shard, the gather and M1
    (``postings_sharded.py:217/:223``), with and without ambiguity
    windows, as ``tests/test_postings_sharded.py`` runs JAX's."""
    m_t, m_j = meshes(dp, mp)
    reads = plain_reads(8 * dp, 30, seed=21) + [
        pdb.alphabet.kmer_to_string(int(x), pdb.k) * 5
        for x in pdb.keys[:8 * dp]]
    if amb:
        reads = [r[:9] + "NRY"[i % 3] + r[10:] if i % 2 else r
                 for i, r in enumerate(reads)]
    codes, lens, mat = encode(tpdb, reads)
    eng = PlacementEngine(tpdb, device="cpu", table="postings",
                          postings_width=4)
    host_amb = eng._expand_ambiguities_host(codes, mat, lens) if amb \
        else None
    got = PostingsShardedPlacement(tpdb, m_t, postings_width=4).score(
        codes, lens, host_amb)
    j = JaxPostingsSharded(pdb, m_j, postings_width=4)
    j_amb = JaxEngine(pdb, table="postings", postings_width=4) \
        ._expand_ambiguities_host(codes, mat, lens) if amb else None
    same_order(got, j.score(codes, lens, j_amb))
    same_as_jax(got, eng.score(mat, lens))


@pytest.mark.parametrize("table", ["direct", "postings"])
@pytest.mark.parametrize("dp, mp", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("kw, amb", [
    ({}, 0.5), ({"ambiguities_with_max": True}, 0.5),
    ({"treat_ambiguities": False}, 0.5)], ids=["mean", "max", "noamb"])
def test_sharded_engine_matches_jax(db, tdb, table, dp, mp, kw, amb):
    """The drop-in engine, dense and postings, with ambiguities in the
    mean, max and ``--noamb`` modes: against JAX's ``ShardedEngine`` on
    the same mesh shape (order), the port's single engine (sets) and the
    oracle (``tests/test_sharded_engine.py``)."""
    m_t, m_j = meshes(dp, mp)
    rng = np.random.default_rng(21 + mp)
    reads = random_reads(16, rng, with_amb=amb)
    mat, lens = batch_of(reads)
    eng = ShardedEngine(tdb, m_t, table=table, **kw)
    assert eng.table == table
    got = eng.score(mat, lens)
    same_order(got, JaxShardedEngine(db, m_j, table=table, **kw)
               .score(mat, lens))
    same_as_jax(got, PlacementEngine(tdb, device="cpu", table=table, **kw)
                .score(mat, lens))
    compare(db, eng, random_reads(16, rng, with_amb=1.0), **kw)


def test_sharded_engine_compact_matches_jax(db, tdb):
    m_t, m_j = meshes(4, 2)
    reads = random_reads(16, np.random.default_rng(23), with_amb=0.3)
    mat, lens = batch_of(reads)
    eng = ShardedEngine(tdb, m_t, table="compact")
    assert eng.keys_dev is not None
    got = eng.score(mat, lens)
    same_order(got, JaxShardedEngine(db, m_j, table="compact")
               .score(mat, lens))
    same_as_jax(got, PlacementEngine(tdb, device="cpu", table="compact")
                .score(mat, lens))
    compare(db, eng, reads)


def test_sharded_engine_compact_host_search(tdb, db):
    """Above 31 bits the host searches the keys and C2 sums the column
    shards' rows (forced here by hiding the keys from the card)."""
    eng = ShardedEngine(tdb, make_mesh(["cpu"] * 4, dp=2, mp=2),
                        table="compact")
    eng.keys_dev = None
    reads = random_reads(16, np.random.default_rng(24), with_amb=0.5)
    compare(db, eng, reads)


def test_sharded_engine_short_batch_and_protein(tdb):
    """Reads shorter than k are unplaced; a protein DB on the postings
    layout is refused (no direct row table), as JAX's."""
    eng = ShardedEngine(tdb, make_mesh(["cpu"] * 4, dp=4, mp=1))
    res = eng.score(*batch_of(["ACG"] * 4))
    assert (res.n_matched == 0).all() and (res.top_edges == -1).all()
    from test_torch_postings import _protein_db
    pdb, _ = _protein_db()
    with pytest.raises(ValueError, match="direct row table"):
        ShardedEngine(port_db(pdb), make_mesh(["cpu"] * 2, dp=1, mp=2),
                      table="postings")


# ------------------------------------------------------------------ CLI #
def write_reads(path, reads):
    with open(path, "w") as f:
        for i, s in enumerate(reads):
            f.write(f">r{i} synthetic\n{s}\n")


def canon(jplace_path):
    j = json.loads(Path(jplace_path).read_text())
    return j["tree"], j["fields"], [
        (tuple(tuple(row) for row in p["p"]), tuple(map(tuple, p["nm"])))
        for p in j["placements"]]


@pytest.mark.parametrize("table", ["auto", "postings"])
def test_cli_mesh_matches_single_and_jax_cli(db, tmp_path, table):
    """``--device cpu --dp 4 --mp 2`` gives the jplace of the port's
    single-device run (edge sets) and of the JAX CLI with ``--dp 4 --mp
    2`` (edge order)."""
    from rappas_tpu import cli as jax_cli
    from rappas_tpu_torch import cli
    db_path = tmp_path / "db.rptpu"
    db.save(db_path)
    rng = np.random.default_rng(31)
    reads = random_reads(40, rng, with_amb=0.3)
    reads.append(reads[0])            # duplicate -> nm grouping
    q = tmp_path / "reads.fasta"
    write_reads(q, reads)
    base = ["-p", "p", "-d", str(db_path), "-q", str(q), "--batch-size",
            "14", "--table", table]
    mesh = ["--dp", "4", "--mp", "2"]
    assert cli.main(base + ["-w", str(tmp_path / "single"), "--device",
                            "cpu", "--dp", "1"]) == 0
    assert cli.main(base + ["-w", str(tmp_path / "mesh"), "--device",
                            "cpu", *mesh]) == 0
    assert jax_cli.main(base + ["-w", str(tmp_path / "jax"), *mesh]) == 0
    name = "placements_reads.fasta.jplace"
    t1, f1, p1 = canon(tmp_path / "single" / name)
    t2, f2, p2 = canon(tmp_path / "mesh" / name)
    t3, f3, p3 = canon(tmp_path / "jax" / name)
    assert (t1, f1) == (t2, f2) == (t3, f3)
    assert len(p1) == len(p2) == len(p3) > 0
    for (r1, n1), (r2, n2), (r3, n3) in zip(p1, p2, p3):
        assert n1 == n2 == n3
        assert sorted(r[0] for r in r1) == sorted(r[0] for r in r2)
        assert [r[0] for r in r2] == [r[0] for r in r3]
        for a, b in zip(r2, r3):
            assert abs(a[1] - b[1]) <= 2e-4 and abs(a[2] - b[2]) <= 1e-4


def test_read_shard_parts_merge_to_full_run(tdb, tmp_path):
    """Two host shards (``read_shard``) through a mesh engine give parts
    whose merged placements are the full run's."""
    from rappas_tpu_torch.parallel.distributed import merge_jplace
    from rappas_tpu_torch.place.pipeline import (PlacementConfig,
                                                 place_queries)
    reads = random_reads(30, np.random.default_rng(33))
    q = tmp_path / "reads.fasta"
    write_reads(q, reads)
    eng = ShardedEngine(tdb, make_mesh(["cpu"] * 4, dp=2, mp=2))
    full = place_queries(tdb, q, tmp_path / "full",
                         PlacementConfig(batch_size=8, device="cpu"),
                         engine=eng)
    parts = [place_queries(tdb, q, tmp_path / "hosts",
                           PlacementConfig(batch_size=8, device="cpu",
                                           read_shard=(h, 2)), engine=eng)
             for h in range(2)]
    merged = tmp_path / "merged.jplace"
    merge_jplace(parts, merged)
    jf = json.loads(full.read_text())
    jm = json.loads(merged.read_text())
    assert jf["tree"] == jm["tree"] and jf["fields"] == jm["fields"]

    def by_read(j):
        return {nm[0]: tuple(tuple(r) for r in p["p"])
                for p in j["placements"] for nm in p["nm"]}
    assert by_read(jf) == by_read(jm)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _placements_by_read(path):
    j = json.loads(Path(path).read_text())
    return {h.split(" ")[0]: [tuple(r) for r in p["p"]]
            for p in j["placements"] for h, _ in p["nm"]}, j


def test_two_hosts_with_coordinator(tdb, tmp_path):
    """Two port CLI processes join one gloo group at ``--coordinator``,
    place their round-robin read shards (each on a dp=2 x mp=2 CPU mesh),
    meet at the barrier, and rank 0 merges the parts: the placements are
    the single-host run's (``tests/test_multihost.py`` for JAX)."""
    db_path = tmp_path / "db.rptpu"
    tdb.save(db_path)
    reads = random_reads(40, np.random.default_rng(35), with_amb=0.3)
    q = tmp_path / "reads.fasta"
    write_reads(q, reads)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    wd = tmp_path / "multi"
    base = [sys.executable, "-m", "rappas_tpu_torch.cli", "-p", "p",
            "-d", str(db_path), "-q", str(q), "--device", "cpu",
            "--batch-size", "8"]
    procs = [subprocess.Popen(
        base + ["-w", str(wd), "--coordinator", f"127.0.0.1:{port}",
                "--num-hosts", "2", "--host-id", str(i), "--dp", "2",
                "--mp", "2"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"host process failed:\n{o}"
    got, jm = _placements_by_read(wd / "placements_reads.fasta.jplace")
    r = subprocess.run(base + ["-w", str(tmp_path / "single")], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    want, j1 = _placements_by_read(
        tmp_path / "single" / "placements_reads.fasta.jplace")
    assert jm["tree"] == j1["tree"] and jm["fields"] == j1["fields"]
    assert got.keys() == want.keys()
    for h in want:
        assert [r[0] for r in got[h]] == [r[0] for r in want[h]], h
        for a, b in zip(got[h], want[h]):
            assert abs(a[1] - b[1]) <= 2e-4 and abs(a[2] - b[2]) <= 1e-4
