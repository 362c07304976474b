"""The port's ``mp`` axis across processes (``tests/test_multihost_mp.py``
for JAX): two CPU processes join one gloo group and form the transposed
``(dp=2, mp=2)`` mesh of ``["cpu"] * 4`` whose ``ranks`` put each mp pair
across both processes, so the k-mer-range psum, the edge-range wire
gather and the column-tile gather cross the process boundary.  Each rank
gets every row (it holds a device of each) and writes its results
(``ShardedPlacement``, ``KmerShardedPlacement``,
``PostingsShardedPlacement`` with and without ambiguity windows, and
``ShardedEngine`` on the direct table); here they must be bitwise the
single-process port mesh's on the same batch, and within the tolerances
of ``tests/test_engine.py:41-60`` of JAX's same class on the conftest's
virtual CPU mesh, edge order included."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rappas_tpu.parallel.engine import ShardedEngine as JaxShardedEngine
from rappas_tpu.parallel.kmer_sharded import \
    KmerShardedPlacement as JaxKmerSharded
from rappas_tpu.parallel.mesh import ShardedPlacement as JaxSharded
from rappas_tpu.parallel.postings_sharded import \
    PostingsShardedPlacement as JaxPostingsSharded
from rappas_tpu.place.engine import PlacementEngine as JaxEngine
from rappas_tpu_torch.parallel.engine import ShardedEngine
from rappas_tpu_torch.parallel.kmer_sharded import KmerShardedPlacement
from rappas_tpu_torch.parallel.mesh import ShardedPlacement, make_mesh
from rappas_tpu_torch.parallel.postings_sharded import \
    PostingsShardedPlacement
from rappas_tpu_torch.place.engine import PlacementEngine
from test_engine import batch_of, random_reads, synthetic_db
from test_torch_engine import port_db
from test_torch_postings import random_reads as plain_reads
from test_torch_postings import skewed_db
from test_torch_sharded import meshes, same_order

REPO = Path(__file__).resolve().parent.parent
#: each mp pair holds one device of each rank (JAX's ``devs.reshape(2,
#: 2).T`` of two processes with two devices each)
RANKS = [[0, 1], [0, 1]]
CASES = ("placement", "kmer", "postings-pure", "postings-ambiguous",
         "engine-direct")

_WORKER = r'''
import sys
from datetime import timedelta

import numpy as np
import torch.distributed as dist

rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=timedelta(seconds=60))
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.parallel.engine import ShardedEngine
from rappas_tpu_torch.parallel.kmer_sharded import KmerShardedPlacement
from rappas_tpu_torch.parallel.mesh import ShardedPlacement, make_mesh
from rappas_tpu_torch.parallel.postings_sharded import \
    PostingsShardedPlacement
from rappas_tpu_torch.place.engine import PlacementEngine

db = PhyloKmerDB.load(f"{work}/db.rptpu")
pdb = PhyloKmerDB.load(f"{work}/pdb.rptpu")
x = np.load(f"{work}/inputs.npz")
mesh = make_mesh(["cpu"] * 4, dp=2, mp=2, ranks=%(ranks)r)
assert mesh.local_rows() == [0, 1], mesh.local_rows()
out = {}

def keep(tag, res):
    for name, arr in res._asdict().items():
        out[f"{tag}/{name}"] = arr

keep("placement", ShardedPlacement(db, mesh).score(x["codes"], x["lens"]))
keep("kmer", KmerShardedPlacement(db, mesh).score(x["codes"], x["lens"]))
psp = PostingsShardedPlacement(pdb, mesh, postings_width=4)
for tag in ("pure", "ambiguous"):
    codes, mat, lens = (x[f"{tag}_{n}"] for n in ("codes", "mat", "lens"))
    amb = (PlacementEngine(pdb, device="cpu", table="postings",
                           postings_width=4)
           ._expand_ambiguities_host(codes, mat, lens)
           if tag == "ambiguous" else None)
    keep(f"postings-{tag}", psp.score(codes, lens, amb))
eng = ShardedEngine(db, mesh, table="direct")
keep("engine-direct", eng.score(x["mat"], x["lens"]))
try:
    make_mesh(["cpu"] * 4, dp=2, mp=2, ranks=[[0, 2], [1, 0]])
    out["bad_ranks"] = np.array("no error")
except ValueError as e:
    out["bad_ranks"] = np.array(str(e))
np.savez(f"{work}/rank{rank}.npz", **out)
dist.destroy_process_group()
print(f"rank{rank} OK", flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The DBs and batches, the two ranks' results, and the
    single-process port mesh's on the same inputs."""
    work = tmp_path_factory.mktemp("mp_ranks")
    jdb = synthetic_db(seed=5, k=5, n_edges=10, n_kmers=700)
    jpdb = skewed_db(n_edges=40, n_kmers=300)
    tdb, tpdb = port_db(jdb), port_db(jpdb)
    tdb.save(work / "db.rptpu")
    tpdb.save(work / "pdb.rptpu")
    reads = random_reads(16, np.random.default_rng(61), with_amb=0.3)
    mat, lens = batch_of(reads)
    inputs = {"mat": mat, "lens": lens,
              "codes": PlacementEngine(tdb, device="cpu").encode_batch(mat)}
    preads = plain_reads(8, 30, seed=62) + [
        jpdb.alphabet.kmer_to_string(int(k), jpdb.k) * 5
        for k in jpdb.keys[:8]]
    for tag in ("pure", "ambiguous"):
        r = preads if tag == "pure" else [
            s[:9] + "NRY"[i % 3] + s[10:] if i % 2 else s
            for i, s in enumerate(preads)]
        m, ln = batch_of(r)
        inputs.update({f"{tag}_mat": m, f"{tag}_lens": ln,
                       f"{tag}_codes": PlacementEngine(
                           tpdb, device="cpu").encode_batch(m)})
    np.savez(work / "inputs.npz", **inputs)
    script = work / "worker.py"
    script.write_text(_WORKER % {"ranks": RANKS})
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(work)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o}"
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    return dict(jdb=jdb, jpdb=jpdb, tdb=tdb, tpdb=tpdb, inputs=inputs,
                ranks=ranks)


def _single_and_jax(case, run):
    """(the single-process port mesh's result, JAX's) for one case."""
    x = run["inputs"]
    m_t, m_j = meshes(2, 2)
    if case == "placement":
        return (ShardedPlacement(run["tdb"], m_t).score(x["codes"],
                                                         x["lens"]),
                JaxSharded(run["jdb"], m_j).score(x["codes"], x["lens"]))
    if case == "kmer":
        return (KmerShardedPlacement(run["tdb"], m_t).score(x["codes"],
                                                             x["lens"]),
                JaxKmerSharded(run["jdb"], m_j).score(x["codes"], x["lens"]))
    if case == "engine-direct":
        return (ShardedEngine(run["tdb"], m_t, table="direct")
                .score(x["mat"], x["lens"]),
                JaxShardedEngine(run["jdb"], m_j, table="direct")
                .score(x["mat"], x["lens"]))
    tag = case.split("-")[1]
    codes, mat, lens = (x[f"{tag}_{n}"] for n in ("codes", "mat", "lens"))
    amb = j_amb = None
    if tag == "ambiguous":
        amb = PlacementEngine(run["tpdb"], device="cpu", table="postings",
                              postings_width=4)._expand_ambiguities_host(
                                  codes, mat, lens)
        j_amb = JaxEngine(run["jpdb"], table="postings", postings_width=4) \
            ._expand_ambiguities_host(codes, mat, lens)
    return (PostingsShardedPlacement(run["tpdb"], m_t, postings_width=4)
            .score(codes, lens, amb),
            JaxPostingsSharded(run["jpdb"], m_j, postings_width=4)
            .score(codes, lens, j_amb))


@pytest.mark.parametrize("case", CASES)
def test_cross_process_mesh_matches_single_process_and_jax(case, run):
    single, jax_res = _single_and_jax(case, run)
    assert (single.n_matched > 0).sum() > len(single.n_matched) // 2
    for r, got in enumerate(run["ranks"]):
        for name, want in single._asdict().items():
            g = got[f"{case}/{name}"]
            assert g.dtype == want.dtype and g.shape == want.shape
            assert np.array_equal(g.view(np.uint8), want.view(np.uint8)), \
                f"rank {r}: {name} differs from the single-process mesh"
    same_order(single, jax_res)


def test_ranks_outside_the_group_raise(run):
    """A rank past the group's size raises at ``make_mesh`` (on each rank
    of the two-process group), as does a mesh with ranks where no group
    is joined."""
    for got in run["ranks"]:
        assert "outside the group of 2 ranks" in str(got["bad_ranks"])
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="joined torch.distributed"):
        make_mesh(["cpu"] * 4, dp=2, mp=2, ranks=RANKS)
