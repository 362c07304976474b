"""The DB is the parameter set: it crosses between the JAX package and the
port unchanged (``.rptpu`` files in both directions, the same bytes, and
:func:`rappas_tpu_torch.convert.db_from_arrays`)."""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from rappas_tpu import db as jdb_mod
from rappas_tpu.tree import write_newick as j_write_newick
from rappas_tpu_torch import db as tdb_mod
from rappas_tpu_torch.convert import db_from_arrays, device_tables
from rappas_tpu_torch.tree import write_newick as t_write_newick
from test_engine import synthetic_aa_db, synthetic_db


@pytest.fixture(scope="module", params=["dna", "amino"])
def jax_db(request, tmp_path_factory):
    """A JAX DB as placement sees it: after a save / load round trip (the
    tree then carries the jplace ids parsed from its newick)."""
    db = synthetic_db(seed=3) if request.param == "dna" else \
        synthetic_aa_db(seed=4)
    db.meta = {"note": "saved by rappas_tpu"}
    path = tmp_path_factory.mktemp("jax_db") / "db.rptpu"
    db.save(path)
    return jdb_mod.PhyloKmerDB.load(path)


def _port_db(j):
    return db_from_arrays(j.k, j.omega, j.alphabet.name, j.thr_log10,
                          j_write_newick(j.tree, True, True, True, False),
                          j.keys, j.offsets, j.edges, j.deltas, j.meta)


def _assert_same(j, t):
    assert (t.k, t.omega, t.alphabet.name) == (j.k, j.omega,
                                                j.alphabet.name)
    assert np.float32(t.thr_log10).view(np.uint32) == \
        np.float32(j.thr_log10).view(np.uint32)
    assert t_write_newick(t.tree, True, True, True, False) == \
        j_write_newick(j.tree, True, True, True, False)
    for name in ("keys", "offsets", "edges", "deltas"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
    assert t.meta == j.meta
    assert t.n_edge_slots == j.n_edge_slots
    assert np.array_equal(t.arrays.jplace_edge_id, j.arrays.jplace_edge_id)


def test_rptpu_from_jax_loads_in_port(tmp_path, jax_db):
    jax_db.save(tmp_path / "j.rptpu")
    _assert_same(jax_db, tdb_mod.PhyloKmerDB.load(tmp_path / "j.rptpu"))


def test_rptpu_from_port_loads_in_jax(tmp_path, jax_db):
    t = _port_db(jax_db)
    t.meta = {"note": "saved by rappas_tpu_torch"}
    t.save(tmp_path / "t.rptpu")
    back = jdb_mod.PhyloKmerDB.load(tmp_path / "t.rptpu")
    _assert_same(back, t)


@pytest.mark.parametrize("compress", [False, True])
def test_rptpu_same_bytes(tmp_path, jax_db, compress):
    """Both packages write the same members with the same bytes (the zip
    containers differ only in their timestamps)."""
    jax_db.save(tmp_path / "j.rptpu", compress=compress)
    _port_db(jax_db).save(tmp_path / "t.rptpu", compress=compress)

    def members(p):
        with zipfile.ZipFile(p) as z:
            return {i.filename: (i.compress_type, z.read(i.filename))
                    for i in z.infolist()}

    mj, mt = members(tmp_path / "j.rptpu"), members(tmp_path / "t.rptpu")
    assert mj == mt
    header = np.load(io.BytesIO(mj["header.npy"][1]))
    assert json.loads(bytes(header))["format_version"] == \
        tdb_mod.FORMAT_VERSION == jdb_mod.FORMAT_VERSION


def test_db_from_arrays_dense_matrix_bitwise(jax_db):
    t = _port_db(jax_db)
    _assert_same(jax_db, t)
    assert np.array_equal(t.dense_matrix(pad_rows=1).view(np.uint32),
                          jax_db.dense_matrix(pad_rows=1).view(np.uint32))


def test_device_tables(jax_db):
    D, scale, thr = device_tables(_port_db(jax_db), "cpu")
    dense = jax_db.dense_matrix(pad_rows=1)
    assert D.dtype == torch.float32 and D.shape == dense.shape
    assert np.array_equal(D.numpy().view(np.uint32), dense.view(np.uint32))
    assert not D[-1].any()                      # miss row
    assert float(scale) == 1.0
    assert thr.dtype == torch.float32
    assert thr.numpy().view(np.uint32) == \
        np.float32(jax_db.thr_log10).view(np.uint32)


@pytest.mark.parametrize("k, omega, states", [(8, 1.5, 4), (5, 2.0, 4),
                                              (4, 1.5, 20)])
def test_threshold_matches(k, omega, states):
    a = jdb_mod.PhyloKmerDB.threshold(k, omega, states)
    b = tdb_mod.PhyloKmerDB.threshold(k, omega, states)
    assert np.float32(a).view(np.uint32) == np.float32(b).view(np.uint32)


def test_build_csr_matches():
    rng = np.random.default_rng(7)
    thr = tdb_mod.PhyloKmerDB.threshold(6, 1.5, 4)
    codes = rng.integers(0, 4 ** 6, 5000).astype(np.int64)
    edges = rng.integers(0, 40, 5000).astype(np.int32)
    scores = (thr + rng.random(5000) * 2 - 0.2).astype(np.float32)
    for a, b in zip(jdb_mod.build_csr(codes, edges, scores, thr),
                    tdb_mod.build_csr(codes, edges, scores, thr)):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert tdb_mod.DELTA_TINY == jdb_mod.DELTA_TINY
    assert tdb_mod.LIGHT_PAD_EDGE == jdb_mod.LIGHT_PAD_EDGE
