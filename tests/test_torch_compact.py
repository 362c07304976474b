"""The port's compact layout and u16 tables (``device="cpu"``: the
kernels' plain versions) against the JAX functions and the JAX engine,
mirroring ``tests/test_engine.py`` and ``tests/test_lookup.py``.

Tolerances: k-mer indices, compact rows and u16 sums bitwise (the sums
of quantised deltas are exact in f32); engines as
``tests/test_engine.py:41-60`` (``|L|`` and edge sets identical, scores
within 2e-4, LWR within 1e-4); u16 against f32 within 5e-3 as
``tests/test_engine.py:109-123``.  The CLI cases are held against the
JAX CLI as ``tests/test_torch_e2e.py`` holds the others."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rappas_tpu.alphabet import AA, DNA
from rappas_tpu.db import PhyloKmerDB, build_csr
from rappas_tpu.place import engine as J
from rappas_tpu.place.engine import PlacementEngine as JaxEngine
from rappas_tpu.tree import parse_newick
from rappas_tpu_torch import utils
from rappas_tpu_torch.convert import device_tables
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import HostKeyIndex, PlacementEngine
from test_engine import batch_of, compare, random_reads, synthetic_db
from test_torch_e2e import db_path, e2e_case  # noqa: F401 (fixture)
from test_torch_engine import port_db, same_as_jax
from test_torch_kernels import _codes


@pytest.fixture(scope="module")
def db():
    return synthetic_db()


@pytest.fixture(scope="module")
def tdb(db):
    return port_db(db)


def _u16_table(rng, n_rows, E, fill=0.3):
    D = np.where(rng.random((n_rows, E)) < fill,
                 rng.integers(1, 65536, (n_rows, E)), 0).astype(np.uint16)
    D[-1] = 0
    return D


# ---- plain versions against the JAX functions ------------------------ #

@pytest.mark.parametrize("k, n_states, L", [(5, 4, 40), (8, 4, 150),
                                            (3, 20, 25), (7, 20, 30)])
def test_kmer_indices64_matches_jax(k, n_states, L):
    rng = np.random.default_rng(k * n_states)
    codes, _ = _codes(rng, 29, L, k, n_states, amb=0.02)
    want = np.asarray(J.kmer_indices64(jnp.asarray(codes), k, n_states))
    got = T.kmer_indices64(torch.from_numpy(codes), k, n_states)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want == -1).any() and (want >= 0).any()


def test_kmer_indices64_wide_space_raises():
    """20^8 > 2^31 - 1: the host computes such indices (the JAX function
    takes int64 only under x64, which its engine never uses)."""
    codes, _ = _codes(np.random.default_rng(3), 17, 30, 8, 20, amb=0.02)
    with pytest.raises(ValueError, match="do not fit int32"):
        T.kmer_indices64(torch.from_numpy(codes), 8, 20)


@pytest.mark.parametrize("n_keys", [0, 1, 300])
def test_compact_rows_matches_jax(n_keys):
    rng = np.random.default_rng(n_keys)
    keys = np.sort(rng.choice(4 ** 6, n_keys, replace=False)).astype(np.int32)
    idx = rng.integers(-1, 4 ** 6, (13, 40)).astype(np.int32)
    if n_keys:
        idx[:, ::3] = rng.choice(keys, (13, 14))     # hits
    idx[:, 1::7] = -1                                # invalid windows
    want = np.asarray(J.compact_rows(jnp.asarray(keys), jnp.asarray(idx)))
    got = T.compact_rows(torch.from_numpy(keys), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if n_keys == 0:
        assert not got.any()


@pytest.mark.parametrize("E", [6, 300])
def test_accumulate_u16_matches_jax_bitwise(E):
    rng = np.random.default_rng(E + 1)
    k = 5
    D = _u16_table(rng, 4 ** k + 1, E)
    codes, _ = _codes(rng, 24, 150, k, amb=0.01)
    rows = T.kmer_rows(torch.from_numpy(codes), k, 4, D.shape[0])
    want = np.asarray(J.accumulate(jnp.asarray(D),
                                   jnp.asarray(rows.numpy())))
    got = T.accumulate(torch.from_numpy(D), rows)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_alt_delta_rows_u16_matches_jax_bitwise():
    rng = np.random.default_rng(5)
    D = _u16_table(rng, 200, 40)
    scale = np.float32(2.5 / 65535)
    alt = rng.integers(0, 200, 77).astype(np.int32)
    want = np.asarray(J.alt_delta_rows(jnp.asarray(D), jnp.float32(scale),
                                       jnp.asarray(alt)))
    got = T.alt_delta_rows(torch.from_numpy(D), float(scale),
                           torch.from_numpy(alt))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


# ---- wrappers on the CPU: the plain compositions ---------------------- #

@pytest.mark.parametrize("u16", [False, True])
def test_compact_wrappers_compose_plain_versions(u16):
    rng = np.random.default_rng(6)
    k, E, n = 5, 12, 300
    keys = np.sort(rng.choice(4 ** k, n, replace=False)).astype(np.int32)
    D = torch.from_numpy(_u16_table(rng, n + 1, E) if u16 else
                         rng.random((n + 1, E)).astype(np.float32))
    D[-1] = 0
    codes, _ = _codes(rng, 9, 40, k, amb=0.05)
    c = torch.from_numpy(codes)
    rows = T.compact_rows(torch.from_numpy(keys), T.kmer_indices64(c, k, 4))
    want = T.accumulate(D, rows) * 0.25
    got = T.accumulate_compact(D, torch.from_numpy(keys), c, k, 4, 0.25)
    assert torch.equal(got, want)
    assert torch.equal(T.accumulate_rows(D, rows, 0.25), want)
    assert not any(n.startswith("kernel.launch.")
                   for n in utils.trace_totals()["counters"])


def test_device_tables_compact_and_u16(db, tdb):
    for table, prec in (("direct", "u16"), ("compact", "f32"),
                        ("compact", "u16")):
        tabs = device_tables(tdb, "cpu", table, prec)
        if prec == "u16":
            want, scale = getattr(db, f"{table.replace('direct', 'dense')}"
                                  "_matrix_u16")(pad_rows=1)
            assert tabs.D.dtype == torch.uint16
            assert float(tabs.scale) == float(scale)
        else:
            want = db.compact_matrix(pad_rows=1)
            assert float(tabs.scale) == 1.0
        got = tabs.D.numpy()
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        if table == "compact":
            assert tabs.keys.dtype == torch.int32
            assert np.array_equal(tabs.keys.numpy(), db.keys)
        else:
            assert tabs.keys is None


# ---- engines against the JAX engine ----------------------------------- #

MODES = [{}, {"ambiguities_with_max": True}, {"treat_ambiguities": False}]
LAYOUTS = [{"table": "compact"}, {"table": "direct", "precision": "u16"},
           {"table": "compact", "precision": "u16"}]


@pytest.mark.parametrize("mode", MODES, ids=["mean", "max", "noamb"])
@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["compact", "direct_u16", "compact_u16"])
def test_engine_matches_jax(db, tdb, layout, mode):
    """DNA k=5: the compact table searches its keys on the device."""
    rng = np.random.default_rng(7)
    mat, lens = batch_of(random_reads(64, rng, with_amb=0.5))
    engine = PlacementEngine(tdb, device="cpu", **layout, **mode)
    assert engine.table == layout.get("table", "direct")
    assert (engine.keys_dev is not None) == (engine.table == "compact")
    assert engine.D.dtype == (torch.uint16 if "precision" in layout
                              else torch.float32)
    same_as_jax(engine.score(mat, lens),
                JaxEngine(db, **layout, **mode).score(mat, lens))


def test_compact_matches_oracle(db, tdb):
    engine = PlacementEngine(tdb, device="cpu", table="compact")
    compare(db, engine, random_reads(30, np.random.default_rng(11),
                                     with_amb=0.5))


def _wide_db(alphabet, k, n_keys, seed=0, n_edges=6):
    """``n_keys`` random keys in an index space above 31 bits, 4 postings
    each."""
    rng = np.random.default_rng(seed)
    labels = ",".join(f"L{i}:0.1" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, alphabet.n_states)
    keys = np.unique(rng.integers(0, alphabet.n_states ** k,
                                  int(n_keys * 1.1), np.int64))[:n_keys]
    codes = np.repeat(keys, 4)
    edges = rng.integers(1, n_edges, codes.size).astype(np.int32)
    scores = (thr + 0.01 + rng.random(codes.size) * 2.0).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    return PhyloKmerDB(k=k, omega=1.5, alphabet=alphabet, thr_log10=thr,
                       tree=tree, keys=keys, offsets=offsets, edges=e,
                       deltas=deltas)


def _reads_with_keys(db, rng, n, amb_char):
    """Reads stitched from three DB k-mers with two random letters after
    each; every third read carries one ambiguity character, every sixth
    a second one a few positions on (a window may then hold two)."""
    letters = list(db.alphabet.letters)
    reads = []
    for i in range(n):
        parts = [db.alphabet.kmer_to_string(int(key), db.k)
                 for key in rng.choice(db.keys, 3)]
        s = "".join(p + "".join(rng.choice(letters, 2)) for p in parts)
        for j, step in ((3, 0), (6, 5)):
            if i % j == 0:
                pos = int(rng.integers(0, len(s) - 6)) + step
                s = s[:pos] + amb_char + s[pos + 1:]
        reads.append(s)
    return reads


@pytest.mark.parametrize("precision", ["f32", "u16"])
@pytest.mark.parametrize("alphabet, k, n_keys, amb", [
    (AA, 8, 70_000, "X"), (DNA, 16, 3_000, "N")], ids=["amino8", "dna16"])
def test_host_lookup_matches_jax(alphabet, k, n_keys, amb, precision):
    """Index spaces above 31 bits (20^8, 4^16): the host searches the keys
    and C2's plain version sums; 70,000 keys take the bucketed
    ``HostKeyIndex``; DNA k=16 windows may hold two ambiguities."""
    jdb = _wide_db(alphabet, k, n_keys)
    engine = PlacementEngine(port_db(jdb), device="cpu", table="compact",
                             precision=precision)
    assert engine.keys_dev is None
    assert isinstance(engine._db_lookup, HostKeyIndex) == (n_keys >= 65536)
    reads = _reads_with_keys(jdb, np.random.default_rng(k), 24, amb)
    mat, lens = batch_of(reads)
    res = engine.score(mat, lens)
    assert (res.n_matched > 0).all()
    for mode in MODES:
        same_as_jax(PlacementEngine(port_db(jdb), device="cpu",
                                    table="compact", precision=precision,
                                    **mode).score(mat, lens),
                    JaxEngine(jdb, table="compact", precision=precision,
                              **mode).score(mat, lens))


@pytest.mark.parametrize("table", ["direct", "compact"])
def test_u16_close_to_f32(tdb, table):
    rng = np.random.default_rng(9)
    mat, lens = batch_of(random_reads(30, rng, with_amb=0.3))
    r32 = PlacementEngine(tdb, device="cpu", table=table).score(mat, lens)
    r16 = PlacementEngine(tdb, device="cpu", table=table,
                          precision="u16").score(mat, lens)
    assert np.array_equal(r32.n_matched, r16.n_matched)
    for i in range(mat.shape[0]):
        v32, v16 = r32.top_edges[i] >= 0, r16.top_edges[i] >= 0
        assert v32.sum() == v16.sum()
        assert np.allclose(sorted(r32.top_scores[i][v32]),
                           sorted(r16.top_scores[i][v16]), atol=5e-3)


def test_resolve_table_u16_never_postings():
    """A sparse k=12 DB (``tests/test_lookup.py:109-115``): the JAX engine
    resolves f32 to postings and u16 to compact; the port's H100 rule
    takes the compact table (120 MB, its keys searched on the card) in
    both precisions, and neither package gives u16 postings."""
    jdb = _wide_db(DNA, 12, 100_000, n_edges=300)
    tdb12 = port_db(jdb)
    for prec, want in (("f32", "postings"), ("u16", "compact")):
        assert PlacementEngine.resolve_table(
            tdb12, "auto", prec,
            PlacementEngine.table_budget("cpu")) == "compact"
        assert JaxEngine.resolve_table(
            jdb, "auto", prec, JaxEngine.DIRECT_BYTE_LIMIT) == want


def test_postings_with_u16_raises(db, tdb):
    with pytest.raises(ValueError, match="f32-only"):
        PlacementEngine(tdb, device="cpu", table="postings", precision="u16")
    with pytest.raises(ValueError, match="f32-only"):
        JaxEngine(db, table="postings", precision="u16")


# ---- the CLI against the JAX CLI --------------------------------------- #

@pytest.mark.parametrize("reads, flags", [
    ("variant", ["--precision", "u16"]),
    ("variant", ["--table", "compact"]),
    ("variant", ["--table", "compact", "--precision", "u16",
                 "--ambwithmax"])])
def test_port_cli_matches_jax_cli(tmp_path, fixtures_dir, db_path,  # noqa
                                  reads, flags):
    e2e_case(tmp_path, fixtures_dir, db_path, reads, flags)
