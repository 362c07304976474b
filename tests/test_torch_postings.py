"""The port's postings layout (``device="cpu"``: the kernels' plain
versions) against the serial reference-semantics oracle and the JAX
engine's postings layout, mirroring ``tests/test_postings.py``.

Tolerances as ``tests/test_engine.py:41-60``: ``|L|`` and edge sets
identical, scores within 2e-4, LWR within 1e-4.  The device tables and
the native key probe are held against the JAX engine's bitwise."""

import numpy as np
import pytest

from rappas_tpu.alphabet import DNA, get_alphabet
from rappas_tpu.db import DELTA_TINY, PhyloKmerDB, build_csr
from rappas_tpu.place import oracle
from rappas_tpu.place.engine import PlacementEngine as JaxEngine
from rappas_tpu.tree import parse_newick
from rappas_tpu_torch import native, utils
from rappas_tpu_torch.convert import postings_device_tables
from rappas_tpu_torch.db import LIGHT_PAD_EDGE, LightLayout
from rappas_tpu_torch.place import engine as port_engine
from rappas_tpu_torch.place.engine import PlacementEngine
from rappas_tpu_torch.place.kernels import light_postings
from test_engine import batch_of, compare, synthetic_db
from test_torch_engine import port_db, same_as_jax


def skewed_db(seed=0, k=5, n_edges=40, n_kmers=300, heavy_frac=0.1):
    """``tests/test_postings.py:19-45``'s DB: most k-mers get 1-4
    postings, a ``heavy_frac`` tail gets 12-30 (past the width-8 light
    cap), exercising both sides of the split."""
    rng = np.random.default_rng(seed)
    labels = ",".join(f"L{i}:0.{i % 9 + 1}" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, 4)
    kmers = rng.choice(4 ** k, size=n_kmers, replace=False)
    codes, edges = [], []
    for km in kmers:
        n = (int(rng.integers(12, 31)) if rng.random() < heavy_frac
             else int(rng.integers(1, 5)))
        es = rng.choice(np.arange(1, n_edges), size=min(n, n_edges - 1),
                        replace=False)
        codes.extend([km] * len(es))
        edges.extend(es)
    codes = np.array(codes, np.int64)
    edges = np.array(edges, np.int32)
    scores = (thr + 0.01 + rng.random(codes.shape[0]) * 2.5
              ).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    return PhyloKmerDB(k=k, omega=1.5, alphabet=DNA, thr_log10=thr,
                       tree=tree, keys=keys, offsets=offsets,
                       edges=e, deltas=deltas)


def random_reads(n, L, seed=1, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet), L)) for _ in range(n)]


@pytest.fixture(scope="module")
def db():
    return skewed_db()


@pytest.fixture(scope="module")
def tdb(db):
    return port_db(db)


def with_db_kmers(db, reads, n=4):
    """``reads`` plus reads made of DB k-mers (light and heavy hits)."""
    return reads + [db.alphabet.kmer_to_string(int(k), db.k) * 5
                    for k in db.keys[:n]]


def test_postings_device_tables_match_jax(db, tdb):
    """The tables carried to the device are bitwise the JAX engine's (a
    DB whose light table JAX does not split), its light table's rows
    packed with u16 edge ids (40 edge slots)."""
    j = JaxEngine(db, table="postings")
    assert len(j.light_parts) == 1
    ps = postings_device_tables(tdb, 8, "cpu")
    jp = np.asarray(j.light_parts[0])
    assert ps.layout == LightLayout(8, True)
    assert np.array_equal(ps.pairs.numpy(), ps.layout.pack(
        jp[:, :8], jp[:, 8:].view(np.float32)))
    e, d = light_postings(ps.pairs, ps.layout)
    assert np.array_equal(e.numpy(), jp[:, :8])
    assert np.array_equal(d.numpy().view(np.int32), jp[:, 8:])
    assert np.array_equal(ps.heavy_dense.numpy().view(np.uint32),
                          np.asarray(j.D).view(np.uint32))
    assert np.array_equal(ps.rof, j._rof_np)
    assert np.array_equal(ps.light_counts, j._light_counts)
    assert np.array_equal(ps.light_keys, j._light_keys_np)
    assert np.array_equal(ps.heavy_keys, j._heavy_keys_np)
    assert postings_device_tables(tdb, 8, "cpu", 0).rof is None


@pytest.mark.parametrize("P", [45, 8])
@pytest.mark.parametrize("E", [8000, 70000])
def test_light_rows_by_edge_count(E, P):
    """Below 65,535 edge slots a light row is ``ceil(P / 2)`` words of u16
    edge ids (pads 0xFFFF, the odd tail half-word too) and P deltas
    bit-identical to ``db.postings_tables``'; at or above, P int32 ids
    (pads ``LIGHT_PAD_EDGE``) and the deltas; ``engine.table_bytes``
    counts the rows as laid out."""
    tdb = port_db(skewed_db(seed=P, n_edges=E, n_kmers=120,
                            heavy_frac=0.2))
    assert tdb.n_edge_slots == E
    pt = tdb.postings_tables(P)
    ps = postings_device_tables(tdb, P, "cpu")
    narrow = E < 65535
    assert ps.layout == LightLayout(P, narrow)
    nl = pt.light_keys.shape[0]
    pairs = ps.pairs.numpy()
    ew = (P + 1) // 2 if narrow else P
    assert pairs.shape == (nl + 1, ew + P)
    assert np.array_equal(pairs[:, ew:], pt.light_deltas.view(np.int32))
    real = pt.light_edges != LIGHT_PAD_EDGE
    assert real.any() and (~real).any() and not real[-1].any()
    if narrow:
        ids = pairs[:, :ew].copy().view(np.uint16)
        assert ids.shape == (nl + 1, 2 * ew)
        assert np.array_equal(ids[:, :P], np.where(real, pt.light_edges,
                                                   0xFFFF))
        assert (ids[:, P:] == 0xFFFF).all() and ids.shape[1] - P == P % 2
    else:
        assert np.array_equal(pairs[:, :P], pt.light_edges)
    names = ("engine.table_bytes", "engine.edge_id_bytes")
    before = [utils.counter(n) for n in names]
    eng = PlacementEngine(tdb, table="postings", postings_width=P,
                          device="cpu")
    got = [utils.counter(n) - b for n, b in zip(names, before)]
    assert got == [(nl + 1) * (ew + P) * 4 + pt.heavy_dense.nbytes,
                   2 if narrow else 4]
    assert eng.light_layout == ps.layout


@pytest.mark.parametrize("kw", [{}, {"keep_at_most": 1},
                                {"keep_at_most": 4}])
def test_postings_matches_oracle_and_jax(db, tdb, kw):
    engine = PlacementEngine(tdb, table="postings", device="cpu", **kw)
    assert engine.table == "postings"
    reads = with_db_kmers(db, random_reads(24, 30))
    if not kw:
        compare(db, engine, reads)
    mat, lens = batch_of(reads)
    same_as_jax(engine.score(mat, lens),
                JaxEngine(db, table="postings", **kw).score(mat, lens))


@pytest.mark.parametrize("with_max, char", [(False, "N"), (True, "R")])
def test_postings_ambiguous_reads(db, tdb, with_max, char):
    """IUPAC windows (P2 into the dense slots), mean and max modes."""
    engine = PlacementEngine(tdb, table="postings", device="cpu",
                             ambiguities_with_max=with_max)
    base = db.alphabet.kmer_to_string(int(db.keys[0]), db.k) * 5
    reads = [r[:10] + char + r[11:] for r in random_reads(8, 30, seed=3)]
    reads += [base[:12] + char + base[13:], base, char * 20]
    compare(db, engine, reads, ambiguities_with_max=with_max)
    mat, lens = batch_of(reads)
    same_as_jax(engine.score(mat, lens),
                JaxEngine(db, table="postings",
                          ambiguities_with_max=with_max).score(mat, lens))


def test_postings_light_only():
    """No k-mer past the width: the heavy table is only its zero row."""
    db = synthetic_db(n_edges=5, n_kmers=60)
    engine = PlacementEngine(port_db(db), table="postings",
                             postings_width=64, device="cpu")
    assert engine.heavy_dense.shape[0] == 1
    compare(db, engine, random_reads(12, 25, seed=11))


def test_postings_heavy_only(db, tdb):
    """Width 0 pushes everything into the heavy dense table."""
    engine = PlacementEngine(tdb, table="postings", postings_width=0,
                             device="cpu")
    assert engine.pairs.shape[1] == 0
    reads = with_db_kmers(db, random_reads(12, 25, seed=13))
    compare(db, engine, reads)
    mat, lens = batch_of(reads)
    same_as_jax(engine.score(mat, lens),
                JaxEngine(db, table="postings",
                          postings_width=0).score(mat, lens))


def test_postings_without_direct_index(db, tdb, monkeypatch):
    """Past the direct-index budget the rows come from sorted-key
    searches (the protein / very-large-k route)."""
    monkeypatch.setattr(PlacementEngine, "DIRECT_INDEX_LIMIT", 0)
    monkeypatch.setattr(JaxEngine, "DIRECT_INDEX_LIMIT", 0)
    engine = PlacementEngine(tdb, table="postings", device="cpu")
    assert engine._rof_np is None
    reads = with_db_kmers(db, random_reads(12, 30, seed=19))
    reads[0] = reads[0][:9] + "N" + reads[0][10:]
    compare(db, engine, reads)
    mat, lens = batch_of(reads)
    same_as_jax(engine.score(mat, lens),
                JaxEngine(db, table="postings").score(mat, lens))


def _protein_db():
    rng = np.random.default_rng(4)
    aa = get_alphabet("amino")
    k, n_edges = 8, 12
    labels = ",".join(f"L{i}:0.2" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, 20)
    codes = rng.integers(0, 20 ** k, 500, dtype=np.int64)
    edges = rng.integers(1, n_edges, 500).astype(np.int32)
    scores = (thr + 0.01 + rng.random(500) * 2.0).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    db = PhyloKmerDB(k=k, omega=1.5, alphabet=aa, thr_log10=thr,
                     tree=tree, keys=keys, offsets=offsets, edges=e,
                     deltas=deltas)
    letters = "ARNDCQEGHILKMFPSTWYV"
    reads = ["".join(rng.choice(list(letters), 25)) for _ in range(6)]
    reads.append(db.alphabet.kmer_to_string(int(keys[0]), k) * 3)
    reads.append(reads[-1][:5] + "X" + reads[-1][6:])
    return db, reads


@pytest.mark.parametrize("native_probe", [False, True])
def test_postings_protein_mode(monkeypatch, native_probe):
    """AA postings: 20^8 index space, no direct index.  The native key
    probe serves key sets of ``_KEY_INDEX_MIN`` keys or more (lowered
    here so the small DB takes it); both routes give the oracle's
    placements."""
    db, reads = _protein_db()
    if native_probe:
        monkeypatch.setattr(port_engine, "_KEY_INDEX_MIN", 1)
    engine = PlacementEngine(port_db(db), device="cpu")
    assert engine.table == "postings" and engine._rof_np is None
    calls = utils.counter("native.probe_rows")
    compare(db, engine, reads)
    assert (utils.counter("native.probe_rows") > calls) == native_probe
    mat, lens = batch_of(reads)
    same_as_jax(engine.score(mat, lens),
                JaxEngine(db, table="postings").score(mat, lens))


def test_probe_rows_matches_jax():
    """The port's copy of the native key probe gives the JAX copy's rows,
    bitwise."""
    from rappas_tpu.native import probe_rows as jax_probe_rows
    rng = np.random.default_rng(9)
    k, S, B, L = 8, 20, 64, 40
    keys = np.unique(rng.integers(0, S ** k, 70000, dtype=np.int64))
    vals = rng.integers(0, 1 << 20, keys.size).astype(np.int32)
    hki = port_engine.HostKeyIndex(keys)
    codes = rng.integers(0, S, (B, L)).astype(np.int8)
    hits = rng.integers(0, keys.size, B)
    for b in range(0, B, 2):      # plant DB k-mers so some windows hit
        kk = int(keys[hits[b]])
        codes[b, 3:3 + k] = [(kk // S ** (k - 1 - i)) % S for i in range(k)]
    codes[rng.random((B, L)) < 0.02] = -1
    lens = rng.integers(k - 1, L + 1, B).astype(np.int32)
    args = (codes, lens, k, S, keys, vals, hki.lo, hki.shift, -7)
    got = native.probe_rows(*args)
    want = jax_probe_rows(*args)
    assert np.array_equal(got, want)
    assert (got[::2, 3] == vals[hits[::2]]).sum() > 0
    want_np = port_engine.searchsorted_rows(
        keys, port_engine.host_kmer_indices(codes, lens, k, S))
    assert np.array_equal(got, np.where(want_np < keys.size,
                                        vals[np.minimum(want_np,
                                                        keys.size - 1)],
                                        -7))


@pytest.mark.parametrize("lookup", ["direct", "keys"])
@pytest.mark.parametrize("nh", [40, 0])
def test_light_sweep_matches_numpy(lookup, nh):
    """The native sweep's rows and light pack (direct index or key probe)
    give ``postings_batch`` the arrays its numpy passes give, bitwise:
    heavy hits (or none), ambiguous codes and short reads included."""
    rng = np.random.default_rng(11)
    k, S, B, L = 6, 4, 96, 50
    space = S ** k
    order = rng.permutation(space)
    nl = space // 3
    direct = np.full(space + 1, nl, np.int32)
    direct[order[:nl]] = np.arange(nl, dtype=np.int32)
    direct[order[nl:nl + nh]] = nl + 1 + np.arange(nh, dtype=np.int32)
    light_counts = rng.integers(1, 9, nl + 1).astype(np.int32)
    light_counts[nl] = 0
    codes = rng.integers(0, S, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.03] = -1
    lens = rng.integers(k - 1, L + 1, B).astype(np.int32)
    if lookup == "direct":
        got = native.probe_light_rows(codes, lens, k, S, nl, light_counts,
                                      direct=direct)
    else:
        keys = np.flatnonzero(direct[:space] != nl).astype(np.int64)
        hki = port_engine.HostKeyIndex(keys)
        got = native.probe_light_rows(codes, lens, k, S, nl, light_counts,
                                      keys=keys, vals=direct[keys],
                                      lo=hki.lo, shift=hki.shift)
    kidx = port_engine.host_kmer_indices(codes, lens, k, S)
    rof = direct[np.where(kidx >= 0, kidx, space)]
    assert np.array_equal(got[0], rof)
    assert (rof < nl).any() and got[4] == (rof > nl).sum() and \
        bool(got[4]) == bool(nh)
    want, want_plan = port_engine.postings_batch(rof, nl, light_counts,
                                                 lens)
    host, plan = port_engine.postings_batch(rof, nl, light_counts, lens,
                                            packed=tuple(got[1:]))
    assert host.keys() == want.keys()
    for name in want:
        assert host[name].dtype == want[name].dtype, name
        assert np.array_equal(host[name], want[name]), name
    assert plan[:2] + plan[3:4] == want_plan[:2] + want_plan[3:4]


def test_host_key_index_matches_searchsorted():
    rng = np.random.default_rng(10)
    keys = np.unique(rng.integers(0, 1 << 40, 100000, dtype=np.int64))
    q = np.concatenate([keys[rng.integers(0, keys.size, 500)],
                        rng.integers(-1, 1 << 40, 500, dtype=np.int64)])
    assert np.array_equal(port_engine.HostKeyIndex(keys)(q),
                          port_engine.searchsorted_rows(keys, q))
    assert isinstance(port_engine.make_key_lookup(keys),
                      port_engine.HostKeyIndex)


def test_postings_tiny_delta_membership():
    """An edge matched only by a threshold-grade (DELTA_TINY) posting
    stays a candidate: membership is ``edge != LIGHT_PAD_EDGE``, never a
    sum > 0 (``tests/test_postings.py:192``)."""
    k, n_edges = 5, 10
    labels = ",".join(f"L{i}:0.2" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, 4)
    read = "ACGTACGTACGT"
    weights = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    code_of = {c: i for i, c in enumerate("ACGT")}
    kmers = [read[i:i + k] for i in range(len(read) - k + 1)]
    codes, edges, scores = [], [], []
    for j, km in enumerate(kmers):
        codes.append(int(np.array([code_of[c] for c in km]) @ weights))
        if j == len(kmers) - 1:
            edges.append(9)
            scores.append(float(thr))
        else:
            edges.append(1 + j % 5)
            scores.append(float(thr) + 2.5)
    keys, offsets, e, deltas = build_csr(
        np.array(codes, np.int64), np.array(edges, np.int32),
        np.array(scores, np.float32), thr)
    db = PhyloKmerDB(k=k, omega=1.5, alphabet=DNA, thr_log10=thr,
                     tree=tree, keys=keys, offsets=offsets, edges=e,
                     deltas=deltas)
    assert (deltas == DELTA_TINY).any()
    engine = PlacementEngine(port_db(db), table="postings", device="cpu")
    res = engine.score(*batch_of([read]))
    assert 9 in {int(x) for x in res.top_edges[0] if x >= 0}
    assert int(res.n_matched[0]) == oracle.place_read(db, read)[1]


def test_auto_selects_postings(db, tdb, monkeypatch):
    monkeypatch.setattr(PlacementEngine, "DIRECT_BYTE_LIMIT", 1024)
    monkeypatch.setattr(JaxEngine, "DIRECT_BYTE_LIMIT", 1024)
    engine = PlacementEngine(tdb, table="auto", device="cpu")
    assert engine.table == JaxEngine(db, table="auto").table == "postings"
    compare(db, engine, random_reads(6, 25, seed=17))


@pytest.fixture(scope="module")
def star_trees():
    """A star tree of 65,600 leaves (65,601 edge slots), parsed once for
    each package (the parse is most of these tests' set-up)."""
    from rappas_tpu.tree import write_newick
    from rappas_tpu_torch.tree import parse_newick as port_parse_newick
    labels = ",".join(f"T{i}:0.1" for i in range(65600))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    return tree, port_parse_newick(
        write_newick(tree, True, True, True, False), jplace_edge_ids=True)


def _star_dbs(trees, k, seed=0):
    """(JAX DB, port DB) on the star: light and heavy k-mers whose edges
    reach the top ids."""
    from rappas_tpu_torch.db import PhyloKmerDB as PortDB
    rng = np.random.default_rng(seed)
    E = 65601
    thr = PhyloKmerDB.threshold(k, 1.5, 4)
    keys = rng.choice(4 ** k, size=min(300, 4 ** k), replace=False)
    lens = np.where(rng.random(keys.size) < 0.1,
                    rng.integers(12, 30, keys.size),
                    rng.integers(1, 8, keys.size))
    codes = np.repeat(keys, lens).astype(np.int64)
    edges = np.where(rng.random(codes.size) < 0.5,
                     rng.integers(E - 200, E, codes.size),
                     rng.integers(1, E, codes.size)).astype(np.int32)
    scores = (thr + 0.01 + rng.random(codes.size) * 2.5).astype(np.float32)
    csr = build_csr(codes, edges, scores, thr)
    db = PhyloKmerDB(k, 1.5, DNA, thr, trees[0], *csr)
    return db, PortDB(k, 1.5, port_db(db).alphabet, thr, trees[1], *csr)


@pytest.mark.parametrize("k, table", [(5, "auto"), (3, "direct")])
def test_wide_result_path_matches_jax(star_trees, k, table):
    """65,601 edge slots: edge ids do not fit u16.  The port's wire
    carries them as int32 (P3 on the postings layout, which JAX's
    ``auto`` picks at k=5, and K3 on the compact table the port's picks;
    K3 on a direct table at k=3), the JAX engine, on the same layout,
    returns its four arrays; both give the oracle's placements."""
    db, tdb = _star_dbs(star_trees, k)
    assert db.n_edge_slots == tdb.n_edge_slots == 65601
    if table == "auto":
        assert JaxEngine.resolve_table(
            db, "auto", "f32", JaxEngine.DIRECT_BYTE_LIMIT) == "postings"
    reads = with_db_kmers(db, random_reads(10, 30, seed=21), n=6)
    reads[1] = reads[1][:7] + "N" + reads[1][8:]
    mat, lens = batch_of(reads)
    want = {"auto": "compact", "postings": "postings", "direct": "direct"}
    for layout in (table, "postings") if table == "auto" else (table,):
        engine = PlacementEngine(tdb, table=layout, device="cpu")
        assert engine.wide
        assert engine.table == want[layout]
        j = JaxEngine(db, table=engine.table)
        assert not j._wire_ok
        res = engine.score(mat, lens)
        same_as_jax(res, j.score(mat, lens))
        assert res.top_edges.max() >= 65535
        compare(db, engine, reads[-3:])
