"""The port's table-layout policy (``PlacementEngine.resolve_table`` and
the split budgets, set on an NVIDIA H100 80GB by
``scripts/layout_sweep.py``), on the CPU, where each budget stands at its
H100 value so that the CPU engine makes the card's choices.

* the rule on a grid of DB shapes (k, E, k-mers present, light share,
  precision), each with its layout and the constant that decides it: a
  change of that constant alone moves the layout;
* each budget moves only its own path (the light part size, the
  two-stage caps, the direct part size, the layout lines);
* the DBs whose layout the rule moved (configs 2 and 6 at small sizes):
  the port's ``auto`` engine against JAX's engine with ``table=`` set to
  the same layout, within ``tests/test_engine.py:41-60``'s gate (``|L|``
  and edge sets identical, scores within 2e-4, LWR within 1e-4)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rappas_tpu.alphabet import DNA as JaxDNA
from rappas_tpu.db import PhyloKmerDB as JaxDB
from rappas_tpu.db import build_csr
from rappas_tpu.place.engine import PlacementEngine as JaxEngine
from rappas_tpu.tree import parse_newick
from rappas_tpu_torch.alphabet import AA, DNA
from rappas_tpu_torch.db import LightLayout
from rappas_tpu_torch.place import engine as port_engine
from rappas_tpu_torch.place.engine import PlacementEngine, light_width
from test_engine import batch_of, compare, synthetic_db
from test_torch_engine import port_db, same_as_jax
from test_torch_postings import random_reads, skewed_db, with_db_kmers

GiB = 1 << 30


def shape(alphabet, k: int, E: int, n_kmers: int,
          light_share: float = 1.0, light_len: int = 4):
    """What ``resolve_table`` reads of a DB, without its tables:
    ``n_kmers`` k-mers, light ones with ``light_len`` postings and heavy
    ones with 40, as many heavy ones as make ``light_share`` of the
    postings light (light and heavy at the default width of 8)."""
    n_heavy = round(n_kmers * (1 - light_share) /
                    (1 - light_share + 10 * light_share))
    lens = np.full(n_kmers, light_len, np.int64)
    lens[:n_heavy] = 40
    return of_lengths(alphabet, k, E, lens)


def of_lengths(alphabet, k: int, E: int, lens: np.ndarray):
    """A DB shape whose keys hold ``lens`` postings each."""
    offsets = np.concatenate([[0], np.cumsum(lens)])
    return SimpleNamespace(alphabet=alphabet, k=k, n_edge_slots=E,
                           n_kmers=lens.size, offsets=offsets,
                           nnz=int(offsets[-1]))


def resolve(db, precision="f32", layout=False, **consts):
    cls = type("Patched", (PlacementEngine,), consts)
    got = cls.resolve_layout(db, "auto", precision, cls.table_budget("cpu"))
    return got if layout else got[0]


#: (name, DB shape, precision, layout, the constants that decide it and
#: values of them alone that move the layout, the layout it moves to).
#: The configs and sparse12, k12_E1000 and k8_full are the sweep's DBs
#: (PERF.md "Table layouts"); config 4's keys pass int32, so no budget
#: gives it compact (its heavy-dominated variant takes compact under an
#: ``AUTO_POSTINGS_SHARE`` below its 23%).
GRID = [
    ("config1", (DNA, 8, 300, 39_321), "f32", "compact",
     {"AUTO_COMPACT_BYTES": 1 << 20}, "postings"),
    ("config1_u16", (DNA, 8, 300, 39_321), "u16", "compact",
     {"DIRECT_BYTE_LIMIT": 1 << 20}, "raises"),
    ("config2", (DNA, 10, 300, 52_428), "f32", "compact",
     {"AUTO_COMPACT_BYTES": 1 << 20}, "postings"),
    ("config2_u16", (DNA, 10, 300, 52_428), "u16", "compact",
     {"DIRECT_BYTE_LIMIT": 1 << 20}, "raises"),
    ("config6", (DNA, 12, 300, 2_010_000, 0.895), "f32", "compact",
     {"AUTO_COMPACT_BYTES": GiB}, "postings"),
    ("config6_u16", (DNA, 12, 300, 2_010_000, 0.895), "u16", "compact",
     {"DIRECT_BYTE_LIMIT": GiB}, "raises"),
    ("config5", (DNA, 12, 7999, 2_010_000, 0.875), "f32", "postings",
     {"AUTO_COMPACT_BYTES": 70 * GiB, "DIRECT_BYTE_LIMIT": 70 * GiB},
     "compact"),
    ("config5_u16", (DNA, 12, 7999, 2_010_000, 0.875), "u16", "compact",
     {"DIRECT_BYTE_LIMIT": 16 * GiB}, "raises"),
    ("config4", (AA, 8, 150, 500_000), "f32", "postings",
     {"AUTO_COMPACT_BYTES": 1 << 62}, "postings"),
    # heavy-dominated past the line (keys past int32): postings at width
    # 4 takes 22% of the compact table's bytes
    ("config4_heavy", (AA, 8, 150, 500_000, 0.3), "f32", "postings",
     {"AUTO_POSTINGS_SHARE": 0.2}, "compact"),
    ("config4_u16", (AA, 8, 150, 500_000), "u16", "compact",
     {"DIRECT_BYTE_LIMIT": 1 << 20}, "raises"),
    ("sparse12", (DNA, 12, 300, 100_000), "f32", "compact",
     {"AUTO_COMPACT_BYTES": 1 << 20}, "postings"),
    ("k12_E1000", (DNA, 12, 1000, 2_010_000, 0.88), "f32", "postings",
     {"AUTO_COMPACT_BYTES": 9 * GiB}, "compact"),
    # heavy-dominated past the line: postings at width 40 takes 6% of
    # the compact table's bytes
    ("k12_E1000_heavy", (DNA, 12, 1000, 2_010_000, 0.3), "f32",
     "postings", {"AUTO_POSTINGS_SHARE": 0.05}, "compact"),
    ("k12_E1000_u16", (DNA, 12, 1000, 2_010_000, 0.88), "u16", "compact",
     {"DIRECT_BYTE_LIMIT": 3 * GiB}, "raises"),
    # every k-mer present: compact all the same (direct only tied it)
    ("k8_full", (DNA, 8, 300, 4 ** 8), "f32", "compact",
     {"AUTO_COMPACT_BYTES": 1 << 20}, "postings"),
    # protein keys within int32 (the card searches them)
    ("aa6", (AA, 6, 150, 2_000_000), "f32", "compact",
     {"AUTO_COMPACT_BYTES": GiB}, "postings"),
    # the 4,000-taxon k=10 deployment (c5): every 10-mer a key with 45
    # postings on 8,000 slots, postings at width 45 0.85% of compact
    ("c5", (DNA, 10, 8000, 4 ** 10, 1.0, 45), "f32", "postings",
     {"AUTO_POSTINGS_SHARE": 0.008}, "compact"),
    # heavy-dominated and dense (20% of compact at its own width): past
    # the line with no share, only a compact table past the card's
    # budget gives postings
    ("dense_past_budget", (DNA, 12, 300, 2_010_000, 0.3), "f32", "compact",
     {"AUTO_COMPACT_BYTES": 0, "AUTO_POSTINGS_SHARE": 0,
      "DIRECT_BYTE_LIMIT": 1 << 20}, "postings"),
]


@pytest.mark.parametrize("name, dims, precision, want, consts, moved",
                         GRID, ids=[row[0] for row in GRID])
def test_rule_on_a_grid(name, dims, precision, want, consts, moved):
    db = shape(*dims)
    assert resolve(db, precision) == want
    if moved == "raises":
        with pytest.raises(ValueError, match="u16"):
            resolve(db, precision, **consts)
    else:
        assert resolve(db, precision, **consts) == moved


def test_light_share_moves_only_past_the_compact_line():
    """Below the compact line a heavy-dominated DB takes compact as a
    light-dominated one does; past it the light-dominated one takes
    postings at the default width, and the heavy-dominated one (40
    postings a key on 1,000 slots) postings at its own width, 40."""
    for share in (1.0, 0.5, 0.1):
        assert resolve(shape(DNA, 12, 300, 2_010_000, share)) == "compact"
    assert resolve(shape(DNA, 12, 1000, 2_010_000, 0.6), layout=True) == \
        ("postings", 8)
    assert resolve(shape(DNA, 12, 1000, 2_010_000, 0.4), layout=True) == \
        ("postings", 40)


def _lengths(name):
    """Key lengths of 4,096 keys and the DB's slots: PERF.md §4's
    densities of the method's own builds (60 taxa: 44.5 postings a key,
    median 42, on 119 slots; 150 taxa: 227.4, median 228, on 299), the
    4,000-taxon deployment (45 on 8,000), and a long tail (97% of keys
    with 10-30 postings, 3% with 500-3,000, on 8,000)."""
    rng = np.random.default_rng(13)
    n = 4096
    if name == "taxa60":
        lens = rng.negative_binomial(20, 20 / (20 + 44.5), n)
        return np.clip(lens, 1, 119), 119
    if name == "taxa150":
        return np.maximum(rng.binomial(299, 227.4 / 299, n), 1), 299
    if name == "c5":
        return np.full(n, 45, np.int64), 8000
    lens = rng.integers(10, 31, n)
    tail = rng.random(n) < 0.03
    lens[tail] = rng.integers(500, 3001, int(tail.sum()))
    return lens, 8000


def _brute_width(lens, E, row_bytes=None):
    """The postings layout's least bytes over every width 0 .. max, a
    light row of width W taking ``row_bytes(W)`` (default: its
    ``LightLayout``'s words)."""
    ws = np.arange(int(lens.max()) + 1)
    if row_bytes is None:
        row_bytes = np.vectorize(lambda w: 4 * LightLayout.of(w, E).words)
    nl = (lens[None, :] <= ws[:, None]).sum(axis=1)
    return int(((nl + 1) * row_bytes(ws) + (lens.size - nl + 1) * 4 *
                E).min())


#: (name, layout past the line, the light width, heavy keys left)
SHARE = [("c5", "postings", 45, False), ("taxa60", "compact", None, None),
         ("taxa150", "compact", None, None),
         ("long_tail", "postings", 30, True)]


@pytest.mark.parametrize("name, want, width, heavy", SHARE,
                         ids=[row[0] for row in SHARE])
def test_own_width_past_the_compact_line(name, want, width, heavy):
    """Past the compact line (patched to 0) a heavy-dominated DB takes
    postings at its own light width when that layout takes at most
    ``AUTO_POSTINGS_SHARE`` of the compact table's bytes: the
    deployment's 45 a key on 8,000 slots does, the method's dense builds
    do not; the width is the bytes' least over every width."""
    lens, E = _lengths(name)
    db = of_lengths(DNA, 10, E, lens)
    assert int(lens[lens > 8].sum()) * 2 > db.nnz      # heavy-dominated
    w, nbytes = light_width(lens, E)
    assert nbytes == _brute_width(lens, E)
    share = nbytes / ((db.n_kmers + 1) * E * 4)
    got = resolve(db, layout=True, AUTO_COMPACT_BYTES=0)
    if want == "compact":
        assert got[0] == "compact" and share > 0.6
        # the share alone moves it
        assert resolve(db, AUTO_COMPACT_BYTES=0,
                       AUTO_POSTINGS_SHARE=share) == "postings"
        return
    assert got == ("postings", w) and w == width
    assert bool((lens > w).any()) == heavy
    assert resolve(db, AUTO_COMPACT_BYTES=0,
                   AUTO_POSTINGS_SHARE=share * 0.99) == "compact"


@pytest.mark.parametrize("name", [row[0] for row in SHARE])
def test_past_the_budget_takes_the_own_width(name):
    """A DB whose compact table passes the card's budget takes postings
    at its own light width, whatever its share: the width that makes the
    layout least, dense builds included."""
    lens, E = _lengths(name)
    db = of_lengths(DNA, 10, E, lens)
    consts = {"AUTO_COMPACT_BYTES": 0, "AUTO_POSTINGS_SHARE": 0}
    assert resolve(db, **consts) == "compact"
    assert resolve(db, layout=True, DIRECT_BYTE_LIMIT=1 << 20, **consts) \
        == ("postings", light_width(lens, E)[0])


def _int32_width(lens, E):
    """:func:`light_width` with light rows of int32 edge ids (8 bytes a
    posting, the layout at 65,535 edge slots and above)."""
    counts = np.bincount(lens, minlength=1)
    widths = np.flatnonzero(np.r_[1, counts[1:]])
    nl = np.cumsum(counts)[widths]
    nbytes = (nl + 1) * 8 * widths + (len(lens) - nl + 1) * 4 * E
    best = int(np.argmin(nbytes))
    assert nbytes[best] == _brute_width(lens, E, lambda w: 8 * w)
    return int(widths[best]), int(nbytes[best])


#: the DB shapes above in f32 (the grid's and the dense builds')
SHAPES = [(row[0], row[1]) for row in GRID if row[2] == "f32"] + \
    [(name, None) for name, *_ in SHARE]


@pytest.mark.parametrize("name, dims", SHAPES, ids=[n for n, _ in SHAPES])
def test_u16_rows_keep_the_layouts(name, dims, monkeypatch):
    """Light rows with u16 edge ids (6 bytes a posting below 65,535 edge
    slots, in place of 8) move no layout or width of these shapes: the
    rule with the light rows at 8 bytes a posting chooses the same, at
    the compact line and past it (the dense builds: past it, patched to
    0)."""
    if dims is None:
        lens, E = _lengths(name)
        db, consts = of_lengths(DNA, 10, E, lens), {"AUTO_COMPACT_BYTES": 0}
    else:
        db, consts = shape(*dims), {}
    got = resolve(db, layout=True, **consts)
    monkeypatch.setattr(port_engine, "light_width", _int32_width)
    assert resolve(db, layout=True, **consts) == got


def test_light_width_of_no_keys():
    # W = 0: one miss row of each table, the light one of no slots
    assert light_width(np.zeros(0, np.int64), 50) == (0, 200)


def test_u16_never_postings():
    for dims in [(DNA, 12, 7999, 2_010_000, 0.875), (AA, 8, 150, 500_000),
                 (DNA, 12, 1200, 2_010_000, 0.88)]:
        assert resolve(shape(*dims), "u16") != "postings"
    with pytest.raises(ValueError, match="compact table takes"):
        resolve(shape(DNA, 12, 12_000, 2_010_000), "u16")


def test_explicit_layout_is_kept():
    db = shape(DNA, 12, 7999, 2_010_000, 0.875)
    for table in ("direct", "compact", "postings"):
        assert PlacementEngine.resolve_table(db, table, "f32", 0) == table


def test_budgets_scale_with_the_card(monkeypatch):
    """On the CPU a budget stands at its H100 value; on CUDA it scales by
    the card's memory over ``CARD_MEMORY_BYTES``."""
    E = PlacementEngine
    assert E.table_budget("cpu") == E.DIRECT_BYTE_LIMIT == \
        E.CARD_MEMORY_BYTES // 2
    assert E.card_bytes(E.LIGHT_PART_BYTES, "cpu") == E.LIGHT_PART_BYTES
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(
                            total_memory=E.CARD_MEMORY_BYTES // 2))
    assert E.table_budget(torch.device("cuda", 0)) == \
        E.DIRECT_BYTE_LIMIT // 2
    # a half-size card: config 5's 32 GB u16 compact table no longer fits
    cfg5 = shape(DNA, 12, 7999, 2_010_000, 0.875)
    with pytest.raises(ValueError, match="u16"):
        E.resolve_table(cfg5, "auto", "u16",
                        E.table_budget(torch.device("cuda", 0)))


def test_one_budget_per_job():
    """JAX's one split budget is four constants here, one per job."""
    for name in ("AUTO_COMPACT_BYTES", "LIGHT_PART_BYTES",
                 "TWO_STAGE_MAX_BYTES", "DIRECT_PART_BYTES"):
        assert hasattr(PlacementEngine, name)
    assert not hasattr(PlacementEngine, "LIGHT_SPLIT_BYTES")


# ---- each budget moves only its own path ------------------------------- #

@pytest.fixture(scope="module")
def pdb():
    return port_db(skewed_db())


@pytest.fixture(scope="module")
def ddb():
    return port_db(synthetic_db())


def _pairs_bytes(db):
    return (db.postings_tables(8).light_keys.shape[0] + 1) * 4 * \
        LightLayout.of(8, db.n_edge_slots).words


def _source(engine, reads):
    mat, lens = batch_of(reads)
    host, _ = engine.postings_inputs(engine.encode_batch(mat), mat, lens)
    return engine._light_source(host)


def test_default_tables_stay_whole(pdb, ddb):
    p = PlacementEngine(pdb, table="postings", device="cpu")
    assert len(p.light_parts) == 1 and not p._light_slow
    assert not p._routed_windows
    d = PlacementEngine(ddb, table="direct", device="cpu")
    assert d.direct_parts is None and d.D is not None


def test_light_part_bytes_moves_only_the_light_split(pdb, ddb,
                                                     monkeypatch):
    def layouts():
        return [PlacementEngine.resolve_table(
            db, "auto", "f32", PlacementEngine.table_budget("cpu"))
            for db in (pdb, ddb)]
    before = layouts()
    monkeypatch.setattr(PlacementEngine, "LIGHT_PART_BYTES",
                        _pairs_bytes(pdb) // 3 + 64)
    monkeypatch.setattr(PlacementEngine, "DIRECT_SPLIT_MIN", 0)
    p = PlacementEngine(pdb, table="postings", device="cpu")
    assert len(p.light_parts) == 3 and p._routed_windows
    # the direct table splits by its own part size (one table's budget)
    d = PlacementEngine(ddb, table="direct", device="cpu")
    assert d.direct_parts is None
    assert layouts() == before


def test_two_stage_cap_moves_only_the_row_source(pdb, monkeypatch):
    """A split light table with routing off: within the two-stage caps
    the batch's unique rows are gathered (``compact``); with the byte cap
    at 0 the same table (same parts) takes the select fallback, and the
    placements stay bitwise the one-table engine's."""
    ref = PlacementEngine(pdb, table="postings", device="cpu")
    monkeypatch.setattr(PlacementEngine, "LIGHT_PART_BYTES",
                        _pairs_bytes(pdb) // 3 + 64)
    monkeypatch.setattr(PlacementEngine, "MIN_SPLIT_B", 1 << 20)
    reads = with_db_kmers(pdb, random_reads(4, 40, seed=47), n=4) * 2
    mat, lens = batch_of(reads)
    got, cap0 = {}, PlacementEngine.TWO_STAGE_MAX_BYTES
    for cap in (cap0, 0):
        monkeypatch.setattr(PlacementEngine, "TWO_STAGE_MAX_BYTES", cap)
        t = PlacementEngine(pdb, table="postings", device="cpu")
        t.enable_routed_windows(False)
        assert len(t.light_parts) == 3
        got[cap] = _source(t, reads)[0]
        r = t.score(mat.copy(), lens.copy())
        want = ref.score(mat.copy(), lens.copy())
        assert np.array_equal(r.top_edges, want.top_edges)
        assert np.array_equal(r.top_scores.view(np.uint32),
                              want.top_scores.view(np.uint32))
    assert got == {cap0: "compact", 0: "parts"}


def test_min_split_b_moves_only_the_halving(pdb, monkeypatch):
    """Past the two-stage caps a batch takes the select fallback whole;
    with a halving size it is halved first (the split is the same)."""
    monkeypatch.setattr(PlacementEngine, "LIGHT_PART_BYTES",
                        _pairs_bytes(pdb) // 2 + 64)
    monkeypatch.setattr(PlacementEngine, "TWO_STAGE_MAX_UNIQUE", 0)
    reads = with_db_kmers(pdb, random_reads(8, 40, seed=51), n=4)
    got = []
    for min_b in (PlacementEngine.MIN_SPLIT_B, 2):
        monkeypatch.setattr(PlacementEngine, "MIN_SPLIT_B", min_b)
        t = PlacementEngine(pdb, table="postings", device="cpu")
        t.enable_routed_windows(False)
        assert len(t.light_parts) == 2
        got.append(_source(t, reads))
    assert got == [("parts",), None]


def test_direct_part_bytes_moves_only_the_direct_split(pdb, ddb,
                                                       monkeypatch):
    dense = ddb.dense_matrix(pad_rows=1)
    monkeypatch.setattr(PlacementEngine, "DIRECT_SPLIT_MIN", 0)
    monkeypatch.setattr(PlacementEngine, "DIRECT_PART_BYTES",
                        dense.nbytes // 4 + 64)
    d = PlacementEngine(ddb, table="direct", device="cpu")
    assert len(d.direct_parts) == 4 and d.D is None
    p = PlacementEngine(pdb, table="postings", device="cpu")
    assert len(p.light_parts) == 1 and not p._routed_windows


def test_compact_line_moves_only_the_layout(pdb, monkeypatch):
    """The compact line picks the layout and leaves the tables of each
    layout as they are."""
    assert PlacementEngine(pdb, device="cpu").table == "compact"
    monkeypatch.setattr(PlacementEngine, "AUTO_COMPACT_BYTES", 0)
    p = PlacementEngine(pdb, device="cpu")
    assert p.table == "postings" and len(p.light_parts) == 1
    c = PlacementEngine(pdb, table="compact", device="cpu")
    assert c.keys_dev is not None and c.D.shape[0] == pdb.n_kmers + 1


# ---- the DBs whose layout the rule moved ------------------------------- #

def _star(n_edges):
    labels = ",".join(f"L{i}:0.1" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    return tree


def small_config2(seed=0):
    """``chip_smoke.bench_db``'s recipe at config 2's k=10 and 300 edge
    slots, 1% occupancy (config 2: 5%): 10,485 k-mers with 5 postings."""
    rng = np.random.default_rng(seed)
    k, n_edges = 10, 300
    thr = JaxDB.threshold(k, 1.5, 4)
    codes = np.repeat(rng.choice(4 ** k, int(4 ** k * 0.01),
                                 replace=False).astype(np.int64), 5)
    edges = rng.integers(1, n_edges, codes.size).astype(np.int32)
    scores = (thr + rng.random(codes.size) * 2.5).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    return JaxDB(k=k, omega=1.5, alphabet=JaxDNA, thr_log10=thr,
                 tree=_star(n_edges), keys=keys, offsets=offsets, edges=e,
                 deltas=deltas)


def small_config6(seed=0):
    """``chip_smoke.k12_db``'s recipe (config 6: k=12, 300 edge slots)
    with 20,000 light k-mers of 1-7 postings and 100 heavy ones of
    32-199."""
    rng = np.random.default_rng(seed)
    k, n_edges, n_light, n_heavy = 12, 300, 20_000, 100
    thr = JaxDB.threshold(k, 1.5, 4)
    keys = rng.choice(4 ** k, n_light + n_heavy, replace=False)
    lens = np.concatenate([rng.integers(1, 8, n_light),
                           rng.integers(32, 200, n_heavy)])
    codes = np.repeat(keys.astype(np.int64), lens)
    edges = rng.integers(1, n_edges, codes.size).astype(np.int32)
    scores = (thr + 0.01 + rng.random(codes.size) * 2.5).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    return JaxDB(k=k, omega=1.5, alphabet=JaxDNA, thr_log10=thr,
                 tree=_star(n_edges), keys=keys, offsets=offsets, edges=e,
                 deltas=deltas)


@pytest.mark.parametrize("make", [small_config2, small_config6],
                         ids=["config2", "config6"])
def test_moved_dbs_match_jax_on_the_same_layout(make):
    """JAX's rule sends these DBs to postings, the port's to compact; the
    port's ``auto`` engine places as JAX's compact engine and as the
    serial oracle."""
    jdb = make()
    tdb = port_db(jdb)
    assert JaxEngine.resolve_table(jdb, "auto", "f32",
                                   JaxEngine.DIRECT_BYTE_LIMIT) == "postings"
    engine = PlacementEngine(tdb, device="cpu")
    assert engine.table == "compact"
    reads = with_db_kmers(jdb, random_reads(12, 60, seed=5), n=6)
    reads += [r[:20] + "N" + r[21:] for r in random_reads(4, 60, seed=6)]
    mat, lens = batch_of(reads)
    res = engine.score(mat, lens)
    assert (res.n_matched > 0).any()
    same_as_jax(res, JaxEngine(jdb, table=engine.table).score(mat, lens))
    compare(jdb, engine, reads)
