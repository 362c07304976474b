"""The port's multi-device pieces (``rappas_tpu_torch.parallel``) against
the JAX package's on its virtual 8-device CPU mesh (``tests/conftest.py``):
the sharded tables bitwise, the sharded kernels' plain versions against
the JAX functions they replace, and the mesh's errors.

Tolerances as ``tests/test_engine.py:41-60``: edge sets, edge order and
``|L|`` identical, scores within 2e-4, LWR within 1e-4; partial sums
within 1e-5 (f32 summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rappas_tpu.parallel.engine import ShardedEngine as JaxShardedEngine
from rappas_tpu.parallel.kmer_sharded import \
    KmerShardedPlacement as JaxKmerSharded
from rappas_tpu.parallel.mesh import ShardedPlacement as JaxSharded
from rappas_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rappas_tpu.parallel.postings_sharded import \
    shard_db_by_edge as jax_shard_db_by_edge
from rappas_tpu.place import engine as J
from rappas_tpu_torch.convert import column_shards, kmer_range_shards
from rappas_tpu_torch.parallel.mesh import make_mesh
from rappas_tpu_torch.parallel.postings_sharded import shard_db_by_edge
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import (PlacementEngine, postings_batch,
                                           searchsorted_rows)
from test_engine import batch_of, random_reads, synthetic_db
from test_torch_engine import port_db
from test_torch_postings import random_reads as plain_reads
from test_torch_postings import skewed_db


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


def jax_mesh(dp, mp):
    return jax_make_mesh(jax.devices()[:dp * mp], dp=dp, mp=mp)


# ---------------------------------------------------------------- mesh #
def test_make_mesh_shapes_and_errors():
    """dp*mp must equal the device count (``tests/test_parallel.py:
    98-101``); a mesh may repeat a device."""
    m = make_mesh(["cpu"] * 8, mp=2)
    assert m.shape == {"dp": 4, "mp": 2}
    assert m.axis_names == ("dp", "mp")
    assert m.devices.shape == (4, 2)
    assert m.distinct == [torch.device("cpu")]
    with pytest.raises(ValueError, match="dp\\*mp"):
        make_mesh(["cpu"] * 8, dp=3, mp=2)
    with pytest.raises(ValueError, match="dp\\*mp"):
        jax_make_mesh(jax.devices()[:8], dp=3, mp=2)


def test_batch_not_divisible_by_dp_raises(tdb):
    from rappas_tpu_torch.parallel.engine import ShardedEngine
    eng = ShardedEngine(tdb, make_mesh(["cpu"] * 4, dp=4, mp=1))
    mat, lens = batch_of(random_reads(6, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="not divisible by dp=4"):
        eng.score(mat, lens)


# -------------------------------------------------------------- tables #
@pytest.mark.parametrize("mp", [1, 2, 4])
def test_column_shards_match_jax(db, tdb, mp):
    """The direct and compact tables' column shards are JAX's padded
    tables cut over the mp axis, bitwise."""
    D = np.asarray(JaxSharded(db, jax_mesh(8 // mp, mp)).D)
    got = column_shards(tdb, "direct", mp)
    assert np.array_equal(np.concatenate(got, axis=1).view(np.uint32),
                          D.view(np.uint32))
    assert [g.shape[1] for g in got] == [D.shape[1] // mp] * mp
    Dc = np.asarray(JaxShardedEngine(db, jax_mesh(8 // mp, mp),
                                     table="compact").D)
    got = column_shards(tdb, "compact", mp)
    assert np.array_equal(np.concatenate(got, axis=1).view(np.uint32),
                          Dc.view(np.uint32))


@pytest.mark.parametrize("mp", [2, 4, 8])
def test_kmer_range_shards_match_jax(db, tdb, mp):
    j = JaxKmerSharded(db, jax_mesh(8 // mp, mp))
    per, shards = kmer_range_shards(tdb, mp)
    assert per == j._per and per + 1 == j.n_local_rows
    assert np.array_equal(np.stack(shards).view(np.uint32),
                          np.asarray(j.D).view(np.uint32))


@pytest.mark.parametrize("mp, width", [(4, 4), (2, 8), (8, 4), (3, 0)])
def test_shard_db_by_edge_matches_jax(pdb, tpdb, mp, width):
    """The port's copy gives JAX's tables bitwise, and the partition covers
    every posting (``tests/test_postings_sharded.py:31-38``)."""
    b_j, t_j = jax_shard_db_by_edge(pdb, mp, width)
    b_t, t_t = shard_db_by_edge(tpdb, mp, width)
    assert np.array_equal(b_j, b_t)
    for name in ("light_pairs", "rof", "nl"):
        assert np.array_equal(t_j[name], t_t[name]), name
    assert np.array_equal(t_j["heavy_dense"].view(np.uint32),
                          t_t["heavy_dense"].view(np.uint32))
    for name in ("heavy_keys", "light_keys"):
        assert all(np.array_equal(a, b)
                   for a, b in zip(t_j[name], t_t[name])), name
    total = sum(int(np.count_nonzero(t_t["light_pairs"][i, :, width:])) +
                int(np.count_nonzero(t_t["heavy_dense"][i]))
                for i in range(mp))
    assert total == tpdb.nnz
    assert b_t[0] == 0 and b_t[-1] == tpdb.n_edge_slots


def test_postings_sharded_protein_raises_as_jax():
    """No direct row table for a protein k=8 space: both packages refuse
    edge-range sharding with the same message."""
    from test_torch_postings import _protein_db
    db, _ = _protein_db()
    with pytest.raises(ValueError) as ej:
        jax_shard_db_by_edge(db, 2)
    with pytest.raises(ValueError) as et:
        shard_db_by_edge(port_db(db), 2)
    assert str(et.value) == str(ej.value)
    assert "direct row table" in str(et.value)


# -------------------------------------------- plain versions vs JAX #
def _codes(tdb, reads):
    mat, lens = batch_of(reads)
    return PlacementEngine(tdb, device="cpu").encode_batch(mat), lens


@pytest.mark.parametrize("dp, mp", [(4, 2), (2, 4), (1, 8)])
def test_accumulate_range_matches_kmer_sharded_step(db, tdb, dp, mp):
    """Plain C3 on each k-mer-range shard against the fold + ``accumulate``
    of ``KmerShardedPlacement``'s shard step, and its psum + K3 against
    the whole ``_step``."""
    j = JaxKmerSharded(db, jax_mesh(dp, mp))
    per, shards = kmer_range_shards(tdb, mp)
    codes, lens = _codes(tdb, random_reads(8 * dp, np.random.default_rng(3),
                                           with_amb=0.3))
    rows = searchsorted_rows(tdb.keys, J.host_kmer_indices(
        codes, lens, tdb.k, 4))
    rows_t = torch.from_numpy(rows)
    acc = 0
    for i, sh in enumerate(shards):
        got = T.accumulate_range(torch.from_numpy(sh), rows_t, i * per, per)
        local = rows - i * per
        want = J.accumulate(jnp.asarray(sh), jnp.where(
            (local >= 0) & (local < per), local, per))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        acc = acc + got
    te, ts, lwr, nm = T.finalize(acc, torch.from_numpy(lens),
                                 torch.tensor(np.float32(tdb.thr_log10)),
                                 tdb.k, 7)
    je, js, jl, jn = (np.asarray(x) for x in j._step(
        j.D, jnp.asarray(rows), jnp.asarray(lens)))
    assert np.array_equal(nm.numpy(), jn)
    assert np.array_equal(te.numpy(), je)
    np.testing.assert_allclose(ts.numpy(), js, atol=2e-4)
    np.testing.assert_allclose(lwr.numpy(), jl, atol=1e-4)


def _shard_batch(tpdb, t, bounds, j, reads, amb=True):
    """Shard ``j``'s host inputs of a batch (the port's per-shard
    preparation) and the ambiguity expansion."""
    eng = PlacementEngine(tpdb, device="cpu", table="postings",
                          postings_width=4)
    mat, lens = batch_of(reads)
    codes = eng.encode_batch(mat)
    S, k = 4, tpdb.k
    kidx = J.host_kmer_indices(codes, lens, k, S)
    kidx = np.where(kidx >= 0, kidx, S ** k)
    nl = int(t["nl"][j])
    nh = t["heavy_keys"][j].shape[0]
    pairs = t["light_pairs"][j, :nl + 1]
    counts = (pairs[:, :4] != np.iinfo(np.int32).max).sum(1)
    a = eng._expand_ambiguities_host(codes, mat, lens) if amb else None
    from rappas_tpu_torch.place.engine import alt_rows_of
    host, _ = postings_batch(
        t["rof"][j][kidx], nl, counts, lens, a,
        None if a is None else alt_rows_of(t["rof"][j][a[0]], nl, nh))
    return host, a, pairs, t["heavy_dense"][j, :nh + 1], lens


@pytest.mark.parametrize("mp, j", [(4, 1), (4, 3), (2, 1)])
def test_finalize_postings_offset_matches_jax(pdb, tpdb, mp, j):
    """Plain P3 on edge-range shard ``j`` (its offset, global ids out)
    against ``finalize_postings_local(edge_offset=...)`` on the same
    tables and rows: edge order, ``|L|``, scores and LWR."""
    bounds, t = shard_db_by_edge(tpdb, mp, 4)
    reads = plain_reads(24, 30, seed=5) + [
        pdb.alphabet.kmer_to_string(int(x), pdb.k) * 5 for x in pdb.keys[:6]]
    host, _, pairs, H, lens = _shard_batch(tpdb, t, bounds, j, reads,
                                           amb=False)
    slot_of = host["slot_of"]
    hoff = host["hoff"]
    n_slots = hoff.shape[0] - 1
    acc_c = T.dense_side(torch.from_numpy(H), torch.from_numpy(host["hrows"]),
                         torch.from_numpy(hoff))
    thr = np.float32(tpdb.thr_log10)
    te, ts, lwr, nm = T.finalize_postings(
        torch.from_numpy(pairs), torch.from_numpy(host["lrows"]), acc_c,
        torch.from_numpy(slot_of), torch.from_numpy(lens),
        torch.tensor(thr), tpdb.k, 7, int(bounds[j]),
        layout=T.LightLayout(4, False))
    # JAX: the same heavy rows as (row, read) dense sources
    read_of_slot = np.flatnonzero(slot_of >= 0)
    dense_reads = np.repeat(read_of_slot, np.diff(hoff)).astype(np.int32)
    je, js, jl, jn = (np.asarray(x) for x in J.finalize_postings_local(
        jnp.asarray(pairs), jnp.asarray(host["lrows"]),
        jnp.asarray(H[host["hrows"]]), jnp.asarray(dense_reads),
        jnp.asarray(lens), jnp.float32(thr), jnp.int32(bounds[j]),
        tpdb.k, 7, True))
    assert n_slots > 0 and (je >= bounds[j] + 0).sum() > 0
    assert np.array_equal(nm.numpy(), jn)
    assert np.array_equal(te.numpy(), je)
    np.testing.assert_allclose(ts.numpy(), js, atol=2e-4)
    np.testing.assert_allclose(lwr.numpy(), jl, atol=1e-4)
    # the wire form (what P3 writes) decodes to the same placements
    wire = T.finalize_postings_wire(
        torch.from_numpy(pairs), torch.from_numpy(host["lrows"]), acc_c,
        torch.from_numpy(slot_of), torch.from_numpy(lens), float(thr),
        tpdb.k, 7, T.postings_plan(np.zeros(len(reads))), int(bounds[j]),
        tpdb.n_edge_slots, layout=T.LightLayout(4, False))
    K, wide, _ = T.wire_format(tpdb.n_edge_slots, 7, H.shape[1])
    we, ws, wn = T.wire_fields(wire, K, wide)
    assert np.array_equal(we.numpy(), te.numpy())
    assert np.array_equal(wn.numpy(), nm.numpy())


@pytest.mark.parametrize("mp, j", [(4, 2), (2, 1)])
def test_ambiguous_postings_offset_matches_jax(pdb, tpdb, mp, j):
    """Plain P2 on edge-range shard ``j`` against the ambiguity block of
    ``PostingsShardedPlacement``'s ``_step_amb`` (``postings_sharded.py:
    170-180``): the alternatives' rows and the window contributions."""
    bounds, t = shard_db_by_edge(tpdb, mp, 4)
    reads = [r[:10] + "N" + r[11:] for r in plain_reads(12, 30, seed=6)]
    reads += [pdb.alphabet.kmer_to_string(int(x), pdb.k) * 5
              for x in pdb.keys[:4]]
    reads[-1] = reads[-1][:7] + "R" + reads[-1][8:]
    host, a, pairs, H, lens = _shard_batch(tpdb, t, bounds, j, reads)
    off = int(bounds[j])
    lr, hr = host["alt_lrows"], host["alt_hrows"]
    got = T.alt_delta_rows_postings(torch.from_numpy(pairs),
                                    torch.from_numpy(H), torch.from_numpy(lr),
                                    torch.from_numpy(hr), off,
                                    layout=T.LightLayout(4, False))
    g = jnp.asarray(pairs)[lr]
    P = g.shape[1] // 2
    W = H.shape[1]
    e_loc = jnp.clip(g[:, :P] - off, 0, W - 1)
    d = jax.lax.bitcast_convert_type(g[:, P:], jnp.float32)
    want = jnp.asarray(H)[hr].at[jnp.arange(e_loc.shape[0])[:, None],
                                 e_loc].add(d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert (got.numpy() > 0).sum() > 0
    _, alt_win, win_read, inv_w, is_mean = a
    contrib = T.ambiguous_pass(
        got, torch.from_numpy(alt_win.astype(np.int64)),
        torch.from_numpy(win_read.astype(np.int64)),
        torch.from_numpy(inv_w), torch.from_numpy(is_mean),
        torch.zeros((len(reads), W)))
    jc = J.ambiguous_contrib(want, jnp.asarray(alt_win), jnp.asarray(inv_w),
                             jnp.asarray(is_mean))
    jacc = jnp.zeros((len(reads), W)).at[jnp.asarray(win_read)].add(jc)
    np.testing.assert_allclose(contrib.numpy(), np.asarray(jacc), atol=2e-4)


@pytest.mark.parametrize("mp, K_in, keep", [(2, 7, 7), (4, 3, 7),
                                            (8, 7, 7), (3, 2, 5)])
def test_merge_candidates_matches_jax_tail(mp, K_in, keep):
    """Plain M1 against the JAX step's tail on the same candidates: the
    tiled all-gather, ``lax.top_k`` (ties to the lower index, so the lower
    shard), the LWR and the psum of ``|L|`` (``postings_sharded.py:
    192-206``), with many exact ties."""
    rng = np.random.default_rng(mp * 10 + K_in)
    B = 64
    ts = -np.sort(-(rng.integers(0, 12, (mp, B, K_in)) * 0.5 - 20.0)
                  .astype(np.float32), axis=2)
    n_valid = rng.integers(0, K_in + 1, (mp, B))
    ts[np.arange(K_in)[None, None, :] >= n_valid[..., None]] = -np.inf
    te = np.where(np.isfinite(ts), rng.integers(0, 1000, (mp, B, K_in)), -1)
    nm = n_valid + rng.integers(0, 4, (mp, B))
    # the tiled all-gather over mp: shard j's candidates at columns j*K_in..
    ts_all = np.concatenate(list(ts), axis=1)
    te_all = np.concatenate(list(te), axis=1)
    got = T.merge_candidates(torch.from_numpy(te_all),
                             torch.from_numpy(ts_all),
                             torch.from_numpy(nm), keep)
    top_s, ti = jax.lax.top_k(jnp.asarray(ts_all), keep)
    top_e = jnp.take_along_axis(jnp.asarray(te_all), ti, axis=1)
    valid = jnp.isfinite(top_s)
    w = jnp.where(valid, jnp.exp2(
        (top_s - top_s[:, :1]) * np.float32(np.log2(10.0))), 0.0)
    lwr = w / jnp.maximum(w.sum(axis=1, keepdims=True), 1e-30)
    want = (jnp.where(valid, top_e, -1), top_s, lwr, nm.sum(axis=0))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-6)
    assert np.array_equal(got[3].numpy(), want[3])
    # the wire form: pack the shards' wires, merge, decode
    wide = False
    wires = torch.stack([T.pack_wire(
        torch.from_numpy(te[j].astype(np.int32)), torch.from_numpy(ts[j]),
        torch.zeros(B, K_in), torch.from_numpy(nm[j].astype(np.int32)))
        for j in range(mp)])
    e, s, n = T.wire_fields(T.merge_candidates_wire(wires, K_in, keep, wide),
                            keep, wide)
    assert np.array_equal(e.numpy(), np.asarray(want[0]))
    assert np.array_equal(s.numpy(), np.asarray(want[1]))
    assert np.array_equal(n.numpy(), want[3])
