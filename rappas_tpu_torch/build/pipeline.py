"""DB-build pipeline: from (reference alignment, reference tree) to a
:class:`rappas_tpu_torch.db.PhyloKmerDB`, the same DB, bit for bit, as
``rappas_tpu.build.pipeline`` builds.

Orchestration mirrors the reference's ``main_v2/Main_DBBUILD_3.java``:

1. load + optionally gap-reduce the alignment (``:210-236``);
2. decide gap-jump activation from the gap ratio (``:240-261``);
3. parse the original tree, root it if requested, cross-check labels,
   assign jplace edge ids (``:263-309``);
4. inject ghost nodes, extend the alignment with gap-only rows, write the
   ``extended_trees/`` artifacts (``:325-383``);
5. run (or reuse via ``ar_dir``) the external AR program (``:412-447``);
6. parse AR outputs (``:460-483``);
7. enumerate phylo-kmers per ghost node and max-merge into the DB
   (``:596-755``).

The k-mer generation runs on the host: the vectorised frontier explorer
batched over ghost nodes, or the native exact explorer when gap jumps are
active (see ``rappas_tpu_torch.build.explorer``); there is no fallback
to the Python recursion.  :data:`LAST_BUILD` holds the host seconds of
the last build's stages and its counts.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch

from rappas_tpu_torch.alignment import Alignment
from rappas_tpu_torch.alphabet import get_alphabet
from rappas_tpu_torch.ar.launcher import ARLauncher
from rappas_tpu_torch.ar.results import ARResults, parse_ar_outputs
from rappas_tpu_torch.build.explorer import explore_node, sort_probas_desc
from rappas_tpu_torch.db import PhyloKmerDB, build_csr, max_merge_tuples
from rappas_tpu_torch.extend import extend_tree
from rappas_tpu_torch.models import EvolModel
from rappas_tpu_torch.native import _we_lib, explore_node_exact_native
from rappas_tpu_torch.seqio import read_fasta
from rappas_tpu_torch.tree import Tree, parse_newick, write_newick
from rappas_tpu_torch.utils import log

#: the last :func:`build_database`'s host seconds per stage (``inputs_s``:
#: alignment, trees, extended artifacts; ``ar_s``: the AR run or the
#: ``--ardir`` check, then the parse of its outputs; ``kmers_s``: the
#: enumeration and the max-merge into the CSR; ``save_s``) and counts
#: (``nodes``: nodes tested, ``raw_tuples``: k-mers enumerated before the
#: merge)
LAST_BUILD: dict = {}


@dataclasses.dataclass
class BuildConfig:
    k: int = 8
    omega: float = 1.5
    states: str = "nucl"
    #: ghost nodes injected per branch (``ArgumentsParser_v2.java:53``)
    ghosts: int = 1
    reduction: bool = True
    reduction_ratio: float = 0.99
    #: write the reduced alignment copy to this path (default
    #: ``workdir/align.reduced``).  NOTE: despite the reference help
    #: text ("Write reduced alignment to file"), its pipeline ALWAYS
    #: writes the reduced copy when reduction is on, defaulting to
    #: ``workdir/align.reduced``; ``--write-reduction FILE`` only
    #: overrides the destination (``Main_DBBUILD_3.java:227-234``).
    #: This implementation matches that live behavior exactly.
    reduced_align_file: str | None = None
    model: EvolModel | None = None
    ar_binary: str | None = None
    ar_dir: str | None = None          # reuse existing AR outputs
    ar_parameters: str | None = None
    threads: int = 1
    force_rooting: bool = False        # --force-root
    use_unrooted: bool = False
    only_fake_nodes: bool = True
    only_x1_nodes: bool = False
    do_gap_jumps: bool = False         # --force-gap-jump / --do-n-jumps
    limit_to_1_jump: bool = True
    gap_jump_threshold: float = 0.3
    #: stop-early debug modes (``--aronly`` / ``--arinputonly``)
    only_ar: bool = False
    only_ar_input: bool = False
    #: force the exact sequential explorer even without gap jumps
    exact_explorer: bool = False
    db_filename: str | None = None
    #: fold U->C and O->L in amino alignments (--convertUO,
    #: AAStates.java:118-123)
    convert_uo: bool = False
    #: ``--dbinram``: keep the DB in RAM only -- the reference's flag
    #: places immediately and skips writing DB files entirely
    #: (``Main_DBBUILD_3.java:873-986``)
    save_db: bool = True


def build_database(ref_align_path, ref_tree_path, workdir,
                   config: BuildConfig) -> PhyloKmerDB | None:
    t0 = time.time()
    LAST_BUILD.clear()
    workdir = Path(workdir)
    ext_dir = workdir / "extended_trees"
    ar_path = Path(config.ar_dir) if config.ar_dir else workdir / "AR"
    logs_dir = workdir / "logs"
    for d in (workdir, ext_dir, logs_dir):
        d.mkdir(parents=True, exist_ok=True)

    alphabet = get_alphabet(config.states, convert_uo=config.convert_uo)
    model = config.model or EvolModel.default(alphabet.name)

    # ---------------------------------------------------------------- #
    # 1. alignment
    align = Alignment.from_records(alphabet,
                                   list(read_fasta(ref_align_path)))
    log(f"alignment: {align.n_rows} rows x {align.length} cols")
    if config.reduction:
        before = align.length
        align = align.reduce(config.reduction_ratio)
        log(f"gap-column reduction @{config.reduction_ratio}: "
            f"{before} -> {align.length} cols")
        reduced_path = Path(config.reduced_align_file) if \
            config.reduced_align_file else workdir / "align.reduced"
        align.write_fasta(reduced_path)

    # 2. gap jumps (Main_DBBUILD_3.java:240-261)
    gap_jumps = config.do_gap_jumps
    if not gap_jumps:
        ratio = align.gap_ratio()
        gap_jumps = ratio >= config.gap_jump_threshold
        log(f"gap ratio {ratio:.4f} -> gap jumps "
            f"{'activated' if gap_jumps else 'off'}")

    # ---------------------------------------------------------------- #
    # 3. original tree
    tree_text = Path(ref_tree_path).read_text()
    tree_line = [ln for ln in tree_text.splitlines() if ln.strip()][-1]
    original = parse_newick(tree_line, force_rooting=config.force_rooting)
    if not original.rooted and not config.use_unrooted:
        raise SystemExit(
            "This reference tree is unrooted. The newick trifurcation can "
            "be used as root; confirm with --use_unrooted (placement "
            "accuracy may be affected).")
    # label cross-check (Main_DBBUILD_3.java:288-300)
    tree_labels = {n.label for n in original.nodes}
    missing = [lb for lb in align.labels if lb not in tree_labels]
    if missing:
        raise SystemExit(
            f"Alignment/tree labels do not match (first missing: "
            f"{missing[0]!r})")
    original.reset_jplace_edge_ids()

    # ---------------------------------------------------------------- #
    # 4. ghost injection + extended artifacts
    log("injecting ghost nodes...")
    extended = extend_tree(original, n_ghosts=config.ghosts)
    fake_labels = [n.label for n in extended.fake_leaves]
    ext_align = align.add_gap_rows(fake_labels)
    f_fasta = ext_dir / "extended_align.fasta"
    f_phylip = ext_dir / "extended_align.phylip"
    f_tree = ext_dir / "extended_tree_withBL.tree"
    f_tree_nolabel = ext_dir / "extended_tree_withBL_withoutInterLabels.tree"
    ext_align.write_fasta(f_fasta)
    ext_align.write_phylip(f_phylip)
    f_tree.write_text(write_newick(extended, True, True, False, False))
    f_tree_nolabel.write_text(write_newick(extended, True, False, False,
                                           False))
    with open(ext_dir / "extended_tree_node_mapping.tsv", "w") as f:
        f.write("original_id\toriginal_name\textended_id\textended_name")
        for ext_id, orig_id in extended.fake_to_original.items():
            f.write(f"\n{orig_id}\t{original.by_id(orig_id).label}\t"
                    f"{ext_id}\t{extended.by_id(ext_id).label}")

    LAST_BUILD["inputs_s"] = time.time() - t0

    # ---------------------------------------------------------------- #
    # 5. AR
    t1 = time.time()
    if config.ar_binary is None and config.ar_dir is None:
        raise SystemExit("need --arbinary (or --ardir with existing AR "
                         "outputs)")
    launcher = ARLauncher(config.ar_binary or "phyml", model,
                          config.ar_parameters, config.threads)
    if config.only_ar_input:
        ar_path.mkdir(parents=True, exist_ok=True)
        com = launcher.build_command(ar_path, f_phylip, f_tree_nolabel)
        (ar_path / "ar_command.txt").write_text(" ".join(com) + "\n")
        log("only AR inputs were requested, pipeline stopped")
        return None
    if config.ar_dir is None:
        ar_path.mkdir(parents=True, exist_ok=True)
        log(f"launching ancestral reconstruction ({launcher.program})...")
        launcher.launch(ar_path, f_phylip, f_tree_nolabel)
    else:
        log(f"reusing AR outputs from {ar_path}")
    # sanity-gate the AR outputs on BOTH paths: the reference parses
    # PhyML stats and aborts with an actionable error on malformed
    # output (ARProcessLauncher.java:302-314,737-797); a truncated
    # fresh run (disk full, OOM-killed AR) must fail here with the
    # leaf-set/site-count mismatch spelled out, not as a downstream
    # parser error
    launcher.validate_existing(ar_path, f_phylip,
                               set(ext_align.labels),
                               ext_align.length)

    # ---------------------------------------------------------------- #
    # 6. parse AR outputs
    log("parsing ancestral reconstruction results...")
    ar = parse_ar_outputs(launcher, ar_path, f_phylip, extended,
                          original.rooted, ext_align.length, alphabet)
    with open(ar_path / "ARtree_id_mapping.tsv", "w") as f:
        f.write("extended_id\textended_label\tARTree_id\tARtree_label")
        for ar_id, ext_id in ar.ar_to_extended.items():
            f.write(f"\n{ext_id}\t{extended.by_id(ext_id).label}\t"
                    f"{ar_id}\t{ar.ar_tree.by_id(ar_id).label}")
    LAST_BUILD["ar_s"] = time.time() - t1
    if config.only_ar:
        log("only AR was requested, pipeline stopped")
        return None

    # ---------------------------------------------------------------- #
    # 7. k-mer enumeration
    t1 = time.time()
    db = generate_kmers(ar, extended, ext_align, original, alphabet,
                        config, gap_jumps)
    LAST_BUILD["kmers_s"] = time.time() - t1
    if not config.only_fake_nodes:
        db.meta["orinodes_resolution"] = orinodes_resolution_table(
            ar, extended, original)
    db.meta.update({
        "only_fake_nodes": config.only_fake_nodes,
        "build_seconds": round(time.time() - t0, 3),
        "gap_jumps": bool(gap_jumps),
        "ghosts": config.ghosts,
        "ar_program": launcher.program,
        "model": model.name,
        "reduction_ratio": config.reduction_ratio if config.reduction
        else None,
        "extended_tree_newick": write_newick(extended, True, True, False,
                                             False),
    })
    if not config.save_db:
        # --dbinram: the reference keeps the DB in RAM, places
        # immediately and never writes DB files (Main_DBBUILD_3.java:
        # 873-986); match that contract exactly
        log(f"DB built in RAM (--dbinram, not persisted): {db.n_kmers} "
            f"kmers, {db.nnz} postings, {time.time() - t0:.1f}s total")
        return db
    name = config.db_filename or f"DB_k{config.k}_o{config.omega}.rptpu"
    if not name.endswith(".rptpu"):
        name += ".rptpu"
    out = workdir / name
    t1 = time.time()
    db.save(out)
    LAST_BUILD["save_s"] = time.time() - t1
    log(f"DB saved: {out} ({db.n_kmers} kmers, {db.nnz} postings, "
        f"{time.time() - t0:.1f}s total)")
    return db


def orinodes_resolution_table(ar: ARResults, extended,
                              original: Tree) -> dict:
    """Ghost-neighbor resolution table for ``--original-nodes`` DBs.

    The reference resolves a best edge that is an *original* node to an
    adjacent ghost at placement time (``PlacementProcess.java:856-916``):
    ``secondBestNodeId`` is never assigned in ``processQueries`` (always
    -1), so the live path is ALWAYS the arbitrary child-0 fallback --
    ``ARTree.getById(best).getChildAt(0)`` (``:880-884``), whose extended
    counterpart must be a ghost X0 -- then maps it back through
    ``nodeMapping`` / ``getFakeToOriginalId``.  The ported
    ``Tree.shortest_path`` exists for the dead branch; the live decision
    is precomputed here as a per-node table stored in the DB.

    For each original-tree node id this returns
    ``[ar_id, ar_label, ext_id, ext_label, resolved_original_id]`` of
    the chosen ghost.  Deviation (documented): when the best node is a
    *leaf* edge the reference crashes (``getChildAt(0)`` on a leaf);
    here the leaf resolves to the X0 ghost on its own edge (the ghost
    whose postings produced the hit).
    """
    ext_to_ar = {e: a for a, e in ar.ar_to_extended.items()}
    table = {}
    for node in original.nodes:
        ext_node = extended.by_id(node.id)
        ghost_ext = None
        if not node.is_leaf:
            # the reference's child-0 choice (:884), hardened: if the AR
            # program reordered children so child 0 is not a ghost, take
            # the first ghost child ("Something went wrong in neighboor
            # node search" exit, PlacementProcess.java:905-908, would
            # otherwise fire per read at placement)
            ar_node = ar.ar_tree.by_id(ext_to_ar[node.id])
            for child in ar_node.children:
                cand = extended.by_id(ar.ar_to_extended[child.id])
                if cand.is_fake:
                    ghost_ext = cand
                    break
        if ghost_ext is None and ext_node.parent is not None and \
                ext_node.parent.is_fake:
            # leaf edge (reference crashes here: getChildAt(0) on a
            # leaf) -- resolve to the X0 ghost on the node's own edge
            ghost_ext = ext_node.parent
        if ghost_ext is None:
            continue          # unresolvable: placement reports raw ids
        ar_id = ext_to_ar[ghost_ext.id]
        table[str(node.id)] = [
            int(ar_id), ar.ar_tree.by_id(ar_id).label,
            int(ghost_ext.id), ghost_ext.label,
            int(extended.fake_to_original_id(ghost_ext.id))]
    return table


def generate_kmers(ar: ARResults, extended, ext_align, original: Tree,
                   alphabet, config: BuildConfig,
                   gap_jumps: bool) -> PhyloKmerDB:
    """Step 7: the node loop (``Main_DBBUILD_3.java:648-755``)."""
    thr = PhyloKmerDB.threshold(config.k, config.omega, alphabet.n_states)
    if config.only_fake_nodes:
        nodes = ar.ghost_nodes(extended, only_x1=config.only_x1_nodes)
    else:
        nodes = [n.id for n in ar.ar_tree.nodes if not n.is_leaf]
    log(f"{len(nodes)} nodes tested, threshold log10={float(thr):.6f}")

    # posterior coverage gate: unparsed rows stay NaN
    # (rappas_tpu_torch.ar.wrappers) and a node with NaN posteriors would
    # silently emit zero k-mers -- a PARTIALLY covered node means a
    # truncated AR output and must abort (the reference's analog:
    # parsed-output sanity checks, ARProcessLauncher.java:302-314).
    # Nodes the AR program never reports at all (e.g. the re-rooting
    # surgery's added_root, which PhyML has no posteriors for) are
    # skipped like the reference's loop over parsed results.
    partial, absent = [], []
    for nid in nodes:
        site_nan = np.isnan(ar.probas[nid]).any(axis=-1)
        if site_nan.all():
            absent.append(nid)
        elif site_nan.any():
            partial.append(nid)
    if partial:
        nid = partial[0]
        lbl = ar.ar_tree.by_id(nid).label
        raise SystemExit(
            f"AR posteriors are incomplete: {len(partial)} of "
            f"{len(nodes)} tested nodes have missing per-site "
            f"probabilities (first: AR node {nid} {lbl!r}). The AR "
            "output is truncated or belongs to different inputs; re-run "
            "ancestral reconstruction.")
    if absent:
        labels = [ar.ar_tree.by_id(n).label for n in absent[:3]]
        log(f"{len(absent)} node(s) without AR posteriors skipped "
            f"(not reported by the AR program): {labels}")
        absent_set = set(absent)
        nodes = [n for n in nodes if n not in absent_set]

    use_exact = gap_jumps or config.exact_explorer
    gap_intervals = ext_align.gap_intervals() if use_exact else None
    if use_exact:
        # the native explorer (bit-identical to explore_node_exact,
        # ~1000x faster); built here, before the workers start, so that a
        # missing toolchain fails the build instead of falling back to
        # the Python recursion
        _we_lib()

    # Bucketed two-phase merge.  Workers explore AND dedup their own
    # node (torch sort releases the GIL, so dedup runs in parallel with
    # other nodes' exploration); the consumer splits each node's
    # code-sorted tuples into NB code-range buckets with one
    # searchsorted (no re-sort); buckets compact independently when
    # oversized and merge independently at the end.  Concatenating the
    # merged buckets in range order yields a globally (code, edge)-
    # sorted unique stream, so CSR assembly is a boundary scan with no
    # final sort.  This replaced an accumulate-and-refold design whose
    # re-folds re-sorted the whole accumulated set (quadratic: a
    # 1000-taxon k=12 build spent hours folding); the reference instead
    # leans on GC + hash trimming at >80% heap (Main_DBBUILD_3.java:
    # 676-683, 8-16 GB heaps).
    space = alphabet.n_states ** config.k
    NB = 32
    bounds = (np.arange(1, NB, dtype=np.int64) * space) // NB
    b_codes = [[] for _ in range(NB)]
    b_edges = [[] for _ in range(NB)]
    b_sums = [[] for _ in range(NB)]
    b_pending = [0] * NB
    #: per-bucket compaction cap (~1.2 GB of tuples): bounds any one
    #: bucket's working set for builds bigger than the k=12/1000-taxon
    #: regime without ever re-sorting the whole accumulation
    bucket_cap = 75_000_000

    def explore_one(node_id: int):
        P = ar.probas[node_id]
        if use_exact:
            states_sorted, pp_sorted = sort_probas_desc(P)
            codes, sums = explore_node_exact_native(
                states_sorted, pp_sorted, config.k, thr,
                gap_intervals=gap_intervals, do_gap_jumps=gap_jumps,
                limit_to_1_jump=config.limit_to_1_jump)
        else:
            codes, sums = explore_node(P, config.k, thr)
        raw_n = codes.size
        if raw_n == 0:
            return codes.astype(np.int64, copy=False), sums, 0
        # per-node dedup: multiple start positions emit the same k-mer;
        # keep the max (one edge per node); output sorted by code
        sc, order = torch.sort(torch.from_numpy(
            codes.astype(np.int64, copy=False)))
        c = sc.numpy()
        s = sums[order.numpy()]
        first = np.ones(c.shape[0], bool)
        np.not_equal(c[1:], c[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        s = np.maximum.reduceat(s, starts)
        c = c[starts]
        return c, s, raw_n

    def fold_bucket(b: int):
        c, e, s = max_merge_tuples(np.concatenate(b_codes[b]),
                                   np.concatenate(b_edges[b]),
                                   np.concatenate(b_sums[b]))
        b_codes[b] = [c]
        b_edges[b] = [e]
        b_sums[b] = [s]
        b_pending[b] = c.size

    n_workers = min(8, os.cpu_count() or 1)
    raw_total = 0
    t0 = time.time()
    tick = max(1, len(nodes) // 10)
    with cf.ThreadPoolExecutor(n_workers) as pool:
        # bounded sliding window: pool.map would queue every node up
        # front and buffer results without limit whenever the consumer
        # stalls on a compaction
        window = n_workers * 4
        inflight = {i: pool.submit(explore_one, nodes[i])
                    for i in range(min(window, len(nodes)))}
        for count in range(len(nodes)):
            c, s, raw_n = inflight.pop(count).result()
            nxt = count + window
            if nxt < len(nodes):
                inflight[nxt] = pool.submit(explore_one, nodes[nxt])
            raw_total += raw_n
            if c.size:
                ext_id = ar.ar_to_extended[nodes[count]]
                orig_id = extended.fake_to_original_id(ext_id)
                cuts = [0, *np.searchsorted(c, bounds), c.size]
                for b in range(NB):
                    lo, hi = cuts[b], cuts[b + 1]
                    if hi > lo:
                        b_codes[b].append(c[lo:hi])
                        b_sums[b].append(s[lo:hi])
                        b_edges[b].append(
                            np.full(hi - lo, orig_id, np.int32))
                        b_pending[b] += hi - lo
                        if b_pending[b] > bucket_cap:
                            fold_bucket(b)
            if (count + 1) % tick == 0:
                log(f"  node {count + 1}/{len(nodes)} "
                    f"({time.time() - t0:.1f}s, "
                    f"{sum(b_pending) / 1e6:.0f}M tuples held)")

    def merge_bucket(b: int):
        if not b_codes[b]:
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        if len(b_codes[b]) == 1:  # already deduped by a fold
            return b_codes[b][0], b_edges[b][0], b_sums[b][0]
        return max_merge_tuples(np.concatenate(b_codes[b]),
                                np.concatenate(b_edges[b]),
                                np.concatenate(b_sums[b]))

    # 2 threads: torch sort is itself multi-threaded; this just overlaps
    # its single-threaded numpy pre/post passes
    with cf.ThreadPoolExecutor(2) as pool:
        parts = list(pool.map(merge_bucket, range(NB)))
    codes = np.concatenate([p[0] for p in parts])
    edges = np.concatenate([p[1] for p in parts])
    sums = np.concatenate([p[2] for p in parts])
    if codes.size == 0:
        raise SystemExit("Something went wrong... hash is empty!")
    keys, offsets, e, deltas = build_csr(codes, edges, sums, thr,
                                         presorted=True)
    LAST_BUILD.update(nodes=len(nodes), raw_tuples=raw_total)
    log(f"postings: {raw_total} raw tuples -> {e.size} after max-merge, "
        f"{keys.size} kmers")
    return PhyloKmerDB(
        k=config.k, omega=config.omega, alphabet=alphabet,
        thr_log10=thr, tree=original, keys=keys, offsets=offsets,
        edges=e, deltas=deltas, meta={})
