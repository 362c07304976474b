"""Parsers for AR program outputs -> (AR tree, posterior tensor).

Reference parsers:
``inputs/PHYMLWrapper.java`` (TSV
``Site\\tNode\\tA C G T...``), ``RAXMLNGWrapper.java`` (TSV
``Node\\tSite\\tState\\tp_A...``), ``PAMLWrapper.java`` (the ``rst`` file).

All parsers produce ``P[node_id, n_sites, n_states] float32`` holding
``log10(max(pp, clamp))`` in the *canonical* state order of our alphabet
(see ``rappas_tpu_torch.alphabet``), indexed by AR-tree node id.  Leaf /
unreported rows stay NaN.
"""

from __future__ import annotations

import re

import numpy as np

from rappas_tpu_torch.alphabet import Alphabet
from rappas_tpu_torch.tree import Tree, parse_newick

#: clamp for site posterior probabilities; the reference uses
#: ``Float.MIN_VALUE`` = 2^-149 (``ARResults.java:127,161,194``).
SITE_PP_CLAMP = float(np.float32(1.401298464324817e-45))


def _read_last_tree_line(text: str) -> str:
    tree_line = None
    for line in text.splitlines():
        if line.strip():
            tree_line = line
    if tree_line is None:
        raise ValueError("no tree found")
    return tree_line


def reroot_ar_newick(newick: str) -> str:
    """Reverse AR unrooting of a rooted input tree at the string level.

    PhyML/RAxML-ng turn ``((C1,C2)node,C3)root;`` into
    ``(C3,C1,C2)newick_root;``.  The reference reorders the top-level
    clades to ``(C1,C2,C3)newick_root;`` before re-applying the standard
    forced-rooting transform (``PHYMLWrapper.java:69-119``).
    """
    s = _read_last_tree_line(newick)
    # find the closing paren of the top-level clade
    clade_close = s.rfind(")")
    clades: list[str] = []
    depth = 0
    start = 1
    for i, c in enumerate(s):
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        if (depth == 1 and c == ",") or (depth == 0 and i == clade_close):
            if i > 0:
                clades.append(s[start:i])
            start = i + 1
    root_payload = s[start:]
    if len(clades) != 3:
        raise ValueError(
            f"expected trifurcation at AR tree root, got {len(clades)} "
            "clades")
    return "(" + clades[1] + "," + clades[2] + "," + clades[0] + ")" + \
        root_payload


def parse_ar_tree(text: str, reroot: bool) -> Tree:
    """Parse the AR output tree; optionally reverse the AR unrooting."""
    line = _read_last_tree_line(text)
    if reroot:
        return parse_newick(reroot_ar_newick(line), force_rooting=True)
    return parse_newick(line, force_rooting=False)


def _alloc_probas(tree: Tree, n_sites: int, alphabet: Alphabet):
    n = tree.max_id() + 1
    return np.full((n, n_sites, alphabet.n_states), np.nan, np.float32)


def _finalize(p_linear: np.ndarray) -> np.ndarray:
    """Clamp + log10, float32 like the reference
    (``PHYMLWrapper.java:216-221``)."""
    out = np.maximum(p_linear, np.float32(SITE_PP_CLAMP))
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log10(out, dtype=np.float32)


# ====================================================================== #
# PhyML
# ====================================================================== #

def parse_phyml_probas(text: str, tree: Tree, n_sites: int,
                       alphabet: Alphabet) -> np.ndarray:
    """Parse ``*_phyml_ancestral_seq.txt``.

    Format (``PHYMLWrapper.java:163-229``): a header line starting with
    ``Site\\tNode`` whose remaining tab-separated fields name the state
    columns (plus an optional trailing ``MPEE`` column), then one row per
    (site, node): ``site\\tnode_label\\tp_1..p_S[\\tMPEE]``.  Site is
    1-based.
    """
    lines = text.splitlines()
    state_cols: list[int] | None = None
    rows_site: list[int] = []
    rows_node: list[int] = []
    rows_p: list[list[str]] = []
    label_to_id = {}
    started = False
    for line in lines:
        if line.startswith("Site\tNode"):
            fields = line.split("\t")
            state_chars = [f.strip() for f in fields[2:]
                          if f.strip() and f.strip() != "MPEE"]
            state_cols = [int(alphabet.char_to_code[ord(c[0])])
                          for c in state_chars]
            started = True
            continue
        if not started or not line.strip():
            continue
        data = line.split("\t")
        label = data[1].strip()
        nid = label_to_id.get(label)
        if nid is None:
            nid = tree.by_label(label).id
            label_to_id[label] = nid
        site = int(data[0].strip())
        if site > n_sites:
            raise ValueError(
                "phyML AR output contains more sites than the reference "
                "alignment -- was AR run on the same alignment?")
        rows_site.append(site - 1)
        rows_node.append(nid)
        rows_p.append(data[2:2 + len(state_cols)])
    if state_cols is None:
        raise ValueError("no 'Site\\tNode' header in phyml ancestral file")
    P = _alloc_probas(tree, n_sites, alphabet)
    vals = np.array(rows_p, dtype=np.float32)
    # state_cols[j] = canonical code of column j; scatter accordingly
    canon = np.empty_like(vals)
    for j, code in enumerate(state_cols):
        canon[:, code] = vals[:, j]
    P[np.array(rows_node), np.array(rows_site), :] = _finalize(canon)
    return P


# ====================================================================== #
# RAxML-ng
# ====================================================================== #

def parse_raxmlng_probas(text: str, tree: Tree, n_sites: int,
                         alphabet: Alphabet) -> np.ndarray:
    """Parse ``*.raxml.ancestralProbs``.

    Format (``RAXMLNGWrapper.java:120-231``): header
    ``Node\\tSite\\tState\\tp_A\\tp_C...`` then rows
    ``node_label\\tsite\\tml_state\\tp_1..p_S``.  Site is 1-based; state
    column order comes from the ``p_X`` headers.
    """
    lines = text.splitlines()
    state_cols: list[int] | None = None
    rows_site: list[int] = []
    rows_node: list[int] = []
    rows_p: list[list[str]] = []
    label_to_id = {}
    for line in lines:
        if not line.strip():
            continue
        if line.startswith("Node"):
            fields = line.rstrip("\n").split("\t")
            probs = [f for f in fields if f.startswith("p_")]
            state_cols = [int(alphabet.char_to_code[ord(f[2])])
                          for f in probs]
            continue
        if state_cols is None:
            continue
        data = line.split("\t")
        label = data[0].strip()
        nid = label_to_id.get(label)
        if nid is None:
            nid = tree.by_label(label).id
            label_to_id[label] = nid
        site = int(data[1].strip())
        if site > n_sites:
            raise ValueError("raxml-ng AR output has more sites than the "
                             "reference alignment")
        rows_site.append(site - 1)
        rows_node.append(nid)
        rows_p.append(data[3:3 + len(state_cols)])
    if state_cols is None:
        raise ValueError("no header in raxml-ng ancestralProbs file")
    P = _alloc_probas(tree, n_sites, alphabet)
    vals = np.array(rows_p, dtype=np.float32)
    canon = np.empty_like(vals)
    for j, code in enumerate(state_cols):
        canon[:, code] = vals[:, j]
    P[np.array(rows_node), np.array(rows_site), :] = _finalize(canon)
    return P


# ====================================================================== #
# PAML (baseml / codeml, the `rst` file)
# ====================================================================== #

_PAML_PP_RE = re.compile(r"([A-Z\-])\(([0-9.eE+\-]+)\)")


def parse_paml_tree(rst_text: str, alphabet: Alphabet) -> Tree:
    """Parse the AR tree from a PAML ``rst`` file.

    The reference (``PAMLWrapper.java:76-148``) reads the 1st newick (with
    branch lengths, leaf names) and the 3rd newick (same topology, node
    labels replaced by PAML's node numbers) and renames internal nodes of
    the former to PAML's numbering by matched DFS.  PAML internal node
    numbers are then usable as labels when parsing the "Prob distribs"
    section.
    """
    trees = []
    for line in rst_text.splitlines():
        t = line.strip()
        if t.startswith("(") and t.endswith(";"):
            trees.append(t)
    if len(trees) < 3:
        raise ValueError("could not locate the 3 header trees in rst")
    # PAML writes spaces around labels/branch lengths; normalise
    bl_tree = parse_newick(trees[0].replace(" ", ""), force_rooting=False)
    num_tree = parse_newick(trees[2].replace(" ", ""),
                            force_rooting=False)
    # matched pre-order DFS: same topology, transfer numeric labels
    for a, b in zip(bl_tree.nodes, num_tree.nodes):
        if not a.is_leaf:
            a.label = b.label.strip() if b.label else a.label
    bl_tree.init_indexes()
    return bl_tree


def parse_paml_probas(rst_text: str, tree: Tree, n_sites: int,
                      alphabet: Alphabet) -> np.ndarray:
    """Parse per-node posterior distributions from PAML ``rst``.

    Section "Prob distribution at node X, by site" holds per-site strings
    like ``A(0.972) C(0.006) G(0.018) T(0.004)``; the reference extracts
    them by regex (``PAMLWrapper.java:159-306``).
    """
    P = _alloc_probas(tree, n_sites, alphabet)
    node_re = re.compile(r"Prob distribution at node (\d+), by site")
    cur_node = None
    for line in rst_text.splitlines():
        m = node_re.search(line)
        if m:
            cur_node = tree.by_label(m.group(1)).id
            continue
        if re.match(r"\(\d+\) ", line) or \
                line.startswith("Best amino acids reconstructed"):
            # next rst section (joint reconstruction / codon translation
            # dump): the marginal prob distributions are over
            cur_node = None
            continue
        if cur_node is None:
            continue
        # data rows: "  <site>  <freq>  <data>: A(p) C(p) ..."; states
        # with p < 0.001 are omitted by PAML and default to 0 (then
        # clamped), like the reference's per-site init
        # (PAMLWrapper.java:159-306)
        toks = line.split()
        if not toks or not toks[0].isdigit():
            continue
        site = int(toks[0]) - 1
        pairs = _PAML_PP_RE.findall(line)
        if not pairs:
            continue
        if site < 0 or site >= n_sites:
            # silently dropping would build a wrong DB from a stale
            # --ardir; fail like the other parsers do
            raise ValueError(
                "PAML rst output contains more sites than the reference "
                "alignment -- was AR run on the same alignment?")
        vec = np.zeros(alphabet.n_states, np.float32)
        for ch, p in pairs:
            if ch == "-":
                continue
            code = int(alphabet.char_to_code[ord(ch)])
            if code != 255:
                vec[code] = np.float32(p)
        P[cur_node, site, :] = _finalize(vec)
    return P
