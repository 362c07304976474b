"""Phylogenetic tree model: newick I/O, jplace edge numbering, array views.

Replaces the reference's Swing-based object graph (``PhyloTree extends
JTree``, ``/root/reference/src/tree/PhyloTree.java:28``) with a light
node-object tree for host-side construction plus an immutable
:class:`ArrayTree` (numpy index arrays) for everything compute-facing.

Exactly reproduced reference behaviors (required for jplace parity):

* newick parsing node-id assignment order: internal nodes are numbered when
  their ``(`` opens, leaves when their token closes, scanning left to right
  (``NewickReader.java:76-160``);
* forced rooting of unrooted trees:
  ``(s1,s2,s3)r; -> ((s1,s2)r,s3)added_root;`` with the new root taking the
  next free id (``NewickReader.java:225-256``);
* jplace edge-id numbering: post-order DFS, leaves numbered as encountered,
  an internal node right after its whole subtree, starting at 0
  (``PhyloTree.java:408-439``);
* newick writing with branch lengths printed as the *double* value of the
  stored float, 12 fixed decimals, half-even rounding
  (``NewickWriter.java:57-65`` uses ``NumberFormat`` Locale.UK with
  max=min=12 fraction digits);
* label-based node mapping between topologically identical trees
  (``PhyloTree.java:494-574``).
"""

from __future__ import annotations

import numpy as np
from typing import Optional


class Node:
    """Mutable tree node (host-side construction only)."""

    __slots__ = ("id", "label", "branch_len", "jplace_edge_id", "is_fake",
                 "children", "parent", "bl_to_original_ancestor",
                 "bl_to_original_son")

    def __init__(self, id: int, label: str = "", branch_len: float = 0.0,
                 jplace_edge_id: int = -1, is_fake: bool = False):
        self.id = id
        self.label = label
        # branch length to ancestor; stored as f32 like the reference
        # (PhyloNode.java:26-57 uses float fields)
        self.branch_len = np.float32(branch_len)
        self.jplace_edge_id = jplace_edge_id
        self.is_fake = is_fake
        self.children: list[Node] = []
        self.parent: Optional[Node] = None
        # ghost-node bookkeeping (ExtendedTree, PhyloNode.java:40-43)
        self.bl_to_original_ancestor = np.float32(0.0)
        self.bl_to_original_son = np.float32(0.0)

    def add(self, child: "Node") -> None:
        child.parent = self
        self.children.append(child)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def __repr__(self):
        return f"Node({self.id},{self.label!r})"


class Tree:
    """A rooted-or-unrooted tree of :class:`Node` with reference-identical
    indexing semantics."""

    def __init__(self, root: Node, rooted: bool):
        self.root = root
        self.rooted = rooted
        self._by_id: dict[int, Node] = {}
        self._by_label: dict[str, Node] = {}
        self._dfs_nodes: list[Node] = []
        self.init_indexes()

    # -------------------------------------------------------------- #
    def init_indexes(self) -> None:
        """Pre-order DFS indexing (PhyloTree.initIndexes, :342-381)."""
        self._by_id.clear()
        self._by_label.clear()
        self._dfs_nodes = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            self._by_id[n.id] = n
            self._by_label[n.label] = n
            self._dfs_nodes.append(n)
            stack.extend(reversed(n.children))

    def by_id(self, i: int) -> Node:
        return self._by_id[i]

    def by_label(self, s: str) -> Node:
        return self._by_label[s]

    @property
    def nodes(self) -> list[Node]:
        """All nodes in pre-order DFS."""
        return self._dfs_nodes

    @property
    def leaves(self) -> list[Node]:
        return [n for n in self._dfs_nodes if n.is_leaf]

    @property
    def internal_nodes(self) -> list[Node]:
        return [n for n in self._dfs_nodes if not n.is_leaf]

    def node_count(self) -> int:
        return len(self._dfs_nodes)

    def max_id(self) -> int:
        return max(self._by_id)

    # -------------------------------------------------------------- #
    def reset_jplace_edge_ids(self) -> None:
        """Post-order jplace numbering (PhyloTree.java:408-439)."""
        counter = -1

        def dfs(node: Node):
            nonlocal counter
            for c in node.children:
                if c.is_leaf:
                    counter += 1
                    c.jplace_edge_id = counter
                else:
                    dfs(c)
            counter += 1
            node.jplace_edge_id = counter

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10 * len(self._dfs_nodes) + 1000))
        try:
            dfs(self.root)
        finally:
            sys.setrecursionlimit(old)

    # -------------------------------------------------------------- #
    def map_nodes(self, other: "Tree") -> dict[int, int]:
        """map(self node id) = other tree node id, by shared leaf labels.

        Reference: ``PhyloTree.mapNodes`` (:494-574): leaves map by label;
        an internal node maps via any of its leaf children's parent; root
        maps to root.  Children of the root that are leaves map only
        themselves.
        """
        mapping: dict[int, int] = {}

        def dfs(node: Node):
            for c in node.children:
                dfs(c)
            if node.parent is None:
                return
            if node.parent is self.root:
                if node.is_leaf:
                    mapping[node.id] = other.by_label(node.label).id
            elif node.is_leaf:
                other_leaf = other.by_label(node.label)
                mapping[node.id] = other_leaf.id
                mapping[node.parent.id] = other_leaf.parent.id
            else:
                other_node = other.by_id(mapping[node.id])
                mapping[node.parent.id] = other_node.parent.id

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10 * len(self._dfs_nodes) + 1000))
        try:
            dfs(self.root)
        finally:
            sys.setrecursionlimit(old)
        if (self.rooted and other.rooted) or \
           (not self.rooted and not other.rooted):
            mapping[self.root.id] = other.root.id
        else:
            raise ValueError("cannot map rooted against unrooted tree")
        return mapping

    # -------------------------------------------------------------- #
    def shortest_path(self, a: Node, b: Node):
        """Port of ``PhyloTree.shortestPath`` (PhyloTree.java:586-673).

        Returns ``(path, node_dist, branch_dist)`` where ``path`` is the
        node list from ``a`` to ``b`` (both included; LCA included once),
        ``node_dist`` counts intermediate nodes + the LCA like the
        reference, and ``branch_dist`` is the f32-accumulated branch
        length along the path (same summation order).
        """
        def path_from_root(n: Node) -> list[Node]:
            # DefaultMutableTreeNode.getPath(): [root, ..., n]
            out = []
            while n is not None:
                out.append(n)
                n = n.parent
            return out[::-1]

        pa = path_from_root(a)
        pb = path_from_root(b)
        lca_index = -1
        shortest = min(len(pa), len(pb))
        for i in range(shortest):
            if pa[i] is not pb[i]:
                lca_index = i - 1
                break
        if lca_index == -1:
            lca_index = shortest - 1

        path: list[Node] = []
        branch_dist = np.float32(0.0)
        node_dist = 0
        for i in range(len(pa) - 1, lca_index, -1):
            path.append(pa[i])
            branch_dist = np.float32(branch_dist + pa[i].branch_len)
            if i > lca_index and i != len(pa) - 1:
                node_dist += 1
        for i in range(lca_index, len(pb)):
            path.append(pb[i])
            if i > lca_index:
                branch_dist = np.float32(branch_dist + pb[i].branch_len)
            if i > lca_index and i != len(pb) - 1:
                node_dist += 1
        if len(path) > 1:
            node_dist += 1   # the LCA itself (PhyloTree.java:661-662)
        return path, node_dist, float(branch_dist)

    # -------------------------------------------------------------- #
    def copy(self) -> "Tree":
        def cp(n: Node) -> Node:
            m = Node(n.id, n.label, float(n.branch_len), n.jplace_edge_id,
                     n.is_fake)
            m.bl_to_original_ancestor = n.bl_to_original_ancestor
            m.bl_to_original_son = n.bl_to_original_son
            for c in n.children:
                m.add(cp(c))
            return m

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10 * len(self._dfs_nodes) + 1000))
        try:
            root = cp(self.root)
        finally:
            sys.setrecursionlimit(old)
        return Tree(root, self.rooted)

    # -------------------------------------------------------------- #
    def to_arrays(self) -> "ArrayTree":
        return ArrayTree.from_tree(self)


class ArrayTree:
    """Immutable tensor view of a tree, indexed by node id.

    Node ids are dense-ish small ints (assigned by the newick parser /
    ghost injection); arrays are sized ``max_id + 1`` and indexed directly
    by node id -- exactly how the reference indexes its score arrays
    (``PlacementProcess.java:493-496``).
    """

    def __init__(self, parent, branch_len, jplace_edge_id, is_leaf, is_fake,
                 labels, root_id, rooted, dfs_order):
        self.parent = parent                  # int32[n], -1 for root
        self.branch_len = branch_len          # float32[n]
        self.jplace_edge_id = jplace_edge_id  # int32[n], -1 if unset
        self.is_leaf = is_leaf                # bool[n]
        self.is_fake = is_fake                # bool[n]
        self.labels = labels                  # list[str] ('' for unused ids)
        self.root_id = root_id
        self.rooted = rooted
        self.dfs_order = dfs_order            # int32[m] pre-order node ids

    @classmethod
    def from_tree(cls, tree: Tree) -> "ArrayTree":
        n = tree.max_id() + 1
        parent = np.full(n, -1, np.int32)
        bl = np.zeros(n, np.float32)
        jp = np.full(n, -1, np.int32)
        leaf = np.zeros(n, bool)
        fake = np.zeros(n, bool)
        labels = [""] * n
        order = []
        for node in tree.nodes:
            i = node.id
            order.append(i)
            parent[i] = node.parent.id if node.parent is not None else -1
            bl[i] = node.branch_len
            jp[i] = node.jplace_edge_id
            leaf[i] = node.is_leaf
            fake[i] = node.is_fake
            labels[i] = node.label
        return cls(parent, bl, jp, leaf, fake, labels, tree.root.id,
                   tree.rooted, np.array(order, np.int32))

    @property
    def n_ids(self) -> int:
        return self.parent.shape[0]


# ====================================================================== #
# Newick parsing (reference id-assignment order)
# ====================================================================== #

def parse_newick(s: str, force_rooting: bool = False,
                 jplace_edge_ids: bool = False) -> Tree:
    """Parse a newick string with reference-identical node-id numbering.

    Ids: an internal node takes the next id when its ``(`` opens; a leaf
    takes the next id when its ``label:bl`` token terminates (at ``,`` or
    ``)``), scanning left to right (``NewickReader.java:76-160``).

    ``jplace_edge_ids``: accept ``{x}`` edge labels after branch lengths
    (``NewickReader.java:92-101``).

    ``force_rooting``: if the top level has 3+ children (unrooted), apply
    ``(s1,s2,s3)r; -> ((s1,s2)r,s3)added_root;`` with the added root taking
    the next free id (``NewickReader.java:225-256``).
    """
    s = s.strip()
    if not s.endswith(";"):
        raise ValueError("newick string must end with ';'")

    counter = -1

    def next_id() -> int:
        nonlocal counter
        counter += 1
        return counter

    def parse_payload(tok: str):
        """Split 'label:bl{jp}' -> (label, bl, jplace_id)."""
        if ":" in tok:
            label, blpart = tok.split(":", 1)
        else:
            label, blpart = tok, None
        bl = 0.0
        jp = -1
        if blpart is not None:
            if jplace_edge_ids and "{" in blpart:
                ob = blpart.index("{")
                jp = int(blpart[ob + 1:blpart.index("}")])
                bl = float(np.float32(blpart[:ob]))
            else:
                bl = float(np.float32(blpart))
        return label, bl, jp

    # iterative scanner mirroring the reference's stack parser
    stack: list[Node] = []        # open internal nodes
    children: list[list[Node]] = [[]]  # children collected per depth
    i = 0
    buf = []
    last_internal: Optional[Node] = None  # node closed by the last ')'
    pending_internal = False  # True if buf belongs to last_internal
    root: Optional[Node] = None

    while i < len(s):
        c = s[i]
        if c == "(":
            stack.append(Node(next_id()))
            children.append([])
            buf = []
            pending_internal = False
        elif c in ",)" :
            tok = "".join(buf)
            if pending_internal:
                label, bl, jp = parse_payload(tok) if tok else ("", 0.0, -1)
                if tok:
                    last_internal.label = label
                    last_internal.branch_len = np.float32(bl)
                    last_internal.jplace_edge_id = jp
                children[-1].append(last_internal)
                pending_internal = False
            elif tok:
                label, bl, jp = parse_payload(tok)
                leaf = Node(next_id(), label, bl, jp)
                children[-1].append(leaf)
            buf = []
            if c == ")":
                node = stack.pop()
                for ch in children.pop():
                    node.add(ch)
                last_internal = node
                pending_internal = True
        elif c == ";":
            tok = "".join(buf)
            if pending_internal and tok:
                label, bl, jp = parse_payload(tok)
                last_internal.label = label
                last_internal.branch_len = np.float32(bl)
                last_internal.jplace_edge_id = jp
            root = last_internal
            break
        else:
            buf.append(c)
        i += 1

    if root is None:
        raise ValueError("malformed newick (no root)")

    rooted = len(root.children) < 3  # NewickReader.java:209-220

    if not rooted and force_rooting:
        # ((s1,s2,s3)r; -> ((s1,s2)r,s3)added_root;  NewickReader.java:225-256
        newick_root = root
        son3 = newick_root.children[2]
        added_root = Node(next_id(), "added_root", 0.0)
        newick_root.children.remove(son3)
        son3.parent = None
        newick_root.branch_len = np.float32(0.0)
        added_root.add(newick_root)
        added_root.add(son3)
        return Tree(added_root, True)

    return Tree(root, rooted)


# ====================================================================== #
# Newick writing (reference formatting)
# ====================================================================== #

def _format_bl(bl: np.float32) -> str:
    """Branch length as the reference prints it.

    The reference stores float, prints via ``NumberFormat`` (Locale.UK,
    min=max=12 fraction digits, half-even) on the implicitly-widened double
    (``NewickWriter.java:57-65``).  Python's format() of the f64 value with
    '.12f' applies the same round-half-even.
    """
    return format(float(np.float32(bl)), ".12f")


def write_newick(tree: Tree, branch_lengths: bool = True,
                 internal_labels: bool = True,
                 jplace_labels: bool = False,
                 id_prefix: bool = False) -> str:
    """Serialise following ``NewickWriter.writerDFS`` (:144-212).

    For unrooted trees no branch length / ``{id}`` is emitted on the root
    (``level>-1`` guard, ``NewickWriter.java:91-95,193-201``).
    """
    out = []
    root_level = -1 if not tree.rooted else 0

    def emit_node_suffix(node: Node, level: int):
        if internal_labels:
            out.append(node.label)
        if branch_lengths and level > -1:
            out.append(":")
            out.append(_format_bl(node.branch_len))
        if jplace_labels and level > -1:
            out.append("{%d}" % node.jplace_edge_id)

    def dfs(node: Node, level: int):
        out.append("(")
        for idx, c in enumerate(node.children):
            if c.is_leaf:
                if id_prefix:
                    out.append(f"__{c.id}__")
                out.append(c.label)
                if branch_lengths:
                    out.append(":")
                    out.append(_format_bl(c.branch_len))
                if jplace_labels:
                    out.append("{%d}" % c.jplace_edge_id)
            else:
                dfs(c, level + 1)
            if idx < len(node.children) - 1:
                out.append(",")
            else:
                out.append(")")
                if id_prefix:
                    out.append(f"__{node.id}__")
                emit_node_suffix(node, level)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * tree.node_count() + 1000))
    try:
        dfs(tree.root, root_level)
    finally:
        sys.setrecursionlimit(old)
    out.append(";")
    return "".join(out)
