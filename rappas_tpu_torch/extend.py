"""Ghost ("fake") node injection into every branch of the reference tree.

Re-implements the semantics of ``tree/ExtendedTree.java``
(BRANCHING_ON_BRANCH mode, the live default): for every non-root node B with
parent A and branch length ``l_init``, insert N serial ghost nodes X0 along
the A->B branch, each carrying a pendant subtree ``X1(X2,X3)`` where X2/X3
are new leaves (later added to the alignment as gap-only rows).

Exact reference numerics (``ExtendedTree.java:228-364``):

* ``l_b = l_init / (N+1)``; each X0 has bl ``l_b`` to its predecessor and B
  keeps ``l_init - N*l_b``;
* X1 branch length ``l_new``:
  - B internal: ``l_new = l_XO_B + mean_path(B -> real leaves)`` where
    ``l_XO_B = l_init - l_b*(j+1)`` and the mean is over the *already
    extended* subtree of B, skipping fake leaves
    (``getBLFromMean_DFS``, :371-391; the post-order processing order makes
    child branches already extended, which leaves the mean unchanged);
  - B leaf: ``l_new = l_b``;
* X2/X3 branch lengths: 0.01;
* node ids: ``fakeNodeCounter`` starts at the original node count, is
  incremented by 4 *before* each quad is created, so the first new id is
  ``node_count + 1`` (id ``node_count`` is skipped -- reference quirk,
  ``ExtendedTree.java:144,284-288``);
* processing order: post-order over the ORIGINAL children
  (``ExtendedTree.java:242-254``);
* ghost->original mapping: X0, X1 -> B; original nodes -> themselves
  (``extendedNodesToOriginalNodes``, :276-298).

All computations are float32, like the reference.
"""

from __future__ import annotations

import numpy as np

from rappas_tpu_torch.tree import Node, Tree

__all__ = ["ExtendedTree", "extend_tree"]


class ExtendedTree(Tree):
    """Tree with ghost nodes plus the bookkeeping the pipelines need."""

    def __init__(self, root: Node, rooted: bool,
                 fake_to_original: dict[int, int],
                 fake_leaves: list[Node], fake_internal: list[Node]):
        super().__init__(root, rooted)
        #: map(extended node id) -> original tree node id (son of the branch)
        self.fake_to_original = fake_to_original
        self.fake_leaves = fake_leaves
        self.fake_internal = fake_internal

    def fake_to_original_id(self, node_id: int) -> int:
        return self.fake_to_original[node_id]


def _mean_leaf_path(node: Node) -> tuple[np.float32, int]:
    """(sum of root-to-leaf path lengths, #real leaves) below ``node``.

    Mirrors ``getBLFromMean_DFS`` (ExtendedTree.java:371-391): fake leaves
    are skipped; the path sum uses f32 accumulation in DFS order; the
    *starting* node's own branch length is excluded (level-0 guard).
    """
    # The reference mutates a single f32 accumulator with += / -= on DFS
    # entry/exit; we emulate that exactly (fp residuals differ from a
    # per-path recomputation).
    state = {"total": np.float32(0.0), "cumul": np.float32(0.0), "count": 0}

    def dfs(n: Node, level: int):
        if n.is_leaf and not n.is_fake:
            state["total"] = np.float32(
                state["total"] + np.float32(state["cumul"] + n.branch_len))
            state["count"] += 1
        else:
            if level > 0:
                state["cumul"] = np.float32(state["cumul"] + n.branch_len)
            else:
                state["cumul"] = np.float32(0.0)
                state["total"] = np.float32(0.0)
            for c in n.children:
                dfs(c, level + 1)
            if level > 0:
                state["cumul"] = np.float32(state["cumul"] - n.branch_len)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(old + 100000)
    try:
        dfs(node, 0)
    finally:
        sys.setrecursionlimit(old)
    return state["total"], state["count"]


def extend_tree(tree: Tree, n_ghosts: int = 1,
                branchbreak_threshold: float = -1.0) -> ExtendedTree:
    """Build the extended (ghost) tree from a COPY of ``tree``.

    The caller keeps the original tree untouched (the reference copies the
    root before constructing ExtendedTree, ``Main_DBBUILD_3.java:330-336``).
    """
    work = tree.copy()
    fake_counter = [work.node_count()]  # ExtendedTree.java:144
    fake_to_original: dict[int, int] = {}
    fake_leaves: list[Node] = []
    fake_internal: list[Node] = []
    N = n_ghosts
    thr = np.float32(branchbreak_threshold)

    def process(B: Node):
        A = B.parent
        for child in list(B.children):  # snapshot: new ghosts not recursed
            process(child)
        if A is None:
            return
        # skip short branches (default threshold -1 keeps everything,
        # ExtendedTree.java:261)
        if B.branch_len < thr:
            return

        l_init = np.float32(B.branch_len)
        l_b = np.float32(l_init / np.float32(N + 1))

        A.children.remove(B)
        B.parent = None
        fake_to_original.setdefault(A.id, A.id)
        fake_to_original.setdefault(B.id, B.id)

        current_parent = A
        for j in range(N):
            fake_counter[0] += 4
            c = fake_counter[0]
            X0 = Node(c - 3, f"{c-3}_X0", 0.01, is_fake=True)
            X1 = Node(c - 2, f"{c-2}_X1", 0.01, is_fake=True)
            X2 = Node(c - 1, f"{c-1}_X2", 0.01, is_fake=True)
            X3 = Node(c, f"{c}_X3", 0.01, is_fake=True)
            X1.add(X2)
            X1.add(X3)
            X0.add(X1)
            fake_leaves.extend([X2, X3])
            fake_internal.extend([X0, X1])
            fake_to_original[X0.id] = B.id
            fake_to_original[X1.id] = B.id

            l_XO_B = np.float32(l_init - np.float32(l_b * np.float32(j + 1)))
            if not B.is_leaf:
                path_sum, n_leaves = _mean_leaf_path(B)
                # (sum_B_leaves*l_XO_B + l_sum_B_subtree)/sum_B_leaves,
                # f32 arithmetic (ExtendedTree.java:327)
                l_new = np.float32(
                    (np.float32(np.float32(n_leaves) * l_XO_B) + path_sum)
                    / np.float32(n_leaves))
            else:
                l_new = l_b

            X1.branch_len = l_new
            X0.branch_len = l_b
            X1.bl_to_original_ancestor = np.float32(
                np.float32(np.float32(j + 1) * l_b) + l_new)
            X1.bl_to_original_son = np.float32(l_XO_B + l_new)
            X0.bl_to_original_ancestor = np.float32(np.float32(j + 1) * l_b)
            X0.bl_to_original_son = l_XO_B

            current_parent.add(X0)
            current_parent = X0

        current_parent.add(B)
        B.branch_len = np.float32(
            l_init - np.float32(l_b * np.float32(N)))

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(old + 100000)
    try:
        process(work.root)
    finally:
        sys.setrecursionlimit(old)

    ext = ExtendedTree(work.root, work.rooted, fake_to_original,
                       fake_leaves, fake_internal)
    return ext
