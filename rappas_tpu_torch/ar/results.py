"""Assemble AR outputs into the structures the DB build consumes.

Mirrors ``inputs/ARResults.java``: parse the AR tree
(reversing the AR program's unrooting when the input extended tree was
rooted, ``ARResults.java:139-154,172-187``), parse the posterior tensor,
and build the node mapping ``map(AR tree id) = extended tree id`` via
label-based topology matching (``ARTree.mapNodes(extendedTree)``,
``ARResults.java:77``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from rappas_tpu_torch.alphabet import Alphabet
from rappas_tpu_torch.ar.launcher import (AR_BASEML, AR_CODEML, AR_PHYML,
                                          ARLauncher)
from rappas_tpu_torch.ar import wrappers
from rappas_tpu_torch.extend import ExtendedTree
from rappas_tpu_torch.tree import Tree


@dataclasses.dataclass
class ARResults:
    ar_tree: Tree
    #: float32[n_ar_ids, n_sites, n_states] log10 posteriors (NaN = unset)
    probas: np.ndarray
    #: map(AR tree node id) -> extended tree node id
    ar_to_extended: dict[int, int]

    def ghost_nodes(self, extended: ExtendedTree,
                    only_x1: bool = False) -> list[int]:
        """AR-tree internal node ids that are ghost nodes, in the AR tree's
        DFS order (``Main_DBBUILD_3.java:607-630``)."""
        out = []
        for node in self.ar_tree.nodes:  # pre-order DFS
            if node.is_leaf:
                continue
            ext_id = self.ar_to_extended.get(node.id)
            if ext_id is None:
                continue
            ext_node = extended.by_id(ext_id)
            if not ext_node.is_fake:
                continue
            if only_x1 and "_X1" not in ext_node.label:
                continue
            out.append(node.id)
        return out


def parse_ar_outputs(launcher: ARLauncher, ar_dir, align_path,
                     extended_tree: ExtendedTree, original_rooted: bool,
                     n_sites: int, alphabet: Alphabet) -> ARResults:
    """Parse tree + posteriors for whichever AR program ran."""
    paths = launcher.output_paths(ar_dir, align_path)
    tree_text = Path(paths["tree"]).read_text()
    probas_text = Path(paths["probas"]).read_text()

    if launcher.program in (AR_BASEML, AR_CODEML):
        ar_tree = wrappers.parse_paml_tree(tree_text, alphabet)
        probas = wrappers.parse_paml_probas(probas_text, ar_tree, n_sites,
                                            alphabet)
    else:
        ar_tree = wrappers.parse_ar_tree(tree_text, reroot=False)
        if original_rooted and not ar_tree.rooted:
            # the AR program unrooted our rooted tree; reverse it
            # (ARResults.java:139-154)
            ar_tree = wrappers.parse_ar_tree(tree_text, reroot=True)
        if launcher.program == AR_PHYML:
            probas = wrappers.parse_phyml_probas(probas_text, ar_tree,
                                                 n_sites, alphabet)
        else:
            probas = wrappers.parse_raxmlng_probas(probas_text, ar_tree,
                                                   n_sites, alphabet)

    mapping = ar_tree.map_nodes(extended_tree)
    return ARResults(ar_tree=ar_tree, probas=probas,
                     ar_to_extended=mapping)
