"""DB build (``-p b``): phylo-kmer enumeration, the build pipeline and
the score calibration."""

from rappas_tpu_torch.build.explorer import explore_node, explore_node_exact
from rappas_tpu_torch.build.pipeline import BuildConfig, build_database

__all__ = ["BuildConfig", "build_database", "explore_node",
           "explore_node_exact"]
