"""Multi-device and multi-host placement (port of ``rappas_tpu/parallel``)."""

from rappas_tpu_torch.parallel.mesh import (  # noqa: F401
    ShardedPlacement, make_mesh)
