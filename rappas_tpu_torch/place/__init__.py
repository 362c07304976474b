from rappas_tpu_torch.place.engine import PlacementEngine  # noqa: F401
from rappas_tpu_torch.place.pipeline import (  # noqa: F401
    PlacementConfig, place_queries)
