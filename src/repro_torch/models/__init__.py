"""Model zoo of the port: dense GQA decoders over dict pytrees."""

from repro_torch.models.model_zoo import (  # noqa: F401
    ModelBundle,
    get_bundle,
    get_smoke_bundle,
)
from repro_torch.models.sharding import Param, materialize  # noqa: F401
