from repro_torch.train.train_step import (  # noqa: F401
    TrainConfig,
    batch_shard,
    init_train_state,
    make_state_specs,
    make_train_step,
    place_train_state,
)
from repro_torch.train.pipeline_parallel import pipelined_forward  # noqa: F401
