from repro_torch.train.train_step import (  # noqa: F401
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.train.pipeline_parallel import pipelined_forward  # noqa: F401
