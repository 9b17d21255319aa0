from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    apply_updates,
    global_norm,
    init_opt_state,
    schedule,
)
from repro_torch.optim.compression import (  # noqa: F401
    compressed_grad_sync,
    dequantize,
    init_error_feedback,
    quantize,
    quantized_all_reduce,
)
