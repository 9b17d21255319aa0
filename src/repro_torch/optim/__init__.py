from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    apply_updates,
    global_norm,
    init_opt_state,
    schedule,
)
