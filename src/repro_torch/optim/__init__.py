from repro_torch.optim.adamw import (
    OptState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
)
from repro_torch.optim.schedule import SCHEDULES, linear, warmup_cosine

__all__ = [
    "OptState", "adamw_update", "clip_by_global_norm", "global_norm",
    "init_opt_state", "SCHEDULES", "linear", "warmup_cosine",
]
