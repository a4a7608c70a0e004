from repro_torch.optim import schedules  # noqa: F401
from repro_torch.optim.optimizers import (Optimizer, adam,  # noqa: F401
                                          adamw, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          sgd)
