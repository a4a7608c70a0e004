from repro_torch.optim.optimizers import (Optimizer, adamw,  # noqa: F401
                                          apply_updates, clip_by_global_norm,
                                          global_norm, sgd)
