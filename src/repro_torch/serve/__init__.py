from repro_torch.serve.split_infer import (ServePlan, ServeSession,
                                           resolve_device)  # noqa: F401
