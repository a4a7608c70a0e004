from repro_torch.models.registry import (build_model,
                                         supports_split_serving)  # noqa: F401
