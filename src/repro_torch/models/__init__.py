from repro_torch.models.registry import (build_model, input_specs,
                                         supports_split_serving,
                                         text_len)  # noqa: F401
