from repro_torch.models.registry import (build_model, input_specs,
                                         supports_shape,
                                         supports_split_serving,
                                         text_len)  # noqa: F401
