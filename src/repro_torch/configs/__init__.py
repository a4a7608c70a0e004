from repro_torch.configs.base import (INPUT_SHAPES, PORTED_ARCH_IDS,
                                      ArchConfig, InputShape,
                                      get_config)  # noqa: F401
