from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ArchConfig,
                                      InputShape, all_configs,
                                      get_config)  # noqa: F401
