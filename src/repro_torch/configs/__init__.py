from repro_torch.configs.base import (PORTED_ARCH_IDS, ArchConfig,
                                      get_config)  # noqa: F401
