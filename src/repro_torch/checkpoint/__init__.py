from repro_torch.checkpoint.checkpoint import (load_manifest,  # noqa: F401
                                               restore, save)
