from repro_torch.checkpoint.checkpoint import (load_manifest,  # noqa: F401
                                               restore, restore_state, save,
                                               save_state)
