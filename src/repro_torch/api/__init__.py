from repro_torch.api.baseline import (FedAvgEngine,  # noqa: F401
                                      LargeBatchEngine)
from repro_torch.api.plan import (MODES, PORTED_MODES, FullFns,  # noqa: F401
                                  Plan, SplitFns, lm_split_fns,
                                  softmax_xent)
from repro_torch.api.session import Session  # noqa: F401
from repro_torch.api.wire import (WireAccountingError, WireStack,  # noqa: F401
                                  WireTape, WireTransform, dp_noise,
                                  leakage_probe, parse_wire, quantize_int8,
                                  with_wire)
