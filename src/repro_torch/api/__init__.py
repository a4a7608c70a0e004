from repro_torch.api.plan import MODES, Plan, softmax_xent  # noqa: F401
from repro_torch.api.session import Session  # noqa: F401
from repro_torch.api.wire import (WireAccountingError, WireStack,  # noqa: F401
                                  WireTape, WireTransform, leakage_probe,
                                  parse_wire, quantize_int8, with_wire)
