from repro_torch.api.wire import (WireAccountingError, WireStack, WireTape,
                                  WireTransform, parse_wire,
                                  quantize_int8)  # noqa: F401
