"""Split-inference serving (port of `repro/serve/`).

`ServeSession` is single-stream (one stacked batch, all rows in step);
`Batcher` multiplexes independent tenants over one server cache with
continuous batching (join on prefill, leave on EOS or budget);
`greedy_decode_scan` is the monolithic greedy decode.
"""
from repro_torch.serve.batcher import Batcher, Tenant  # noqa: F401
from repro_torch.serve.split_infer import (  # noqa: F401
    ServePlan, ServeSession, greedy_decode_scan, resolve_device)
