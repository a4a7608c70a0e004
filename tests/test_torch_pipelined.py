"""The port's microbatch-pipelined schedule for all 8 modes against the
JAX reference, on the CPU: `Plan(schedule="pipelined", microbatches=M)`
at M = 1 and 2, fitted 3 rounds from the reference's init.

The models, batches, wires, optimizers and tolerances are
`tests/test_torch_schedules.py`'s (its docstring gives each tolerance's
reason): losses and states after 3 rounds within `TOL` of the reference
at the SAME M; the metered bytes exactly the reference's, and the whole
meter exactly the mode's default schedule's (wire bytes do not depend on
M).
"""
import numpy as np
import pytest
import torch
from test_torch_modes import _assert_trees
from test_torch_schedules import (BRANCH_KINDS, MODES, N_CLIENTS, TOL,
                                  TURN_KINDS, _fit, _fresh_fit_meter, _meter,
                                  _wire_meter)


# The intra-op thread count this file's fits run at.  A convolution's
# weight gradient on the CPU sums its rows in an order set by the thread
# count, and the AdamW large_batch fits below hold a conv 2 weight whose
# gradient nearly cancels, where Adam divides two tiny moments: within
# `TOL` of the reference at 4 and 8 threads, but not at 1 (M=1: 1.6e-5
# apart) or 2 (M=1 and M=2: 1.4e-5) (ROADMAP.md queue 3).  So the count
# is fixed at one that was measured, whatever the host's core count.
PIPELINED_THREADS = 8


@pytest.fixture(autouse=True, scope="module")
def _pipelined_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(PIPELINED_THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


PIPELINED_CASES = [(mode, m) for mode in MODES for m in (1, 2)]


@pytest.fixture(scope="module", params=PIPELINED_CASES,
                ids=[f"{mode}-M{m}" for mode, m in PIPELINED_CASES])
def pipelined(request):
    mode, m = request.param
    return (mode, m) + _fit(mode, schedule="pipelined", microbatches=m)


def test_pipelined_fit_matches_reference(pipelined):
    mode, m, jsess, tsess, lj, lt = pipelined
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    _assert_trees(tsess.state, jsess.state, TOL)
    if mode in TURN_KINDS:
        assert lt[0].shape == (N_CLIENTS,)
        assert int(tsess.state["last_trained"]) == N_CLIENTS - 1
    elif mode in BRANCH_KINDS:
        assert lt[0].shape == (1,)
    assert tsess.engine.microbatches == m


def test_pipelined_meter_matches_reference_and_default_schedule(pipelined):
    """Wire bytes do not depend on the microbatch count, and the handoff
    is still billed once a turn: the meter is the reference's and the
    mode's default schedule's, exactly."""
    mode, m, jsess, tsess, _, _ = pipelined
    assert _wire_meter(tsess) == _wire_meter(jsess)
    assert _meter(tsess) == _fresh_fit_meter(mode)[0]
    if mode in TURN_KINDS:
        sync = tsess.engine.meter.sync_bytes
        assert 0 < sync[0] < sync[1] == sync[2]
