"""The torch CPU thread count of the port's test files.

The suite runs several worker processes at once (pytest-xdist), and
torch's intra-op pool, sized to every core, spins waiting for cores that
the other workers hold. So each port test file calls `one_torch_thread`
on import, and its tests run one intra-op thread a process.
"""
import torch


def one_torch_thread() -> None:
    torch.set_num_threads(1)
