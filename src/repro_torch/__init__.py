"""PyTorch/CUDA port of the split-learning system (`repro` is the JAX
reference it is held against).

It covers split-inference serving (`serve/`: every ported family split
at the cut over the packed int8 wire, monolithic serving and the
continuous-batching `Batcher`), split training through `api.Plan` ->
`Session` -> `engine` for every mode and schedule (VGG-16, ResNet and
the LM family), the training CLI (`launch/train.py`), the deprecated
trainer shims (`core/protocol.py`, `core/baselines.py`) and the paper's
Tables 1-2 and Fig. 3 (`launch/paper_tables.py`).  Every TPU kernel of
the reference is a hand-written CUDA kernel (`kernels/`).

The package imports torch, numpy and the standard library only.
"""
