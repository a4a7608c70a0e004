"""PyTorch/CUDA port of the split-learning system (`repro` is the JAX
reference it is held against).

This first slice serves a decoder LM split at the cut: the client holds
the embedding and layers [0, cut), the server the rest, and only the cut
activation (up) and the logits (down) cross, over the packed int8 wire.
The wire's pack/unpack and the server's fused int8 entry matmul are
hand-written CUDA kernels (`repro_torch.kernels`).

The package imports torch, numpy and the standard library only.
"""
