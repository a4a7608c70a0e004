"""Hand-written CUDA kernels of the port (sources in `csrc/`), their
plain torch versions, and the nvcc/ctypes build (`build.py`)."""
