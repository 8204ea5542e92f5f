"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterpart of `repro.kernels`).  Kernels are built at first use
(`kernels._build`), never at import."""
