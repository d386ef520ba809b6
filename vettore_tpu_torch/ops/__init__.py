"""Scan kernels and pure algorithm helpers: hand-written CUDA kernels with
their plain PyTorch versions, and the float64 host oracles."""
