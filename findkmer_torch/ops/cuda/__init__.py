"""Hand-written CUDA kernels of the port and their PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors and runs the kernel's
plain PyTorch twin for CPU tensors, and only for those.
"""
