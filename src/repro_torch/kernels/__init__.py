"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Each kernel module holds the wrapper (which launches the kernel for CUDA
tensors), the plain PyTorch version of the same function (taken only
for CPU tensors), and launch counts.  Sources live in ``csrc/`` and are
built at first use by :mod:`._build`.
"""
