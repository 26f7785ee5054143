"""Hand-written Hopper kernels (CUDA C++ for sm_90a under ``csrc/``),
each with a plain PyTorch version beside it.

A wrapper given a CPU tensor computes the plain version; given a CUDA
tensor it launches the kernel or raises.  Sources are compiled with nvcc at
first use into ``_build/`` and loaded with ctypes (see ``_build.py``).
"""
