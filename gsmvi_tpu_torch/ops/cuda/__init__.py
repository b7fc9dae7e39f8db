"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``, built by
``_build.py`` at first launch and bound with ctypes)."""
