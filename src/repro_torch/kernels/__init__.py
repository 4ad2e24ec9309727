"""Hand-written Hopper kernels (``csrc/``), each beside its plain PyTorch
version. Importing this package builds nothing: a kernel is compiled the
first time a CUDA tensor reaches its wrapper (see ``_build``)."""
