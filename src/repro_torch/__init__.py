"""PyTorch/CUDA port of the SpecPCM reproduction (``src/repro`` is the
JAX reference).

Layout mirrors ``repro``: ``core.hd`` (Eq. 1 encode, bit-pack, search),
``spectra`` (synthetic data, FDR), ``kernels`` (hand-written Hopper
kernels with their plain PyTorch versions), ``serve`` (the DB-search
server) and ``launch`` (runnable entry points). Packed hypervector words
are int32 bit-views of the reference's uint32 words; the top-k sentinel
is ``INT32_MIN``.
"""
