"""Grid kernels of the PyTorch port and the exact top-k.

- ``fused_posterior``: K1 and K2, the fused grid intervals (K2 for one
  GP with a Sum/Product kernel algebra, the contextual kernels);
- ``fused_expander``: K3 and K4, the fused expander predicate;
- ``topk``: K5, the exact top-k with an explicit tie rule.

Each kernel's wrapper launches the hand-written CUDA kernel for CUDA
tensors and runs its plain PyTorch version for CPU tensors. Nothing is
built or loaded at import time (see ``_build.py``).
"""
