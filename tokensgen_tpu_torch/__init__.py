"""PyTorch/CUDA port of `tokensgen_tpu` for NVIDIA Hopper (H100).

Module paths and public names mirror the JAX package (`tokensgen_tpu/`), which
stays the reference every module here is tested against. The five attention
kernels of the edit and training paths (the forwards K1-K4 and the backward
K5) are hand-written CUDA C++ for `sm_90a` (`kernels/csrc/attention.cu`);
everything else is plain PyTorch.
"""
