"""PyTorch/CUDA port of nerf_from_image_tpu for NVIDIA Hopper (sm_90a).

Layout mirrors the JAX package: ops/ (render primitives), models/
(generator), pose/, engine/ (render and inversion), data/ (datasets),
utils/, and the drivers (invert.py); kernels/ holds
the Python wrappers of the hand-written CUDA kernels whose sources live in
csrc/. Public tensors keep the JAX package's layouts (NHWC images, planes
[B, 3, H, W, C], points [B, N, 3]).

Entry points take an explicit `device` (default 'cuda', which raises when
no card is present); `device='cpu'` runs everything on the CPU with the
kernels' plain PyTorch versions.
"""
