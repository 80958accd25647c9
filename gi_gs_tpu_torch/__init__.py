"""gi_gs_tpu_torch — the PyTorch + CUDA port of gi_gs_tpu for NVIDIA Hopper.

Mirrors the module layout of `gi_gs_tpu` so every function has a
counterpart at the same relative path. Plain tensor code is PyTorch; every
Pallas kernel of the ported path is a hand-written CUDA kernel under
`csrc/`, built by nvcc for sm_90a at its first CUDA call
(`ops/cuda_kernels.py`). Entry points run on `cuda` unless the caller asks
for the CPU, where each kernel wrapper uses its plain PyTorch version.
"""
import torch

# The reference evaluates its dense prefilter operators, the diffuse
# irradiance matrix and the SSIM convolution in full f32
# (Precision.HIGHEST); TF32 would keep only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
