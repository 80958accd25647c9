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

# PyTorch's CPU exp, log, sqrt and the like call MKL's vector math. In the
# first such call of a process that PyTorch splits across OpenMP threads,
# worker threads can start before MKL has set itself up and then compute
# their chunks at lower accuracy (f64 relative error ~3e-9, so other f32
# bits): about one fresh process in ten. One call on this thread alone
# sets MKL up first (tests/test_torch_cpu_first_call.py).
torch.exp(torch.zeros(1, dtype=torch.float64))

__version__ = "0.1.0"
