"""The benchmark's plain reference: a frozen copy of the plain PyTorch
path of gi_gs_tpu_torch 0.1.0 (the tree of 4cf87c6), module for module,
with every CUDA kernel's dispatch cut so that its plain version runs on
any device, and nothing else changed but these:

- `ops/rasterize/composite.py`: the compositing walks count the pairs
  that contribute (`work["contrib"]`), and `composite_fwd` and
  `composite_bwd` run in blocks of `RasterConfig.tile_block` tiles.
- `cli/render_cli.py` holds only the serving path.
- What no cell reaches is cut: the multi-rank paths (`parallel/`, the
  tile-sharded compositing and its `tile_group` arguments), capacity
  growth (`grow_state`, `grow_params`, `surgery_grow`), `rasterize_lite`,
  `mark_visible` and `params_from_numpy`.

It imports nothing of gi_gs_tpu_torch, gi_gs_tpu or JAX, and is never
edited to follow the program: it is the yardstick the program is held to.
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
