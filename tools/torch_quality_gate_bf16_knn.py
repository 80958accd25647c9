"""The port's phase-1 quality gate (gi_gs_tpu_torch.quality_gate,
P1_PROTOCOL) on the card, with both operands of the knn's distance matmul
rounded to bf16, as JAX's knn runs on a TPU (gi_gs_tpu/ops/knn.py:98-100
asks for no precision, and a TPU's default is one bf16 pass); everything
else stays f32. The init cloud and the GT scene both take their scales
from that knn. It sets the port beside QUALITY_r05.json's TPU phase-1
figure from a like init.

    python tools/torch_quality_gate_bf16_knn.py OUT.json
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import gi_gs_tpu_torch.models.gaussians as gaussians  # noqa: E402
from gi_gs_tpu_torch import quality_gate as qg  # noqa: E402
from gi_gs_tpu_torch.ops import knn  # noqa: E402
from gi_gs_tpu_torch.utils.device import card_line, resolve_device  # noqa


def mean_knn_dist2_bf16(points: torch.Tensor, chunk: int = 512
                        ) -> torch.Tensor:
    """The port's exact knn with the distance matmul's operands rounded to
    bf16 (f32 products and sums)."""
    assert points.shape[0] <= knn.EXACT_MAX
    sq = (points * points).sum(-1)
    pts16 = points.bfloat16().float()
    out = []
    for s in range(0, points.shape[0], chunk):
        q = points[s:s + chunk]
        d2 = (q * q).sum(-1)[:, None] + sq[None, :] - 2.0 * (
            pts16[s:s + chunk] @ pts16.T)
        out.append(knn._three_smallest_mean(torch.clamp(d2, min=0.0),
                                            skip_first=True))
    return torch.cat(out)


def main(out_path: str) -> None:
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    from gi_gs_tpu_torch.ops import cuda_kernels
    cuda_kernels.library()
    gaussians.mean_knn_dist2 = mean_knn_dist2_bf16
    res = qg.run_phase1_gate(**qg.P1_PROTOCOL, device=dev)
    res["device"] = card_line(dev)
    res["knn"] = "bf16 operands"
    with open(out_path, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1])
