"""LPIPS, VGG16 variant (port of gi_gs_tpu/utils/lpips.py) with weights
loaded from a file.

The reference computes LPIPS with the `lpips` pip package, whose
pretrained VGG16 and linear-head weights are downloaded at run time. The
port ships no weights: the metric is computed when `--lpips_weights`
names a file, and the eval JSONs report null otherwise.

Weight formats (`load_lpips_weights`):
  * .npz with `conv{i}_w` [Cout, Cin, 3, 3] and `conv{i}_b` [Cout] for
    i in 0..12 (the 13 VGG16 convolutions, torchvision layout) and
    `lin{j}_w` [C_j] for j in 0..4 (the LPIPS 1x1 heads, squeezed);
  * a torch file (.pt/.pth) of the `lpips.LPIPS(net='vgg')` state dict
    (`net.slice*.<idx>.weight`, `lin*.model.1.weight`), or of
    {"vgg": torchvision vgg16 state dict, "lin": lpips head state dict}.

The computation follows the lpips package: inputs in [0, 1] go to
[-1, 1], are shifted and scaled by fixed constants and pass through the
VGG16 features; the activations after relu1_2, relu2_2, relu3_3, relu4_3
and relu5_3 are unit-normalised over channels, their squared differences
weighted by the linear heads and averaged over the image, and the five
layer scores summed. This is plain convolution and pooling
(`torch.nn.functional`), run in full f32: the package turns TF32 off.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# torchvision VGG16 `features`: conv widths and max pools ("M"); LPIPS taps
# the activations after the 2nd, 4th, 7th, 10th and 13th convolution.
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _to_np(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _feature_indices() -> List[int]:
    """torchvision `features` index of each convolution."""
    out, fi = [], 0
    for v in _VGG_CFG:
        if v == "M":
            fi += 1
        else:
            out.append(fi)
            fi += 2
    return out


def load_lpips_weights(path: str) -> Dict[str, np.ndarray]:
    """Load LPIPS weights into the canonical dict (module docstring)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: np.asarray(v, np.float32) for k, v in data.items()}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, np.ndarray] = {}
    if any(k.startswith("net.slice") for k in obj):
        # lpips.LPIPS state dict: net.slice<n>.<features index>.weight
        convs: List[Tuple[int, str]] = sorted(
            (int(k.split(".")[2]), k) for k in obj
            if k.startswith("net.slice") and k.endswith(".weight"))
        for i, (_, k) in enumerate(convs):
            out[f"conv{i}_w"] = _to_np(obj[k])
            out[f"conv{i}_b"] = _to_np(obj[k[:-len("weight")] + "bias"])
        for j in range(5):
            out[f"lin{j}_w"] = _to_np(obj[f"lin{j}.model.1.weight"]
                                      ).reshape(-1)
    elif "vgg" in obj and "lin" in obj:
        vgg, lin = obj["vgg"], obj["lin"]
        for i, f in enumerate(_feature_indices()):
            out[f"conv{i}_w"] = _to_np(vgg[f"features.{f}.weight"])
            out[f"conv{i}_b"] = _to_np(vgg[f"features.{f}.bias"])
        for j in range(5):
            key = f"lin{j}.model.1.weight"
            if key not in lin:
                key = f"lins.{j}.model.1.weight"
            out[f"lin{j}_w"] = _to_np(lin[key]).reshape(-1)
    else:
        raise ValueError(f"unrecognised LPIPS weight format in {path}: "
                         f"keys {sorted(obj)[:5]}...")
    return out


def random_lpips_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Correctly shaped random weights (tests and the card check); the
    same arrays as JAX's `random_lpips_weights(seed)`."""
    rng = np.random.RandomState(seed)
    out = {}
    cin, i = 3, 0
    for v in _VGG_CFG:
        if v == "M":
            continue
        out[f"conv{i}_w"] = rng.randn(v, cin, 3, 3).astype(np.float32) * 0.05
        out[f"conv{i}_b"] = rng.randn(v).astype(np.float32) * 0.01
        cin = v
        i += 1
    widths = [v for v in _VGG_CFG if v != "M"]
    for j, tap in enumerate(_TAPS):
        out[f"lin{j}_w"] = np.abs(rng.randn(widths[tap]).astype(
            np.float32)) * 0.1
    return out


def _vgg_features(x: torch.Tensor, w: Dict[str, torch.Tensor]):
    """x: [N, 3, H, W] normalised -> the 5 tapped activations."""
    feats, conv = [], 0
    for v in _VGG_CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = F.relu(F.conv2d(x, w[f"conv{conv}_w"], w[f"conv{conv}_b"],
                            padding=1))
        if conv in _TAPS:
            feats.append(x)
        conv += 1
    return feats


@torch.no_grad()
def lpips(img0: torch.Tensor, img1: torch.Tensor,
          weights: Dict[str, np.ndarray]) -> float:
    """LPIPS distance between two [3, H, W] images in [0, 1], computed on
    img0's device."""
    dev = img0.device
    w = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
         for k, v in weights.items()}
    shift = torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=dev)[None, :, None, None]

    def prep(im):
        im = torch.as_tensor(im, dtype=torch.float32, device=dev)
        im = im[None] if im.ndim == 3 else im
        return (2.0 * im - 1.0 - shift) / scale

    total = torch.zeros((), dtype=torch.float32, device=dev)
    for j, (a, b) in enumerate(zip(_vgg_features(prep(img0), w),
                                   _vgg_features(prep(img1), w))):
        na = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
        nb = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
        total = total + (((na - nb) ** 2) * w[f"lin{j}_w"][None, :, None, None]
                         ).sum(1).mean()
    return float(total)


def maybe_load(path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """Weights if `path` names an existing file, else None (metric null)."""
    if path and os.path.exists(path):
        return load_lpips_weights(path)
    return None
