"""LPIPS (Zhang et al. 2018, v0.1), VGG16 variant (port of
`tokensgen_tpu/metrics/lpips.py`): inputs in [-1, 1] shifted and scaled by
the ImageNet statistics layer; VGG16 features tapped after relu1_2, relu2_2,
relu3_3, relu4_3 and relu5_3; per tap, both maps unit-normalised over
channels, their squared difference weighted by a learned 1x1 "lin" head and
averaged over space; the taps summed.

The convolutions are written with ``F.conv2d`` (no torchvision), in the
torch layout of the published artifacts: `convert_lpips` takes a
torchvision ``vgg16().features`` state dict and the lpips package's
``vgg.pth`` heads. Without weights, `metrics.quality.perceptual_distance` is
a weights-free proxy, not LPIPS.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 "D"; "M" = 2x2 / 2 max pool. Taps after the ReLU of convs 1, 3, 6,
# 9 and 12 (0-based over the 13 convs).
VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512]
TAP_CONV_IDX = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)
# torchvision `vgg16().features` module indices of the 13 convs
TORCHVISION_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _vgg_taps(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    taps, ci = [], 0
    for v in VGG_CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w, b = params["features"][ci]
        x = F.relu(F.conv2d(x, w, b, padding=1))
        if ci in TAP_CONV_IDX:
            taps.append(x)
        ci += 1
    return taps


@torch.no_grad()
def lpips_distance(params: Dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS between image batches ``a`` / ``b`` [B, H, W, 3] in [-1, 1] -> [B]."""
    dev = a.device
    shift = torch.from_numpy(_SHIFT).to(dev)
    scale = torch.from_numpy(_SCALE).to(dev)
    fa = _vgg_taps(params, ((a - shift) / scale).permute(0, 3, 1, 2))
    fb = _vgg_taps(params, ((b - shift) / scale).permute(0, 3, 1, 2))
    total = 0.0
    for f0, f1, w in zip(fa, fb, params["lins"]):
        n0 = f0 / (torch.linalg.vector_norm(f0, dim=1, keepdim=True) + 1e-10)
        n1 = f1 / (torch.linalg.vector_norm(f1, dim=1, keepdim=True) + 1e-10)
        d = (n0 - n1) ** 2  # [B, C, h, w]
        total = total + torch.einsum("bchw,c->bhw", d, w).mean(dim=(1, 2))
    return total


def convert_lpips(vgg_sd: Dict, lin_sd: Dict, *, device) -> Dict:
    """torchvision ``vgg16().features`` weights (``features.{i}.weight`` /
    ``.bias``) and the lpips package's lin heads (``lin{k}.model.1.weight``
    or ``lins.{k}.model.1.weight``) -> ``{"features": [(weight, bias)] * 13,
    "lins": [[C]] * 5}`` of float32 tensors on ``device``."""
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    feats = [(t(vgg_sd[f"features.{i}.weight"]), t(vgg_sd[f"features.{i}.bias"]))
             for i in TORCHVISION_CONV_IDX]
    lins = []
    for k in range(5):
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if key in lin_sd:
                lins.append(t(lin_sd[key]).reshape(-1))
                break
        else:
            raise KeyError(f"lin head {k} not found in lpips state dict")
    return {"features": feats, "lins": lins}


def load_lpips_params(vgg_path: str, lins_path: str, *, device) -> Dict:
    """`convert_lpips` of the two torch artifacts: a torchvision VGG16 state
    dict and the lpips package's ``weights/v0.1/vgg.pth``."""
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    lin_sd = torch.load(lins_path, map_location="cpu", weights_only=True)
    return convert_lpips({k: v.numpy() for k, v in vgg_sd.items()},
                         {k: v.numpy() for k, v in lin_sd.items()}, device=device)


def lpips_video(params: Dict, pred: np.ndarray, target: np.ndarray) -> float:
    """Frame-averaged LPIPS between videos [F, H, W, 3] in [0, 1], on the
    device of ``params``."""
    dev = params["lins"][0].device
    a = torch.as_tensor(np.asarray(pred, np.float32), device=dev) * 2.0 - 1.0
    b = torch.as_tensor(np.asarray(target, np.float32), device=dev) * 2.0 - 1.0
    f = min(a.shape[0], b.shape[0])
    return float(lpips_distance(params, a[:f], b[:f]).mean())
