"""Image and video quality metrics of the validation renders (port of
`tokensgen_tpu/metrics/quality.py`): PSNR, SSIM, CIE76 ΔE*ab, a weights-free
perceptual proxy, and `evaluate_video`, which the To2V trainer logs.

Inputs are float arrays in [0, 1], videos [F, H, W, 3] or images [H, W, 3],
evaluated in float64 on the host. SSIM's Gaussian window runs as one
``F.conv2d`` per statistic (the JAX package slides numpy windows: the same
sums in another order).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val ** 2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Gaussian-window SSIM (11 x 11, sigma 1.5, valid positions; Wang et
    al.'s constants), averaged over channels."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kernel = torch.from_numpy(_gaussian_kernel())[None, None]
    x = torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1)))[:, None]  # [C, 1, H, W]
    y = torch.from_numpy(np.ascontiguousarray(b.transpose(2, 0, 1)))[:, None]
    mu_x, mu_y, xx, yy, xy = F.conv2d(torch.cat([x, y, x * x, y * y, x * y]), kernel).chunk(5)
    mu_x2, mu_y2, mu_xy = mu_x ** 2, mu_y ** 2, mu_x * mu_y
    m = ((2 * mu_xy + c1) * (2 * (xy - mu_xy) + c2)) / (
        (mu_x2 + mu_y2 + c1) * ((xx - mu_x2) + (yy - mu_y2) + c2))
    return float(m.mean(dim=(1, 2, 3)).mean())


# --------------------------------------------------------------- color (Lab)


def rgb_to_xyz(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb, np.float64)
    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    m = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    return lin @ m.T


def xyz_to_lab(xyz: np.ndarray) -> np.ndarray:
    x = xyz / np.array([0.950456, 1.0, 1.088754])
    eps = 6.0 / 29.0
    f = np.where(x > eps ** 3, np.cbrt(x), x / (3 * eps ** 2) + 4.0 / 29.0)
    lum = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([lum, a, b], axis=-1)


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    return xyz_to_lab(rgb_to_xyz(rgb))


def delta_e_ab(a: np.ndarray, b: np.ndarray) -> float:
    """Mean CIE76 ΔE*ab between two RGB images in [0, 1]."""
    return float(np.mean(np.linalg.norm(rgb_to_lab(a) - rgb_to_lab(b), axis=-1)))


# ---------------------------------------------------------------- perceptual


def perceptual_distance(a: np.ndarray, b: np.ndarray,
                        feature_fn: Optional[Callable[[np.ndarray], list]] = None) -> float:
    """A weights-free perceptual proxy (a fixed random-projection feature
    pyramid), not comparable to published LPIPS numbers; `metrics.lpips`
    is LPIPS. ``feature_fn`` maps [H, W, 3] -> a list of [h, w, c] maps."""
    feature_fn = feature_fn or _random_pyramid_features
    dists = []
    for x, y in zip(feature_fn(a), feature_fn(b)):
        xn = x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-10)
        yn = y / (np.linalg.norm(y, axis=-1, keepdims=True) + 1e-10)
        dists.append(np.mean((xn - yn) ** 2))
    return float(np.mean(dists))


def _random_pyramid_features(img: np.ndarray, levels: int = 3, dim: int = 32):
    rng = np.random.default_rng(0)  # a fixed projection
    feats = []
    x = np.asarray(img, np.float64)
    for _ in range(levels):
        h, w, c = x.shape
        patches = x[: h // 4 * 4, : w // 4 * 4].reshape(h // 4, 4, w // 4, 4, c)
        patches = patches.transpose(0, 2, 1, 3, 4).reshape(h // 4, w // 4, 16 * c)
        proj = rng.normal(size=(patches.shape[-1], dim)) / np.sqrt(patches.shape[-1])
        feats.append(patches @ proj)
        x = patches[..., :c]  # the next level's carrier
    return feats


def evaluate_video(pred: np.ndarray, target: np.ndarray, lpips_params=None) -> Dict[str, float]:
    """``psnr``, ``ssim`` and ``delta_e`` averaged over the frames the two
    videos [F, H, W, 3] in [0, 1] share, and ``lpips`` with LPIPS weights
    (`metrics.lpips.load_lpips_params`)."""
    f = min(pred.shape[0], target.shape[0])
    out = {
        "psnr": float(np.mean([psnr(pred[i], target[i]) for i in range(f)])),
        "ssim": float(np.mean([ssim(pred[i], target[i]) for i in range(f)])),
        "delta_e": float(np.mean([delta_e_ab(pred[i], target[i]) for i in range(f)])),
    }
    if lpips_params is not None:
        from tokensgen_tpu_torch.metrics.lpips import lpips_video

        out["lpips"] = lpips_video(lpips_params, pred[:f], target[:f])
    return out
