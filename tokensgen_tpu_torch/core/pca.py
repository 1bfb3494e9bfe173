"""PCA with sklearn's sign convention (port of `tokensgen_tpu/core/pca.py`).

T2To works in a PCA-compressed token space: the 3072-dim condensed tokens are
projected to their first 16 principal components for diffusion and lifted
back for rendering. The fitted state is two tensors on the caller's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PCAState(NamedTuple):
    mean: torch.Tensor  # [1, D]
    components: torch.Tensor  # [K, D] rows are principal axes


def _svd_flip(u: torch.Tensor, vt: torch.Tensor):
    """Deterministic signs: flip each singular pair so that the largest-|u|
    entry of each left vector is positive (sklearn's u-based rule)."""
    max_abs_rows = torch.argmax(u.abs(), dim=0)
    signs = torch.sign(u[max_abs_rows, torch.arange(u.shape[1], device=u.device)])
    return u * signs, vt * signs[:, None]


def fit(x: torch.Tensor, n_components: Optional[int] = None) -> PCAState:
    """Fit PCA on [N, D] data via the SVD of the centered matrix."""
    _, d = x.shape
    k = d if n_components is None else min(n_components, d)
    mean = x.mean(dim=0, keepdim=True)
    u, _, vt = torch.linalg.svd(x - mean, full_matrices=False)
    u, vt = _svd_flip(u, vt)
    return PCAState(mean=mean, components=vt[:k])


def transform(state: PCAState, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean) @ state.components.T


def inverse_transform(state: PCAState, y: torch.Tensor) -> torch.Tensor:
    return y @ state.components + state.mean


def bottleneck(state: PCAState, x: torch.Tensor, keep: int = 16) -> torch.Tensor:
    """Project, zero all but the first ``keep`` components, lift back (the
    resampler's inference-time PCA bottleneck)."""
    y = transform(state, x)
    y[..., keep:] = 0.0
    return inverse_transform(state, y)
