"""Value-range diagnostics: the min / max / mean / std prints that the
reference used as its numeric regression check, at the places the JAX
package prints them (port of `tokensgen_tpu/utils/debug.py`).

Enable with ``TOKENSGEN_DEBUG=1`` (read at import, as there). Off, `stats`
returns its input and does nothing else: no reduction runs and nothing
waits for the device.
"""

from __future__ import annotations

import os

import torch

_ENABLED = os.environ.get("TOKENSGEN_DEBUG") == "1"


def enabled() -> bool:
    return _ENABLED


def stats(name: str, x: torch.Tensor) -> torch.Tensor:
    """Prints ``name: min .. max .. mean .. std ..`` of ``x`` (in float32;
    the std over all elements, ddof 0) when enabled; returns ``x``."""
    if not _ENABLED:
        return x
    xf = x.float()
    mn, mx, me, sd = (v.item() for v in (xf.min(), xf.max(), xf.mean(), xf.std(correction=0)))
    print(f"{name}: min {mn:.4f} max {mx:.4f} mean {me:.4f} std {sd:.4f}", flush=True)
    return x
