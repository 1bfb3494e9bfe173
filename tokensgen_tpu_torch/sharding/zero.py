"""ZeRO-1: the optimizer state split over the data ranks (port of
`tokensgen_tpu/sharding/zero.py`).

The JAX package annotates every optimizer-state leaf as sharded over the
mesh's ``data`` axis (the first dimension divisible by the axis size) and
lets XLA place the reduce-scatter / all-gather pair around the update. Here
each rank is a process, so the layout is explicit: every trainable tensor is
seen flat, and rank ``r`` owns elements ``[r * chunk, (r + 1) * chunk)`` of
it (cut at its end), ``chunk`` a whole number of `ALIGN` (256) values.
The optimizer runs on the owned parts only (its state is made for them);
after the update every rank's part is all-gathered into every rank's
parameters. Tensors too small to give each rank at least one `ALIGN` block
stay replicated, as the JAX rule leaves leaves with no divisible dimension
replicated: every rank holds their whole state and updates them alike.

AdamW, Adam and the int8 AdamW are elementwise, so a split does not change
their arithmetic; the int8 moments quantize blocks of 256 values of the flat
tensor, which the 256-value alignment keeps whole (the whole tensor's size,
not the part's, decides whether a tensor's moments are int8:
`AdamW8bit(sizes=)`). Prodigy's two sums run over every rank's part
(`Prodigy(reduce=)`).

A checkpoint holds each rank's part with its element range
(`checkpoint.save_checkpoint(parts=)`); `restore_part` cuts the part of any
other layout (another rank count, or the whole tensors of a replicated
optimizer) out of them.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

ALIGN = 256  # values: the int8 AdamW's quantization block


class ZeroLayout:
    """The ZeRO-1 layout of named tensors of ``numels`` over ``ranks``
    ranks, seen from ``rank``: ``ranges[name]`` is the ``[lo, hi)`` of the
    flat tensor this rank owns (the whole tensor where it is replicated) and
    ``chunk[name]`` the elements a rank owns (0 where replicated)."""

    def __init__(self, numels: Dict[str, int], ranks: int, rank: int, align: int = ALIGN):
        if not 0 <= rank < ranks:
            raise ValueError(f"rank {rank} of {ranks}")
        self.ranks, self.rank, self.align = ranks, rank, align
        self.numels = dict(numels)
        self.ranges: Dict[str, Tuple[int, int]] = {}
        self.chunk: Dict[str, int] = {}
        for name, n in self.numels.items():
            if ranks > 1 and n >= ranks * align:
                c = math.ceil(n / (ranks * align)) * align
                lo = min(rank * c, n)
                self.ranges[name], self.chunk[name] = (lo, min(lo + c, n)), c
            else:
                self.ranges[name], self.chunk[name] = (0, n), 0

    @classmethod
    def of(cls, tensors: Dict[str, torch.Tensor], ranks: int, rank: int,
           align: int = ALIGN) -> "ZeroLayout":
        return cls({n: t.numel() for n, t in tensors.items()}, ranks, rank, align)

    def split(self, name: str) -> bool:
        return self.chunk[name] > 0

    def owned(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's part of each tensor: a flat view (writes land in the
        tensor)."""
        out = {}
        for name, t in tensors.items():
            lo, hi = self.ranges[name]
            out[name] = t.detach().view(-1)[lo:hi]
        return out

    def gather_items(self, tensors: Dict[str, torch.Tensor]) -> List[tuple]:
        """``(flat view, chunk)`` of each split tensor, for
        `DataGroup.all_gather_parts_`."""
        return [(t.detach().view(-1), self.chunk[n]) for n, t in tensors.items() if self.split(n)]


def state_nbytes(state) -> int:
    """Bytes of every tensor in an optimizer's ``state_dict`` (nested)."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_nbytes(v) for v in state)
    return 0


def sharded_bytes_per_device(make_optimizer, params: Dict[str, torch.Tensor],
                             ranks: int) -> int:
    """Bytes of optimizer state on the rank with the largest part (rank 0)
    of the ZeRO-1 layout over ``ranks``: ``make_optimizer(parts, sizes)``
    is built on rank 0's parts of ``params`` (meta tensors do: nothing is
    allocated)."""
    layout = ZeroLayout.of(params, ranks, 0)
    opt = make_optimizer(layout.owned(params), {n: p.numel() for n, p in params.items()})
    return state_nbytes(opt.state_dict())


# ------------------------------------------------------------- checkpoints


def _per_name_keys(state: Dict, names) -> List[str]:
    """The keys of an optimizer state dict that map each parameter name to
    its state (the rest are scalars the ranks share)."""
    names = set(names)
    return [k for k, v in state.items() if isinstance(v, dict) and v and set(v) == names]


def _blocks(n: int) -> int:
    return -(-n // ALIGN)


def _cut(value, plo: int, phi: int, lo: int, hi: int, pad: bool):
    """Elements ``[lo, hi)`` (inside the piece's ``[plo, phi)``) of one
    piece of a tensor's state: a tensor over the piece's elements, or an
    int8 moment (``q`` over the elements, padded to whole blocks, and
    per-block fields). ``pad``: the cut ends at the tensor's end, so the
    block padding of ``q`` comes along."""
    if isinstance(value, dict):
        a, b = (lo - plo) // ALIGN, _blocks(hi - plo)
        q = value["q"].reshape(-1)
        out = {"q": q[lo - plo:] if pad else q[lo - plo:hi - plo]}
        out.update({k: v[a:b] for k, v in value.items() if k != "q"})
        return out
    return value.reshape(-1)[lo - plo:hi - plo]


def _join(pieces):
    if isinstance(pieces[0], dict):
        return {k: torch.cat([p[k] for p in pieces]) for k in pieces[0]}
    return torch.cat(pieces) if len(pieces) > 1 else pieces[0].clone()


def restore_part(parts: Iterable[Tuple[Dict, Dict]], ranges: Dict[str, Tuple[int, int]],
                 numels: Dict[str, int], shapes: Optional[Dict[str, torch.Size]] = None) -> Dict:
    """The optimizer state of the element ranges ``ranges`` (a layout's
    ``ranges``, or the whole tensors) from the ``(ranges, state)`` parts a
    checkpoint holds (one per rank it was written at; a replicated
    optimizer's state is one part over the whole tensors). Ranges start on
    `ALIGN` boundaries, so int8 blocks are cut whole. With ``shapes`` (a
    replicated optimizer's), whole-tensor state takes the tensor's shape;
    int8 payloads stay flat."""
    parts = list(parts)
    first = parts[0][1]
    keys = _per_name_keys(first, numels)
    out = {k: v for k, v in first.items() if k not in keys}
    for key in keys:
        out[key] = {}
        for name, (lo, hi) in ranges.items():
            pieces = []
            for pranges, state in parts:
                plo, phi = pranges[name]
                a, b = max(lo, plo), min(hi, phi)
                if a < b or (a == b == lo == hi and plo <= lo <= phi):
                    pad = a < b == numels[name]
                    pieces.append(_cut(state[key][name], plo, phi, a, b, pad))
                    if a == b or b == hi:
                        break
            joined = _join(pieces)
            if shapes is not None and isinstance(joined, torch.Tensor) and (lo, hi) == (
                    0, numels[name]):
                joined = joined.reshape(shapes[name])
            out[key][name] = joined
    return out
