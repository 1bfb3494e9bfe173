"""K3's and K4's split-KV forward over split counts: the device time of one
call at each count (its kernels' times summed, torch.profiler) beside
`kernels.attention.kv_split_plan`'s modelled cost, at the edit path's
shapes: K4 ([1, H, 384, d] x 17,934 keys, the resampler's 1,024-wide
attention as H = 1024 / d heads of d = 64, 128, 32 and 16) and K3
([2, 480, 48 x 64] x 18,256 keys). The plan's own count is marked with a
star. With --device cpu it prints the plans and the modelled costs only:
the kernels run on the card alone.

    python -m tokensgen_tpu_torch.tools.bench_splitkv [--max-splits 24] [--runs 8]
"""

from __future__ import annotations

import re

import torch

from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.tools import _common

H100_SMS = 132  # the plan's SM count where no card is present

# (kernel, B, H, Sq, Skv, d)
SHAPES = (("K4", 1, 16, 384, 17934, 64), ("K4", 1, 8, 384, 17934, 128),
          ("K4", 1, 32, 384, 17934, 32), ("K4", 1, 64, 384, 17934, 16),
          ("K3", 2, 48, 480, 18256, 64))


def device_ms(fn, calls: int) -> float:
    """Mean device time of one call of ``fn``: its split-KV kernels' (the
    prologue pass, the body, the combine) times from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and re.search(
                r"(splitkv|combine|prologue)_kernel", evt.key):
            us += t
    return us / calls / 1e3


def _launcher(kernel, b, h, sq, skv, d, dev):
    """A call of K3 or K4 at one shape with random bf16 operands, taking the
    split count to force."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    if kernel == "K4":
        q, k, v = randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d)
        return lambda n: A._launch_bhsd(q, k, v, None, d ** -0.5, splits=n)
    q, k, v = randn(b, sq, h * d), randn(b, skv, h * d), randn(b, skv, h * d)
    tq = A.make_prologue(d, [(None, sq)], fold=d ** -0.5, device=dev)
    tk = A.make_prologue(d, [(None, skv)], device=dev)
    return lambda n: A._launch_smallq(q, k, v, None, tq, tk, h, 1e-6, True, True, splits=n)


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("--max-splits", type=int, default=24, help="largest split count asked for")
    args = ap.parse_args(argv)
    dev = _common.device_of(args)
    on_card = dev.type == "cuda"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if on_card else H100_SMS
    print(f"device {_common.device_name(dev)}, {sms} SMs; per split count: modelled cost "
          f"(makespan + SPLIT_COST x splits){', device ms' if on_card else ''}", flush=True)
    for kernel, b, h, sq, skv, d in SHAPES:
        plan = A.kv_split_plan(b, h, sq, skv, d, sms)
        tiles = -(-skv // A.kv_tile(d))
        counts = sorted({A.kv_split_plan(b, h, sq, skv, d, sms, n)[0]
                         for n in range(1, args.max_splits + 1)})
        call = _launcher(kernel, b, h, sq, skv, d, dev) if on_card else None
        parts = []
        for n in counts:
            cost = A._split_makespan(b, h, sq, tiles, d, sms, n) + A.SPLIT_COST * n
            part = f"{n}{'*' if n == plan[0] else ''}: {cost}"
            if on_card:
                part += f" {device_ms(lambda: call(n), args.runs):.4f}"
            parts.append(part)
        print(f"{kernel} [{b}, {h}, {sq}, {d}] x {skv:,}: plan {plan}; " + " | ".join(parts),
              flush=True)
        del call
        if on_card:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
