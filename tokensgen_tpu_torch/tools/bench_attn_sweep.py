"""T1: the K4-family flash attention at the card's tile sweep, counterpart of
the JAX package's ``tools/bench_attn_sweep.py`` (K4's Pallas `_flash_kernel`
at explicit block_q / block_kv / hblk).

    python -m tokensgen_tpu_torch.tools.bench_attn_sweep [--device cpu]
        [--batch 1] [--heads 48] [--seq 17776] [--runs 5]

At the script's shape, [1, 48, 17,776, 64] bf16 q / k / v (independent
standard normal draws from a seed) and a zero key bias (17,776 is not a
multiple of any kv tile, so the last tile is ragged), it runs
`probes.attention_sweep` at every (block_q, block_kv, heads per block) of
`probes.SWEEP_CONFIGS` and prints, per configuration, the median time, TFLOP/s (4 B H S^2 D) and the error against
the plain version.
"""

from __future__ import annotations

import torch

from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common as C


def make_inputs(dev, batch: int, heads: int, seq: int, seed: int = 0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(batch, heads, seq, 64, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    return q, k, v, torch.zeros(batch, seq, device=dev)


def main(argv=None):
    ap = C.parser(__doc__)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--heads", type=int, default=48)
    ap.add_argument("--seq", type=int, default=17776)
    args = ap.parse_args(argv)
    dev = C.device_of(args)
    if dev.type == "cuda":
        P.build_probes()
    q, k, v, bias = make_inputs(dev, args.batch, args.heads, args.seq)
    ref = P.attention_sweep_plain(q, k, v, bias)
    flops = 4.0 * args.batch * args.heads * args.seq ** 2 * 64
    name = C.device_name(dev)
    print(f"attention_sweep [{args.batch}, {args.heads}, {args.seq}, 64] bf16 on {name}",
          flush=True)
    results = []
    for bq, bkv, hb in P.SWEEP_CONFIGS:
        fn = lambda: P.attention_sweep(q, k, v, bias, bq, bkv, hb)  # noqa: E731
        rel, err = C.agreement(fn(), ref)
        ms = C.time_ms(fn, dev, args.runs)
        print(f"bq={bq:4d} bkv={bkv:4d} hblk={hb}: {ms:9.3f} ms {flops / ms / 1e9:7.1f} TFLOP/s "
              f"rel_l2_err {rel:.2e} max_abs_err {err:.2e}", flush=True)
        results.append(dict(block_q=bq, block_kv=bkv, hblk=hb, ms=ms, rel_l2_err=rel,
                            max_abs_err=err, tflops=flops / ms / 1e9))
    return results


if __name__ == "__main__":
    main()
