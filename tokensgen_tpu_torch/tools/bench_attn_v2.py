"""T2: flash attention with the key bias on every kv tile ("full") or only on
the last ("last"), counterpart of the JAX package's ``tools/bench_attn_v2.py``
(`_kernel_v2`).

    python -m tokensgen_tpu_torch.tools.bench_attn_v2 [--device cpu]
        [--batch 1] [--heads 48] [--seq 17776] [--runs 5]

At the script's shape ([1, 48, 17,776, 64] bf16, zero key bias, ragged last
kv tile) it runs `probes.attention_v2` in both bias modes at each
(block_q, block_kv, hblk) of `probes.SWEEP_CONFIGS` (the script sweeps the
same three axes) and prints the median time, TFLOP/s and the error against
the plain version of that mode at the tile's block_kv. On the card both
modes run T1's kernel ("full" is T1's launch). The TPU script's contiguous
per-head scratch has no counterpart here (each warpgroup keeps its rows'
m / l / acc in registers).
"""

from __future__ import annotations

from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common as C
from tokensgen_tpu_torch.tools.bench_attn_sweep import make_inputs


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
    flops = 4.0 * args.batch * args.heads * args.seq ** 2 * 64
    print(f"attention_v2 [{args.batch}, {args.heads}, {args.seq}, 64] bf16 on "
          f"{C.device_name(dev)}", flush=True)
    results = []
    for mode in P.BIAS_MODES:
        for bq, bkv, hb in P.SWEEP_CONFIGS:
            ref = P.attention_v2_plain(q, k, v, bias, bkv, mode)
            fn = lambda: P.attention_v2(q, k, v, bias, bq, bkv, mode, hb)  # noqa: E731
            rel, err = C.agreement(fn(), ref)
            del ref
            ms = C.time_ms(fn, dev, args.runs)
            print(f"bq={bq:4d} bkv={bkv:4d} hblk={hb} {mode:4s}: {ms:9.3f} ms "
                  f"{flops / ms / 1e9:7.1f} TFLOP/s rel_l2_err {rel:.2e} max_abs_err {err:.2e}",
                  flush=True)
            results.append(dict(block_q=bq, block_kv=bkv, hblk=hb, bias_mode=mode, ms=ms,
                                rel_l2_err=rel, max_abs_err=err, tflops=flops / ms / 1e9))
    return results


if __name__ == "__main__":
    main()
