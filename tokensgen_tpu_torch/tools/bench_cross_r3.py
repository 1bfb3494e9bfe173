"""T4a / T4b: the max-free VIP cross-attention variants of the JAX package's
``tools/bench_cross_r3.py`` on the card: K2's call with the head fastest in
the grid (`_smallkv_kernel`, `probes.cross_smallkv_pairinner`) and K3's split
over the keys (`_smallq_kernel`, `probes.cross_smallq_splitkv`), each against
the port's shipped kernel for the same call.

    python -m tokensgen_tpu_torch.tools.bench_cross_r3 [--device cpu]
        [--heads 48] [--text 226] [--grid 13x30x45] [--vip-grid 5x8x12]
        [--runs 5]

The script's inputs (`bench_attn_r3.make_inputs`, VIP func_type "1" tables).
Cases, as the script's `main`:
  cross1  17,776 q x 480 vip keys: shipped K2 (`fused_attention_cross_smallkv`),
          then pairinner at each q block of `probes.PAIRINNER_BLOCK_Q`;
  cross2  480 vip q x 18,256 keys: shipped K3 (`fused_attention_cross_smallq`),
          then splitkv at each split of `probes.SPLITKV_BLOCK_KV`.
Each line as `bench_attn_r3`'s: time, TFLOP/s, the error against the
max-free plain version and against the shipped kernel; C is computed once
per case and passed in. ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common as C
from tokensgen_tpu_torch.tools.bench_attn_r3 import D, make_inputs, parser, shipped_case


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = C.device_of(args)
    if dev.type == "cuda":
        P.build_probes()
    h = args.heads
    x = make_inputs(dev, h, args.text, args.grid, args.vip_grid)
    print(f"round-3 cross-attention probes, {h} heads of {D}, bf16 on {C.device_name(dev)}",
          flush=True)
    results = []
    calls = (  # (case, q, k, v, tables q, tables k, shipped kernel, probe, its tiles)
        ("cross1", x["q"], x["kv"], x["vv"], x["tq_tv"], x["tk_vip"],
         A.fused_attention_cross_smallkv, P.cross_smallkv_pairinner, P.PAIRINNER_BLOCK_Q),
        ("cross2", x["qv"], x["kcat"], x["vcat"], x["tq_vip"], x["tk_all"],
         A.fused_attention_cross_smallq, P.cross_smallq_splitkv, P.SPLITKV_BLOCK_KV),
    )
    for case, q, k, v, tq, tk, shipped_fn, probe, tiles in calls:
        sq, skv = q.shape[1], k.shape[1]
        flops = 4.0 * sq * skv * h * D
        shift = P.score_shift(tq, tk).item()
        print(f"{case} {sq:,} x {skv:,}: score shift C = {shift:.6g}", flush=True)
        shipped = shipped_case(f"{case} {shipped_fn.__name__}",
                               lambda: shipped_fn(q, k, v, tq, tk, None, h), dev, args.runs, flops)
        ref = P.attention_maxfree_plain(q, k, v, None, tq, tk, h, shift)
        for tile in tiles:
            results.append(C.max_free_case(
                f"{case} {probe.__name__} {tile}",
                lambda: probe(q, k, v, None, tq, tk, h, tile, shift=shift), ref, shipped, flops,
                dev, args.runs, shape=case, variant=probe.__name__, tile=tile))
        del shipped, ref
    return results


if __name__ == "__main__":
    main()
