"""T5: the pair-loop smallkv cross attention of the JAX package's
``tools/bench_cross_pairloop.py`` on the card (`_smallkv_pairloop_kernel`,
`probes.cross_smallkv_pairloop`) against the port's shipped kernel for the
same call, K2 (`fused_attention_cross_smallkv`).

    python -m tokensgen_tpu_torch.tools.bench_cross_pairloop [--device cpu]
        [--batch 1] [--runs 5] [--heads 48] [--text 226] [--grid 13x30x45]
        [--vip-grid 5x8x12]

As the script's `main`: text_video q [B, 17,776, 48*64] bf16 against the 480
vip keys and values, no key bias, the round-3 scripts' tables
(`bench_attn_r3.make_inputs`; ``--batch`` is the script's B). The shipped
K2 is timed first, then T5 at each q block of `probes.PAIRLOOP_BLOCK_Q`
(0: one wave of blocks over the card's SMs; the script's 1,024 and 2,048
rows a block; 128 / 256 / 512). Each line as `bench_cross_r3`'s: the
median time (CUDA events) of the call, TFLOP/s (4 B Sq Skv H*64), the error
against the max-free plain version (`probes.attention_maxfree_plain`), then
the speedup over the shipped kernel and the error against it; on the card
each q block's kernel alone (`probes.pairloop_prologued`, on k prologued
once: the call also runs k's prologue in plain torch) follows, its device
time over 10 queued calls (`_common.queued_time_ms`). The score
shift C (`probes.score_shift`) is computed once and passed in. ``--device
cpu`` runs the plain versions.
"""

from __future__ import annotations

from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common as C
from tokensgen_tpu_torch.tools.bench_attn_r3 import D, make_inputs, parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=1, help="batch rows (the script's B)")
    args = ap.parse_args(argv)
    dev = C.device_of(args)
    if dev.type == "cuda":
        P.build_probes()
    h = args.heads
    x = make_inputs(dev, h, args.text, args.grid, args.vip_grid, batch=args.batch)
    q, k, v, tq, tk = x["q"], x["kv"], x["vv"], x["tq_tv"], x["tk_vip"]
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    flops = 4.0 * b * sq * skv * h * D
    shift = P.score_shift(tq, tk).item()
    print(f"pair-loop smallkv probe, {h} heads of {D}, B={b}, {sq:,} q x {skv:,} vip keys, bf16 "
          f"on {C.device_name(dev)}: score shift C = {shift:.6g}", flush=True)

    def shipped_fn():
        return A.fused_attention_cross_smallkv(q, k, v, tq, tk, None, h)

    shipped = shipped_fn()
    shipped_ms = C.time_ms(shipped_fn, dev, args.runs)
    print(f"{f'shipped smallkv (B={b})':34s} {shipped_ms:9.3f} ms "
          f"{flops / shipped_ms / 1e9:7.1f} TFLOP/s (shipped)", flush=True)
    ref = P.attention_maxfree_plain(q, k, v, None, tq, tk, h, shift)
    kn = A.merge_heads(A.apply_prologue_plain(A.split_heads(k, h), tk, 1e-6, True))
    results = []
    for bq in P.PAIRLOOP_BLOCK_Q:
        results.append(C.max_free_case(
            f"pair-loop smallkv bq={bq} (B={b})",
            lambda: P.cross_smallkv_pairloop(q, k, v, None, tq, tk, h, bq, shift=shift), ref,
            shipped, flops, dev, args.runs, shipped_ms=shipped_ms, shape="cross1",
            variant="pairloop", block_q=bq))
        if dev.type == "cuda":
            ms = C.queued_time_ms(lambda: P.pairloop_prologued(q, kn, v, None, tq, h, shift, bq),
                                  dev, args.runs)
            results[-1]["kernel_ms"] = ms
            print(f"{f'  its kernel alone (bq={bq})':34s} {ms:9.3f} ms "
                  f"{flops / ms / 1e9:7.1f} TFLOP/s", flush=True)
    return results


if __name__ == "__main__":
    main()
