"""T3a / T3b: the max-free head-pair attention variants of the JAX package's
``tools/bench_attn_r3.py`` on the card: split p@v (`_packed_kernel_splitpv`,
`probes.attention_splitpv`) and two head pairs per block
(`_packed_kernel_pair2`, `probes.attention_pair2`), each against the port's
shipped kernel for the same call.

    python -m tokensgen_tpu_torch.tools.bench_attn_r3 [--device cpu]
        [--heads 48] [--text 226] [--grid 13x30x45] [--vip-grid 5x8x12]
        [--runs 5]

The script's inputs (`make_inputs`): bf16 [1, S, 48*64] q / k / v drawn from
a seeded generator, S = 226 text + 13 x 30 x 45 video = 17,776 tokens, qk-norm
gain g = |N(0, 1)| + 0.5 and bias 0.1 N(0, 1) over the 64 head dims, the 3-D
RoPE, no key bias; the vip side 5 x 8 x 12 = 480 tokens. Cases, as the
script's `main`:
  joint   17,776 x 17,776: shipped K1 (`fused_attention_joint`), split p@v at
          each (block_q, block_kv) of `probes.SPLITPV_CONFIGS`, pair2 at each
          block_kv of `probes.PAIR2_BLOCK_KV`;
  cross1  17,776 q x 480 vip keys: shipped K2, pair2;
  cross2  480 vip q x 18,256 keys ([joint || vip]): shipped K3, pair2.
Each line: the median time (CUDA events), TFLOP/s (4 B Sq Skv H*64), the
error against the max-free plain version (`probes.attention_maxfree_plain`)
and against the shipped kernel. The score shift C (`probes.score_shift`) is
computed once per case's tables and passed in, so the times leave it out.
The TPU script's 1024-4096-row blocks do not fit an SM; the tiles are the
card's. ``--device cpu`` runs the plain versions on the host at any size.
"""

from __future__ import annotations

import numpy as np
import torch

from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2
from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common as C

D = 64


def make_inputs(dev, heads: int = 48, text: int = 226, grid=(13, 30, 45), vip_grid=(5, 8, 12),
                seed: int = 0, batch: int = 1) -> dict:
    """The round-3 scripts' tensors and tables: q, k, v over [text || video],
    the vip k / v (kv, vv) and q (qv), the keys of [joint || vip] (kcat,
    vcat), each with ``batch`` rows; joint tables tq / tk, vip-side tables
    tq_tv (joint q), tk_vip, tq_vip and tk_all (every key of [joint || vip]),
    shared by the rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = text + int(np.prod(grid))
    s_vip = int(np.prod(vip_grid))

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    q, k, v = (randn(batch, s, heads * D).bfloat16() for _ in range(3))
    g = randn(D).abs() + 0.5
    bs = randn(D, std=0.1)
    kv, vv, qv = (randn(batch, s_vip, heads * D).bfloat16() for _ in range(3))

    def rope(shape, t_offset=0.0):
        return get_3d_rotary_pos_embed_v2(
            D, np.arange(shape[0], dtype=np.float32) + t_offset,
            *(np.arange(n, dtype=np.float32) for n in shape[1:]), device=dev)

    segs = [(None, text), (rope(grid), s - text)]
    vsegs = [(None, text), (rope(grid, 1000.0), s - text), (rope(vip_grid, 1000.0), s_vip)]
    vtq = A.make_prologue(D, vsegs, g, bs, fold=D ** -0.5)
    vtk = A.make_prologue(D, vsegs, g, bs)
    return dict(q=q, k=k, v=v, kv=kv, vv=vv, qv=qv, kcat=torch.cat([k, kv], 1),
                vcat=torch.cat([v, vv], 1),
                tq=A.make_prologue(D, segs, g, bs, fold=D ** -0.5),
                tk=A.make_prologue(D, segs, g, bs),
                tq_tv=A.slice_tabs(vtq, 0, s), tk_vip=A.slice_tabs(vtk, s, s + s_vip),
                tq_vip=A.slice_tabs(vtq, s, s + s_vip), tk_all=vtk)


def parser(doc: str):
    ap = C.parser(doc)
    ap.add_argument("--heads", type=int, default=48)
    ap.add_argument("--text", type=int, default=226)
    ap.add_argument("--grid", type=C.parse_grid, default=(13, 30, 45),
                    help="video latent frames x height x width")
    ap.add_argument("--vip-grid", type=C.parse_grid, default=(5, 8, 12),
                    help="vip token frames x height x width")
    return ap


def shipped_case(label: str, shipped_fn, dev, runs: int, flops: float):
    """The shipped kernel's output and its timed line."""
    out = shipped_fn()
    ms = C.time_ms(shipped_fn, dev, runs)
    print(f"{label:34s} {ms:9.3f} ms {flops / ms / 1e9:7.1f} TFLOP/s (shipped)", flush=True)
    return out


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = C.device_of(args)
    if dev.type == "cuda":
        P.build_probes()
    h = args.heads
    x = make_inputs(dev, h, args.text, args.grid, args.vip_grid)
    print(f"round-3 attention probes, {h} heads of {D}, bf16 on {C.device_name(dev)}", flush=True)
    results = []
    calls = (  # (case, q, k, v, tables q, tables k, shipped kernel)
        ("joint", x["q"], x["k"], x["v"], x["tq"], x["tk"], A.fused_attention_joint),
        ("cross1", x["q"], x["kv"], x["vv"], x["tq_tv"], x["tk_vip"],
         A.fused_attention_cross_smallkv),
        ("cross2", x["qv"], x["kcat"], x["vcat"], x["tq_vip"], x["tk_all"],
         A.fused_attention_cross_smallq),
    )
    for case, q, k, v, tq, tk, shipped_fn in calls:
        sq, skv = q.shape[1], k.shape[1]
        flops = 4.0 * sq * skv * h * D
        shift = P.score_shift(tq, tk).item()
        print(f"{case} {sq:,} x {skv:,}: score shift C = {shift:.6g}", flush=True)
        shipped = shipped_case(f"{case} {shipped_fn.__name__}",
                               lambda: shipped_fn(q, k, v, tq, tk, None, h), dev, args.runs, flops)
        ref = P.attention_maxfree_plain(q, k, v, None, tq, tk, h, shift)
        if case == "joint":
            for bq, bkv in P.SPLITPV_CONFIGS:
                results.append(C.max_free_case(
                    f"{case} splitpv bq={bq} bkv={bkv}",
                    lambda: P.attention_splitpv(q, k, v, None, tq, tk, h, bq, bkv, shift=shift),
                    ref, shipped, flops, dev, args.runs, shape=case, variant="splitpv",
                    block_q=bq, block_kv=bkv))
        for bkv in P.PAIR2_BLOCK_KV:
            results.append(C.max_free_case(
                f"{case} pair2 bq={P.PAIR2_BLOCK_Q} bkv={bkv}",
                lambda: P.attention_pair2(q, k, v, None, tq, tk, h, bkv, shift=shift),
                ref, shipped, flops, dev, args.runs, shape=case, variant="pair2",
                block_q=P.PAIR2_BLOCK_Q, block_kv=bkv))
        del shipped, ref
    return results


if __name__ == "__main__":
    main()
