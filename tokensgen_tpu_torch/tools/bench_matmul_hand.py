"""T7: a hand-written bf16 GEMM (f32 accumulator, bf16 out) at the DiT's dense
shapes, counterpart of the JAX package's ``tools/bench_matmul_pallas.py``
(`_mm_kernel`), timed beside `torch.matmul` on the same inputs.

    python -m tokensgen_tpu_torch.tools.bench_matmul_hand [--device cpu]
        [--m 36352] [--shapes 3072x12288,12288x3072,3072x9216,3072x3072]

M = the CFG-batched joint rows (2 x 18,256, rounded down to 512: 36,352);
per (K, N) of the script (ff up, ff down, qkv, proj), x [M, K] and y [K, N]
bf16 (0.1 x standard normal, from a seed), it prints `probes.matmul_hand`'s
median time and TFLOP/s (2 M K N), `torch.matmul`'s time (the library call,
timed only), and the error against the plain version. On the card the
kernel is csrc/probe_gemm.cu's: one block an SM walking 128 x 256 output
tiles, a and b by TMA through a ring of k tiles, wgmma, TMA stores.
"""

from __future__ import annotations

import numpy as np
import torch

from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common as C

M = (2 * 18256 // 512) * 512
SHAPES = "3072x12288,12288x3072,3072x9216,3072x3072"
NAMES = {(3072, 12288): "ff up", (12288, 3072): "ff down", (3072, 9216): "qkv",
         (3072, 3072): "proj"}


def make_inputs(dev, m: int, kdim: int, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
                 .to(dev).bfloat16() for s in ((m, kdim), (kdim, n)))


def main(argv=None):
    ap = C.parser(__doc__)
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--shapes", default=SHAPES, help="comma-separated KxN")
    args = ap.parse_args(argv)
    dev = C.device_of(args)
    if dev.type == "cuda":
        P.build_probes()
    print(f"matmul_hand on {C.device_name(dev)}, M = {args.m}", flush=True)
    results = []
    for shape in args.shapes.split(","):
        kdim, n = (int(x) for x in shape.split("x"))
        x, y = make_inputs(dev, args.m, kdim, n)
        ref = P.matmul_plain(x, y)
        rel, err = C.agreement(P.matmul_hand(x, y), ref)
        ref_max = ref.float().abs().max().item()
        del ref
        ms = C.time_ms(lambda: P.matmul_hand(x, y), dev, args.runs)
        library_ms = C.time_ms(lambda: torch.matmul(x, y), dev, args.runs)
        flops = 2.0 * args.m * kdim * n
        name = NAMES.get((kdim, n), "")
        print(f"{name:7s} [{args.m},{kdim}]x[{kdim},{n}]: {ms:9.3f} ms "
              f"{flops / ms / 1e9:7.1f} TFLOP/s (torch.matmul {library_ms:.3f} ms, "
              f"{library_ms / ms:.2f}x) rel_l2_err {rel:.2e} max_abs_err {err:.2e}", flush=True)
        results.append(dict(m=args.m, k=kdim, n=n, name=name, ms=ms, rel_l2_err=rel,
                            max_abs_err=err, ref_max=ref_max, tflops=flops / ms / 1e9,
                            library_ms=library_ms))
        del x, y
    return results


if __name__ == "__main__":
    main()
