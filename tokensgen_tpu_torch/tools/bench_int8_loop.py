"""T6: the flash inner loop chained through requantized scores, in bf16 (f32
sums) and in int8 (int32 sums), counterpart of the JAX package's
``tools/bench_pallas_int8.py`` (`_flash_like_kernel`): does the card run the
int8 products inside a flash loop faster than the bf16 ones?

    python -m tokensgen_tpu_torch.tools.bench_int8_loop [--device cpu]
        [--iters 500] [--check-iters 4] [--shapes 2048x1024x128,2048x2048x128]

Per (m, n, d) of the script (q [m, d], k [d, n], v [n, d]; bf16 standard
normal, int8 uniform integers in [-127, 127), from a seed) and each type, it
times `probes.flash_loop` at ``--iters`` steps and prints the median time,
the microseconds per step and TOP/s counting both chains (iters x 2 x 4 m n
d). The error against the plain version is taken at ``--check-iters`` steps:
the bf16 chain shrinks by about 11/64 a step (q <- bf16(s / 64), |s| ~
sqrt(d) |q|), so later steps compare numbers near underflow; the int8 chain
does not decay and must be bit-equal.
"""

from __future__ import annotations

import numpy as np
import torch

from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common as C

SHAPES = "2048x1024x128,2048x2048x128"


def make_inputs(dev, m: int, n: int, d: int, dtype: torch.dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        arrs = [rng.integers(-127, 127, s) for s in ((m, d), (d, n), (n, d))]
    else:
        arrs = [rng.standard_normal(s) for s in ((m, d), (d, n), (n, d))]
    return tuple(torch.from_numpy(a).to(dtype).to(dev) for a in arrs)


def main(argv=None):
    ap = C.parser(__doc__)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--check-iters", type=int, default=4)
    ap.add_argument("--shapes", default=SHAPES, help="comma-separated MxNxD")
    args = ap.parse_args(argv)
    dev = C.device_of(args)
    if dev.type == "cuda":
        P.build_probes()
    print(f"flash_loop on {C.device_name(dev)}: {args.iters} steps timed, "
          f"{args.check_iters} checked", flush=True)
    results = []
    for shape in args.shapes.split(","):
        m, n, d = (int(x) for x in shape.split("x"))
        for dtype in (torch.bfloat16, torch.int8):
            q, k, v = make_inputs(dev, m, n, d, dtype)
            out = P.flash_loop(q, k, v, args.check_iters)
            rel, err = C.agreement(out, P.flash_loop_plain(q, k, v, args.check_iters))
            ms = C.time_ms(lambda: P.flash_loop(q, k, v, args.iters), dev, args.runs)
            ops = args.iters * 2 * 4.0 * m * n * d
            label = "int8" if dtype == torch.int8 else "bf16"
            print(f"q{m} kv{n} d{d} {label}: {ms:9.3f} ms {ms * 1e3 / max(args.iters, 1):8.2f} "
                  f"us/step {ops / ms / 1e9:7.1f} TOP/s rel_l2_err {rel:.2e} max_abs_err "
                  f"{err:.2e}", flush=True)
            results.append(dict(m=m, n=n, d=d, dtype=label, iters=args.iters, ms=ms,
                                rel_l2_err=rel, max_abs_err=err, tops=ops / ms / 1e9))
    return results


if __name__ == "__main__":
    main()
