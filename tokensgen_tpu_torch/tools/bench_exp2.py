"""T8: the throughput of exp2 (the instruction ex2.approx.f32 that K1's
softmax runs on) against a plain multiply, on a register-resident f32 block,
counterpart of the JAX package's ``tools/bench_vpu_exp2.py`` (`make_kernel`).

    python -m tokensgen_tpu_torch.tools.bench_exp2 [--device cpu]
        [--rows 2048] [--cols 2048] [--n-iter 256]

For each op (mul: x * 1.0000001; exp2: 2^(x/2); exp2_add: 2^(x/2 + 1/8), the
softmax pass with its bias add) over x uniform in [-1, 1) (from a seed) it
prints `probes.exp2_loop`'s median time, microseconds per pass, Gelem/s
(rows x cols x n_iter per call) and the error against the plain version.
exp2_add has no fixed point: its values pass 2^128 and stay infinite after
about 30 passes, as in the JAX probe (the rate of ex2 on infinities is the
rate measured there too); equal infinities count as agreement.
"""

from __future__ import annotations

import torch

from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common as C


def make_input(dev, rows: int, cols: int, seed: int = 0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(rows, cols, generator=gen, device=dev) * 2.0 - 1.0


def main(argv=None):
    ap = C.parser(__doc__)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--cols", type=int, default=2048)
    ap.add_argument("--n-iter", type=int, default=256)
    args = ap.parse_args(argv)
    dev = C.device_of(args)
    if dev.type == "cuda":
        P.build_probes()
    x = make_input(dev, args.rows, args.cols)
    elems = args.rows * args.cols * args.n_iter
    print(f"exp2_loop [{args.rows}x{args.cols}] f32, {args.n_iter} passes, on "
          f"{C.device_name(dev)}", flush=True)
    results = []
    for op in P.EXP2_OPS:
        rel, err = C.agreement(P.exp2_loop(x, args.n_iter, op),
                               P.exp2_loop_plain(x, args.n_iter, op))
        ms = C.time_ms(lambda: P.exp2_loop(x, args.n_iter, op), dev, args.runs)
        print(f"{op:9s}: {ms:9.3f} ms {ms * 1e3 / max(args.n_iter, 1):8.3f} us/pass "
              f"{elems / ms / 1e6:8.1f} Gelem/s rel_l2_err {rel:.2e} max_abs_err {err:.2e}",
              flush=True)
        results.append(dict(op=op, rows=args.rows, cols=args.cols, n_iter=args.n_iter, ms=ms,
                            rel_l2_err=rel, max_abs_err=err, gelems=elems / ms / 1e6))
    return results


if __name__ == "__main__":
    main()
