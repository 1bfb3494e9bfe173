"""A trainer's data axis on several cards: one of the two trainer CLIs'
configs over ``--dp`` ranks (one process a card, NCCL; `sharding/mesh.py`'s
`DataGroup`, ZeRO-1 with ``--set zero1=true``), `STEPS` micro-steps, then
every rank's peak device memory and each step's seconds split into data,
staging, train step (forward and backward), all-reduce, optimizer and
all-gather, beside `train/memory.py`'s budget of the same layout. The
weights are random from the config's seed, the batches synthetic (the
configs' ``csv_file`` is unset); the config's text encoder and PCA files
are not in the repository, so the T5 path and ``longvgen_pca`` are unset
(the hash text encoder, the random PCA stand-in).

    python -m tokensgen_tpu_torch.tools.bench_dp_train --trainer t2to --dp 4 \\
        --set zero1=true [--out dp_t2to.json]
    python -m tokensgen_tpu_torch.tools.bench_dp_train --trainer to2v --dp 4 \\
        --set zero1=true --set gradient_accumulation_steps=1
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, Optional

import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = {"t2to": "tokensgen_tpu/configs/train_t2to.yaml",
           "to2v": "tokensgen_tpu/configs/train_to2v.yaml"}
# no weight files in the repository: the hash text encoder and the random PCA
UNSET = {"pretrained_text_encoder_path": None, "longvgen_pca": None, "checkpointing_steps": 10 ** 9}
STEPS = 2  # micro-steps: the first warms up, the second is the steady step
STEP_KEYS = ("data_s", "staging_s", "train_step_s", "all_reduce_s", "optimizer_s",
             "all_gather_s", "peak_gib")


def _rank(group, kind: str, overrides: Dict) -> Optional[Dict]:
    """One rank: build the trainer, run `STEPS` micro-steps -> on rank 0
    every rank's step figures ([rank][step][STEP_KEYS]), build seconds and
    peak, optimizer-state bytes and rank 0's records."""
    from tokensgen_tpu_torch.sharding.zero import state_nbytes
    from tokensgen_tpu_torch.train_t2to import T2ToTrainer
    from tokensgen_tpu_torch.train_to2v import To2VTrainer
    from tokensgen_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, CONFIGS[kind]), overrides)
    dev = torch.device(group.device if group is not None else "cuda")
    t0 = time.perf_counter()
    trainer = (T2ToTrainer if kind == "t2to" else To2VTrainer)(cfg, False, dev, group=group)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    build_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    if group is not None:  # the ranks build at their own pace: the first step's
        group.barrier()  # all-reduce then waits for no build
    try:
        records = trainer.run(STEPS, save_final=False)
        fn = trainer.step_fn
        opt_bytes = state_nbytes(fn.optimizer.state_dict())
        meta = {"layers": trainer.dcfg.num_layers, "optimizer": type(fn.optimizer).__name__,
                "trainable": sum(p.numel() for p in fn.params.values()),
                "tensors": len(fn.params), "split": 0 if fn.zero is None else sum(
                    fn.zero.layout.split(n) for n in fn.params),
                "per_gpu_batch_size": trainer.batch_size, "global_batch": trainer.global_batch}
    finally:
        trainer.close()
    size, rank = (group.size, group.rank) if group is not None else (1, 0)
    table = torch.zeros(size, len(records), len(STEP_KEYS) + 3, dtype=torch.float64)
    for i, rec in enumerate(records):
        table[rank, i, :len(STEP_KEYS)] = torch.tensor(
            [float(rec.get(k) or 0.0) for k in STEP_KEYS], dtype=torch.float64)
    table[rank, :, -3:] = torch.tensor([build_s, build_peak, opt_bytes], dtype=torch.float64)
    if group is not None:
        table = group.sum_(table.to(group.device)).cpu()
        if not group.leader:
            return None
    return dict(meta, table=table.tolist(), records=records)


def _budget(kind: str, cfg, dp: int):
    """`train/memory.py`'s budget of the run's layout."""
    from tokensgen_tpu_torch.train import memory

    zero = dp if cfg.get("zero1") else 1
    b = int(cfg.get("per_gpu_batch_size", 1))
    if kind == "t2to":
        return memory.t2to_budget(per_device_batch=b, zero_ranks=zero,
                                  max_chunks=int(cfg.get_path("train_data_params.max_num_chunks",
                                                              24)),
                                  use_8bit_adam=bool(cfg.get("use_8bit_adam")))
    return memory.to2v_budget(per_device_batch=b, zero_ranks=zero)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--trainer", choices=sorted(CONFIGS), required=True)
    ap.add_argument("--dp", type=int, default=None, help="data ranks (default: the visible cards)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--out", default=None, help="write the summary here as JSON")
    args = ap.parse_args(argv)
    from tokensgen_tpu_torch.sharding import mesh
    from tokensgen_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    device = torch.device("cuda")
    overrides = dict(UNSET)
    for kv in args.set:
        key, _, val = kv.partition("=")
        overrides[key] = yaml.safe_load(val)
    dp = args.dp or torch.cuda.device_count()
    overrides["dp_devices"] = dp
    cfg = load_config(os.path.join(REPO, CONFIGS[args.trainer]), overrides)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.trainer}: {CONFIGS[args.trainer]} with {json.dumps(overrides)}, {dp} rank(s), "
          f"{STEPS} micro-steps; cards: {smi}", flush=True)
    mesh.build_kernels_for_ranks(dp, device)
    t0 = time.perf_counter()
    res = mesh.run_data_parallel(_rank, dp, (args.trainer, overrides), device=device)
    wall = time.perf_counter() - t0
    table = res.pop("table")
    per_rank = []
    for r, rows in enumerate(table):
        steps = [dict(zip(STEP_KEYS, row[:len(STEP_KEYS)])) for row in rows]
        per_rank.append({"rank": r, "build_s": rows[0][-3], "build_peak_gib": rows[0][-2],
                         "opt_state_bytes": int(rows[0][-1]),
                         "peak_gib": max(s["peak_gib"] for s in steps), "steps": steps})
    for pr in per_rank:
        print(f"rank {pr['rank']}: build {pr['build_s']:.1f} s (peak {pr['build_peak_gib']:.2f} "
              f"GiB), optimizer state {pr['opt_state_bytes'] / 2 ** 30:.2f} GiB, step peak "
              f"{pr['peak_gib']:.2f} GiB", flush=True)
        for i, s in enumerate(pr["steps"], 1):
            parts = ", ".join(f"{k[:-2]} {s[k]:.3f}" for k in STEP_KEYS[:-1])
            print(f"  step {i}: {sum(s[k] for k in STEP_KEYS[:-1]):.3f} s ({parts})", flush=True)
    budget = _budget(args.trainer, cfg, dp)
    print(budget.table(), flush=True)
    summary = dict(res, trainer=args.trainer, config=CONFIGS[args.trainer], overrides=overrides,
                   dp=dp, device=smi, wall_s=wall, ranks=per_rank,
                   budget=dict(rows=budget.rows, total_gib=budget.total_gib,
                               fits=budget.fits()))
    summary.pop("records", None)
    print(json.dumps({k: summary[k] for k in ("trainer", "dp", "layers", "optimizer", "trainable",
                                              "split", "tensors", "global_batch", "wall_s")}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
