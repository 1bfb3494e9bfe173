"""Serving CLI of the port: a persistent HTTP video service on one card or
several (port of the root `serve.py`).

    python -m tokensgen_tpu_torch.serve --config tokensgen_tpu/configs/infer_gen.yaml \\
        [--host 0.0.0.0] [--port 8080] [--smoke] [--warmup] [--device cuda] \\
        [--queue-devices N] [--set KEY=VALUE]

Reads the same config as `tokensgen_tpu_torch.infer`, builds the text
encoder (kept resident, with a per-prompt cache) and the To2V pipeline (and,
with `use_2nd_stage`, the T2To one) once, and serves

  POST /edit            one-shot edit (source video + prompt -> mp4)
  POST /edit_stream     NDJSON chunked stream, one 49-frame chunk per line as
                        the FIFO emits it
  POST /generate        text -> long video through T2To tokens + To2V
  POST /generate_stream its streaming form
  GET  /health          backend, devices, request count and mean seconds

Invalid payloads get 400 before any card work. Runs on the card unless
given ``--device cpu``.

``--queue-devices N`` (or `sampling_params.queue_devices: N`) runs every
request's FIFO over N processes, one card each (NCCL; Gloo on the host):
this process is rank 0 and serves HTTP, and it spawns ranks 1 to N - 1,
which build the pipeline on their own cards and join each run
(`To2VPipeline.follow`). ``/health`` reports ``queue_devices``. Shutdown stops
them. N must divide the FIFO's rank windows and, under NCCL, not exceed
the visible cards; both are checked before anything is spawned or built.
"""

from __future__ import annotations

import argparse

import torch

from tokensgen_tpu_torch.infer import (build_pipeline, build_t2to_pipeline, build_text_encoder,
                                       check_weights_agree, load_cli_config,
                                       prepare_queue_group, queue_devices)
from tokensgen_tpu_torch.serving import VideoService, serve_http
from tokensgen_tpu_torch.sharding import mesh


def build_service(cfg, smoke: bool, device, group=None) -> VideoService:
    """The service of ``cfg`` on ``device``: the text encoder, the To2V
    pipeline and, with `use_2nd_stage`, the T2To pipeline, as the infer CLI
    builds them; random draws from `sampling.base.keyed_noise`. ``group``:
    this process's rank 0 of the queue group that `sampling_params.queue_devices`
    asks for (its other ranks in `_follow_service`)."""
    nq, have = queue_devices(cfg), group.size if group is not None else 1
    if nq != have:
        raise ValueError(f"the config asks for {nq} queue devices, the service was given a "
                         f"group of {have}: start it with `python -m tokensgen_tpu_torch.serve "
                         f"--queue-devices {nq}`")
    device = torch.device(device)
    text_enc = build_text_encoder(cfg, smoke, device)
    pipe, _ = build_pipeline(cfg, smoke, device)
    check_weights_agree(group, pipe)
    t2to_pipe = build_t2to_pipeline(cfg, smoke, pipe, device) if cfg.get("use_2nd_stage") else None
    return VideoService(pipe, text_enc, t2to_pipe=t2to_pipe, group=group)


def _follow_service(group, cfg, smoke: bool) -> None:
    """Ranks above 0: the To2V pipeline on this rank's device, then every
    request's FIFO until the service closes."""
    pipe, _ = build_pipeline(cfg, smoke, group.device)
    check_weights_agree(group, pipe)
    while pipe.follow(group):
        pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="HTTP video service (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model, random weights (API and bring-up testing)")
    ap.add_argument("--warmup", action="store_true",
                    help="run one undecoded edit (builds the kernels) before serving")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queue-devices", type=int, default=None,
                    help="run each request's FIFO over this many processes, a card each")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (dotted path; the value is parsed as yaml)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the host")
    cfg = load_cli_config(args.config, args.set)
    nq = queue_devices(cfg, args.queue_devices)
    followers = group = None
    if nq > 1:
        prepare_queue_group(cfg, args.smoke, device, nq)
        cfg.setdefault("sampling_params", {})["queue_devices"] = nq
        followers = mesh.start_followers(_follow_service, nq, (cfg, args.smoke), device=device)
        group, device = followers.group, followers.group.device
    service = None
    try:
        service = build_service(cfg, args.smoke, device, group=group)
        if args.warmup:
            print("warming up (one undecoded edit)...", flush=True)
            service.warmup()
        serve_http(service, host=args.host, port=args.port)
    finally:
        if followers is not None:
            if service is not None:
                service.close()
                followers.close()
            else:  # rank 0 never came up: the followers may wait in a collective
                followers.close(timeout_s=0.0)


if __name__ == "__main__":
    main()
