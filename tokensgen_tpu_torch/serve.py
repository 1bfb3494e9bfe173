"""Serving CLI of the port: a persistent HTTP video service on one card
(port of the root `serve.py`).

    python -m tokensgen_tpu_torch.serve --config tokensgen_tpu/configs/infer_gen.yaml \\
        [--host 0.0.0.0] [--port 8080] [--smoke] [--warmup] [--device cuda] [--set KEY=VALUE]

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
given ``--device cpu``. `sampling_params.queue_devices` > 1 (the
queue-sharded FIFO) is not ported (ROADMAP A12) and raises.
"""

from __future__ import annotations

import argparse

import torch

from tokensgen_tpu_torch.infer import (build_pipeline, build_t2to_pipeline, build_text_encoder,
                                       load_cli_config, refuse_unported)
from tokensgen_tpu_torch.serving import VideoService, serve_http


def build_service(cfg, smoke: bool, device) -> VideoService:
    """The service of ``cfg`` on ``device``: the text encoder, the To2V
    pipeline and, with `use_2nd_stage`, the T2To pipeline, as the infer CLI
    builds them; random draws from `sampling.base.keyed_noise`."""
    refuse_unported(cfg)
    device = torch.device(device)
    text_enc = build_text_encoder(cfg, smoke, device)
    pipe, _ = build_pipeline(cfg, smoke, device)
    t2to_pipe = build_t2to_pipeline(cfg, smoke, pipe, device) if cfg.get("use_2nd_stage") else None
    return VideoService(pipe, text_enc, t2to_pipe=t2to_pipe)


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
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (dotted path; the value is parsed as yaml)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the host")
    cfg = load_cli_config(args.config, args.set)
    service = build_service(cfg, args.smoke, device)
    if args.warmup:
        print("warming up (one undecoded edit)...", flush=True)
        service.warmup()
    serve_http(service, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
