"""What the probe CLIs share: the device argument, timing and agreement."""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Optional

import torch


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--runs", type=int, default=5, help="timed calls per case (median)")
    return ap


def device_of(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions on the host")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def time_ms(fn, dev: torch.device, runs: int) -> float:
    """Median of ``runs`` calls after a warm-up: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    times = []
    for _ in range(runs):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def queued_time_ms(fn, dev: torch.device, runs: int, calls: int = 10) -> float:
    """Median over ``runs`` of the device time of ``calls`` back-to-back
    calls, per call (CUDA events), with the launches queued behind a device
    sleep: the host's time between them (the wrapper's checks, a call's
    tensor maps) is not counted, which a single call's events would count
    for a kernel of ~0.1 ms. The card only."""
    fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(runs):
        torch.cuda._sleep(50_000_000)  # ~25 ms of device time while the host queues the calls
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def agreement(out: torch.Tensor, ref: torch.Tensor):
    """(relative L2 error, max abs error) of ``out`` against ``ref``; equal
    values count as no error (infinities included), the norm is that of
    ``ref``'s finite part."""
    out, ref = out.double(), ref.double()
    diff = torch.where(out == ref, 0.0, out - ref)
    norm = ref[torch.isfinite(ref)].norm().item()
    return (diff.norm().item() / norm if norm else diff.norm().item()), diff.abs().max().item()


def parse_grid(text: str):
    """"13x30x45" -> (13, 30, 45)."""
    return tuple(int(n) for n in text.split("x"))


def max_free_case(label: str, fn, ref, shipped, flops: float, dev, runs: int,
                  shipped_ms: Optional[float] = None, **meta) -> dict:
    """One case of the max-free probe CLIs: ``fn``'s output against the plain
    version ``ref`` and the shipped kernel's output ``shipped``, its median
    time and rate (and, given the shipped kernel's time ``shipped_ms``, the
    speedup over it); printed as one line and returned as a dict."""
    out = fn()
    rel, err = agreement(out, ref)
    srel, serr = agreement(out, shipped)
    del out
    ms = time_ms(fn, dev, runs)
    speedup = "" if shipped_ms is None else f" speedup {shipped_ms / ms:.2f}x"
    print(f"{label:34s} {ms:9.3f} ms {flops / ms / 1e9:7.1f} TFLOP/s rel_l2_err {rel:.2e} "
          f"max_abs_err {err:.2e} | vs shipped{speedup} rel_l2_err {srel:.2e} max_abs_err "
          f"{serr:.2e}", flush=True)
    extra = {} if shipped_ms is None else {"speedup": shipped_ms / ms}
    return dict(case=label, ms=ms, tflops=flops / ms / 1e9, rel_l2_err=rel, max_abs_err=err,
                shipped_rel_l2_err=srel, shipped_max_abs_err=serr, **extra, **meta)
