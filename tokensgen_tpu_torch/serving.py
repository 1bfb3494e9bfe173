"""Serving runtime of the port: the To2V (and T2To) pipelines resident on the
card behind a request API (port of `tokensgen_tpu/serving.py`).

* `VideoService` holds the pipelines and a text encoder with a per-prompt
  cache, and serves `edit` / `generate` requests and their streaming forms,
  which yield each 49-frame chunk as soon as the FIFO queue has emitted its
  latent frames. One lock serializes every piece of card work.
* `serve_http`: JSON over HTTP (the standard library's threaded server):
  ``POST /edit``, ``/generate``, the NDJSON streams ``/edit_stream`` and
  ``/generate_stream``, ``GET /health``.
* Over a queue group (``group``, `sharding.mesh.QueueGroup`) the service
  lives on rank 0 and runs every request's FIFO across the group: the other
  ranks join each run in `To2VPipeline.follow` (`serve._follow_service`). A
  closed stream cancels the run on every rank within one FIFO iteration
  (the flag rides on the iteration's merge), and a failure on any rank ends
  the run on all of them, so the group stays ready for the next request.
  Only the worker thread of the request that holds the lock issues the
  group's collectives.

Where it differs from the JAX module on purpose: ``/edit`` forwards
``negative_prompt`` (the JAX handler drops it); the server is threaded, so
``/health`` answers while a request runs (the JAX server blocks); every
random draw of a request comes from ``noise_for_seed(seed)``, by default
`sampling.base.keyed_noise` on the pipeline's device, so a seed gives other
numbers than the JAX package's ``PRNGKey(seed)``.
"""

from __future__ import annotations

import base64
import io
import json
import os
import queue as queue_mod
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tokensgen_tpu_torch.data.video_io import write_video
from tokensgen_tpu_torch.infer import gen_image_embeddings
from tokensgen_tpu_torch.sampling.base import NoiseFn, keyed_noise
from tokensgen_tpu_torch.sampling.fifo import FIFOCancelled

_DONE, _ERR = object(), object()


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def _stage_noise(noise: NoiseFn, stage: str) -> NoiseFn:
    """``noise`` with every tag prefixed by ``stage``: the T2To stage's draws
    apart from the To2V render's, which use the same tag names."""
    return lambda tag, shape: noise((stage, *tag), shape)


class VideoService:
    def __init__(self, pipe, text_encoder, t2to_pipe=None,
                 noise_for_seed: Optional[Callable[[int], NoiseFn]] = None, group=None):
        self.pipe = pipe
        self.text_encoder = text_encoder
        self.t2to_pipe = t2to_pipe
        self.group = group  # rank 0 of a queue group, or None
        self.noise_for_seed = noise_for_seed or (lambda seed: keyed_noise(seed, pipe.device))
        self._lock = threading.Lock()
        # rebound whole, under the lock, so that health() reads one consistent pair
        self.stats: Dict[str, float] = {"requests": 0, "total_s": 0.0}

    def _record(self, seconds: float) -> None:
        s = self.stats
        self.stats = {"requests": s["requests"] + 1, "total_s": s["total_s"] + seconds}

    def _encode(self, prompt: str, negative_prompt: str):
        return self.text_encoder([prompt]), self.text_encoder([negative_prompt])

    def _t2to_embeddings(self, text, neg, num_chunks: int, noise: NoiseFn):
        if self.t2to_pipe is None:
            raise ValueError("service was built without a T2To pipeline")
        return gen_image_embeddings(self.t2to_pipe, self.pipe, text, neg, num_chunks,
                                    _stage_noise(noise, "t2to"))[1]

    def warmup(self, num_chunks: int = 2) -> None:
        """One undecoded edit before serving: builds the kernels at first use."""
        c = self.pipe.cfg
        frames = np.zeros((1, num_chunks * c.num_frames_per_chunk, c.height, c.width, 3),
                          np.float32)
        self.edit(prompt="warmup", frames=frames, num_chunks=num_chunks, decode=False)

    def _run(self, text, neg, num_chunks: int, noise: NoiseFn, decode: bool, t0: float,
             **gen_kwargs) -> Dict:
        """One-shot render; the caller holds the lock."""
        out = self.pipe.generate(text, neg, num_chunks=num_chunks, noise_fn=noise,
                                 decode=decode, group=self.group, **gen_kwargs)
        result = {"latents": _host(out["latents"])}
        if decode:
            result["video"] = _host(out["video"][0])
        result["seconds"] = time.time() - t0
        self._record(result["seconds"])
        return result

    def edit(self, prompt: str, frames: np.ndarray, num_chunks: int, seed: int = 0,
             negative_prompt: str = "", decode: bool = True) -> Dict:
        """Source video [B, F, H, W, 3] in [-1, 1] + prompt -> {"latents",
        "video" (with ``decode``), "seconds"}."""
        t0 = time.time()
        with self._lock, torch.no_grad():
            text, neg = self._encode(prompt, negative_prompt)
            return self._run(text, neg, num_chunks, self.noise_for_seed(seed), decode, t0,
                             frames=torch.as_tensor(frames))

    def generate(self, prompt: str, num_chunks: int, seed: int = 0, negative_prompt: str = "",
                 decode: bool = True) -> Dict:
        """Text -> long video: T2To tokens, then the To2V FIFO render."""
        t0 = time.time()
        with self._lock, torch.no_grad():
            text, neg = self._encode(prompt, negative_prompt)
            noise = self.noise_for_seed(seed)
            emb = self._t2to_embeddings(text, neg, num_chunks, noise)
            return self._run(text, neg, num_chunks, noise, decode, t0, image_embeddings=emb)

    def edit_stream(self, prompt: str, frames: np.ndarray, num_chunks: int, seed: int = 0,
                    negative_prompt: str = "", decode: bool = True):
        """Generator form of `edit`: yields {"chunk": k, "video": [B, 49, H,
        W, 3]} (or {"chunk", "latents": [B, nf, C, h, w]} without
        ``decode``) as soon as the FIFO has emitted chunk k's latent frames,
        so a long video starts playing while its tail is still denoising."""
        with self._lock, torch.no_grad():
            text, neg = self._encode(prompt, negative_prompt)
        yield from self._stream_fifo(text, neg, {"frames": torch.as_tensor(frames)}, num_chunks,
                                     seed, decode)

    def generate_stream(self, prompt: str, num_chunks: int, seed: int = 0,
                        negative_prompt: str = "", decode: bool = True):
        """Generator form of `generate`: the T2To tokens up front, then the
        To2V chunks stream out as in `edit_stream`."""
        with self._lock, torch.no_grad():
            text, neg = self._encode(prompt, negative_prompt)
            emb = self._t2to_embeddings(text, neg, num_chunks, self.noise_for_seed(seed))
        yield from self._stream_fifo(text, neg, {"image_embeddings": emb}, num_chunks, seed,
                                     decode)

    def _stream_fifo(self, text, neg, gen_kwargs: Dict, num_chunks: int, seed: int,
                     decode: bool):
        """A worker thread drives ``pipe.generate(decode=False)`` and hands
        each emitted frame over through its emit callback; this generator
        groups the frames after warm-up into chunks of ``nf_latent`` and
        decodes each between iterations (both threads use the device's
        default stream, so their work runs in stream order).

        If the consumer abandons the generator (a client disconnect:
        GeneratorExit), the FIFO is cancelled on every rank at its next
        merge, at most one FIFO iteration later, and the worker joined before
        the lock is released, so no orphaned run overlaps the next request
        on the card."""
        t0 = time.time()
        nf = self.pipe.cfg.nf_latent
        warmup = self.pipe.cfg.num_inference_steps - nf
        frames: "queue_mod.Queue" = queue_mod.Queue()
        cancel = threading.Event()

        def run():
            try:
                with torch.no_grad():  # grad mode is per thread: a new one starts enabled
                    self.pipe.generate(text, neg, num_chunks=num_chunks,
                                       noise_fn=self.noise_for_seed(seed), decode=False,
                                       emit_callback=lambda i, em: frames.put((i, em)),
                                       group=self.group, cancel=cancel.is_set, **gen_kwargs)
                frames.put((_DONE, None))
            except FIFOCancelled:
                frames.put((_DONE, None))
            except BaseException as e:  # handed to the consumer, which raises it
                frames.put((_ERR, e))

        with self._lock:
            worker = threading.Thread(target=run, name="fifo-stream", daemon=True)
            worker.start()
            try:
                group, chunk = [], 0
                while True:
                    i, emitted = frames.get()
                    if i is _ERR:
                        raise emitted
                    if i is _DONE:
                        break
                    if i < warmup:  # the discarded warm-up emissions
                        continue
                    group.append(emitted)  # [B, C, h, w], on the host
                    if len(group) == nf:
                        lat = torch.stack(group, dim=1)
                        group = []
                        out = {"chunk": chunk}
                        if decode and self.pipe.vae is not None:
                            out["video"] = _host(self.pipe.decode_latents(lat))
                        else:
                            out["latents"] = lat.numpy()
                        chunk += 1
                        yield out
                self._record(time.time() - t0)
            finally:
                cancel.set()
                worker.join()

    def health(self) -> Dict:
        s = self.stats
        dev = self.pipe.device
        return {
            "status": "ok",
            "backend": dev.type,
            "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
            "queue_devices": self.group.size if self.group is not None else 1,
            "requests": s["requests"],
            "avg_seconds": s["total_s"] / s["requests"] if s["requests"] else None,
        }

    def close(self) -> None:
        """Tells the queue group's other ranks to stop (once the current
        request is done); nothing without a group."""
        if self.group is not None and self.group.size > 1:
            with self._lock:
                self.group.send(None)


def _encode_video_b64(video: np.ndarray, fps: float = 10.0) -> str:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "video.mp4")
        write_video(path, video, fps=fps)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()


class RequestError(ValueError):
    """Invalid request payload: HTTP 400, before any card work."""


def validate_request(service: VideoService, req: Dict, frames: Optional[np.ndarray] = None,
                     max_chunks: int = 25) -> int:
    """Shape and size gate of a request -> its chunk count. ``max_chunks=25``
    is the reference's FIFO cap: an over-long request would otherwise run the
    card out of memory mid-generation instead of failing at the door."""
    if not isinstance(req.get("prompt"), str) or not req.get("prompt"):
        raise RequestError("'prompt' must be a non-empty string")
    try:
        num_chunks = int(req.get("num_chunks", 2))
    except (TypeError, ValueError):
        raise RequestError("'num_chunks' must be an integer")
    if not 1 <= num_chunks <= max_chunks:
        raise RequestError(
            f"num_chunks={num_chunks} out of range [1, {max_chunks}] (FIFO queue cap)")
    if frames is not None:
        cfg = service.pipe.cfg
        want_f = num_chunks * cfg.num_frames_per_chunk
        if frames.ndim != 5 or frames.shape[-1] != 3:
            raise RequestError(f"frames must be [B, F, H, W, 3]; got {frames.shape}")
        if frames.shape[1] != want_f:
            raise RequestError(
                f"frames has {frames.shape[1]} frames; num_chunks={num_chunks} "
                f"requires {want_f} ({cfg.num_frames_per_chunk}/chunk)")
        if frames.shape[2] != cfg.height or frames.shape[3] != cfg.width:
            raise RequestError(
                f"frames are {frames.shape[2]}x{frames.shape[3]}; the pipeline "
                f"is compiled for {cfg.height}x{cfg.width}")
    return num_chunks


def make_server(service: VideoService, host: str = "0.0.0.0",
                port: int = 8080) -> ThreadingHTTPServer:
    """The HTTP front of ``service``, bound and not yet serving: POST /edit,
    /generate, /edit_stream, /generate_stream; GET /health. Each connection
    has its own thread; the service's lock serializes the card's work.
    Invalid payloads get 400 before any card work; a failure mid-stream ends
    the NDJSON stream with an {"error": ...} line (the chunked framing stays
    whole: a second status line cannot be sent once streaming has begun).
    Every reply and stream line carries ``parse_seconds``: the host's time
    from the request's first byte read to its frames decoded and checked."""

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer-encoding exists only in HTTP/1.1
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_line(self, payload: Dict):
            line = (json.dumps(payload) + "\n").encode()
            self.wfile.write(f"{len(line):x}\r\n".encode())
            self.wfile.write(line + b"\r\n")
            self.wfile.flush()

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, service.health())
            else:
                self._reply(404, {"error": "unknown path"})

        def _read_request(self) -> Dict:
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:
                raise RequestError(f"request body is not valid JSON: {e}")
            if not isinstance(req, dict):
                raise RequestError("request body must be a JSON object")
            return req

        def _decode_frames(self, req: Dict) -> np.ndarray:
            if "frames_npy" not in req:
                raise RequestError("'frames_npy' (base64 .npy) is required")
            try:
                return np.load(io.BytesIO(base64.b64decode(req["frames_npy"])))
            except Exception as e:
                raise RequestError(f"frames_npy is not a valid .npy: {e!r}")

        def do_POST(self):
            t0 = time.perf_counter()
            stream, streaming = None, False
            try:
                req = self._read_request()
                kw = dict(seed=int(req.get("seed", 0)),
                          negative_prompt=req.get("negative_prompt", ""))
                if self.path in ("/edit", "/edit_stream"):
                    frames = self._decode_frames(req)
                    num_chunks = validate_request(service, req, frames)
                elif self.path in ("/generate", "/generate_stream"):
                    num_chunks = validate_request(service, req)
                    if self.path == "/generate_stream" and service.t2to_pipe is None:
                        raise RequestError(
                            "service was built without a T2To pipeline (use_2nd_stage)")
                else:
                    return self._reply(404, {"error": "unknown path"})
                parse_s = time.perf_counter() - t0
                if self.path == "/edit":
                    out = service.edit(req["prompt"], frames, num_chunks, **kw)
                elif self.path == "/generate":
                    out = service.generate(req["prompt"], num_chunks, **kw)
                else:
                    stream = (service.edit_stream(req["prompt"], frames, num_chunks, **kw)
                              if self.path == "/edit_stream" else
                              service.generate_stream(req["prompt"], num_chunks, **kw))
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    streaming = True
                    for c in stream:  # one NDJSON line per 49-frame chunk
                        self._send_line({"chunk": c["chunk"], "parse_seconds": parse_s,
                                         "video_mp4_b64": _encode_video_b64(c["video"][0])})
                    self.wfile.write(b"0\r\n\r\n")
                    return
                self._reply(200, {"seconds": out["seconds"], "parse_seconds": parse_s,
                                  "video_mp4_b64": _encode_video_b64(out["video"])})
            except RequestError as e:  # raised only before any card work or streaming
                self._reply(400, {"error": str(e)})
            except Exception as e:  # the serving boundary: report, keep serving
                if not streaming:
                    self._reply(500, {"error": repr(e)})
                    return
                try:  # headers are gone: an error line, then the terminating chunk
                    self._send_line({"error": repr(e)})
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass  # the client is gone
            finally:
                if stream is not None:
                    stream.close()  # cancels and joins the FIFO worker if still running

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(service: VideoService, host: str = "0.0.0.0", port: int = 8080) -> None:
    """Blocking: serves ``make_server(service, host, port)`` until interrupted."""
    server = make_server(service, host, port)
    print(f"serving on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
