"""The port's serving CLI in a subprocess: `python -m
tokensgen_tpu_torch.serve --smoke --device cpu` (the To2V and T2To
pipelines at the JAX smoke's geometry, random weights) comes up on an
ephemeral port and answers /health (backend "cpu"), /edit (200 and an mp4),
/generate_stream (two NDJSON chunks) and a 400, each under a deadline."""

import base64
import http.client
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STARTUP_S = 120  # ~5 s on an idle host


def _request(port, method, path, payload=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_serve_cli_smoke(tmp_path):
    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text(f"""
name_prefix: serve_smoke
output_dir: {tmp_path}/out
seed: 7
use_2nd_stage: true
""")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tokensgen_tpu_torch.serve", "--config", str(cfg_path), "--smoke",
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path))
    try:
        deadline = time.time() + STARTUP_S
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited rc={proc.returncode}:\n"
                                     + proc.stdout.read()[-3000:])
            try:
                status, _, body = _request(port, "GET", "/health", timeout=5)
                break
            except OSError as e:
                if time.time() > deadline:
                    raise AssertionError(f"the service never came up: {e!r}")
                time.sleep(0.5)
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert health["backend"] == "cpu" and health["requests"] == 0

        frames = np.random.default_rng(0).uniform(-1, 1, size=(1, 18, 32, 48, 3))
        buf = io.BytesIO()
        np.save(buf, frames.astype(np.float32))
        npy = base64.b64encode(buf.getvalue()).decode()
        status, _, body = _request(port, "POST", "/edit",
                                   {"prompt": "a red car", "num_chunks": 2, "frames_npy": npy})
        out = json.loads(body)
        assert status == 200, out
        assert base64.b64decode(out["video_mp4_b64"])[4:8] == b"ftyp"  # an mp4 box
        assert out["seconds"] > 0

        status, ctype, body = _request(port, "POST", "/generate_stream",
                                       {"prompt": "a blue bird", "num_chunks": 2})
        assert status == 200 and ctype == "application/x-ndjson"
        lines = [json.loads(x) for x in body.decode().splitlines() if x]
        assert [x["chunk"] for x in lines] == [0, 1], lines

        status, _, body = _request(port, "POST", "/edit",
                                   {"prompt": "x", "num_chunks": 99999, "frames_npy": npy})
        assert status == 400 and "out of range" in json.loads(body)["error"]
        assert json.loads(_request(port, "GET", "/health")[2])["requests"] == 2
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def _children(pid: int) -> list:
    """The spawned workers among ``pid``'s child processes (Linux /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                spawned = b"spawn_main" in f.read()
        except (OSError, ValueError, IndexError):
            continue  # not a process, or gone
        if ppid == pid and spawned:
            out.append(int(entry))
    return out


def test_serve_cli_queue_devices_on_the_host(tmp_path):
    """`--queue-devices 2 --device cpu`: this process is rank 0 and spawns
    rank 1 (Gloo); /health reports the group, /edit answers with an mp4,
    and an interrupt stops the follower with the server."""
    import signal

    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text("seed: 7\n")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tokensgen_tpu_torch.serve", "--config", str(cfg_path), "--smoke",
         "--device", "cpu", "--queue-devices", "2", "--host", "127.0.0.1", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path))
    followers = []
    try:
        deadline = time.time() + STARTUP_S
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited rc={proc.returncode}:\n"
                                     + proc.stdout.read()[-3000:])
            try:
                status, _, body = _request(port, "GET", "/health", timeout=5)
                break
            except OSError as e:
                if time.time() > deadline:
                    raise AssertionError(f"the service never came up: {e!r}")
                time.sleep(0.5)
        health = json.loads(body)
        assert status == 200 and health["queue_devices"] == 2
        followers = _children(proc.pid)
        assert len(followers) == 1, followers
        frames = np.random.default_rng(0).uniform(-1, 1, size=(1, 18, 32, 48, 3))
        buf = io.BytesIO()
        np.save(buf, frames.astype(np.float32))
        status, _, body = _request(port, "POST", "/edit", {
            "prompt": "a red car", "num_chunks": 2,
            "frames_npy": base64.b64encode(buf.getvalue()).decode()})
        assert status == 200, body[:2000]
        assert base64.b64decode(json.loads(body)["video_mp4_b64"])[4:8] == b"ftyp"
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
        deadline = time.time() + 30
        while any(os.path.exists(f"/proc/{p}") for p in followers) and time.time() < deadline:
            time.sleep(0.2)
        assert not any(os.path.exists(f"/proc/{p}") for p in followers), "a follower outlived serve"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


@pytest.mark.parametrize("case", ["no_cuda", "queue_devices"])
def test_serve_cli_refuses_before_building(tmp_path, monkeypatch, case):
    """With no card visible the default `--device cuda` exits; more queue
    devices than visible cards raise under NCCL, naming both counts, before
    anything is spawned or built (one card is shown, the rest hidden)."""
    import torch

    from tokensgen_tpu_torch import serve
    from tokensgen_tpu_torch.sharding import mesh

    monkeypatch.setattr(serve, "serve_http", _never_serve)
    cfg = tmp_path / "serve.yaml"
    cfg.write_text("seed: 7\n")
    if case == "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            serve.main(["--config", str(cfg), "--smoke"])
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(mesh, "start_followers", _never_serve)
        with pytest.raises(ValueError, match="2 queue ranks under NCCL need 2 cards .* 1 visible"):
            serve.main(["--config", str(cfg), "--smoke", "--queue-devices", "2"])


def _never_serve(*args, **kwargs):
    raise AssertionError("the CLI went past its checks")
