"""Port parity: `tokensgen_tpu_torch.serving` against `tokensgen_tpu.serving`
at the tiny pipeline of tests/test_pipeline_to2v.py (`build_tiny_pipe`, its
weights moved in through convert/from_jax.py), mirroring every case of
tests/test_serving.py but the queue-sharded one (ROADMAP A12) and the
chunk bucketing (jit shapes, which the port does not have). With a
`noise_for_seed` that replays the JAX service's draws, the port's `edit` and
`generate_stream` meet the JAX service's outputs at 1e-4 (f32 through ~25
DiT forwards and the decode); the port's streams equal its one-shot runs
and its resume drill is bit-equal. The same `validate_request` messages,
400 over the wire, and the two JAX faults not copied: `/edit` forwards the
negative prompt (C2) and `/health` answers while a request holds the card
(C3)."""

import base64
import http.client
import io
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.models.text_encoder import CachedTextEncoder as JCachedTextEncoder
from tokensgen_tpu.models.text_encoder import HashTextEncoder as JHashTextEncoder
from tokensgen_tpu.serving import VideoService as JVideoService
from tokensgen_tpu_torch.convert.from_jax import (dit_state_dict, pca_state, resampler_state_dict,
                                                  to_torch, vae_state_dict)
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.models import resampler as TR
from tokensgen_tpu_torch.models import vae3d as TV
from tokensgen_tpu_torch.models.text_encoder import CachedTextEncoder, HashTextEncoder
from tokensgen_tpu_torch.pipelines import t2to as TT
from tokensgen_tpu_torch.pipelines import to2v as TP
from tokensgen_tpu_torch.sampling.base import keyed_noise
from tokensgen_tpu_torch.serving import RequestError, VideoService, make_server, validate_request

from _torch_parity import jax_noise, np_tree

STEPS, NF, T2_STEPS = 6, 3, 4  # build_tiny_pipe's steps and latent frames; the tiny T2To's
FRAMES = np.random.default_rng(0).uniform(-1, 1, size=(1, 18, 32, 48, 3)).astype(np.float32)


def _jax_noise_for_seed(seed: int, num_chunks: int = 2):
    """The JAX service's draws for a request with ``seed``: the To2V
    pipeline's key split (VIP encode, base pass, FIFO) and the T2To stage's
    (its tags come prefixed with "t2to")."""
    key = jax.random.PRNGKey(seed)
    _, r_vip, r_base, r_fifo = jax.random.split(key, 4)
    r_steps, r_latents = jax.random.split(r_base)
    to2v = jax_noise(base_rng=r_steps, fifo_rng=r_fifo, base_steps=STEPS,
                     fifo_iters=num_chunks * NF + STEPS - NF, latents_key=r_latents, vip_rng=r_vip)
    t2_steps, t2_latents = jax.random.split(key)
    t2to = jax_noise(base_rng=t2_steps, base_steps=T2_STEPS, latents_key=t2_latents)
    return lambda tag, shape: t2to(tag[1:], shape) if tag[0] == "t2to" else to2v(tag, shape)


def _tiny_t2to():
    """build_tiny_pipe's companion T2To (tests/test_serving.py): its JAX
    pipeline and the port's with the same weights and PCA."""
    from tokensgen_tpu.core import pca as JPCA
    from tokensgen_tpu.models import dit as JD
    from tokensgen_tpu.pipelines import t2to as JT

    cfg = dict(num_inference_steps=T2_STEPS, num_frames_per_chunk=2, token_dim=24, height=2,
               width=3, stochastic=False)
    dkw = dict(patch_size=1, sample_height=2, sample_width=3, attention_head_dim=64,
               num_attention_heads=1)
    jd = JD.DiTConfig.tiny(**dkw)
    f0 = 4
    params = JD.CogVideoXTransformer(jd).init(
        jax.random.PRNGKey(1), jnp.zeros((1, f0, 16, 2, 3)),
        jnp.zeros((1, jd.max_text_seq_length, jd.text_embed_dim)), jnp.zeros((1,), jnp.int32),
        image_rotary_emb=JT.T2ToPipeline(JT.T2ToConfig(**cfg), jd, None).rope(f0))
    pca = JPCA.fit(jnp.asarray(np.random.default_rng(0).normal(size=(32, 24)), jnp.float32), None)
    jpipe = JT.T2ToPipeline(JT.T2ToConfig(**cfg), jd, params, pca=pca,
                            token_mean=jnp.zeros((1, 24)), token_std=jnp.ones((1, 24)))
    td = TD.DiTConfig.tiny(**dkw)
    dit = TD.CogVideoXTransformer(td).eval()
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(params), td)), strict=True)
    tpipe = TT.T2ToPipeline(TT.T2ToConfig(**cfg), td, dit, pca=pca_state(pca),
                            token_mean=torch.zeros(1, 24), token_std=torch.ones(1, 24),
                            device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipes():
    """(JAX tiny To2V, JAX tiny T2To, port To2V, port T2To), same weights."""
    from tests.test_pipeline_to2v import build_tiny_pipe

    jpipe = build_tiny_pipe()
    dc, rc = jpipe.dit_config, jpipe.resampler_config
    vip = TD.VIPConfig(**{f: getattr(dc.vip, f) for f in ("output_dim", "num_temporal_queries",
                                                          "num_height_queries",
                                                          "num_width_queries", "length")})
    td = TD.DiTConfig.tiny(vip=vip, sample_height=4, sample_width=6)
    dit = TD.CogVideoXTransformer(td).eval()
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(jpipe.dit_params), td)), strict=True)
    trc = TR.ResamplerConfig.tiny(embedding_dim=td.inner_dim, output_dim=24,
                                  num_temporal_queries=2, num_height_queries=2,
                                  num_width_queries=3)
    assert (trc.depth, trc.output_dim) == (rc.depth, rc.output_dim)
    rs = TR.Resampler(trc).eval()
    rs.load_state_dict(to_torch(resampler_state_dict(np_tree(jpipe.resampler_params), trc.depth)),
                       strict=True)
    tvc = TV.VAEConfig.tiny(sample_height=32, sample_width=48)
    vae = TV.AutoencoderKLCogVideoX(tvc).eval()
    vae.load_state_dict(to_torch(vae_state_dict(np_tree(jpipe.vae.params))), strict=True)
    c = jpipe.cfg
    pcfg = TP.To2VConfig(height=c.height, width=c.width,
                         num_frames_per_chunk=c.num_frames_per_chunk,
                         num_inference_steps=c.num_inference_steps,
                         num_partitions=c.num_partitions, stochastic=c.stochastic)
    tpipe = TP.To2VPipeline(pcfg, td, dit, trc, rs, TV.VAERunner(tvc, vae), device="cpu")
    jt2, tt2 = _tiny_t2to()
    return jpipe, jt2, tpipe, tt2


def _encoder(pipe):
    return CachedTextEncoder(HashTextEncoder(max_length=pipe.dit_config.max_text_seq_length,
                                             embed_dim=pipe.dit_config.text_embed_dim))


def _service(pipes, **kw):
    _, _, tpipe, tt2 = pipes
    return VideoService(tpipe, _encoder(tpipe), t2to_pipe=tt2, **kw)


def _jax_service(pipes):
    jpipe, jt2, _, _ = pipes
    enc = JCachedTextEncoder(JHashTextEncoder(max_length=jpipe.dit_config.max_text_seq_length,
                                              embed_dim=jpipe.dit_config.text_embed_dim))
    return JVideoService(jpipe, enc, t2to_pipe=jt2)


def _npy_b64(frames) -> str:
    buf = io.BytesIO()
    np.save(buf, frames)
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture
def server(pipes):
    """A factory: ``server(svc) -> port`` of a threaded server on an
    ephemeral port, shut down after the test."""
    started = []

    def start(svc):
        srv = make_server(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        started.append((srv, thread))
        return srv.server_address[1]

    yield start
    for srv, thread in started:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _post(port, path, payload, timeout=600):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return conn, resp


def test_edit_request(pipes):
    """edit(): shapes, stats, and the JAX service's latents and video at
    1e-4 with its noise replayed."""
    svc = _service(pipes, noise_for_seed=_jax_noise_for_seed)
    out = svc.edit("a red car", FRAMES, num_chunks=2, seed=1)
    assert out["video"].shape == (18, 32, 48, 3)
    assert out["latents"].shape == (1, 6, 16, 4, 6)
    assert np.isfinite(out["video"]).all()
    h = svc.health()
    assert h["status"] == "ok" and h["requests"] == 1 and h["avg_seconds"] > 0
    assert h["backend"] == "cpu" and h["devices"] == 1
    ref = _jax_service(pipes).edit("a red car", FRAMES, num_chunks=2, seed=1)
    for key in ("latents", "video"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=1e-4, err_msg=key)


def test_edit_stream_matches_edit(pipes):
    """The streamed chunks are the one-shot edit's latents, in order, bit for
    bit (keyed noise: the same draws in both runs)."""
    svc = _service(pipes)
    ref = svc.edit("a red car", FRAMES, num_chunks=2, seed=1, decode=False)
    chunks = list(svc.edit_stream("a red car", FRAMES, num_chunks=2, seed=1, decode=False))
    assert [c["chunk"] for c in chunks] == [0, 1]
    streamed = np.concatenate([c["latents"] for c in chunks], axis=1)
    assert streamed.shape[1] == 2 * NF
    np.testing.assert_array_equal(streamed, ref["latents"])
    assert svc.health()["requests"] == 2


def test_edit_stream_decoded_chunks(pipes):
    svc = _service(pipes)
    ref = svc.edit("a dog", FRAMES, num_chunks=2, seed=3)
    videos = []
    for c in svc.edit_stream("a dog", FRAMES, num_chunks=2, seed=3):
        assert c["video"].shape == (1, 9, 32, 48, 3)
        assert np.isfinite(c["video"]).all()
        videos.append(c["video"])
    assert len(videos) == 2
    np.testing.assert_allclose(np.concatenate(videos, axis=1)[0], ref["video"], rtol=1e-6,
                               atol=1e-6)


def test_http_edit_stream_endpoint(pipes, server):
    """POST /edit_stream: NDJSON lines over a chunked HTTP/1.1 response."""
    port = server(_service(pipes))
    conn, resp = _post(port, "/edit_stream", {"prompt": "a boat", "num_chunks": 2, "seed": 2,
                                              "frames_npy": _npy_b64(FRAMES)})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "application/x-ndjson"
    assert resp.getheader("Transfer-Encoding") == "chunked"
    lines = [json.loads(x) for x in resp.read().decode().splitlines() if x]
    assert [x["chunk"] for x in lines] == [0, 1]
    for x in lines:
        assert len(base64.b64decode(x["video_mp4_b64"])) > 0
        assert x["parse_seconds"] >= 0
    conn.close()


def test_stream_cancellation_frees_service(pipes):
    """Closing the stream after chunk 0 (a client disconnect) cancels the
    worker at its next emit and joins it before the lock is released."""
    svc = _service(pipes)
    gen = svc.edit_stream("a red car", FRAMES, num_chunks=2, seed=1, decode=False)
    assert next(gen)["chunk"] == 0
    gen.close()
    assert svc._lock.acquire(timeout=5)
    svc._lock.release()
    assert not [t for t in threading.enumerate() if t.name == "fifo-stream"]
    assert svc.health()["requests"] == 0  # the abandoned stream is not counted as served
    out = svc.edit("a red car", FRAMES, num_chunks=2, seed=1, decode=False)
    assert np.isfinite(out["latents"]).all()


def test_crash_resume_drill(pipes):
    """Kill the FIFO loop mid-run from its emit callback, resume from the
    last state snapshot: the stitched emission series is the uninterrupted
    run's, bit for bit (keyed noise: each draw depends on its tag alone)."""
    _, _, tpipe, _ = pipes
    enc = _encoder(tpipe)
    text, neg = enc(["a red car"]), enc([""])
    kw = dict(frames=torch.from_numpy(FRAMES), num_chunks=2, decode=False)

    def noise():
        return keyed_noise(7, "cpu")

    full = {}
    tpipe.generate(text, neg, noise_fn=noise(), **kw,
                   emit_callback=lambda i, em: full.__setitem__(i, em))
    n_iters = len(full)

    class Crash(RuntimeError):
        pass

    emits, states = {}, {}

    def on_emit(i, em):
        emits[i] = em
        if i == 5:
            raise Crash()

    def on_state(i, snapshot):
        if (i + 1) % 2 == 0:
            states[i] = snapshot()

    with pytest.raises(Crash):
        tpipe.generate(text, neg, noise_fn=noise(), **kw, emit_callback=on_emit,
                       state_callback=on_state)
    resume_i = max(states)
    assert resume_i < 5
    tail = {}
    tpipe.generate(text, neg, noise_fn=noise(), **kw, resume_from=states[resume_i],
                   emit_callback=lambda i, em: tail.__setitem__(i, em))
    assert sorted(tail) == list(range(resume_i + 1, n_iters))
    stitched = {**{i: emits[i] for i in range(resume_i + 1)}, **tail}
    assert sorted(stitched) == sorted(full)
    for i in full:
        assert torch.equal(stitched[i], full[i]), i


def test_http_error_paths(pipes):
    """Invalid requests raise RequestError with the JAX service's messages."""
    svc = _service(pipes)
    with pytest.raises(RequestError, match="out of range"):
        validate_request(svc, {"prompt": "x", "num_chunks": 9999})
    with pytest.raises(RequestError, match="prompt"):
        validate_request(svc, {"num_chunks": 2})
    with pytest.raises(RequestError, match="must be an integer"):
        validate_request(svc, {"prompt": "x", "num_chunks": "two"})
    with pytest.raises(RequestError, match="requires"):
        validate_request(svc, {"prompt": "x", "num_chunks": 2}, np.zeros((1, 7, 32, 48, 3)))
    with pytest.raises(RequestError, match="compiled for"):
        validate_request(svc, {"prompt": "x", "num_chunks": 2}, np.zeros((1, 18, 16, 16, 3)))
    with pytest.raises(RequestError, match="B, F, H, W"):
        validate_request(svc, {"prompt": "x", "num_chunks": 2}, np.zeros((18, 32, 48, 3)))


def test_http_400_over_the_wire(pipes, server, monkeypatch):
    """A wrong frame count gets 400 and a JSON error before any card work,
    as do a body that is not a JSON object and frames that are not a .npy."""
    svc = _service(pipes)
    calls = []
    monkeypatch.setattr(svc.pipe, "generate", lambda *a, **k: calls.append(1))
    port = server(svc)
    for payload, match in (({"prompt": "x", "num_chunks": 2,
                             "frames_npy": _npy_b64(np.zeros((1, 7, 32, 48, 3), np.float32))},
                            "requires"),
                           ([1, 2], "JSON object"),
                           ({"prompt": "x", "num_chunks": 2, "frames_npy": "AAAA"}, "not a valid")):
        conn, resp = _post(port, "/edit", payload, timeout=60)
        assert resp.status == 400
        assert match in json.loads(resp.read())["error"]
        conn.close()
    assert not calls


def test_generate_stream_two_stage(pipes):
    """generate_stream: the T2To tokens up front, then streamed To2V chunks
    equal to the one-shot generate()'s latents; both at 1e-4 of the JAX
    service's generate() with its noise replayed."""
    svc = _service(pipes, noise_for_seed=_jax_noise_for_seed)
    ref = svc.generate("a blue bird", num_chunks=2, seed=5, decode=False)
    chunks = list(svc.generate_stream("a blue bird", num_chunks=2, seed=5, decode=False))
    assert [c["chunk"] for c in chunks] == [0, 1]
    streamed = np.concatenate([c["latents"] for c in chunks], axis=1)
    np.testing.assert_array_equal(streamed, ref["latents"])
    want = _jax_service(pipes).generate("a blue bird", num_chunks=2, seed=5, decode=False)
    np.testing.assert_allclose(streamed, want["latents"], rtol=1e-4, atol=1e-4)


def test_edit_forwards_the_negative_prompt(pipes, server):
    """C2: POST /edit hands `negative_prompt` to the text encoder (the JAX
    handler drops it)."""
    svc = _service(pipes)
    seen = []
    inner = svc.text_encoder

    def recording(prompts):
        seen.extend(prompts)
        return inner(prompts)

    svc.text_encoder = recording
    port = server(svc)
    conn, resp = _post(port, "/edit", {"prompt": "a red car", "num_chunks": 2,
                                       "negative_prompt": "blurry, low quality",
                                       "frames_npy": _npy_b64(FRAMES)})
    body = json.loads(resp.read())
    assert resp.status == 200, body
    assert len(base64.b64decode(body["video_mp4_b64"])) > 0 and body["seconds"] > 0
    assert seen == ["a red car", "blurry, low quality"]
    conn.close()


def test_health_answers_while_a_request_runs(pipes, server):
    """C3: with the service lock held (a request on the card), /health
    answers at once, and a queued /edit waits for the lock."""
    svc = _service(pipes)
    port = server(svc)
    done = []
    with svc._lock:
        waiter = threading.Thread(target=lambda: done.append(
            _post(port, "/edit", {"prompt": "a red car", "num_chunks": 2,
                                  "frames_npy": _npy_b64(FRAMES)})[1].status))
        waiter.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
        conn.request("GET", "/health")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["status"] == "ok"
        assert time.perf_counter() - t0 < 2
        conn.close()
        assert not done  # the edit is still waiting for the card
    waiter.join(timeout=300)
    assert not waiter.is_alive() and done == [200]


def test_kernel_library_loads_once_under_threads(tmp_path, monkeypatch):
    """A stream's worker and a request thread can reach a kernel's first use
    together: `KernelLibrary.build` holds a lock, so its library is loaded
    and bound once (here a built library stands in for nvcc's output)."""
    import _ctypes
    import shutil
    import sys

    from tokensgen_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    binds = []

    def bind(lib):
        time.sleep(0.01)  # widens the window in which a second thread would bind too
        binds.append(lib)

    lib = build.KernelLibrary("attention.cu", bind)
    shutil.copy(_ctypes.__file__, tmp_path / f"libattention_{lib._tag()}.so")
    start = threading.Barrier(16)
    got = []

    def first_use():
        start.wait(timeout=30)
        got.append(lib.get())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert len(got) == 16 and len(binds) == 1
    assert all(x is binds[0] for x in got)
