"""The queue-sharded FIFO of the port (`sharding/mesh.py`, the group path of
`sampling/fifo.py`, `infer --queue-devices`) on the host, over Gloo ranks
in spawned processes (`tests/_torch_dist_child.py`, which imports no JAX),
each group under a timeout of 60 s.

* At 2 and 4 ranks the engine is bit-equal (`torch.equal`) to its one
  process run: emits, latents and the cache tracks, for the variants of
  tests/test_torch_sampling.py::test_fifo_matches_jax, with keyed and
  with generator noise (each position is one window's value plus zeros).
* At 4 ranks it meets the JAX engine on a ``queue=4`` mesh of conftest's
  virtual devices (its draws precomputed here) at that test's rtol 1e-5,
  atol 2e-5.
* `infer --smoke --device cpu --queue-devices 2` writes what one process
  writes; a count that does not divide the rank windows raises before
  anything is spawned; a rank that raises or dies ends the launch within
  its timeout; `send` / `receive` carry nested tensors whole.

The host's thread count is held at THREADS for these tests (the ranks take
the parent's): a CPU matmul's bits depend on it."""

import glob
import os
import time

import jax
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.sampling import fifo as JF
from tokensgen_tpu.sharding import MeshSpec as JMeshSpec
from tokensgen_tpu.sharding import make_mesh
from tokensgen_tpu_torch import infer
from tokensgen_tpu_torch.core import schedule as TS
from tokensgen_tpu_torch.sampling import base as TB
from tokensgen_tpu_torch.sampling import fifo as TF
from tokensgen_tpu_torch.sharding import mesh

import _torch_dist_child as C
from _torch_parity import jax_noise
from test_torch_sampling import CFG_OFFSET, NF, PARTS, STEPS, TARGET, _jax_model, _vip_states

THREADS = 2
TIMEOUT_S = 60.0
CACHE_IDX = (0, 5)
VARIANTS = ("stochastic_xt", "deterministic_randn", "vip_dynamic_cfg", "no_lookahead")
JAX_VARIANTS = ("stochastic_xt", "vip_dynamic_cfg")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _fcfg(variant: str) -> dict:
    return dict(nf_per_chunk=NF, num_partitions=PARTS, num_inference_steps=STEPS, num_frames=8,
                stochastic=variant != "deterministic_randn",
                tail_renoise_mode="randn" if variant == "deterministic_randn" else "xt",
                use_dynamic_cfg=variant == "vip_dynamic_cfg",
                lookahead_denoising=variant != "no_lookahead")


def _num_ranks(variant: str) -> int:
    return TF.FIFOConfig(**_fcfg(variant)).num_ranks


@pytest.fixture(scope="module")
def seed_np():
    """A FIFO seed from the port's base pass (keyed noise) as numpy, with
    and without test_torch_sampling's VIP states."""
    sched = TS.make_schedule()
    model = C.OracleModel(TARGET, CFG_OFFSET)
    lat0 = np.random.default_rng(1).normal(size=(1, NF, 2, 4, 4)).astype(np.float32)
    res = TB.denoise(lambda lat, tv: model(lat, tv[:, None].expand(-1, NF)), sched,
                     TB.SamplerConfig(num_inference_steps=STEPS, collect_fifo=True,
                                      use_dynamic_cfg=True),
                     torch.from_numpy(lat0), TB.keyed_noise(1, "cpu"))
    seed = {"latents": res.fifo_latents.numpy(), "x0": res.fifo_old_x0.numpy(),
            "valid": res.fifo_old_valid.numpy(),
            "timesteps": np.asarray(TS.inference_timesteps(sched.config, STEPS))}
    _, tv = _vip_states()
    vip = tuple(x.numpy() for x in tv[:7]) + (tv[7],)
    return seed, {**seed, "vip": vip}


def _case(variant: str, noise, seeds) -> dict:
    return {"name": f"{variant}/{noise[0]}", "fcfg": _fcfg(variant),
            "seed": seeds[1] if variant == "vip_dynamic_cfg" else seeds[0], "noise": noise,
            "cache_idx": CACHE_IDX, "model": (TARGET, CFG_OFFSET)}


@pytest.fixture(scope="module")
def jax_runs(seed_np):
    """The JAX engine on a queue=4 mesh, and its draws as a table."""
    jsched = JS.make_schedule()
    runs = {}
    for variant in JAX_VARIANTS:
        seed = seed_np[1] if variant == "vip_dynamic_cfg" else seed_np[0]
        jv = _vip_states()[0] if variant == "vip_dynamic_cfg" else None
        jseed = JF.FIFOSeed(seed["latents"], seed["x0"], seed["valid"], seed["timesteps"],
                            None, jv)
        rng = jax.random.PRNGKey(7)
        jfc = JF.FIFOConfig(**_fcfg(variant))
        out = JF.fifo_generate(_jax_model(jsched), None, jsched, jfc, jseed, rng=rng,
                               cache_idx=CACHE_IDX,
                               mesh=make_mesh(JMeshSpec(data=1, queue=4)))
        draw = jax_noise(fifo_rng=rng, fifo_iters=jfc.num_iterations)
        win = (1, NF, 2, 4, 4)
        table = {("tail", i): draw(("tail", i), (1, 2, 4, 4)).numpy()
                 for i in range(jfc.num_iterations)}
        table.update({("fifo", i, r, k): draw(("fifo", i, r, k), win).numpy()
                      for i in range(jfc.num_iterations) for r in range(jfc.num_ranks)
                      for k in (0, 1)})
        runs[variant] = (out, table)
    return runs


@pytest.fixture(scope="module")
def runs(seed_np, jax_runs):
    """{n: {case name: (all_emitted, latents, cache_x0, cache_valid)}}: one
    process here (n = 1), then one launch of every case at 2 ranks and one
    at 4 (with the JAX-replay cases)."""
    cases = [_case(v, (kind, 5), seed_np) for v in VARIANTS for kind in ("keyed", "generator")]
    out = {1: C.run_fifo_cases(None, cases)}
    out[2] = mesh.launch(C.run_fifo_cases, 2, (cases,), device="cpu", timeout_s=TIMEOUT_S)
    four = [c for c in cases if TF.FIFOConfig(**c["fcfg"]).num_ranks % 4 == 0]
    four += [dict(_case(v, ("replay", jax_runs[v][1]), seed_np), name=f"{v}/jax")
             for v in JAX_VARIANTS]
    out[4] = mesh.launch(C.run_fifo_cases, 4, (four,), device="cpu", timeout_s=TIMEOUT_S)
    return out


SHARDED = [(v, kind, n) for v in VARIANTS for kind in ("keyed", "generator") for n in (2, 4)
           if _num_ranks(v) % n == 0]


@pytest.mark.parametrize("variant,noise,n", SHARDED)
def test_sharded_fifo_is_bit_equal_to_one_process(runs, variant, noise, n):
    ref, got = runs[1][f"{variant}/{noise}"], runs[n][f"{variant}/{noise}"]
    for name, a, b in zip(("all_emitted", "latents", "cache_x0", "cache_valid"), got, ref):
        assert a.shape == b.shape and torch.equal(a, b), name
    assert ref[3].any() and not ref[3].all()


@pytest.mark.parametrize("variant", JAX_VARIANTS)
def test_sharded_fifo_matches_the_jax_queue_mesh(runs, jax_runs, variant):
    jout, _ = jax_runs[variant]
    got = runs[4][f"{variant}/jax"]
    for name, a in zip(("all_emitted", "latents", "cache_x0"), got):
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(jout, name)), rtol=1e-5,
                                   atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(jout.cache_valid))


def test_send_carries_nested_tensors_whole():
    obj = {"seed": TF.FIFOSeed(torch.randn(1, 3, 2, 2), torch.randn(1, 3, 2, 2),
                               torch.tensor([True, False, True]), np.arange(3)[::-1].copy(),
                               (torch.randn(4, 8), torch.randn(4, 8)), None),
           "bf16": torch.randn(5, 3).to(torch.bfloat16), "scalar": torch.tensor(2.5),
           "empty": torch.zeros(0, 4, dtype=torch.int64), "ints": [torch.arange(7), 3, "x"],
           "state": torch.Generator().manual_seed(3).get_state()}
    assert mesh.launch(C.echo, 3, (obj,), device="cpu", timeout_s=TIMEOUT_S) == 3


@pytest.mark.parametrize("how", ["raise", "die"])
def test_a_failing_rank_ends_the_launch(seed_np, how):
    t0 = time.monotonic()
    with pytest.raises(Exception, match="planted failure|another queue rank failed|exit code 3"):
        mesh.launch(C.failing_rank, 2, (_case("stochastic_xt", ("keyed", 5), seed_np), how),
                    device="cpu", timeout_s=TIMEOUT_S)
    assert time.monotonic() - t0 < TIMEOUT_S


def test_queue_split_must_divide_the_rank_windows(seed_np, monkeypatch):
    """Three ranks for the 4 windows raise: in the engine before any model
    call, and in the CLI before anything is spawned."""
    class Three:
        rank, size, leader = 0, 3, True

    def no_model(*a):
        raise AssertionError("the model ran")

    case = _case("stochastic_xt", ("keyed", 5), seed_np)
    with pytest.raises(ValueError, match="4 rank windows do not split evenly over 3"):
        TF.fifo_generate(no_model, TS.make_schedule(), TF.FIFOConfig(**case["fcfg"]),
                         C.make_seed(case["seed"]), C.make_noise(case["noise"]), group=Three())
    monkeypatch.setattr(mesh, "launch", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(ValueError, match="4 rank windows do not split evenly over 3"):
        infer.main(["--config", "tokensgen_tpu/configs/infer_edit.yaml", "--smoke", "--device",
                    "cpu", "--queue-devices", "3"])


def test_mesh_spec_and_ranks_refuse_what_is_not_there(monkeypatch):
    assert mesh.MeshSpec(queue=4).num_devices == 4
    for spec in (dict(data=2), dict(model=2)):
        with pytest.raises(NotImplementedError, match="A12"):
            mesh.MeshSpec(**spec)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 queue ranks under NCCL need 2 cards .* 1 visible"):
        mesh.check_ranks(2, "cuda")
    assert mesh.check_ranks(2, "cuda", backend="gloo") == "gloo"
    assert mesh.check_ranks(4, "cpu") == "gloo"
    with pytest.raises(ValueError, match="Gloo"):
        mesh.check_ranks(2, "cpu", backend="nccl")


def test_infer_queue_devices_writes_what_one_process_writes(tmp_path):
    written = []
    for nq in (1, 2):
        run_dir = infer.main(["--config", "tokensgen_tpu/configs/infer_edit.yaml", "--smoke",
                              "--device", "cpu", "--queue-devices", str(nq), "--set",
                              f"output_dir={tmp_path}/q{nq}", "--set",
                              "input_config.edit_item_1.params.max_num_chunks=2"])
        written.append(np.load(glob.glob(os.path.join(run_dir, "*_latents.npy"))[0]))
        assert glob.glob(os.path.join(run_dir, "*_fifo.mp4"))
    assert written[0].shape == (1, 6, 16, 4, 6)
    np.testing.assert_array_equal(written[1], written[0])
