"""The data axis of the port's trainers (`sharding/mesh.py`'s `DataGroup`,
`sharding/zero.py`, `TrainStep` under a group, both trainers' data
parallelism and ZeRO-1) on the host, over Gloo ranks in spawned processes
(`tests/_torch_dist_child.py`, which imports no JAX; the JAX runs and draws
are made here).

* Port dp=2 against port dp=1 on the same global batch, through the
  trainers of the CLIs at --smoke: two updates of T2To (f32 AdamW, padded
  chunks masked) and of To2V (int8 AdamW, accumulation 2), each with and
  without ZeRO-1, and of T2To with LoRA factors under Prodigy: the gradient
  each update applies within 1e-5 relative L2, each trained tensor on its
  own, and the trained tensors together within 5e-5 / 1e-4 of the update.
* ZeRO-1 against replicated state at dp=2: bit-equal for AdamW and the
  int8 AdamW; Prodigy within 1e-6 (its sums add the ranks' parts in
  another order).
* Against JAX's own data-parallel step (`make_train_step` on a
  ``MeshSpec(data=2)`` mesh of conftest's virtual devices, `shard_batch`,
  `shard_opt_state`), as tests/test_zero.py runs it: the same weights and
  draws, 2e-4 (the two-step tests' tolerance).
* A dp=2 ZeRO-1 checkpoint resumes at dp=2 (bit-equal to the uninterrupted
  run) and at dp=1 (1e-5).
* Multi-host: two processes started as ``torchrun`` starts them (``env://``,
  one Gloo rank each), each reading its host's share of a dataset on disk,
  train what one launch of dp=2 trains.
* Both CLIs run ``--set dp_devices=2 --set zero1=true`` on the host.

The host's thread count is held at THREADS (the ranks take the parent's):
a CPU matmul's bits depend on it."""

import dataclasses
import glob
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.sharding import MeshSpec as JMeshSpec
from tokensgen_tpu.sharding import make_mesh, replicate, shard_batch
from tokensgen_tpu.sharding.zero import shard_opt_state
from tokensgen_tpu.train import objective as JO
from tokensgen_tpu.train import t2to as JT2
from tokensgen_tpu.train import to2v as JT
from tokensgen_tpu_torch import train_t2to, train_to2v
from tokensgen_tpu_torch.convert.from_jax import dit_state_dict, resampler_state_dict
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.sharding import mesh
from tokensgen_tpu_torch.train import checkpoint as CK
from tokensgen_tpu_torch.train import t2to as TT2
from tokensgen_tpu_torch.train import to2v as TT

import _torch_dist_child as C
from _torch_parity import np_tree
from test_torch_t2to_train import TINY
from test_torch_train import _random_params as random_params
from test_torch_train import _train_setup

THREADS = 2
TIMEOUT_S = 300.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2TO_YAML = os.path.join(REPO, "tokensgen_tpu", "configs", "train_t2to.yaml")
TO2V_YAML = os.path.join(REPO, "tokensgen_tpu", "configs", "train_to2v.yaml")
T2TO_BATCHED = ("latents", "text_embeds", "valid_frames")
TO2V_BATCHED = ("latents", "vip_input_chunks", "vip_emb_sel", "text_embeds",
                "vip_image_rotary_emb", "vip_condition_rotary_emb")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _update_error(got: dict, want: dict, before: dict) -> float:
    """Relative L2, over every trained tensor together, of ``got``'s update
    from ``before`` against ``want``'s."""
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum()) for n in want)
    den = sum(float(((want[n].double() - before[n].double()) ** 2).sum()) for n in want)
    return (num / den) ** 0.5


# ------------------------------------------------------------ the JAX side


def _jax_t2to():
    """JAX `make_train_step` over ``MeshSpec(data=2)`` with ZeRO-1 state:
    two f32 AdamW updates of the tiny T2To DiT on a global batch of 2 (the
    second sample with 4 of 8 token frames valid) -> the port's step case
    and the parameters JAX ends with."""
    jd, td = JD.DiTConfig.tiny(**TINY), TD.DiTConfig.tiny(**TINY)
    rng = np.random.default_rng(3)
    b, f = 2, 8
    batch = {"latents": rng.normal(size=(b, f, 16, 8, 12)).astype(np.float32),
             "text_embeds": rng.normal(size=(b, jd.max_text_seq_length,
                                              jd.text_embed_dim)).astype(np.float32),
             "valid_frames": np.array([8, 4])}
    from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2 as jrope

    rope = jrope(64, np.arange(f), np.arange(8), np.arange(12), dim_t=52, dim_h=6, dim_w=6)
    params = random_params(lambda: JD.CogVideoXTransformer(jd).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["latents"]), jnp.asarray(batch["text_embeds"]),
        jnp.zeros((b,), jnp.int32), image_rotary_emb=rope))["params"]
    jcfg = JT2.T2ToTrainConfig(num_processes=2)
    sched = JS.make_schedule(JS.ScheduleConfig(beta_schedule="vip_1"))
    opt = JT2.make_optimizer(jcfg)
    step = jax.jit(JT2.make_train_step(jd, sched, jcfg, opt))
    mesh_ = make_mesh(JMeshSpec(data=2), jax.devices()[:2])
    p, state = replicate(mesh_, params), shard_opt_state(opt.init(params), mesh_)
    jb = {k: shard_batch(mesh_, jnp.asarray(v)) for k, v in batch.items()}
    draws = []
    for key in jax.random.split(jax.random.PRNGKey(7), 2):
        p, state, _ = step(p, state, jb, key)
        r_t, r_noise = jax.random.split(key)
        draws.append((np.array(JO.sample_uniform_timesteps(r_t, b, 1000, None, 1)),
                      np.array(jax.random.normal(r_noise, batch["latents"].shape))))
    case = dict(kind="t2to", dcfg=td, state=dit_state_dict(np_tree(params), td),
                tcfg=TT2.T2ToTrainConfig(), batch={k: torch.from_numpy(v) for k, v in
                                                   batch.items()},
                batched=T2TO_BATCHED, draws=draws, accum=1)
    return case, {"params": {k: torch.from_numpy(np.array(v))
                             for k, v in dit_state_dict(np_tree(p), td).items()}}


def _to2v_flat(tree, td, trc) -> dict:
    flat = {f"dit.{k}": v for k, v in dit_state_dict(tree["dit"], td).items()}
    flat.update({f"resampler.{k}": v
                 for k, v in resampler_state_dict(tree["resampler"], trc.depth).items()})
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _jax_to2v():
    """JAX To2V `make_train_step` over ``MeshSpec(data=2)`` with
    ``num_processes=2`` (the uniform timesteps stratified by batch
    position), int8 AdamW with accumulation 2 (`optax.MultiSteps`), ZeRO-1
    state: four micro-steps, two updates -> the port's step case and the
    trained parameters JAX ends with."""
    jd, td, jrc, trc, params, jb, tb = _train_setup()
    jcfg = JT.To2VTrainConfig(num_processes=2)
    opt = JT.make_optimizer(params, jcfg, accum_steps=2)
    step = jax.jit(JT.make_train_step(jd, jrc, JS.make_schedule(JS.ScheduleConfig()), jcfg, opt))
    mesh_ = make_mesh(JMeshSpec(data=2), jax.devices()[:2])
    p, state = replicate(mesh_, params), shard_opt_state(opt.init(params), mesh_)
    sharded = {k: (tuple(shard_batch(mesh_, x) for x in v) if isinstance(v, tuple)
                   else shard_batch(mesh_, v)) if k in TO2V_BATCHED else v for k, v in jb.items()}
    b, f = jb["latents"].shape[:2]
    draws, losses, after1 = [], [], None
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(9), 4)):
        p, state, metrics = step(p, state, sharded, key)
        losses.append(float(metrics["loss"]))
        if i == 1:
            after1 = _to2v_flat(np_tree(p), td, trc)
        r_t, r_noise, r_mix = jax.random.split(key, 3)  # the loss_fn's draws
        t_uniform = JO.sample_uniform_timesteps(r_t, b, 1000, jnp.arange(b) % 2, 2)
        t_ramp = JO.sample_fifo_ramp_timesteps(r_t, b, f, 1000, jcfg.inference_timesteps)
        use_ramp = jax.random.uniform(r_mix, ()) < jcfg.diff_timesteps_ratio
        ts = jnp.where(use_ramp, t_ramp, jnp.broadcast_to(t_uniform[:, None], (b, f)))
        draws.append((np.array(ts), np.array(jax.random.normal(r_noise, jb["latents"].shape))))
    tree = np_tree(params)
    case = dict(kind="to2v", dcfg=td, rcfg=trc,
                state={"dit": dit_state_dict(tree["dit"], td),
                       "resampler": resampler_state_dict(tree["resampler"], trc.depth)},
                tcfg=TT.To2VTrainConfig(num_processes=2), batch=tb, batched=TO2V_BATCHED,
                draws=draws, accum=2)
    return case, {"after1": {k: v for k, v in after1.items() if TT.is_trainable(k)},
                  "losses": losses}


# ----------------------------------------------------------- the port runs


def _trainer_case(name, kind, out, b, zero1, steps, **extra):
    over = {"output_dir": str(out), "per_gpu_batch_size": b, "zero1": zero1,
            "checkpointing_steps": 2, "checkpoints_total_limit": 5}
    if kind == "to2v":
        over["gradient_accumulation_steps"] = 2
    over.update(extra.pop("overrides", {}))
    return dict(name=name, kind=kind, config=T2TO_YAML if kind == "t2to" else TO2V_YAML,
                overrides=over, steps=steps, **extra)


@pytest.fixture(scope="module")
def jax_cases():
    return {"t2to": _jax_t2to(), "to2v": _jax_to2v()}


@pytest.fixture(scope="module")
def runs(jax_cases, tmp_path_factory):
    """One launch of 2 Gloo ranks running every case: the step cases (JAX's
    weights and draws) with and without ZeRO-1 (To2V also under Prodigy),
    the trainers' runs (To2V's ZeRO-1 run checkpoints at micro-steps 2 and
    4), and a resume at dp=2 from that run's checkpoint-2."""
    root = tmp_path_factory.mktemp("dp")
    cases = []
    for kind, (case, _) in jax_cases.items():
        for zero1 in (True, False):
            cases.append(dict(case, name=f"{kind}_step_{zero1}", zero1=zero1))
        if kind == "to2v":
            prodigy = dataclasses.replace(case["tcfg"], optimizer="prodigy")
            for zero1 in (True, False):
                cases.append(dict(case, name=f"to2v_prodigy_{zero1}", zero1=zero1, tcfg=prodigy))
    for kind, steps in (("t2to", 2), ("to2v", 4)):
        for zero1 in (True, False):
            cases.append(_trainer_case(f"{kind}_{zero1}", kind, root / f"{kind}_{zero1}", 1,
                                       zero1, steps))
    lora = {"lora_rank": 4, "optimizer": "prodigy"}
    for zero1 in (True, False):
        cases.append(_trainer_case(f"t2to_lora_{zero1}", "t2to", root / f"t2to_lora_{zero1}", 1,
                                   zero1, 2, overrides=lora))
    seed = str(root / "to2v_True" / "checkpoints" / "checkpoint-2")
    cases.append(_trainer_case("to2v_resume", "to2v", root / "to2v_resume", 1, True, 4,
                               seed_from=seed, resume=True))
    out = mesh.launch(C.dp_cases, 2, (cases,), device="cpu", timeout_s=TIMEOUT_S,
                      group_cls=mesh.DataGroup)
    return out, root


def _one_process(case):
    """A case in this process, without a group (dp=1 on the global batch)."""
    return (C.train_step_case if "draws" in case else C.trainer_run)(None, case)


@pytest.fixture(scope="module")
def refs(runs, tmp_path_factory):
    """The dp=1 runs on the global batch of 2: the trainers (To2V's uniform
    timesteps stratified over 2 positions, as the 2-rank run draws them),
    and the To2V resume from the dp=2 ZeRO-1 checkpoint-2, with and
    without ZeRO-1."""
    _, root = runs
    out = tmp_path_factory.mktemp("dp1")
    res = {}
    for kind, steps, extra in (("t2to", 2, {}), ("to2v", 4, {"num_processes": 2}),
                               ("t2to_lora", 2, {})):
        over = {"lora_rank": 4, "optimizer": "prodigy"} if kind == "t2to_lora" else {}
        res[kind] = C.trainer_run(None, _trainer_case(
            kind, kind.split("_")[0], out / kind, 2, False, steps, overrides=over, **extra))
    seed = str(root / "to2v_True" / "checkpoints" / "checkpoint-2")
    for zero1 in (True, False):
        res[f"to2v_resume_{zero1}"] = C.trainer_run(None, _trainer_case(
            "to2v_resume", "to2v", out / f"resume_{zero1}", 2, zero1, 4, seed_from=seed,
            resume=True, num_processes=2))
    return res


def _initial(case) -> dict:
    """The trained tensors a step case starts from."""
    model = C._step_model(case)
    return {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


# ------------------------------------------------------------------ tests


def test_dp2_t2to_matches_jax_data_mesh(runs, jax_cases):
    """The port's T2To step at dp=2 (with and without ZeRO-1) against
    JAX's on a data=2 mesh with ZeRO-1 state, from the same weights with
    the same draws: two f32 AdamW updates within 2e-4 relative L2 over every
    trained tensor."""
    out, _ = runs
    case, want = jax_cases["t2to"]
    before = _initial(case)
    for zero1 in (True, False):
        got = out[f"t2to_step_{zero1}"]["params"]
        assert set(got) == set(want["params"])
        err = _update_error(got, want["params"], before)
        assert err <= 2e-4, (zero1, err)


def test_dp2_to2v_matches_jax_data_mesh(runs, jax_cases):
    """The port's To2V step at dp=2 (with and without ZeRO-1) against JAX's
    on a data=2 mesh (``num_processes=2``, ZeRO-1 state), int8 AdamW,
    accumulation 2, the same weights and draws, as the two-step tests hold
    it: the first update within 2e-4 relative L2 over every trained tensor,
    and the losses of the two micro-steps after it, which read the updated
    parameters, within 2e-5 relative. (The second update reads int8 moments
    whose codes tiny gradient differences flip: JAX and the port part by
    ~2.5e-2 there, in one process as over two.)"""
    out, _ = runs
    case, want = jax_cases["to2v"]
    before = {n: v for n, v in _initial(case).items() if n in want["after1"]}
    for zero1 in (True, False):
        res = out[f"to2v_step_{zero1}"]
        err = _update_error(res["after"][0], want["after1"], before)
        assert err <= 2e-4, (zero1, err)
        np.testing.assert_allclose(res["losses"][2:], want["losses"][2:], rtol=2e-5)


@pytest.mark.parametrize("name", ["t2to_step", "to2v_step", "t2to", "to2v"])
def test_zero1_is_bit_equal_to_replicated(runs, name):
    """ZeRO-1 at dp=2 against replicated optimizer state at dp=2: every
    trained tensor bit-equal (AdamW; the int8 AdamW, its blocks cut whole),
    while each rank holds less than the replicated state."""
    out, _ = runs
    z, r = out[f"{name}_True"], out[f"{name}_False"]
    for n, p in r["params"].items():
        assert torch.equal(z["params"][n], p), n
    zb, rb = z["opt_bytes"], r["opt_bytes"]
    assert sum(zb) < 1.2 * rb[0] and max(zb) < 0.8 * rb[0], (zb, rb)


def test_zero1_prodigy_matches_replicated(runs, jax_cases):
    """Prodigy under ZeRO-1: its two sums run over every rank's part (one
    scalar all-reduce); against replicated state within 1e-6 relative L2 of
    the update."""
    out, _ = runs
    z, r = out["to2v_prodigy_True"]["params"], out["to2v_prodigy_False"]["params"]
    base = _initial(jax_cases["to2v"][0])
    err = _update_error(z, r, {n: base[n] for n in r})
    assert err <= 1e-6, err


@pytest.mark.parametrize("kind,bound", [("t2to", 5e-5), ("to2v", 1e-4), ("t2to_lora", 5e-5)])
def test_dp2_trains_what_dp1_trains(runs, refs, kind, bound):
    """The trainers at dp=2 against dp=1 on the global batch: every rank
    draws the global batch's data, windows, timesteps and noise and keeps
    its rows (rank 0's per-sample losses are the first sample's), and the
    gradient each update applies (the all-reduced mean; replicated state,
    which the ZeRO-1 run equals bit for bit) is the one process's within
    1e-5 relative L2, each trained tensor on its own (measured at most
    3.1e-6), at both updates (T2To f32 AdamW; To2V int8 AdamW, accumulation
    2; T2To LoRA under Prodigy). The trained tensors after the two updates
    (ZeRO-1), all together, within ``bound`` relative L2 of the update: the
    grads' last-bit differences reach the second Adam step through its
    per-entry scaling (measured 1.04e-5 for T2To) and, for To2V, through
    int8 codes they flip (2.4e-5). A tensor that starts at zero (a norm's
    bias) is all update, so on its own it moves by up to 3.2e-4 of itself."""
    out, _ = runs
    rep, zero = f"{kind}_False", f"{kind}_True"
    got, want = out[rep], refs[kind]
    assert [r["step"] for r in got["records"]] == [r["step"] for r in want["records"]]
    for r, w in zip(got["records"], want["records"]):
        np.testing.assert_allclose(r["sample_losses"], w["sample_losses"][:1], rtol=1e-5)
    assert len(got["grads"]) == len(want["grads"]) == 2
    for g, w in zip(got["grads"], want["grads"]):
        for n, v in w.items():  # each trained tensor's gradient on its own
            diff = float((g[n].double() - v.double()).norm())
            assert diff <= 1e-5 * float(v.double().norm()), (n, diff)
    err = _update_error(out[zero]["params"], want["params"], want["initial"])
    assert err <= bound, err


def test_to2v_strata_follow_batch_positions(runs):
    """Each rank's uniform timesteps lie in the stratum of their global
    batch position (position i in stratum i mod 2 of [0, 1000)), as the JAX
    step draws them with num_processes=2; a ramp step shares none."""
    out, _ = runs
    records = out["to2v_True"]["records"]  # rank 0: global position 0
    uniform = [r for r in records if min(r["timesteps"][0]) == max(r["timesteps"][0])]
    assert uniform
    assert all(r["timesteps"][0][0] < 500 for r in uniform)


def test_to2v_rank_timesteps_are_jax_stratified_draws():
    """The port's stratified draw (`objective.stratified_timesteps`, which
    `sample_timesteps(num_processes=2)` runs on the global batch) on the
    JAX step's own uniforms equals JAX's `sample_uniform_timesteps` with
    ``process_index = arange(B) % 2``, and each rank's rows of it lie in
    the strata of its global positions."""
    from tokensgen_tpu_torch.train import objective as TO

    b = 4
    for key in jax.random.split(jax.random.PRNGKey(9), 4):
        r_t = jax.random.split(key, 3)[0]
        want = np.array(JO.sample_uniform_timesteps(r_t, b, 1000, jnp.arange(b) % 2, 2))
        u = torch.from_numpy(np.array(jax.random.uniform(r_t, (b,))))
        got = TO.stratified_timesteps(u, torch.arange(b) % 2, 2, 1000)
        np.testing.assert_array_equal(got.numpy(), want)
        for rank in range(2):
            rows = got[rank * 2:(rank + 1) * 2]
            assert rows[0] < 500 <= rows[1], (rank, rows)


def test_zero1_checkpoint_resumes_at_dp2_and_dp1(runs, refs):
    """A dp=2 ZeRO-1 checkpoint (each rank's part of the int8 state with its
    element ranges, rank 0's parameters and random streams) resumed at dp=2
    continues bit-equal to the uninterrupted run; at dp=1, with or without
    ZeRO-1, it applies the uninterrupted run's second update within the
    bound of the dp=1 comparison (1e-4 relative L2)."""
    out, root = runs
    full, resumed = out["to2v_True"]["params"], out["to2v_resume"]["params"]
    for n, p in full.items():
        assert torch.equal(resumed[n], p), n
    ckpt = root / "to2v_True" / "checkpoints" / "checkpoint-2"
    assert sorted(os.listdir(ckpt)) == ["opt-rank0-of-2.pt", "opt-rank1-of-2.pt", "state.pt"]
    mid = torch.load(ckpt / "state.pt", weights_only=True)["params"]
    for zero1 in (True, False):
        err = _update_error(refs[f"to2v_resume_{zero1}"]["params"], full, mid)
        assert err <= 1e-4, (zero1, err)


# ----------------------------------------------------------- the layout


def test_layout_cuts_int8_blocks_whole():
    """The ZeRO-1 layout: parts on 256-value boundaries covering each
    tensor once; tensors too small for a block a rank stay whole on every
    rank. Two ranks' int8 AdamW parts, run one after the other on the same
    gradients, give the replicated update bit for bit; parts cut on
    128-value boundaries (a block cut in two) do not."""
    from tokensgen_tpu_torch.sharding.zero import ZeroLayout
    from tokensgen_tpu_torch.train.adam8bit import AdamW8bit

    gen = torch.Generator().manual_seed(0)
    shapes = {"w": (33, 100), "b": (100,), "big": (4700,)}
    params = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    grads = [{n: torch.randn(s, generator=gen) for n, s in shapes.items()} for _ in range(2)]
    sizes = {n: p.numel() for n, p in params.items()}
    lays = [ZeroLayout.of(params, 2, r) for r in range(2)]
    assert lays[0].ranges == {"w": (0, 1792), "b": (0, 100), "big": (0, 2560)}
    assert lays[1].ranges == {"w": (1792, 3300), "b": (0, 100), "big": (2560, 4700)}
    assert ZeroLayout.of(params, 2, 1, 128).ranges["big"] == (2432, 4700)
    assert not lays[0].split("b")

    def run(align):
        """Each rank's copy of the parameters, its part updated, then every
        split tensor's parts copied into every copy (the all-gather)."""
        copies = [{n: p.clone() for n, p in params.items()} for _ in range(2)]
        ranks = [ZeroLayout.of(params, 2, r, align) for r in range(2)]
        opts = [AdamW8bit(lay.owned(ps), lambda c: 1e-2, min_quant_size=1000, sizes=sizes)
                for lay, ps in zip(ranks, copies)]
        for g in grads:
            for lay, opt, ps in zip(ranks, opts, copies):
                opt.step(lay.owned(ps), lay.owned(g))
            for lay, ps in zip(ranks, copies):
                for other in copies:
                    for n, part in lay.owned(ps).items():
                        if lay.split(n):
                            lay.owned(other)[n].copy_(part)
        assert all(torch.equal(copies[0][n], copies[1][n]) for n in params)
        return copies[0]

    full = {n: p.clone() for n, p in params.items()}
    ref = AdamW8bit(full, lambda c: 1e-2, min_quant_size=1000)
    for g in grads:
        ref.step(full, g)
    whole, cut = run(256), run(128)
    assert all(torch.equal(whole[n], full[n]) for n in full)
    assert not torch.equal(cut["big"], full["big"])


def test_restore_part_moves_state_between_layouts():
    """`restore_part` re-cuts a 2-rank part set (int8 and f32 moments) for
    3 ranks and for the whole tensors of a replicated optimizer, bit for
    bit, the int8 blocks and the last block's padding kept."""
    from tokensgen_tpu_torch.sharding.zero import ZeroLayout, restore_part
    from tokensgen_tpu_torch.train.adam8bit import AdamW8bit

    gen = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(40, 77, generator=gen), "c": torch.randn(10, generator=gen)}
    grad = {n: torch.randn(p.shape, generator=gen) for n, p in params.items()}
    sizes = {n: p.numel() for n, p in params.items()}

    def stepped(ranks):
        ps = {n: p.clone() for n, p in params.items()}
        out = []
        for r in range(ranks):
            lay = ZeroLayout.of(ps, ranks, r)
            opt = AdamW8bit(lay.owned(ps), lambda c: 1e-2, min_quant_size=1000, sizes=sizes)
            opt.step(lay.owned(ps), lay.owned(grad))
            out.append((dict(lay.ranges), opt.state_dict()))
        return out

    two, three = stepped(2), stepped(3)
    for ranges, want in three:
        got = restore_part(two, ranges, sizes)
        for key in ("mu", "nu"):
            for n in params:
                w, g = want[key][n], got[key][n]
                if isinstance(w, dict):
                    assert all(torch.equal(g[k], w[k]) for k in w), (key, n)
                else:
                    assert torch.equal(g, w), (key, n)
    whole = AdamW8bit({n: p.clone() for n, p in params.items()}, lambda c: 1e-2,
                      min_quant_size=1000)
    whole.step({n: p.clone() for n, p in params.items()}, grad)
    want = whole.state_dict()
    got = restore_part(two, {n: (0, k) for n, k in sizes.items()}, sizes,
                       {n: p.shape for n, p in params.items()})
    assert all(torch.equal(got["mu"]["a"][k], want["mu"]["a"][k]) for k in ("q", "scale"))
    assert got["mu"]["c"].shape == (10,) and torch.equal(got["mu"]["c"], want["mu"]["c"])


def test_mesh_spec_data_axis_and_host_shares(monkeypatch):
    """``MeshSpec(data=N)`` builds; ``model`` > 1 still raises naming A12.
    A data group of 4 ranks over 2 hosts numbers its ranks host by host and
    gives each host half of a global batch; the config's ``dp_devices``
    defaults to the visible cards on the card and 1 on the host; NCCL wants
    a card a data rank."""
    assert mesh.MeshSpec(data=4).num_devices == 4
    with pytest.raises(NotImplementedError, match="A12"):
        mesh.MeshSpec(data=2, model=2)
    g = mesh.DataGroup(3, 4, torch.device("cpu"), None, 1.0, local_size=2)
    assert (g.hosts, g.host, g.local_rank) == (2, 1, 1)
    assert mesh.process_batch_shard(8, g) == (4, 1, 2)
    with pytest.raises(ValueError, match="not divisible by 2 hosts"):
        mesh.process_batch_shard(3, g)
    assert mesh.process_batch_shard(6) == (6, 0, 1)
    from tokensgen_tpu_torch.utils.config import Config

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for key in mesh.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert mesh.data_axis(Config({}), "cuda") == 4
    assert mesh.data_axis(Config({}), "cpu") == 1
    assert mesh.data_axis(Config({"dp_devices": 2}), "cuda") == 2
    for key in ("tp_devices", "sp_devices"):
        with pytest.raises(NotImplementedError, match="A12"):
            mesh.data_axis(Config({key: 2}), "cpu")
    with pytest.raises(ValueError, match="8 data ranks under NCCL need 8 cards .* 4 visible"):
        mesh.check_ranks(8, "cuda", group_cls=mesh.DataGroup)


def test_scale_lr_counts_the_ranks():
    """``scale_lr``: lr x accumulation x per-device batch x data ranks, as
    the JAX CLIs scale it."""
    from tokensgen_tpu_torch.utils.config import Config

    cfg = Config({"scale_lr": True, "learning_rate": 1e-4, "gradient_accumulation_steps": 3,
                  "per_gpu_batch_size": 2})
    assert train_to2v.train_config(cfg, 4).learning_rate == pytest.approx(1e-4 * 3 * 2 * 4)
    assert train_t2to.train_config(cfg, 4).learning_rate == pytest.approx(1e-4 * 3 * 2 * 4)
    assert train_to2v.train_config(cfg, 4).num_processes == 4


def test_dropped_train_step_frees_its_parameters():
    """A `TrainStep`'s grad-norm hooks tie no cycle through its parameters:
    dropped while autograd still holds one of them (a live graph), the step
    is freed at once, not left for a collection that skips the cycle while
    that graph lives (on the card, a dropped trainer's weights)."""
    import gc
    import weakref

    from tokensgen_tpu_torch.core import schedule as S
    from tokensgen_tpu_torch.train import optim

    class Step(optim.TrainStep):
        def sample_losses(self, batch, timesteps, noise):
            return (self.params["w"] * noise).sum(-1)

    w = torch.nn.Parameter(torch.randn(8))
    sched = S.make_schedule(S.ScheduleConfig())
    step = Step({"w": w}, optim.base_optimizer("adamw", {"w": w}, 1e-3), 1.0, sched)
    rec = step({}, torch.tensor([10, 20]), torch.randn(2, 8))
    assert float(rec["grad_norm"]) > 0
    alive = weakref.ref(step)
    keep = w * 3  # its graph's AccumulateGrad holds w
    del step
    gc.collect()
    assert alive() is None
    del keep


def test_batch_iterator_slots_split_each_global_batch():
    """A host's ranks read their positions of each global batch: rank
    slots of 2 over batches of 2 x 2 (an incomplete last one dropped)
    together give the one-rank batches of 4."""
    from tokensgen_tpu_torch.data.mira import batch_iterator

    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"i": i}

    one = [b["i"].tolist() for b in batch_iterator(Items(), 4, seed=3, prefetch=0)]
    two = [[b["i"].tolist() for b in batch_iterator(Items(), 2, seed=3, prefetch=0, slot=s,
                                                    slots=2)] for s in range(2)]
    assert [a + b for a, b in zip(*two)] == one and len(one) == 2


# ------------------------------------------------------- CLIs, multi-host


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _video_layout(root):
    """Two 30 fps mp4s of 2 chunks of 9 frames at 10 fps, MiraData layout."""
    from tokensgen_tpu_torch.data.mira import mira_video_path
    from tokensgen_tpu_torch.data.video_io import write_video

    rng = np.random.default_rng(0)
    for idx in (7, 1003):
        path = mira_video_path(str(root / "videos"), idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_video(path, rng.uniform(0, 255, size=(60, 40, 60, 3)).astype(np.uint8), fps=30.0)
    (root / "videos.csv").write_text("index,dense_caption\n7,a red road\n1003,snow\n",
                                     encoding="ISO-8859-1")


def _to2v_disk_args(root, out):
    return ["--config", TO2V_YAML, "--device", "cpu", "--max-steps", "2",
            "--set", "model_size=tiny", "--set", f"output_dir={out}",
            "--set", f"train_data_params.csv_file={root / 'videos.csv'}",
            "--set", f"train_data_params.video_dir={root / 'videos'}",
            "--set", "train_data_params.max_num_chunks=2", "--set", "per_gpu_batch_size=1",
            "--set", "gradient_accumulation_steps=1", "--set", "dataloader_num_workers=0",
            "--set", "zero1=true"]


def _final_params(out, sub="checkpoints") -> dict:
    state, step = CK.restore_checkpoint(os.path.join(out, sub))
    assert step == 2
    return state["params"]


def test_multihost_env_launch_trains_what_one_launch_trains(tmp_path, capsys):
    """Two processes started as ``torchrun --nnodes 2 --nproc-per-node 1``
    starts them (``WORLD_SIZE`` 2, ``RANK``, ``LOCAL_RANK`` 0,
    ``LOCAL_WORLD_SIZE`` 1, ``MASTER_ADDR`` localhost) each join the
    ``env://`` group as one host and read their host's strided share of the
    dataset (`process_batch_shard`); their two To2V updates (ZeRO-1) equal
    those of one launch of ``--set dp_devices=2``, whose ranks read their
    positions of each global batch: at one video a rank the two give each
    rank the same videos."""
    _video_layout(tmp_path)
    one = tmp_path / "one"
    train_to2v.main(_to2v_disk_args(tmp_path, one) + ["--set", "dp_devices=2"])
    assert "training done" in capsys.readouterr().out
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS=str(THREADS),
                   PYTHONPATH=os.pathsep.join([REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tokensgen_tpu_torch.train_to2v"]
            + _to2v_disk_args(tmp_path, tmp_path / "hosts"), env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    assert "data parallel: 2 ranks on 2 host(s)" in outs[0]
    assert "[rank 1/2] step 2:" in outs[1]
    got, want = _final_params(tmp_path / "hosts"), _final_params(one)
    for n, v in want.items():
        np.testing.assert_allclose(got[n].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("cli", ["t2to", "to2v"])
def test_cli_runs_dp2_zero1(tmp_path, capfd, cli):
    """`train_t2to` / `train_to2v --smoke --device cpu --set dp_devices=2
    --set zero1=true`: two ranks, 2 steps (To2V: accumulation 1), rank 0's
    log with the all-reduce and all-gather seconds, rank 1's step times
    marked with its rank, a checkpoint with each rank's optimizer part."""
    module, config, sub = ((train_t2to, T2TO_YAML, "t2to_checkpoints") if cli == "t2to"
                           else (train_to2v, TO2V_YAML, "checkpoints"))
    module.main(["--config", config, "--smoke", "--device", "cpu", "--max-steps", "2",
                 "--set", f"output_dir={tmp_path}", "--set", "dp_devices=2",
                 "--set", "zero1=true", "--set", "per_gpu_batch_size=1",
                 "--set", "gradient_accumulation_steps=1"])
    text = capfd.readouterr().out
    assert "training done" in text
    assert "data parallel: 2 ranks on 1 host(s), global batch 2; zero1 True" in text
    assert "all-reduce" in text and "all-gather" in text
    assert "[rank 1/2] step 2:" in text
    ckpt = tmp_path / sub / "checkpoint-2"
    assert sorted(os.listdir(ckpt)) == ["opt-rank0-of-2.pt", "opt-rank1-of-2.pt", "state.pt"]
