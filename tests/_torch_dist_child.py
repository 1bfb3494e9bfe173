"""What each rank of the port's queue-group tests runs, in spawned processes
(`tokensgen_tpu_torch.sharding.mesh.launch`): a module that imports no JAX,
so that a worker's re-import stays light. Everything a worker receives
pickles: numpy arrays, plain objects and the classes below."""

import dataclasses
import os

import numpy as np
import torch

from tokensgen_tpu_torch.core import schedule as TS
from tokensgen_tpu_torch.sampling import base as TB
from tokensgen_tpu_torch.sampling import fifo as TF


class OracleModel:
    """tests/test_torch_sampling.py's exact-v oracle: a fixed target, a
    CFG-branch offset and, with VIP, terms read from the VIP tokens and
    the rolling rope tables. Its call number ``fail_at`` raises, or with
    ``die`` ends its process at once (the failing-rank tests)."""

    def __init__(self, target: np.ndarray, offset: np.ndarray, fail_at: int = -1,
                 die: bool = False):
        self.sched = TS.make_schedule()
        self.tgt, self.off = torch.from_numpy(target), torch.from_numpy(offset)
        self.fail_at, self.die, self.calls = fail_at, die, 0

    def __call__(self, lat_cfg, t2d, vip_kwargs=None):
        self.calls += 1
        if self.calls == self.fail_at:
            if self.die:
                os._exit(3)
            raise RuntimeError("planted failure in a queue rank's model")
        ap = self.sched.alphas_cumprod[t2d.clamp(0, 999)][:, :, None, None, None]
        v = (ap ** 0.5 * lat_cfg - self.tgt) / (1 - ap) ** 0.5
        v = v + self.off[:, None, None, None, None]
        if vip_kwargs is not None:
            v = v + 0.01 * vip_kwargs["vip_hidden_states"].mean(dim=(1, 2, 3, 4))[
                :, None, None, None, None]
            v = v + 0.01 * vip_kwargs["vip_image_rotary_emb"][0].mean()
            v = v + 0.01 * vip_kwargs["vip_condition_rotary_emb"][1].mean()
        return v


class ReplayNoise:
    """A noise source from a table of draws made elsewhere (the JAX
    package's, precomputed by the parent): tag -> array."""

    keyed = True

    def __init__(self, draws: dict):
        self.draws = draws

    def __call__(self, tag, shape):
        x = self.draws[tuple(int(v) if not isinstance(v, str) else v for v in tag)]
        assert x.shape == tuple(shape), (tag, x.shape, shape)
        return torch.from_numpy(x)


def make_noise(spec):
    kind, arg = spec
    if kind == "keyed":
        return TB.keyed_noise(arg, "cpu")
    if kind == "generator":
        return TB.generator_noise(torch.Generator().manual_seed(arg))
    return ReplayNoise(arg)


def make_seed(seed_np: dict) -> TF.FIFOSeed:
    vip = None
    if seed_np.get("vip") is not None:
        v = seed_np["vip"]
        vip = TF.VIPState(*(torch.from_numpy(x) for x in v[:7]), v[7])
    return TF.FIFOSeed(torch.from_numpy(seed_np["latents"]), torch.from_numpy(seed_np["x0"]),
                       torch.from_numpy(seed_np["valid"]), seed_np["timesteps"], None, vip)


def run_fifo_cases(group, cases):
    """Each case {"name", "fcfg", "seed", "noise", "cache_idx", "model"}
    through `fifo_generate` on this rank -> {name: (all_emitted, latents,
    cache_x0, cache_valid)} on rank 0 (None elsewhere)."""
    sched = TS.make_schedule()
    out = {}
    for c in cases:
        res = TF.fifo_generate(OracleModel(*c["model"]), sched, TF.FIFOConfig(**c["fcfg"]),
                               make_seed(c["seed"]), make_noise(c["noise"]),
                               cache_idx=c["cache_idx"], group=group)
        if res is not None:
            out[c["name"]] = (res.all_emitted, res.latents, res.cache_x0, res.cache_valid)
    return out if group is None or group.leader else None


def failing_rank(group, case, how: str):
    """Rank 1 fails in the third model call of its block: it raises
    (``how="raise"``) or its process dies at once (``"die"``)."""
    fail = dict(fail_at=3, die=how == "die") if group.rank == 1 else {}
    model = OracleModel(*case["model"], **fail)
    TF.fifo_generate(model, TS.make_schedule(), TF.FIFOConfig(**case["fcfg"]),
                     make_seed(case["seed"]), make_noise(case["noise"]), group=group)


# ------------------------------------------------------------------- serving

def smoke_service(group=None):
    """`serve.build_service` at the infer CLI's --smoke geometry on the host
    (random weights from seed 7, the hash text encoder)."""
    from tokensgen_tpu_torch.serve import build_service
    from tokensgen_tpu_torch.utils.config import Config

    cfg = Config({"seed": 7, "sampling_params": Config(
        {"queue_devices": group.size if group is not None else 1})})
    return build_service(cfg, True, "cpu", group=group)


def service_checks(group, frames: np.ndarray, seed: int):
    """Rank 0 of a queue-sharded service (the others follow until it
    closes): an `edit_stream` of two chunks (undecoded); a stream closed
    after its first chunk, then the same stream again; a crash-resume drill
    (the FIFO killed from rank 0's emit callback, resumed on every rank
    from rank 0's last snapshot). -> {"stream", "again": chunk latents,
    "health", "full", "stitched": emits by iteration}."""
    from tokensgen_tpu_torch.serve import _follow_service
    from tokensgen_tpu_torch.utils.config import Config

    if not group.leader:
        cfg = Config({"seed": 7, "sampling_params": Config({"queue_devices": group.size})})
        return _follow_service(group, cfg, True)
    svc = smoke_service(group)
    try:
        out = {"stream": [c["latents"] for c in svc.edit_stream("a red car", frames, 2,
                                                                seed=seed, decode=False)]}
        gen = svc.edit_stream("a red car", frames, 2, seed=seed, decode=False)
        assert next(gen)["chunk"] == 0
        gen.close()
        out["again"] = [c["latents"] for c in svc.edit_stream("a red car", frames, 2, seed=seed,
                                                              decode=False)]
        out["health"] = svc.health()
        out["full"], out["stitched"] = crash_resume_drill(svc.pipe, svc.text_encoder, frames,
                                                         group)
        return out
    finally:
        svc.close()


def crash_resume_drill(pipe, encoder, frames: np.ndarray, group=None):
    """tests/test_torch_serving.py's drill: an uninterrupted run's emits,
    and those of a run killed after emit 5 and resumed from its last
    snapshot (one every 2 iterations), stitched."""
    text, neg = encoder(["a red car"]), encoder([""])
    kw = dict(frames=torch.from_numpy(frames), num_chunks=2, decode=False, group=group)
    full = {}
    pipe.generate(text, neg, noise_fn=TB.keyed_noise(7, "cpu"), **kw,
                  emit_callback=lambda i, em: full.__setitem__(i, em))

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

    try:
        pipe.generate(text, neg, noise_fn=TB.keyed_noise(7, "cpu"), **kw, emit_callback=on_emit,
                      state_callback=on_state)
        raise AssertionError("the drill's run did not crash")
    except Crash:
        pass
    resume_i = max(states)
    tail = {}
    pipe.generate(text, neg, noise_fn=TB.keyed_noise(7, "cpu"), **kw,
                  resume_from=states[resume_i],
                  emit_callback=lambda i, em: tail.__setitem__(i, em))
    return full, {**{i: emits[i] for i in range(resume_i + 1)}, **tail}


def echo(group, obj):
    """Rank 0 `send`s ``obj``; every other rank holds what it `receive`s
    to its own copy of ``obj`` (bit for bit, types and all) -> on rank 0,
    the count of ranks that got it whole."""
    if group.leader:
        group.send(obj)
    else:
        got = group.receive()
        ok = _same(got, obj)
    whole = group.all_reduce_(torch.tensor([1.0 if group.leader or ok else 0.0])).item()
    return whole if group.leader else None


def _same(a, b) -> bool:
    if isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
    if isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and np.array_equal(a, b) and a.dtype == b.dtype
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


# --------------------------------------------------------- data parallelism

def _rows(batch: dict, keys, rows: slice) -> dict:
    """A rank's rows of the batched entries (``keys``) of a global batch;
    the other entries whole. Tuples (rope tables) row by row."""
    out = {}
    for k, v in batch.items():
        if k in keys:
            out[k] = tuple(x[rows] for x in v) if isinstance(v, tuple) else v[rows]
        else:
            out[k] = v
    return out


def _step_model(case):
    """The port model of a step case, its weights from ``case["state"]``."""
    from tokensgen_tpu_torch.models import dit as TD
    from tokensgen_tpu_torch.models import resampler as TR
    from tokensgen_tpu_torch.train import t2to as TT2
    from tokensgen_tpu_torch.train import to2v as TT

    if case["kind"] == "t2to":
        dit = TD.CogVideoXTransformer(case["dcfg"])
        dit.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
        return TT2.setup_full_finetune(dit.train())
    dit = TD.CogVideoXTransformer(case["dcfg"])
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"]["dit"].items()})
    rs = TR.Resampler(case["rcfg"])
    rs.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"]["resampler"].items()})
    return TT.setup_trainable(TT.To2VModel(dit, rs).train())


def train_step_case(group, case):
    """`T2ToTrainStep` / `To2VTrainStep` over ``group`` (None: one process on
    the global batch): each micro-step's global draws ``case["draws"]``
    (timesteps, noise), this rank's rows of them and of ``case["batch"]``
    -> {"params": every trained tensor after the last update, "after":
    after each update, "losses": each call's loss over the global batch,
    "opt_bytes": the optimizer's state bytes on this rank}."""
    from tokensgen_tpu_torch.core import schedule as TS
    from tokensgen_tpu_torch.sharding.zero import state_nbytes
    from tokensgen_tpu_torch.train import t2to as TT2
    from tokensgen_tpu_torch.train import to2v as TT

    model = _step_model(case)
    b = case["draws"][0][0].shape[0]
    rows = slice(None)
    if group is not None:
        per = b // group.size
        rows = slice(group.rank * per, (group.rank + 1) * per)
    if case["kind"] == "t2to":
        sched = TS.make_schedule(TS.ScheduleConfig(beta_schedule="vip_1"))
        step = TT2.T2ToTrainStep(model, sched, case["tcfg"], accum_steps=case["accum"],
                                 group=group, zero1=case["zero1"])
    else:
        step = TT.To2VTrainStep(model, TS.make_schedule(TS.ScheduleConfig()), case["tcfg"],
                                accum_steps=case["accum"], group=group, zero1=case["zero1"])
    batch = _rows(case["batch"], case["batched"], rows)
    losses, after = [], []
    for ts, noise in case["draws"]:
        m = step(batch, torch.from_numpy(ts)[rows], torch.from_numpy(noise)[rows])
        losses.append(m["loss"].item())
        if m["updated"]:
            after.append({n: p.detach().clone() for n, p in step.params.items()})
    if group is not None:  # the global batch's loss: the mean of the ranks' (equal rows)
        losses = (group.sum_(torch.tensor(losses, dtype=torch.float64)) / group.size).tolist()
    return {"params": after[-1], "after": after, "losses": losses,
            "opt_bytes": state_nbytes(step.optimizer.state_dict())}


def trainer_run(group, case):
    """A trainer of the CLIs (`T2ToTrainer` / `To2VTrainer`) at --smoke on
    the host over ``group``: ``case["config"]`` with ``case["overrides"]``,
    ``case["steps"]`` micro-steps, ``case["resume"]``; where
    ``case["seed_from"]`` names a checkpoint directory, rank 0 first copies
    it under the run's checkpoint root -> {"params": the trained tensors,
    "records", "opt_bytes": the optimizer's state bytes on this rank,
    "grads": the gradients each update applied (clipped), "initial": the
    trained tensors before the first step}."""
    import shutil

    from tokensgen_tpu_torch.sharding.zero import state_nbytes
    from tokensgen_tpu_torch.train_t2to import T2ToTrainer
    from tokensgen_tpu_torch.train_to2v import To2VTrainer
    from tokensgen_tpu_torch.utils.config import load_config

    cfg = load_config(case["config"], case["overrides"])
    kind = T2ToTrainer if case["kind"] == "t2to" else To2VTrainer
    sub = "t2to_checkpoints" if case["kind"] == "t2to" else "checkpoints"
    if case.get("seed_from") and (group is None or group.leader):
        dst = os.path.join(cfg["output_dir"], sub, os.path.basename(case["seed_from"]))
        shutil.copytree(case["seed_from"], dst)
    if group is not None:
        group.barrier()
    trainer = kind(cfg, True, "cpu", resume=case.get("resume", False), group=group)
    if case.get("num_processes"):  # a dp=1 run drawing a dp=N run's strata
        trainer.tcfg = dataclasses.replace(trainer.tcfg, num_processes=case["num_processes"])
    fn = trainer.step_fn
    initial = {n: p.detach().clone() for n, p in fn.params.items()}
    grads = []
    step = fn.optimizer.step

    def capture(params, g):
        grads.append({n: t.detach().clone() for n, t in g.items()})
        step(params, g)

    fn.optimizer.step = capture
    try:
        records = trainer.run(case["steps"])
    finally:
        trainer.close()
    return {"params": {n: p.detach().clone() for n, p in fn.params.items()},
            "records": records, "opt_bytes": state_nbytes(fn.optimizer.state_dict()),
            "grads": grads, "initial": initial}


def dp_cases(group, cases):
    """Each case through `train_step_case` (a case with ``"draws"``) or
    `trainer_run` on this group -> {name: result} on rank 0, every rank's
    optimizer state bytes in ``"opt_bytes"`` (a list by rank)."""
    out = {}
    for c in cases:
        res = (train_step_case if "draws" in c else trainer_run)(group, c)
        nbytes = torch.zeros(group.size, dtype=torch.float64)
        nbytes[group.rank] = res["opt_bytes"]
        res["opt_bytes"] = group.sum_(nbytes).tolist()
        out[c["name"]] = res
    return out if group.leader else None
