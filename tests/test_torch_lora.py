"""Port parity: LoRA (tokensgen_tpu_torch/train/lora.py) and Prodigy
(train/optim.py) against the JAX package's `train/lora.py` and
`optax.contrib.prodigy` on the CPU, with the JAX factors carried across by
`convert/from_jax.py::lora_state_dict`: the targeted matrices and the
parameter count, `merge_lora` (1e-6), train steps with LoRA in both trainers
(loss and grads of one step within 1e-4, two optimizer steps within 2e-4;
the port applies the factors unmerged, ``(x·a)·b·α/r``, the JAX package
merges them into the weights: the same function, other roundings), and five
Prodigy updates (1e-5 relative). Each test prints the delta it measures."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2 as jrope
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.train import lora as JL
from tokensgen_tpu.train import optim as JOpt
from tokensgen_tpu.train import t2to as JT2
from tokensgen_tpu.train import to2v as JT
from tokensgen_tpu_torch.convert.from_jax import dit_state_dict, lora_state_dict, to_torch
from tokensgen_tpu_torch.core import schedule as TS
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.train import lora as TL
from tokensgen_tpu_torch.train import optim as TOpt
from tokensgen_tpu_torch.train import t2to as TT2
from tokensgen_tpu_torch.train import to2v as TT

from _torch_parity import np_tree, random_params
from test_torch_train import _capture_grads, _jax_draws, _port_model, _train_setup
from test_torch_t2to_train import TINY, _jax_draws as _t2to_draws

RANK = 4


def _jax_lora(dit_params, seed=1):
    """JAX `init_lora` factors with b made random (init gives zeros, which
    leave a's grads zero)."""
    lora = JL.init_lora(dit_params, jax.random.PRNGKey(seed), rank=RANK)
    rng = np.random.default_rng(seed)
    return {k: {"a": ab["a"], "b": jnp.asarray(0.02 * rng.normal(size=ab["b"].shape),
                                               jnp.float32)} for k, ab in lora.items()}


def _adapt(dit, lora_tree):
    """The port's factors on ``dit``, set to the JAX ones."""
    TL.init_lora(dit, torch.Generator().manual_seed(0), rank=RANK)
    res = dit.load_state_dict(to_torch(lora_state_dict(np_tree(lora_tree))), strict=False)
    assert not res.unexpected_keys
    return TL.lora_factors(dit)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def to2v_setup():
    jd, td, jrc, trc, params, jb, tb = _train_setup()
    params = dict(params, lora=_jax_lora(params["dit"]))
    return jd, td, jrc, trc, params, jb, tb


def _t2to_params():
    jd, td = JD.DiTConfig.tiny(**TINY), TD.DiTConfig.tiny(**TINY)
    rope = jrope(64, np.arange(8), np.arange(8), np.arange(12), dim_t=52, dim_h=6, dim_w=6)
    dit = random_params(JD.CogVideoXTransformer(jd).init, jax.random.PRNGKey(0),
                        jnp.zeros((1, 8, 16, 8, 12)),
                        jnp.zeros((1, jd.max_text_seq_length, jd.text_embed_dim)),
                        jnp.zeros((1,), jnp.int32), image_rotary_emb=rope, seed=3)["params"]
    dit = jax.tree_util.tree_map(jnp.asarray, dit)
    rng = np.random.default_rng(3)
    batch = {"latents": rng.normal(size=(2, 8, 16, 8, 12)).astype(np.float32),
             "text_embeds": rng.normal(size=(2, jd.max_text_seq_length,
                                             jd.text_embed_dim)).astype(np.float32),
             "valid_frames": np.array([8, 4])}
    return jd, td, {"dit": dit, "lora": _jax_lora(dit, 2)}, batch


@pytest.mark.parametrize("model", ["to2v", "t2to"])
def test_targets_and_count_match_jax(to2v_setup, model):
    """The matrices LoRA adapts (by exact module name: to_q, to_k, to_v,
    to_out, not vip_to_q) are the JAX package's after the key mapping, with
    the same factor shapes and `lora_param_count`."""
    if model == "to2v":
        _, td, _, _, params, _, _ = to2v_setup
    else:
        _, td, params, _ = _t2to_params()
    dit = TD.CogVideoXTransformer(td)
    lora = TL.init_lora(dit, torch.Generator().manual_seed(0), rank=RANK)
    want = lora_state_dict(np_tree(params["lora"]))
    got = {f"{m}.lora_{k}": v for m, ab in lora.items() for k, v in ab.items()}
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in want)
    assert not any("vip_" in m for m in lora) and any(m.endswith("to_out.0") for m in lora)
    assert TL.lora_param_count(lora) == JL.lora_param_count(params["lora"])
    b = lora[next(iter(lora))]["b"]
    assert b.dtype == torch.float32 and not b.any()  # zero at init: the base function


def test_merge_lora_matches_jax(to2v_setup):
    """`merge_lora` of the port's state dict with the JAX factors against
    JAX `merge_lora` then the key mapping: every weight within 1e-6; the
    factors' own entries gone; the adapted model's forward equals the
    merged model's (1e-5)."""
    jd, td, jrc, trc, params, jb, tb = to2v_setup
    want = dit_state_dict(np_tree(JL.merge_lora(params["dit"], params["lora"], RANK, 64.0)), td)
    dit = TD.CogVideoXTransformer(td)
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(params["dit"]), td)), strict=True)
    lora = _adapt(dit, params["lora"])
    merged = TL.merge_lora(dit.state_dict(), lora, RANK, 64.0)
    assert set(merged) == set(want)
    err = max(float(np.abs(merged[k].numpy() - want[k]).max()) for k in want)
    print(f"merge_lora: max |port - jax| {err:.3e} (bound 1e-6)")
    assert err <= 1e-6
    plain = TD.CogVideoXTransformer(td)
    plain.load_state_dict(merged, strict=True)
    x = torch.randn(2, 3, td.inner_dim)
    attn, ref = dit.transformer_blocks[0].attn1, plain.transformer_blocks[0].attn1
    for name in ("to_q", "to_k", "to_v"):
        np.testing.assert_allclose(getattr(attn, name)(x).detach().numpy(),
                                   getattr(ref, name)(x).detach().numpy(), rtol=1e-5, atol=1e-5)


def _to2v_port(js_td, js_trc, params):
    model = _port_model(js_td, js_trc, params)
    _adapt(model.dit, params["lora"])
    return model


def _flat_want(td, trc, grads):
    from tokensgen_tpu_torch.convert.from_jax import resampler_state_dict

    want = {f"dit.{k}": v for k, v in dit_state_dict(grads["dit"], td).items()}
    want.update({f"resampler.{k}": v for k, v in
                 resampler_state_dict(grads["resampler"], trc.depth).items()})
    want.update({f"dit.{k}": v for k, v in lora_state_dict(grads["lora"]).items()})
    return want


def test_to2v_step_with_lora_matches_jax(to2v_setup):
    """One To2V train step with LoRA: loss (1e-5 relative) and every
    trainable grad, the factors' included (1e-4 of its largest entry),
    against JAX `make_train_step` with the factors merged in its loss."""
    jd, td, jrc, trc, params, jb, tb = to2v_setup
    jcfg = JT.To2VTrainConfig(lora_rank=RANK)
    opt = optax.multi_transform({"train": _capture_grads(), "freeze": optax.set_to_zero()},
                                JT.trainable_labels(params))
    step = jax.jit(JT.make_train_step(jd, jrc, JS.make_schedule(JS.ScheduleConfig()), jcfg, opt))
    key = jax.random.PRNGKey(1)
    _, state, metrics = step(params, opt.init(params), jb, key)
    flat_g = flax.traverse_util.flatten_dict(state.inner_states["train"].inner_state)
    grads = flax.traverse_util.unflatten_dict({
        k: (np.asarray(flat_g[k]) if isinstance(flat_g.get(k), jax.Array)
            else np.zeros(v.shape, np.float32))
        for k, v in flax.traverse_util.flatten_dict(params).items()})
    model = _to2v_port(td, trc, params)
    loss = TT.to2v_loss(model, TS.make_schedule(TS.ScheduleConfig()), tb,
                        *_jax_draws(key, jb, jcfg))
    loss.backward()
    got = {n: p.grad for n, p in TT.trainable_parameters(model).items()}
    want = _flat_want(td, trc, grads)
    assert set(got) == set(want) - {k for k in want if not TT.is_trainable(k)}
    assert sum(n.endswith(".lora_a") for n in got) == 4 * td.num_layers
    print(f"to2v loss port {loss.item():.7f} jax {float(metrics['loss']):.7f}")
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=1e-5)
    worst = 0.0
    for name, g in got.items():
        w = want[name]
        err = float(np.abs(g.numpy() - w).max()) / max(np.abs(w).max(), 1e-12)
        worst = max(worst, err)
        assert err <= 1e-4, name
    print(f"to2v grads: worst max error / max |grad| {worst:.3e} (bound 1e-4)")


def _two_jax_steps(step, opt, params, batch, keys):
    state = opt.init(params)
    out = []
    for key in keys:
        params, state, metrics = step(params, state, batch, key)
        out.append((params, float(metrics["loss"])))
    return out


def test_to2v_two_steps_with_lora_match_jax(to2v_setup):
    """Two optimizer steps (clip, int8 AdamW as shipped) with LoRA: the
    trainable parameters after step 1 within 2e-4 relative L2, step 2's loss
    within 2e-4."""
    jd, td, jrc, trc, params, jb, tb = to2v_setup
    jcfg, tcfg = JT.To2VTrainConfig(lora_rank=RANK), TT.To2VTrainConfig(lora_rank=RANK)
    opt = JT.make_optimizer(params, jcfg)
    step = jax.jit(JT.make_train_step(jd, jrc, JS.make_schedule(JS.ScheduleConfig()), jcfg, opt))
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    jax_out = _two_jax_steps(step, opt, params, jb, keys)
    model = _to2v_port(td, trc, params)
    port = TT.To2VTrainStep(model, TS.make_schedule(TS.ScheduleConfig()), tcfg)
    port(tb, *_jax_draws(keys[0], jb, jcfg))
    want = _flat_want(td, trc, np_tree(jax_out[0][0]))
    names = list(TT.trainable_parameters(model))
    got = np.concatenate([p.detach().numpy().ravel()
                          for p in TT.trainable_parameters(model).values()])
    rel = _rel(got, np.concatenate([want[n].ravel() for n in names]))
    m2 = port(tb, *_jax_draws(keys[1], jb, jcfg))
    print(f"to2v after step 1: trainable relative L2 {rel:.3e}; step 2 loss port "
          f"{m2['loss'].item():.7f} jax {jax_out[1][1]:.7f}")
    assert rel <= 2e-4
    np.testing.assert_allclose(m2["loss"].item(), jax_out[1][1], rtol=2e-4)


def _t2to_port(td, params):
    dit = TD.CogVideoXTransformer(td)
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(params["dit"]), td)), strict=True)
    TT2.setup_lora_finetune(dit.train(), TT2.T2ToTrainConfig(lora_rank=RANK),
                            torch.Generator().manual_seed(0))
    dit.load_state_dict(to_torch(lora_state_dict(np_tree(params["lora"]))), strict=False)
    return dit


def test_t2to_step_with_lora_matches_jax():
    """The T2To trainer's LoRA mode: the base frozen, only the factors
    trained; one step's loss (1e-5 relative) and factor grads (1e-4 of each
    one's largest entry) against JAX `make_train_step` with LoRA, and two
    f32 AdamW steps: the factors after step 1 within 2e-4 relative L2, step
    2's loss within 2e-4."""
    jd, td, params, batch = _t2to_params()
    jcfg, tcfg = JT2.T2ToTrainConfig(lora_rank=RANK), TT2.T2ToTrainConfig(lora_rank=RANK)
    sched_j = JS.make_schedule(JS.ScheduleConfig(beta_schedule="vip_1"))
    sched_t = TS.make_schedule(TS.ScheduleConfig(beta_schedule="vip_1"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = _capture_grads()
    step = jax.jit(JT2.make_train_step(jd, sched_j, jcfg, opt))
    key = jax.random.PRNGKey(4)
    _, state, metrics = step(params, opt.init(params), jb, key)
    want = lora_state_dict(np_tree(state["lora"]))
    dit = _t2to_port(td, params)
    assert {n for n, p in dit.named_parameters() if p.requires_grad} == set(want)
    loss = TT2.t2to_loss(dit, sched_t, tcfg, tb, *_t2to_draws(key, batch["latents"].shape))
    loss.backward()
    print(f"t2to loss port {loss.item():.7f} jax {float(metrics['loss']):.7f}")
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=1e-5)
    for name, w in want.items():
        g = dict(dit.named_parameters())[name].grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)
    # two optimizer steps: clip + f32 AdamW (the T2To config's)
    opt = JT2.make_optimizer(jcfg)
    step = jax.jit(JT2.make_train_step(jd, sched_j, jcfg, opt))
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    jax_out = _two_jax_steps(step, opt, params, jb, keys)
    dit = _t2to_port(td, params)
    port = TT2.T2ToTrainStep(dit, sched_t, tcfg)
    port(tb, *_t2to_draws(keys[0], batch["latents"].shape))
    want = lora_state_dict(np_tree(jax_out[0][0]["lora"]))
    names = sorted(want)
    got = np.concatenate([dict(dit.named_parameters())[n].detach().numpy().ravel()
                          for n in names])
    rel = _rel(got, np.concatenate([want[n].ravel() for n in names]))
    m2 = port(tb, *_t2to_draws(keys[1], batch["latents"].shape))
    print(f"t2to after step 1: factors relative L2 {rel:.3e}; step 2 loss port "
          f"{m2['loss'].item():.7f} jax {jax_out[1][1]:.7f}")
    assert rel <= 2e-4
    np.testing.assert_allclose(m2["loss"].item(), jax_out[1][1], rtol=2e-4)


@pytest.mark.parametrize("safeguard_warmup", [False, True])
def test_prodigy_matches_optax(safeguard_warmup):
    """Five Prodigy updates (weight decay, the step-size estimate growing on
    a quadratic, with and without safeguard_warmup) against the JAX
    package's `base_optimizer("prodigy")` (optax.contrib.prodigy): each
    parameter's displacement from its start within 1e-5 relative, the
    estimate d too; the state survives a state_dict round trip. The
    parameters are of size 1e-3: the first steps move them by ~d = 1e-6,
    and at unit size one f32 rounding of a parameter (2.4e-7) would be a
    quarter of its whole displacement."""
    rng = np.random.default_rng(5)
    params = {"w": (1e-3 * rng.normal(size=(64, 80))).astype(np.float32),
              "b": (1e-3 * rng.normal(size=(10,))).astype(np.float32)}
    target = {k: (1e-3 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()}
    kw = dict(weight_decay=1e-2, prodigy_safeguard_warmup=safeguard_warmup)
    jopt = JOpt.base_optimizer("prodigy", 1.0, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = TOpt.base_optimizer("prodigy", tp, 1.0, **kw)
    assert isinstance(topt, TOpt.Prodigy)
    for i in range(5):
        if i == 3:  # resume from a saved state
            saved = topt.state_dict()
            topt = TOpt.base_optimizer("prodigy", tp, 1.0, **kw)
            topt.load_state_dict(saved)
        g = {k: np.asarray(jp[k]) - target[k] for k in params}
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in params:
            rel = _rel(tp[k].numpy() - params[k], np.asarray(jp[k]) - params[k])
            assert rel <= 1e-5, (i, k, rel)
        d_rel = abs(float(topt.estim_lr) - float(state.estim_lr)) / float(state.estim_lr)
        print(f"prodigy step {i + 1}: displacement relative L2 {rel:.3e}, d "
              f"{float(state.estim_lr):.4e} (relative error {d_rel:.2e})")
        assert d_rel <= 1e-5
    assert float(state.estim_lr) > 1.5e-6  # the estimate grew past estim_lr0


def test_lora_export_merges_into_a_plain_dit(to2v_setup, tmp_path):
    """The trainers' ``lora_merged`` export: `merge_lora` of the adapted
    DiT loads strictly into a DiT without adapters."""
    jd, td, jrc, trc, params, jb, tb = to2v_setup
    dit = TD.CogVideoXTransformer(td)
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(params["dit"]), td)), strict=True)
    merged = TL.merge_lora(dit.state_dict(), _adapt(dit, params["lora"]), RANK)
    TD.CogVideoXTransformer(dataclasses.replace(td)).load_state_dict(merged, strict=True)
