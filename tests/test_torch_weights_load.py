"""Port parity: the weight and artifact loaders of the port's CLIs
(`tokensgen_tpu_torch/infer.py`, `convert/torch_weights.py`,
`train_t2to.py`) against the JAX package's, on files written here:
* a `converted_weights_dir` written by the JAX package's `save_param_tree`
  (tiny To2V DiT, resampler, VAE, T2To DiT) loads into the port's pipelines,
  each state dict equal to `convert/from_jax.py` of the same tree;
* a to2v tree without the VIP branch raises, as in the JAX CLI;
* the diffusers-layout DiT of `pretrained_model_name_or_path` (top-level
  ``*.safetensors`` only), strict, and the same names the JAX converter reads;
* the gen PCA artifacts and the trainer's ``pca.pt``.
All bit-equal."""

import os

import numpy as np
import pytest
import torch

import infer as jax_infer
from tokensgen_tpu.convert.safetensors_io import save_safetensors as jax_save_safetensors
from tokensgen_tpu.convert.torch_weights import convert_dit
from tokensgen_tpu.convert.torch_weights import load_pca_artifact as jax_load_pca_artifact
from tokensgen_tpu.utils.config import load_config as jax_load_config
from tokensgen_tpu_torch import infer
from tokensgen_tpu_torch import train_t2to as T2CLI
from tokensgen_tpu_torch.convert import torch_weights as TW
from tokensgen_tpu_torch.convert.from_jax import (dit_state_dict, resampler_state_dict, to_torch,
                                                  vae_state_dict)
from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
from tokensgen_tpu_torch.utils.config import load_config

from _torch_weights import smoke_configs, smoke_trees, write_converted_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2TO_TRAIN_YAML = os.path.join(REPO, "tokensgen_tpu", "configs", "train_t2to.yaml")


class PickledPCA:
    """Stands in for the reference's pickled torch PCA module."""

    def __init__(self, mean, components):
        self.mean_ = mean
        self.components_ = components


def _cfg(tmp_path, text):
    path = tmp_path / "cfg.yaml"
    path.write_text(f"name_prefix: t\noutput_dir: {tmp_path}/out\nseed: 3\n{text}")
    return load_config(str(path)), str(path)


def _assert_state_equal(module, want):
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def trees():
    return smoke_trees(t2to=True)


def test_converted_dir_loads_into_the_pipelines(tmp_path, trees, capsys):
    conv = write_converted_dir(str(tmp_path / "conv"), trees)
    cfg, _ = _cfg(tmp_path, f"converted_weights_dir: {conv}\nuse_2nd_stage: true\n")
    pipe, dcfg = infer.build_pipeline(cfg, smoke=True, device="cpu")
    t2to = infer.build_t2to_pipeline(cfg, smoke=True, pipe=pipe, device="cpu")
    _assert_state_equal(pipe.dit, to_torch(dit_state_dict(trees["to2v_dit"], dcfg)))
    _assert_state_equal(pipe.resampler, to_torch(resampler_state_dict(
        trees["resampler"], pipe.resampler_config.depth)))
    _assert_state_equal(pipe.vae.model, to_torch(vae_state_dict(trees["vae"])))
    _assert_state_equal(t2to.dit, to_torch(dit_state_dict(trees["t2to_dit"], t2to.dit_config)))
    out = capsys.readouterr().out
    assert "weights: vae=converted  resampler=converted  to2v_dit=converted" in out
    assert "t2to_dit=converted" in out


def test_vip_less_tree_raises_like_jax(tmp_path):
    trees = smoke_trees(vip=False)
    conv = write_converted_dir(str(tmp_path / "conv"), trees)
    _, path = _cfg(tmp_path, f"converted_weights_dir: {conv}\n")
    with pytest.raises(ValueError, match="no VIP branch"):
        jax_infer.build_pipeline(jax_load_config(path), smoke=True)
    with pytest.raises(ValueError, match="no VIP branch"):
        infer.build_pipeline(load_config(path), smoke=True, device="cpu")


def test_diffusers_dit_route_reads_top_level_files_only(tmp_path, trees, capsys):
    """The DiT of `pretrained_model_name_or_path`: every top-level
    ``*.safetensors`` (here split over two shards, one of them bf16), none
    under ``transformer/``; the names are the ones JAX's `convert_dit`
    reads (its tree maps back to the same state dict)."""
    jd, _, _ = smoke_configs()
    cfg, _ = _cfg(tmp_path, "")
    float_cfg = infer._configs(cfg, True, torch.device("cpu"))[0]
    sd = to_torch(dit_state_dict(trees["to2v_dit"], float_cfg))
    names = sorted(sd)
    ckpt = tmp_path / "CogVideoX-5b"
    (ckpt / "transformer").mkdir(parents=True)
    save_safetensors(str(ckpt / "a.safetensors"), {k: sd[k] for k in names[::2]})
    save_safetensors(str(ckpt / "b.safetensors"),
                     {k: sd[k].bfloat16() for k in names[1::2]})
    save_safetensors(str(ckpt / "transformer" / "c.safetensors"), {"stray": torch.zeros(1)})
    read = TW.read_safetensors_dir(str(ckpt))
    assert sorted(read) == names
    # JAX's converter reads the same names (from its own reader's f32 view)
    from tokensgen_tpu.convert.safetensors_io import load_safetensors as jax_load

    jax_sd = {**jax_load(str(ckpt / "a.safetensors")), **jax_load(str(ckpt / "b.safetensors"))}
    back = dit_state_dict(convert_dit(jax_sd, jd), float_cfg)
    for k in names:
        np.testing.assert_array_equal(np.asarray(back[k]), read[k].float().numpy(), err_msg=k)

    cfg, _ = _cfg(tmp_path, f"pretrained_model_name_or_path: {ckpt}\n")
    pipe, _ = infer.build_pipeline(cfg, smoke=True, device="cpu")
    want = {k: (v if k in names[::2] else v.bfloat16().float()) for k, v in sd.items()}
    _assert_state_equal(pipe.dit, want)
    assert "to2v_dit=torch-checkpoint" in capsys.readouterr().out

    # the shipped layout keeps its shards under transformer/ only: random
    # weights, with the warning outside --smoke
    os.remove(ckpt / "a.safetensors")
    os.remove(ckpt / "b.safetensors")
    infer._report_weight_provenance({"to2v_dit": "random(grafted vip)"}, smoke=False)
    assert "WARNING: non-smoke run with RANDOM weights for: to2v_dit" in capsys.readouterr().out
    pipe, _ = infer.build_pipeline(cfg, smoke=True, device="cpu")
    assert "to2v_dit=random(grafted vip)" in capsys.readouterr().out


def test_gen_pca_artifacts_match_jax(tmp_path):
    """`longvgen_pca` (safetensors mean_ / components_), `longvgen_mean` and
    `longvgen_std` (.npy) as the JAX CLI reads them (root infer.py
    build_t2to_pipeline)."""
    rng = np.random.default_rng(4)
    d = 48
    jax_save_safetensors(str(tmp_path / "pca.safetensors"),
                         {"mean_": rng.normal(size=(1, d)).astype(np.float32),
                          "components_": rng.normal(size=(d, d)).astype(np.float32)})
    np.save(tmp_path / "mean.npy", rng.normal(size=(1, d)).astype(np.float32))
    np.save(tmp_path / "std.npy", rng.uniform(0.5, 2, size=(1, d)))  # f64 on disk
    cfg, _ = _cfg(tmp_path, f"longvgen_pca: {tmp_path}/pca.safetensors\n"
                            f"longvgen_mean: {tmp_path}/mean.npy\n"
                            f"longvgen_std: {tmp_path}/std.npy\n")
    pca, mean, std, prov = infer.t2to_pca(cfg, smoke=False, token_dim=d, device="cpu")
    assert prov == "artifacts"
    from tokensgen_tpu.convert.safetensors_io import load_safetensors as jax_load

    ref = jax_load(cfg.longvgen_pca)
    for got, want in ((pca.mean, ref["mean_"]), (pca.components, ref["components_"]),
                      (mean, np.load(cfg.longvgen_mean)),
                      (std, np.load(cfg.longvgen_std).astype(np.float32))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # under --smoke the random stand-in, as in the JAX CLI
    assert infer.t2to_pca(cfg, smoke=True, token_dim=d, device="cpu")[3] == \
        "random(identity-scale)"


def test_trainer_pca_pt_matches_jax(tmp_path):
    """The T2To trainer outside --smoke loads `longvgen_pca` (a pickled
    torch PCA module) as the JAX trainer's `load_pca_artifact` does, with
    the mean / std .npy files."""
    gen = torch.Generator().manual_seed(5)
    d = 48  # the tiny trainer's token dim
    obj = PickledPCA(torch.randn(1, d, generator=gen, dtype=torch.float64),
                     torch.randn(d, d, generator=gen).bfloat16())
    torch.save(obj, tmp_path / "pca.pt")
    np.save(tmp_path / "mean.npy", np.arange(d, dtype=np.float32)[None])
    np.save(tmp_path / "std.npy", np.full((1, d), 2.0, np.float32))
    ref = jax_load_pca_artifact(str(tmp_path / "pca.pt"))
    got = TW.load_pca_artifact(str(tmp_path / "pca.pt"))
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(ref.mean))
    np.testing.assert_array_equal(got.components.numpy(), np.asarray(ref.components))

    cfg = load_config(T2TO_TRAIN_YAML, {
        "output_dir": str(tmp_path / "out"), "model_size": "tiny",
        "longvgen_pca": str(tmp_path / "pca.pt"), "longvgen_mean": str(tmp_path / "mean.npy"),
        "longvgen_std": str(tmp_path / "std.npy")})
    trainer = T2CLI.T2ToTrainer(cfg, smoke=False, device="cpu")
    np.testing.assert_array_equal(trainer.pca.components.numpy(), np.asarray(ref.components))
    np.testing.assert_array_equal(trainer.pca.mean.numpy(), np.asarray(ref.mean))
    np.testing.assert_array_equal(trainer.token_mean.numpy(), np.load(tmp_path / "mean.npy"))
    np.testing.assert_array_equal(trainer.token_std.numpy(), np.load(tmp_path / "std.npy"))
