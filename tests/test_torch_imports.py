"""The port stands alone: importing every tokensgen_tpu_torch module (the
probe kernels and their CLIs, the training data path included) loads no jax,
flax, tokensgen_tpu, pandas or the JAX package's tools/ (nor cv2, tokenizers
or transformers, which the loaders import only when they read a video or a
tokenizer), and no module calls PyTorch's fused attention, cuDNN attention or
torch.compile."""

import os
import pkgutil
import re
import subprocess
import sys

import tokensgen_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "tokensgen_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG_DIR], "tokensgen_tpu_torch."))


def test_import_loads_no_jax():
    trainer = {"tokensgen_tpu_torch.train_to2v", "tokensgen_tpu_torch.train_t2to",
               "tokensgen_tpu_torch.utils.logging"} | {
        f"tokensgen_tpu_torch.train.{m}"
        for m in ("adam8bit", "checkpoint", "objective", "optim", "staging", "to2v", "t2to")}
    assert trainer <= set(_modules())
    gen = {"tokensgen_tpu_torch.core.pca", "tokensgen_tpu_torch.pipelines.t2to"}
    assert gen <= set(_modules())
    loaders = {"tokensgen_tpu_torch.convert.safetensors_io",
               "tokensgen_tpu_torch.convert.torch_weights", "tokensgen_tpu_torch.models.t5",
               "tokensgen_tpu_torch.models.text_encoder", "tokensgen_tpu_torch.data.transforms",
               "tokensgen_tpu_torch.data.video_io"}
    assert loaders <= set(_modules())
    serving = {"tokensgen_tpu_torch.serving", "tokensgen_tpu_torch.serve",
               "tokensgen_tpu_torch.sharding", "tokensgen_tpu_torch.sharding.mesh"}
    assert serving <= set(_modules())
    training_data = {"tokensgen_tpu_torch.data.mira", "tokensgen_tpu_torch.data.native_store",
                     "tokensgen_tpu_torch.calculate_vae_latents", "tokensgen_tpu_torch.train.lora",
                     "tokensgen_tpu_torch.metrics.quality", "tokensgen_tpu_torch.metrics.lpips"}
    assert training_data <= set(_modules())
    probes = {"tokensgen_tpu_torch.kernels.build", "tokensgen_tpu_torch.kernels.probes"} | {
        f"tokensgen_tpu_torch.tools.{m}" for m in ("bench_attn_sweep", "bench_attn_v2",
                                                   "bench_int8_loop", "bench_matmul_hand",
                                                   "bench_exp2", "bench_attn_r3",
                                                   "bench_cross_r3", "bench_cross_pairloop")}
    assert probes <= set(_modules())
    inference_modes = {"tokensgen_tpu_torch.models.dinov2", "tokensgen_tpu_torch.sampling.freeinit",
                       "tokensgen_tpu_torch.utils.debug"}
    assert inference_modes <= set(_modules())
    data_axis = {"tokensgen_tpu_torch.sharding.zero", "tokensgen_tpu_torch.train.memory"}
    assert data_axis <= set(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib', "
        "'tokensgen_tpu', 'tools', 'cv2', 'tokenizers', 'transformers', 'pandas'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_library_attention_or_compile():
    banned = ("scaled_dot_product_attention", "torch.compile", "cudnn_attention", "flash_attn")
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|flax|tokensgen_tpu|tools)\b(?!_torch)",
                            re.M)
    hits = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, f)
                with open(path) as fh:
                    text = fh.read()
                rel = os.path.relpath(path, REPO)
                hits += [(rel, b) for b in banned if b in text]
                hits += [(rel, m.group(0).strip()) for m in jax_import.finditer(text)]
    assert not hits, hits
    assert tokensgen_tpu_torch.__doc__
