"""The port stands alone: importing every tokensgen_tpu_torch module loads no
jax, flax or tokensgen_tpu, and no module calls PyTorch's fused attention,
cuDNN attention or torch.compile."""

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
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib', "
        "'tokensgen_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_library_attention_or_compile():
    banned = ("scaled_dot_product_attention", "torch.compile", "cudnn_attention", "flash_attn")
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|flax|tokensgen_tpu)\b(?!_torch)", re.M)
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
