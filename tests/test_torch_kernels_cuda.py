"""The Hopper attention kernels of tokensgen_tpu_torch against their plain
PyTorch versions, on the card. Every test here is marked ``cuda`` and skips
without a card. This file imports no JAX, so it also runs on a machine that
has none (skipping tests/conftest.py, which does):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from tokensgen_tpu_torch.kernels import attention as TA

D = 64
# kernel vs plain version on the same bf16 inputs (the kernel rounds the
# prologued q and p to bf16 where the plain version keeps f32): relative L2
# error <= 1e-2 and max abs error <= 2^-5 of the output's largest magnitude,
# as in chip_smoke.py. The measured relative error is ~3e-3; dropping the
# ragged last kv tile (5 of 517 keys, 24 of 2200) gives ~10%.
REL_L2_BOUND = 1e-2
MAX_ABS_REL = 2.0 ** -5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no host mode")
    return torch.device("cuda", 0)


def _tabs(rng, s, batch, text, fold, dev):
    g = torch.from_numpy(np.abs(rng.normal(size=(D,))).astype(np.float32))
    b_ = torch.from_numpy((0.1 * rng.normal(size=(D,))).astype(np.float32))
    ang = torch.from_numpy(rng.normal(size=(batch, s - text, D)).astype(np.float32))
    tabs = TA.make_prologue(D, [(None, text), ((ang.cos(), ang.sin()), s - text)], g, b_,
                            fold=fold)
    return tuple(x.to(dev) for x in tabs)


def _case(name, dev):
    """bf16 merged operands with ragged lengths, per-sample tables with a text
    prefix, and a key-bias mask on one sample."""
    rng = np.random.default_rng(6)
    b, h = 2, 4
    sq, skv = {"fused_attention_joint": (300, 517),
               "fused_attention_cross_smallkv": (2200, 130),
               "fused_attention_cross_smallq": (130, 2200)}.get(name, (130, 517))

    def x(s):
        return torch.from_numpy(rng.normal(size=(b, s, h * D)).astype(np.float32)).to(
            dev, torch.bfloat16)

    bias = torch.zeros(b, skv, device=dev)
    bias[1, : skv // 3] = -1e9
    return (x(sq), x(skv), x(skv), _tabs(rng, sq, b, 5, D ** -0.5, dev),
            _tabs(rng, skv, b, 5, 1.0, dev), bias, h)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_attention_joint", "fused_attention_cross_smallkv",
                                  "fused_attention_cross_smallq", "flash_attention_bhsd"])
def test_kernel_matches_plain_on_card(cuda_device, name):
    """Each kernel vs its plain version on the same bf16 inputs, within
    REL_L2_BOUND and MAX_ABS_REL."""
    q, k, v, tq, tk, bias, h = _case(name, cuda_device)
    fn = getattr(TA, name)
    before = fn.launches
    if name == "flash_attention_bhsd":
        q4, k4, v4 = (TA.split_heads(z, h) for z in (q, k, v))
        out = fn(q4, k4, v4, bias, 0.125)
        ref = TA.attention_plain(q4, k4, v4, bias, 0.125)
    else:
        out = fn(q, k, v, tq, tk, key_bias=bias, heads=h)
        ref = TA._fused_plain_merged(q, k, v, bias, tq, tk, h, 1e-6, True, True)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(out).all()
    diff, ref = out.float() - ref.float(), ref.float()
    assert (diff.norm() / ref.norm()).item() <= REL_L2_BOUND
    assert diff.abs().max().item() <= MAX_ABS_REL * ref.abs().max().item()


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path(cuda_device):
    """On the card a wrapper launches or raises: float32 operands raise
    instead of falling back to the plain version, and nothing is counted."""
    x = torch.zeros(1, 128, 2 * D, device=cuda_device)
    tabs = TA.prologue_identity(128, D, device=cuda_device)
    before = TA.fused_attention_joint.launches
    with pytest.raises(TypeError):
        TA.fused_attention_joint(x, x, x, tabs, tabs, heads=2)
    assert TA.fused_attention_joint.launches == before
