"""The Hopper kernels of tokensgen_tpu_torch (the attention forwards K1-K4,
K4 also at head dims 16, 32 and 128, K1, K3, K4 and K6 at forced split
counts, K2 at 1 to 512 keys, K1, K2 and K6 on all-negative score rows, K1
and K6 refusing misaligned operands, their logsumexp outputs, the backward
K5 at head dims 16, 32, 64 and 128 and at the training shapes' short sides
(few keys, few q rows), the int8-score forward K7 (also at forced split
counts and on all-negative score rows), K4 on float32 operands (DINOv2's
shape, ragged tails, head dims 16 to 64), the
[B, H, S, D] fused-prologue forward K6 at the same four, and the probe
kernels T1, T2, T3a, T3b, T4a, T4b, T5, T6, T7 and T8) against their plain
PyTorch versions, on the card. Every test here is
marked ``cuda`` and skips without a card. This file imports no JAX, so it also runs on a machine that
has none (skipping tests/conftest.py, which does):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from tokensgen_tpu_torch.kernels import attention as TA
from tokensgen_tpu_torch.train.t2to import padded_chunk_masks

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


def _assert_within_bounds(out, ref):
    diff, ref = out.float() - ref.float(), ref.float()
    assert torch.isfinite(out).all()
    assert (diff.norm() / ref.norm()).item() <= REL_L2_BOUND
    assert diff.abs().max().item() <= MAX_ABS_REL * ref.abs().max().item()


# the kernels' lse against the plain logsumexp of the same scores: the
# kernels score bf16(q' * log2 e) where the plain version scores bf16(q'), one
# bf16 rounding apart (as the JAX kernel and its XLA recompute are). Measured
# on an H100: max 1.3e-2 on lse ~6.8 (1.9e-3 relative, about one bf16 ulp),
# relative L2 ~1e-4. Bounds: relative L2 <= 1e-3, max <= 2^-7 of max|lse|.
LSE_REL_L2_BOUND = 1e-3
LSE_MAX_REL = 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bhsd_head_dims_on_card(cuda_device, d):
    """K4 (`flash_attention_bhsd`) at head dims 16, 32, 64 and 128 vs its plain
    version on [2, 3, 300, d] x 517 keys bf16 (ragged) with a key-bias mask
    on one sample, with and without its lse: within REL_L2_BOUND and
    MAX_ABS_REL (the lse within the lse bounds); each call counted once."""
    gen = torch.Generator(cuda_device).manual_seed(20 + d)
    b, h, sq, skv = 2, 3, 300, 517
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=cuda_device).bfloat16()
               for s in (sq, skv, skv))
    bias = torch.zeros(b, skv, device=cuda_device)
    bias[1, : skv // 3] = -1e9
    scale = d ** -0.5
    before = TA.flash_attention_bhsd.launches
    out = TA.flash_attention_bhsd(q, k, v, bias, scale)
    out_l, lse = TA.flash_attention_bhsd(q, k, v, bias, scale, with_lse=True)
    ref, ref_lse = TA.attention_plain(q, k, v, bias, scale, with_lse=True)
    torch.cuda.synchronize()
    assert TA.flash_attention_bhsd.launches == before + 2
    assert torch.equal(out, out_l)
    _assert_within_bounds(out, ref)
    assert ((lse - ref_lse).norm() / ref_lse.norm()).item() <= LSE_REL_L2_BOUND
    assert (lse - ref_lse).abs().max().item() <= LSE_MAX_REL * ref_lse.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("name", ["fused_attention_cross_smallq", "flash_attention_bhsd"])
def test_splitkv_counts_on_card(cuda_device, name, splits):
    """K3 and K4 (the split-KV forward) at forced split counts 1, 2 and 5,
    each with a ragged last split (K3: 2,200 keys, K4: 517), and on one
    sample a -1e9 key bias over a whole split (at one split, over the first
    third of the keys): within REL_L2_BOUND and MAX_ABS_REL of the plain
    version; K4 also with its lse (the lse within the lse bounds, the output
    bit-equal to the call without it)."""
    q, k, v, tq, tk, _, h = _case(name, cuda_device)
    b, skv = q.shape[0], k.shape[1]
    n, split_len = TA.kv_split_plan(b, h, q.shape[1], skv, D, 132, splits)
    assert n == splits and skv % split_len
    bias = torch.zeros(b, skv, device=cuda_device)
    if n > 1:
        bias[1, split_len:2 * split_len] = -1e9
    else:
        bias[1, : skv // 3] = -1e9
    if name == "flash_attention_bhsd":
        q4, k4, v4 = (TA.split_heads(z, h) for z in (q, k, v))
        out = TA._launch_bhsd(q4, k4, v4, bias, 0.125, splits=splits)
        out_l, lse = TA._launch_bhsd(q4, k4, v4, bias, 0.125, with_lse=True, splits=splits)
        ref, ref_lse = TA.attention_plain(q4, k4, v4, bias, 0.125, with_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(out, out_l)
        assert ((lse - ref_lse).norm() / ref_lse.norm()).item() <= LSE_REL_L2_BOUND
        assert (lse - ref_lse).abs().max().item() <= LSE_MAX_REL * ref_lse.abs().max().item()
    else:
        out = TA._launch_smallq(q, k, v, bias, tq, tk, h, 1e-6, True, True, splits=splits)
        ref = TA._fused_plain_merged(q, k, v, bias, tq, tk, h, 1e-6, True, True)
        torch.cuda.synchronize()
    _assert_within_bounds(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_attention_joint", "flash_attention_bhsd"])
def test_lse_matches_plain_on_card(cuda_device, name):
    """K1 and K4 with the logsumexp output (the training forward): the output
    as without it, the lse within LSE_REL_L2_BOUND and LSE_MAX_REL of the
    plain one."""
    q, k, v, tq, tk, bias, h = _case(name, cuda_device)
    fn = getattr(TA, name)
    before = fn.lse_launches
    if name == "flash_attention_bhsd":
        q, k, v = (TA.split_heads(z, h) for z in (q, k, v))
        out, lse = fn(q, k, v, bias, 0.125, with_lse=True)
        plain = fn(q, k, v, bias, 0.125)
        ref_out, ref_lse = TA.attention_plain(q, k, v, bias, 0.125, with_lse=True)
    else:
        out, lse = fn(q, k, v, tq, tk, key_bias=bias, heads=h, with_lse=True)
        plain = fn(q, k, v, tq, tk, key_bias=bias, heads=h)
        qn = TA.apply_prologue_plain(TA.split_heads(q, h), tq, 1e-6, True)
        kn = TA.apply_prologue_plain(TA.split_heads(k, h), tk, 1e-6, True)
        ref_out, ref_lse = TA.attention_plain(qn, kn, TA.split_heads(v, h), bias, 1.0,
                                              with_lse=True)
        ref_out = TA.merge_heads(ref_out)
    torch.cuda.synchronize()
    assert fn.lse_launches == before + 1
    assert torch.equal(out, plain)
    _assert_within_bounds(out, ref_out)
    assert lse.shape == ref_lse.shape and torch.isfinite(lse).all()
    assert ((lse - ref_lse).norm() / ref_lse.norm()).item() <= LSE_REL_L2_BOUND
    assert (lse - ref_lse).abs().max().item() <= LSE_MAX_REL * ref_lse.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["merged", "bhsd"])
def test_backward_matches_plain_on_card(cuda_device, layout):
    """K5 vs attention_bwd_plain on the same bf16 inputs (ragged lengths, a
    key-bias mask): dq, dk, dv and dbias within REL_L2_BOUND and
    MAX_ABS_REL."""
    q, k, v, _, _, bias, h = _case("fused_attention_joint", cuda_device)
    g = torch.randn(q.shape, generator=torch.Generator(cuda_device).manual_seed(1),
                    device=cuda_device).bfloat16()
    heads, scale = (h, 1.0 / 8) if layout == "merged" else (None, 0.125)
    q4, k4, v4, g4 = (TA.split_heads(z, h) for z in (q, k, v, g))
    out4, lse = TA.attention_plain(q4, k4, v4, bias, scale, with_lse=True)
    dsum = TA._row_dsum(g4, out4, None)
    before = TA.attention_backward.launches
    args = (q, k, v, g) if layout == "merged" else (q4, k4, v4, g4)
    got = TA.attention_backward(*args, lse, dsum, bias, heads, scale, with_dbias=True)
    ref = TA.attention_bwd_plain(q4, k4, v4, g4, lse, dsum, bias, scale)
    torch.cuda.synchronize()
    assert TA.attention_backward.launches == before + 1
    for x, r in zip(got[:3], ref[:3]):
        _assert_within_bounds(x if layout == "bhsd" else TA.split_heads(x, h), r)
    _assert_within_bounds(got[3], ref[3])


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(2200, 130), (130, 2200)])
def test_backward_short_sides_on_card(cuda_device, sq, skv):
    """K5 at head dim 64 (the one-pass body) where one side is short, as in
    the training path's cross-attentions: many q tiles against two key
    blocks, and a few q tiles that many key blocks add dq into; merged
    operands, a key-bias mask on one sample: dq, dk, dv and dbias within
    REL_L2_BOUND and MAX_ABS_REL of attention_bwd_plain."""
    gen = torch.Generator(cuda_device).manual_seed(sq + skv)
    b, h = 2, 4

    def rnd(s):
        return torch.randn(b, s, h * D, generator=gen, device=cuda_device).bfloat16()

    q, g, k, v = rnd(sq), rnd(sq), rnd(skv), rnd(skv)
    bias = torch.zeros(b, skv, device=cuda_device)
    bias[1, : skv // 3] = -1e9
    q4, k4, v4, g4 = (TA.split_heads(z, h) for z in (q, k, v, g))
    out4, lse = TA.attention_plain(q4, k4, v4, bias, 0.125, with_lse=True)
    dsum = TA._row_dsum(g4, out4, None)
    before = TA.attention_backward.launches
    got = TA.attention_backward(q, k, v, g, lse, dsum, bias, h, 0.125, with_dbias=True)
    ref = TA.attention_bwd_plain(q4, k4, v4, g4, lse, dsum, bias, 0.125)
    torch.cuda.synchronize()
    assert TA.attention_backward.launches == before + 1
    for x, r in zip(got[:3], ref[:3]):
        _assert_within_bounds(TA.split_heads(x, h), r)
    _assert_within_bounds(got[3], ref[3])


@pytest.mark.cuda
@pytest.mark.parametrize("per_block", [None, 1])
@pytest.mark.parametrize("skv", [1, 100, 480, 512])
def test_smallkv_key_counts_on_card(cuda_device, skv, per_block):
    """K2 (the prologue passes, then the K / V-resident body) at 1 to 512
    keys (one ragged 128-key tile to four whole ones) against 2,200 q rows,
    with the plan's q tiles per block and with one tile a block (every
    block then loads its own K and V), a key-bias mask on one sample: within
    REL_L2_BOUND and MAX_ABS_REL of the plain version; the public call
    counted once."""
    rng = np.random.default_rng(skv)
    b, h, sq = 2, 4, 2200

    def x(s):
        return torch.from_numpy(rng.normal(size=(b, s, h * D)).astype(np.float32)).to(
            cuda_device, torch.bfloat16)

    q, k, v = x(sq), x(skv), x(skv)
    tq = _tabs(rng, sq, b, 5, D ** -0.5, cuda_device)
    tk = TA.prologue_identity(skv, D, device=cuda_device)
    bias = torch.zeros(b, skv, device=cuda_device)
    bias[1, : skv // 3] = -1e9
    before = TA.fused_attention_cross_smallkv.launches
    if per_block is None:
        out = TA.fused_attention_cross_smallkv(q, k, v, tq, tk, key_bias=bias, heads=h)
    else:
        out = TA._launch_smallkv(q, k, v, bias, tq, tk, h, 1e-6, True, True, per_block=per_block)
    ref = TA._fused_plain_merged(q, k, v, bias, tq, tk, h, 1e-6, True, True)
    torch.cuda.synchronize()
    assert TA.fused_attention_cross_smallkv.launches == before + (per_block is None)
    _assert_within_bounds(out, ref)


def _int8_case(dev, b, h, sq, skv, masked, seed):
    """bf16 merged operands of K7 ([b, S, h * 64]), per-sample tables with a
    text prefix of min(5, S - 1) rows, and with ``masked`` a -1e9 key mask on
    the first third of the last sample's keys (None without)."""
    rng = np.random.default_rng(seed)

    def x(s):
        return torch.from_numpy(rng.normal(size=(b, s, h * D)).astype(np.float32)).to(
            dev, torch.bfloat16)

    bias = None
    if masked:
        bias = torch.zeros(b, skv, device=dev)
        bias[-1, : max(1, skv // 3)] = -1e9
    return (x(sq), x(skv), x(skv), _tabs(rng, sq, b, min(5, sq - 1), D ** -0.5, dev),
            _tabs(rng, skv, b, min(5, skv - 1), 1.0, dev), bias)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,masked,splits", [
    (2, 4, 300, 517, True, None),   # the plan's split count
    (2, 4, 300, 517, True, 1),
    (2, 4, 300, 517, False, 2),
    (2, 4, 300, 517, True, 3),
    (1, 2, 1, 1, False, None),
    (1, 2, 7, 1, True, 2),          # one key: the forced count comes back as 1
    (2, 2, 130, 100, True, 1),
    (2, 48, 259, 100, False, 3),
    (1, 2, 300, 300, False, 1),
    (2, 2, 300, 300, True, 2),
    (1, 48, 513, 300, True, 3),
    (2, 2, 77, 383, False, 3),      # an odd length: 3 tiles, the last 127 keys
])
def test_int8_kernel_matches_plain_on_card(cuda_device, b, h, sq, skv, masked, splits):
    """K7 (the quantizing pass, the body, at more than one split the combine)
    vs attention_fused_int8_plain on the same bf16 inputs (ragged lengths,
    per-sample tables, with and without a key-bias mask, at the plan's split
    count and at forced 1 / 2 / 3), within REL_L2_BOUND and MAX_ABS_REL: the
    same codes and scales up to a rare code at a rounding tie (the kernel
    folds log2 e in after the prologue), exact integer products, p rounded
    to bf16 on both sides. The public wrapper counts one launch."""
    q, k, v, tq, tk, bias = _int8_case(cuda_device, b, h, sq, skv, masked, 6 + sq + skv)
    before = TA.fused_attention_joint_int8.launches
    if splits is None:
        out = TA.fused_attention_joint_int8(q, k, v, tq, tk, key_bias=bias, heads=h)
    else:
        out = TA._launch_int8(q, k, v, bias, tq, tk, h, 1e-6, True, True, splits=splits)
    zeros = torch.zeros(b, skv, device=cuda_device)
    ref = TA.attention_fused_int8_plain(q, k, v, zeros if bias is None else bias, tq, tk, h,
                                        1e-6, True, True)
    torch.cuda.synchronize()
    assert TA.fused_attention_joint_int8.launches == before + (splits is None)
    _assert_within_bounds(out, ref)
    with pytest.raises(ValueError):
        TA.fused_attention_joint_int8(q[..., :192], k[..., :192], v[..., :192], tq, tk, heads=3)


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


@pytest.mark.cuda
@pytest.mark.parametrize("d,layout", [(64, "contiguous"), (64, "merged_view"), (32, "contiguous"),
                                      (16, "merged_view"), (128, "contiguous"),
                                      (128, "merged_view")])
def test_fused_bhsd_kernel_matches_plain_on_card(cuda_device, d, layout):
    """K6 (`fused_attention_bhsd`) vs its plain version on [B, H, S, d] bf16
    operands (3 heads, ragged lengths, per-sample tables with a text prefix,
    a key-bias mask on one sample), contiguous or as the strided view of
    merged [B, S, H*d] tensors, whose output comes back merged: within
    REL_L2_BOUND and MAX_ABS_REL; its lse within the lse bounds."""
    rng = np.random.default_rng(7)
    b, h, sq, skv = 2, 3, 300, 517
    dev = cuda_device

    def x(s):
        merged = torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32)).to(
            dev, torch.bfloat16)
        view = TA.split_heads(merged, h)
        return view if layout == "merged_view" else view.contiguous()

    q, k, v = x(sq), x(skv), x(skv)
    tabs = []
    for s, fold in ((sq, d ** -0.5), (skv, 1.0)):
        g = torch.from_numpy(np.abs(rng.normal(size=(d,))).astype(np.float32))
        b_ = torch.from_numpy((0.1 * rng.normal(size=(d,))).astype(np.float32))
        ang = torch.from_numpy(rng.normal(size=(b, s - 5, d)).astype(np.float32))
        tabs.append(tuple(z.to(dev) for z in TA.make_prologue(
            d, [(None, 5), ((ang.cos(), ang.sin()), s - 5)], g, b_, fold=fold)))
    bias = torch.zeros(b, skv, device=dev)
    bias[1, : skv // 3] = -1e9
    before = (TA.fused_attention_bhsd.launches, TA.fused_attention_bhsd.lse_launches)
    out, lse = TA.fused_attention_bhsd(q, k, v, *tabs, key_bias=bias, with_lse=True)
    ref, ref_lse = TA.attention_fused_plain(q, k, v, bias, *tabs, 1e-6, True, True,
                                            with_lse=True)
    torch.cuda.synchronize()
    assert (TA.fused_attention_bhsd.launches, TA.fused_attention_bhsd.lse_launches) == (
        before[0] + 1, before[1] + 1)
    assert out.stride() == q.stride()
    _assert_within_bounds(out, ref)
    assert ((lse - ref_lse).norm() / ref_lse.norm()).item() <= LSE_REL_L2_BOUND
    assert (lse - ref_lse).abs().max().item() <= LSE_MAX_REL * ref_lse.abs().max().item()


@pytest.mark.cuda
def test_fused_bhsd_refuses_what_the_card_lacks(cuda_device):
    """K6 raises on a head dim it is not built for (96), under autograd as
    well, and so do K5 and K4, instead of falling back; nothing is counted."""
    x = torch.zeros(1, 1, 128, 96, device=cuda_device, dtype=torch.bfloat16)
    tabs = TA.prologue_identity(128, 96, device=cuda_device)
    TA.reset_launch_counts()
    with pytest.raises(ValueError):
        TA.fused_attention_bhsd(x, x, x, tabs, tabs)
    q = x.clone().requires_grad_()
    with pytest.raises(ValueError):
        TA.fused_flash_attention(q, x, x, tabs, tabs)
    lse = torch.zeros(1, 1, 128, device=cuda_device)
    with pytest.raises(ValueError):
        TA.attention_backward(x, x, x, x, lse, lse)
    with pytest.raises(ValueError):
        TA.flash_attention_bhsd(x, x, x)
    assert all(n == 0 for n in TA.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_backward_head_dims_on_card(cuda_device, d):
    """K5 at head dims 16, 32, 64 and 128 vs attention_bwd_plain on [B, H, S, d] bf16
    (ragged lengths, a key-bias mask): dq, dk, dv, dbias within REL_L2_BOUND
    and MAX_ABS_REL; then a gradient through `fused_flash_attention` on
    [B, H, S, d] (K6 + K5 under autograd) against autograd through the plain
    version, one K5 launch. At 16, 32 and 128 (the one-pass bodies' 64-row q
    tiles, 64-key groups at 16 and 32, 128-key blocks at 128) also at
    lengths ragged to both and under one q tile, and at 16 and 32 at the tiny
    trainers' [3, H, 1,544, d] with their padded-chunk key bias, each held on
    two calls (dq's reduce-adds land in another order each call)."""
    gen = torch.Generator(cuda_device).manual_seed(d)
    b, h, sq, skv = 2, 3, 300, 517

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).bfloat16()

    q, g, k, v = rnd(b, h, sq, d), rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, d)
    bias = torch.zeros(b, skv, device=cuda_device)
    bias[1, : skv // 3] = -1e9
    scale = d ** -0.5
    out, lse = TA.attention_plain(q, k, v, bias, scale, with_lse=True)
    dsum = TA._row_dsum(g, out, None)
    before = TA.attention_backward.launches
    got = TA.attention_backward(q, k, v, g, lse, dsum, bias, None, scale, with_dbias=True)
    ref = TA.attention_bwd_plain(q, k, v, g, lse, dsum, bias, scale)
    torch.cuda.synchronize()
    assert TA.attention_backward.launches == before + 1
    for x, r in zip(got, ref):
        _assert_within_bounds(x, r)
    tq = TA.prologue_identity(sq, d, fold=scale, device=cuda_device)
    tk = TA.prologue_identity(skv, d, device=cuda_device)
    grads = []
    for fn in (lambda *a: TA.fused_flash_attention(*a, tq, tk, key_bias=bias),
               lambda *a: TA.attention_fused_plain(*a, bias, tq, tk, 1e-6, True, True)):
        leaves = [z.detach().requires_grad_() for z in (q, k, v)]
        torch.autograd.backward(fn(*leaves), g)
        grads.append([z.grad for z in leaves])
    assert TA.attention_backward.launches == before + 2
    for x, r in zip(*grads):
        _assert_within_bounds(x, r)
    cases = [] if d == 64 else [(b, h, sq2, skv2, None)
                                for sq2, skv2 in ((40, 200), (130, 129), (63, 64), (257, 3))]
    if d < 64:  # the tiny trainers' 8 text + 16 frames of 96, valid (16, 8, 4)
        chunk, _ = padded_chunk_masks(torch.tensor([16, 8, 4], device=cuda_device), 16, 96, 8)
        cases.append((3, 2 if d == 16 else 4, 1544, 1544, chunk))
    for b2, h2, sq2, skv2, chunk in cases:
        q2, g2, k2, v2 = (torch.randn(b2, h2, n, d, generator=gen, device=cuda_device).bfloat16()
                          for n in (sq2, sq2, skv2, skv2))
        bias2 = chunk
        if chunk is None:
            bias2 = torch.zeros(b2, skv2, device=cuda_device)
            bias2[0, (skv2 + 1) // 2:] = -1e9  # half of sample 0's keys (a row keeps one)
        out2, lse2 = TA.attention_plain(q2, k2, v2, bias2, scale, with_lse=True)
        dsum2 = TA._row_dsum(g2, out2, None)
        ref2 = TA.attention_bwd_plain(q2, k2, v2, g2, lse2, dsum2, bias2, scale)
        for _ in range(2):
            got2 = TA.attention_backward(q2, k2, v2, g2, lse2, dsum2, bias2, None, scale,
                                         with_dbias=True)
            torch.cuda.synchronize()
            for x, r in zip(got2, ref2):
                _assert_within_bounds(x, r)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
def test_backward_small_cut_on_card(cuda_device, d):
    """K5's body at head dims 16 and 32 is built with the cut that the plain
    decomposition and the wrapper's table assume (`bwd_kv_block` keys a
    warpgroup, `bwd_q_tile` q rows a tile, `BWD_Q_SHARES` warpgroups a key
    group), and at least one block fits a SM."""
    g = TA.bwd_small_geometry(d)
    assert g["q_tile"] == TA.bwd_q_tile(d) and g["q_shares"] == TA.BWD_Q_SHARES[d]
    assert g["keys"] % TA.bwd_kv_block(d) == 0 and g["threads"] % 128 == 0
    assert g["threads"] == 128 * g["q_shares"] * g["keys"] // TA.bwd_kv_block(d)
    assert g["blocks_per_sm"] >= 1


def _fused_case(kernel, d, layout, dev, seed):
    """bf16 operands of K1 (merged [2, S, 4 * 64]) or K6 ([2, 3, S, d],
    contiguous or the strided view of merged tensors), 300 q rows and 517
    keys, per-sample tables with a text prefix and a key-bias mask on one
    sample: (q, k, v, tq, tk, bias, heads or None, the prologued [B, H, S, d]
    (qn, kn, v) of the plain version)."""
    rng = np.random.default_rng(seed)
    b, h, sq, skv = 2, (4 if kernel == "K1" else 3), 300, 517

    def x(s):
        merged = torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32)).to(
            dev, torch.bfloat16)
        if kernel == "K1":
            return merged
        view = TA.split_heads(merged, h)
        return view if layout == "merged_view" else view.contiguous()

    q, k, v = x(sq), x(skv), x(skv)
    tabs = []
    for s, fold in ((sq, d ** -0.5), (skv, 1.0)):
        g = torch.from_numpy(np.abs(rng.normal(size=(d,))).astype(np.float32))
        b_ = torch.from_numpy((0.1 * rng.normal(size=(d,))).astype(np.float32))
        ang = torch.from_numpy(rng.normal(size=(b, s - 5, d)).astype(np.float32))
        tabs.append(tuple(z.to(dev) for z in TA.make_prologue(
            d, [(None, 5), ((ang.cos(), ang.sin()), s - 5)], g, b_, fold=fold)))
    bias = torch.zeros(b, skv, device=dev)
    bias[1, : skv // 3] = -1e9
    heads = h if kernel == "K1" else None
    if kernel == "K1":
        q4, k4, v4 = (TA.split_heads(z, h) for z in (q, k, v))
    else:
        q4, k4, v4 = q, k, v
    qn = TA.apply_prologue_plain(q4, tabs[0], 1e-6, True)
    kn = TA.apply_prologue_plain(k4, tabs[1], 1e-6, True)
    return q, k, v, tabs[0], tabs[1], bias, heads, (qn, kn, v4)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 2, 5])
@pytest.mark.parametrize("kernel,d,layout", [("K1", 64, "merged"), ("K6", 16, "merged_view"),
                                             ("K6", 32, "contiguous"), ("K6", 64, "merged_view"),
                                             ("K6", 128, "contiguous"),
                                             ("K6", 128, "merged_view")])
def test_fused_kernels_at_split_counts_on_card(cuda_device, kernel, d, layout, splits):
    """K1 and K6 (the prologue pass, the body, the combine) at the plan's
    split count and at forced 2 and 5, on ragged bf16 operands with a
    key-bias mask (at 5 splits of 128 keys one split's keys are all masked
    on sample 1 at d <= 64): the output within REL_L2_BOUND and MAX_ABS_REL
    of the plain version, in q's layout, bit-equal to the call without its
    lse; the lse within the lse bounds."""
    q, k, v, tq, tk, bias, heads, (qn, kn, v4) = _fused_case(kernel, d, layout, cuda_device,
                                                             40 + d)
    if splits == 5:
        bias[1, 128:256] = -1e9
    out, lse = TA._launch_fused(q, k, v, bias, tq, tk, heads, 1e-6, True, True, with_lse=True,
                                splits=splits)
    plain = TA._launch_fused(q, k, v, bias, tq, tk, heads, 1e-6, True, True, splits=splits)
    ref, ref_lse = TA.attention_plain(qn, kn, v4, bias, 1.0, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    if kernel == "K6":
        assert out.stride() == q.stride()
    _assert_within_bounds(out if kernel == "K6" else TA.split_heads(out, heads), ref)
    assert ((lse - ref_lse).norm() / ref_lse.norm()).item() <= LSE_REL_L2_BOUND
    assert (lse - ref_lse).abs().max().item() <= LSE_MAX_REL * ref_lse.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_attention_joint", "fused_attention_bhsd",
                                  "fused_attention_cross_smallkv", "fused_attention_joint_int8"])
def test_fused_kernels_on_all_negative_rows(cuda_device, name):
    """K1, K6, K2 (against the first 480 keys) and K7 on rows whose every score
    is far negative (q = -k with LayerNorm gain 50, as chip_smoke.py): the
    online max keeps them finite,
    and each output is a convex combination of v's rows (within v's range
    per column, to a bf16 ulp). The weights themselves hang on the bf16
    rounding of q' (scores near -3e4 in log2 units): no closer agreement
    with the plain version is asked."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    d, h, s = 64, 4, 1024
    base = torch.randn(1, 1, h * d, generator=gen, device=cuda_device)
    k = (base + 1e-3 * torch.randn(1, s, h * d, generator=gen, device=cuda_device)).bfloat16()
    v = torch.randn(1, s, h * d, generator=gen, device=cuda_device).bfloat16()
    gain, zero = torch.full((d,), 50.0, device=cuda_device), torch.zeros(d, device=cuda_device)
    tq = TA.make_prologue(d, [(None, s)], gain, zero, fold=d ** -0.5)
    tk = TA.make_prologue(d, [(None, s)], gain, zero)
    q = -k
    if name in ("fused_attention_joint", "fused_attention_joint_int8"):
        out = getattr(TA, name)(q, k, v, tq, tk, heads=h)
    elif name == "fused_attention_cross_smallkv":
        k, v = k[:, :480], v[:, :480]
        out = TA.fused_attention_cross_smallkv(q, k, v, tq, TA.slice_tabs(tk, 0, 480), heads=h)
    else:
        out = TA.merge_heads(TA.fused_attention_bhsd(*(TA.split_heads(z, h) for z in (q, k, v)),
                                                     tq, tk))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    vf, of = v.float(), out.float()
    assert (of <= vf.amax(dim=1, keepdim=True) * (1 + 2 ** -7) + 1e-6).all()
    assert (of >= vf.amin(dim=1, keepdim=True) * (1 + 2 ** -7) - 1e-6).all()


@pytest.mark.cuda
def test_fused_kernels_refuse_misaligned_operands(cuda_device):
    """An operand whose rows are not 16-byte aligned (TMA cannot take it)
    raises ValueError in K1 and K6, and nothing is counted."""
    x = torch.zeros(1, 129, 2 * D + 8, device=cuda_device, dtype=torch.bfloat16)
    bad = x[:, 1:, 1:1 + 2 * D]  # rows start 2 bytes off the 16-byte grid
    tabs = TA.prologue_identity(128, D, device=cuda_device)
    TA.reset_launch_counts()
    with pytest.raises(ValueError):
        TA.fused_attention_joint(bad, bad, bad, tabs, tabs, heads=2)
    with pytest.raises(ValueError):
        TA.fused_attention_bhsd(*(TA.split_heads(bad, 2) for _ in range(3)), tabs, tabs)
    assert all(n == 0 for n in TA.launch_counts().values())


# ------------------------------------------------------------ probe kernels


@pytest.mark.cuda
def test_probe_attention_kernels_on_card(cuda_device):
    """T1 at every built (block_q, block_kv, hblk) and T2 at every built tile
    (T1's) in both bias modes, on [2, 4, 300, 64] x 517 keys (ragged) bf16
    with a random key bias, vs their plain versions (T2's at the tile's
    block_kv) within REL_L2_BOUND and MAX_ABS_REL; each call counted once."""
    from tokensgen_tpu_torch.kernels import probes as P

    gen = torch.Generator(cuda_device).manual_seed(3)
    q = torch.randn(2, 4, 300, D, generator=gen, device=cuda_device).bfloat16()
    k, v = (torch.randn(2, 4, 517, D, generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    bias = torch.randn(2, 517, generator=gen, device=cuda_device)
    ref = P.attention_sweep_plain(q, k, v, bias)
    for cfg in P.SWEEP_CONFIGS:
        before = P.attention_sweep.launches
        _assert_within_bounds(P.attention_sweep(q, k, v, bias, *cfg), ref)
        assert P.attention_sweep.launches == before + 1
    for mode in P.BIAS_MODES:
        for bq, bkv, hb in P.SWEEP_CONFIGS:
            before = P.attention_v2.launches
            _assert_within_bounds(P.attention_v2(q, k, v, bias, bq, bkv, mode, hb),
                                  P.attention_v2_plain(q, k, v, bias, bkv, mode))
            assert P.attention_v2.launches == before + 1
    with pytest.raises(ValueError):
        P.attention_sweep(q, k, v, bias, 64, 64, 1)  # not built


# T1's other shapes: (batch, heads, Sq, Skv, key bias): Sq and Skv ragged to
# every tile (128 / 256 rows, 128 / 192 keys) and unequal, a random key bias
# (the FFMA path with the bias) or none (the max on the raw scores), one key
# (a tile of one valid key), and one q row
SWEEP_SHAPES = [(2, 4, 1000, 333, True), (2, 4, 333, 1000, True), (2, 2, 257, 700, False),
                (1, 2, 130, 1, True), (2, 2, 1, 385, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,biased", SWEEP_SHAPES)
def test_probe_attention_sweep_shapes_on_card(cuda_device, b, h, sq, skv, biased):
    """T1 at every `SWEEP_CONFIGS` tile on each of `SWEEP_SHAPES` vs its
    plain version within REL_L2_BOUND and MAX_ABS_REL; each call counted
    once."""
    from tokensgen_tpu_torch.kernels import probes as P

    gen = torch.Generator(cuda_device).manual_seed(sq * 7 + skv)
    q = torch.randn(b, h, sq, D, generator=gen, device=cuda_device).bfloat16()
    k, v = (torch.randn(b, h, skv, D, generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    bias = torch.randn(b, skv, generator=gen, device=cuda_device) if biased else None
    ref = P.attention_sweep_plain(q, k, v, bias)
    for cfg in P.SWEEP_CONFIGS:
        before = P.attention_sweep.launches
        out = P.attention_sweep(q, k, v, bias, *cfg)
        torch.cuda.synchronize()
        assert P.attention_sweep.launches == before + 1
        _assert_within_bounds(out, ref)


# T2's shapes: (batch, heads, Sq, Skv): Skv not a multiple of 128 (and under
# one tile), Sq not a multiple of block_q, one key, one q row
V2_SHAPES = [(2, 4, 1000, 333), (2, 4, 333, 1000), (1, 2, 130, 1), (2, 2, 1, 385), (1, 2, 257, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv", V2_SHAPES)
def test_probe_attention_v2_shapes_on_card(cuda_device, b, h, sq, skv):
    """T2 at every built tile (`SWEEP_CONFIGS`) in both bias modes on each of
    `V2_SHAPES`, held to its plain version at the tile's block_kv within
    REL_L2_BOUND and MAX_ABS_REL: with a random key bias, and with -1e9 on
    every key before the last tile (sample 0) that "last" must ignore and
    "full" must apply; each call counted once."""
    from tokensgen_tpu_torch.kernels import probes as P

    gen = torch.Generator(cuda_device).manual_seed(sq * 11 + skv)
    q = torch.randn(b, h, sq, D, generator=gen, device=cuda_device).bfloat16()
    k, v = (torch.randn(b, h, skv, D, generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    random_bias = torch.randn(b, skv, generator=gen, device=cuda_device)
    masked = random_bias.clone()
    masked[0, :(skv - 1) // 128 * 128] = -1e9
    for bias in (random_bias, masked):
        for mode in P.BIAS_MODES:
            for bq, bkv, hb in P.SWEEP_CONFIGS:
                before = P.attention_v2.launches
                out = P.attention_v2(q, k, v, bias, bq, bkv, mode, hb)
                torch.cuda.synchronize()
                assert P.attention_v2.launches == before + 1
                _assert_within_bounds(out, P.attention_v2_plain(q, k, v, bias, bkv, mode))


@pytest.mark.cuda
def test_probe_unbuilt_tiles_raise_on_card(cuda_device):
    """On the card T1, T2, T4a and T4b launch or raise: a tile they were not
    built for raises ValueError and counts nothing."""
    from tokensgen_tpu_torch.kernels import probes as P

    q4 = torch.zeros(1, 2, 128, D, device=cuda_device, dtype=torch.bfloat16)
    before = P.attention_sweep.launches, P.attention_v2.launches
    for cfg in ((128, 64, 1), (64, 128, 1), (256, 128, 2), (128, 128, 3)):
        with pytest.raises(ValueError):
            P.attention_sweep(q4, q4, q4, None, *cfg)
        with pytest.raises(ValueError):
            P.attention_v2(q4, q4, q4, None, cfg[0], cfg[1], "last", cfg[2])
    assert (P.attention_sweep.launches, P.attention_v2.launches) == before
    q, k, v, tq, tk, bias, h = _maxfree_inputs(cuda_device, 2, 300, 130)
    before = P.cross_smallkv_pairinner.launches
    for block_q in (128, 256, 640, 4096):
        with pytest.raises(ValueError):
            P.cross_smallkv_pairinner(q, k, v, bias, tq, tk, h, block_q)
    _, k600, v600, _, tk600, bias600, _ = _maxfree_inputs(cuda_device, 2, 300, 600)
    with pytest.raises(ValueError):  # more keys than it holds
        P.cross_smallkv_pairinner(q, k600, v600, bias600, tq, tk600, h)
    assert P.cross_smallkv_pairinner.launches == before
    before = P.cross_smallq_splitkv.launches
    for split in (64, 128, 640, 1024):
        with pytest.raises(ValueError):
            P.cross_smallq_splitkv(q, k600, v600, bias600, tq, tk600, h, split)
    assert P.cross_smallq_splitkv.launches == before


@pytest.mark.cuda
def test_probe_flash_loop_on_card(cuda_device):
    """T6 on m = 40 rows (ragged to its 64-row blocks), n = 208 keys (ragged
    to its chunks, across a split boundary: two splits in int8, four in
    bf16), d = 128: int8 bit-equal to its plain version (exact integers,
    int32 wrap) at 7 steps, bf16 within the bounds at 3; then n = d (one
    split, which holds the chain's keys) and the CLI's two shapes (2,048 x
    1,024 and 2,048 x 2,048, splits of 256 and 512 keys) at 3 steps."""
    from tokensgen_tpu_torch.kernels import probes as P

    rng = np.random.default_rng(4)
    for m, n, iters in ((40, 208, 7), (40, 128, 7), (2048, 1024, 3), (2048, 2048, 3)):
        d = 128
        shapes = ((m, d), (d, n), (n, d))
        q8, k8, v8 = (torch.from_numpy(rng.integers(-127, 127, s)).to(cuda_device, torch.int8)
                      for s in shapes)
        assert torch.equal(P.flash_loop(q8, k8, v8, iters), P.flash_loop_plain(q8, k8, v8, iters))
        qb, kb, vb = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
            cuda_device, torch.bfloat16) for s in shapes)
        _assert_within_bounds(P.flash_loop(qb, kb, vb, 3), P.flash_loop_plain(qb, kb, vb, 3))


@pytest.mark.cuda
def test_probe_matmul_and_exp2_on_card(cuda_device):
    """T7 on ragged (300 x 200) @ (200 x 136) vs bf16(f32 product) within the
    bounds; T8's three ops over 1,000 x 64 f32 for 20 passes vs the plain
    loop (mul bit-equal: the same IEEE products)."""
    from tokensgen_tpu_torch.kernels import probes as P

    gen = torch.Generator(cuda_device).manual_seed(5)
    x = (0.1 * torch.randn(300, 200, generator=gen, device=cuda_device)).bfloat16()
    y = (0.1 * torch.randn(200, 136, generator=gen, device=cuda_device)).bfloat16()
    _assert_within_bounds(P.matmul_hand(x, y), P.matmul_plain(x, y))
    z = torch.rand(1000, 64, generator=gen, device=cuda_device) * 2 - 1
    for op in P.EXP2_OPS:
        out, ref = P.exp2_loop(z, 20, op), P.exp2_loop_plain(z, 20, op)
        if op == "mul":
            assert torch.equal(out, ref)
        _assert_within_bounds(out, ref)


# T7's edges: (M, K, N) with M not a multiple of its 128-row tiles, N a
# multiple of 8 but not of its 256-column tiles, K a multiple of 8 but not of
# its 64-deep k tile, K under one k tile, more output tiles (256) than an
# H100's 132 SMs (the persistent walk wraps), and K = 12,288 (ff down's: 192
# k tiles, the longest accumulation chain) at a small M x N
MATMUL_EDGES = [(1000, 256, 512), (256, 128, 520), (200, 200, 256), (130, 40, 264),
                (128, 8, 256), (4096, 64, 2048), (256, 12288, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,kdim,n", MATMUL_EDGES)
def test_probe_matmul_edges_on_card(cuda_device, m, kdim, n):
    """T7 at each of `MATMUL_EDGES` against bf16(f32 product) within
    REL_L2_BOUND and MAX_ABS_REL; each call counted once."""
    from tokensgen_tpu_torch.kernels import probes as P

    gen = torch.Generator(cuda_device).manual_seed(m + kdim + n)
    x = (0.1 * torch.randn(m, kdim, generator=gen, device=cuda_device)).bfloat16()
    y = (0.1 * torch.randn(kdim, n, generator=gen, device=cuda_device)).bfloat16()
    before = P.matmul_hand.launches
    out = P.matmul_hand(x, y)
    torch.cuda.synchronize()
    assert P.matmul_hand.launches == before + 1
    _assert_within_bounds(out, P.matmul_plain(x, y))


@pytest.mark.cuda
def test_probe_builds_match_their_host_constants(cuda_device):
    """T7's build (csrc/probe_gemm.cu) has the tile, k tile and raster group
    that `probes.matmul_tiles`, `MATMUL_BK` and `MATMUL_GROUP` assume, and
    its shared memory fits a block; T3a is built at each block_q of
    `SPLITPV_CONFIGS`, within a block's shared memory; T1 (and T2, which
    runs T1's builds) at each tile of `SWEEP_CONFIGS`, T4a at 1 to
    `RESIDENT_MAX` keys and T4b at each split of `SPLITKV_BLOCK_KV` have the
    threads, tiles and shared memory that `probes.sweep_smem_bytes`,
    `pairinner_smem_bytes` and `splitkv_smem_bytes` compute, each block
    resident on a SM (T4b's blocks of one warpgroup, two)."""
    from tokensgen_tpu_torch.kernels import probes as P

    g = P.matmul_geometry()
    assert (g["tile_rows"], g["tile_cols"]) == P.MATMUL_TILE
    assert g["k_tile"] == P.MATMUL_BK and g["raster_group"] == P.MATMUL_GROUP
    assert 0 < g["smem_bytes"] <= 232448
    for block_q, _ in P.SPLITPV_CONFIGS:
        t = P.splitpv_geometry(block_q)
        assert t["block_q"] == block_q and 0 < t["smem_bytes"] <= 232448
    for bq, bkv, hb in P.SWEEP_CONFIGS:
        s = P.sweep_geometry(bq, bkv, hb)
        assert (s["block_q"], s["block_kv"], s["hblk"]) == (bq, bkv, hb)
        assert s["threads"] == 256 and s["chains"] == bq // 128 * hb and s["slots"] >= 2
        assert s["smem_bytes"] == P.sweep_smem_bytes(bq, bkv, hb) <= 232448
        assert s["blocks_per_sm"] >= 1
    for skv in (1, 128, 129, 480, P.RESIDENT_MAX):
        r = P.pairinner_geometry(skv)
        assert r["threads"] == 256 and r["q_slots"] == P.PAIRINNER_SLOTS
        assert r["kv_tiles"] == -(-skv // 128) and r["prologue_pass"] == 1
        assert r["smem_bytes"] == P.pairinner_smem_bytes(skv) <= 232448
        assert r["blocks_per_sm"] >= 1
    for split in P.SPLITKV_BLOCK_KV:
        g = P.splitkv_geometry(split)
        assert g["threads"] == 128 * g["warpgroups"] and g["q_slots"] == P.PAIRINNER_SLOTS
        assert g["kv_tiles"] == split // 128 and g["reduce"] in (0, 1)
        assert g["smem_bytes"] == P.splitkv_smem_bytes(split, g["warpgroups"]) <= 232448
        assert g["blocks_per_sm"] == (2 if g["warpgroups"] == 1 else 1)


MAXFREE_TILES = {  # entry point: (the _case shape it takes, its built tiles)
    "attention_splitpv": ("fused_attention_joint", "SPLITPV_CONFIGS"),
    "attention_pair2": ("fused_attention_joint", "PAIR2_BLOCK_KV"),
    "cross_smallkv_pairinner": ("fused_attention_cross_smallkv", "PAIRINNER_BLOCK_Q"),
    "cross_smallq_splitkv": ("fused_attention_cross_smallq", "SPLITKV_BLOCK_KV"),
    "cross_smallkv_pairloop": ("fused_attention_cross_smallkv", "PAIRLOOP_BLOCK_Q"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MAXFREE_TILES))
def test_probe_maxfree_kernels_on_card(cuda_device, name):
    """T3a, T3b, T4a, T4b and T5 at every built tile vs their shared max-free
    plain version, within REL_L2_BOUND and MAX_ABS_REL, on the ragged
    shapes of `_case` (joint 300 x 517, cross 2200 x 130 and 130 x 2200 keys:
    T4b's last split of 256 / 384 / 512 keys ragged) with per-sample tables
    and a key-bias mask on one sample; each call counted once."""
    from tokensgen_tpu_torch.kernels import probes as P

    shape, tiles = MAXFREE_TILES[name]
    q, k, v, tq, tk, bias, h = _case(shape, cuda_device)
    shift = P.score_shift(tq, tk, bias)
    ref = P.attention_maxfree_plain(q, k, v, bias, tq, tk, h, shift)
    fn = getattr(P, name)
    for tile in getattr(P, tiles):
        before = fn.launches
        out = fn(q, k, v, bias, tq, tk, h, *(tile if isinstance(tile, tuple) else (tile,)))
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_within_bounds(out, ref)
    with pytest.raises(ValueError):
        fn(q, k, v, bias, tq, tk, h, *((128, 64) if name == "attention_splitpv" else (96,)))


def _maxfree_inputs(dev, h, sq, skv, seed=7):
    """As `_case`, at any shape: bf16 merged operands of 2 samples with ``h``
    heads, per-sample tables with a text prefix of up to 5 rows, a key-bias
    mask over the first third of sample 1's keys."""
    rng = np.random.default_rng(seed)
    b = 2

    def x(s):
        return torch.from_numpy(rng.normal(size=(b, s, h * D)).astype(np.float32)).to(
            dev, torch.bfloat16)

    bias = torch.zeros(b, skv, device=dev)
    bias[1, : skv // 3] = -1e9
    return (x(sq), x(skv), x(skv), _tabs(rng, sq, b, min(5, sq - 1), D ** -0.5, dev),
            _tabs(rng, skv, b, min(5, skv - 1), 1.0, dev), bias, h)


@pytest.mark.cuda
@pytest.mark.parametrize("skv", [1, 130, 480, 512])
def test_probe_pairloop_shapes_on_card(cuda_device, skv):
    """T5 with more heads (8) than its K' / V ring has slots (3), on 300 q
    rows (not a multiple of its 128-row blocks: the last block's second
    warpgroup holds 44 rows), against 1, 130, 480 and RESIDENT_MAX (512)
    keys (the ring streams any count; RESIDENT_MAX bounds T4a / T4b only),
    at every built block_q, within REL_L2_BOUND and MAX_ABS_REL of the
    plain version; each call counted once."""
    from tokensgen_tpu_torch.kernels import probes as P

    q, k, v, tq, tk, bias, h = _maxfree_inputs(cuda_device, 8, 300, skv)
    shift = P.score_shift(tq, tk, bias)
    ref = P.attention_maxfree_plain(q, k, v, bias, tq, tk, h, shift)
    for block_q in P.PAIRLOOP_BLOCK_Q:
        before = P.cross_smallkv_pairloop.launches
        out = P.cross_smallkv_pairloop(q, k, v, bias, tq, tk, h, block_q)
        torch.cuda.synchronize()
        assert P.cross_smallkv_pairloop.launches == before + 1
        _assert_within_bounds(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("skv", [1, 100, 130, 480, 512])
def test_probe_pairinner_shapes_on_card(cuda_device, skv):
    """T4a on 300 q rows of 2 samples (not a multiple of its 64-row chunks:
    the last chunk holds 44 rows, and at 512 q rows a block warpgroup 1's
    last chunk lies past Sq) against 1, 100, 130 (a ragged second tile), 480
    and RESIDENT_MAX (512) resident keys, at every built block_q, within
    REL_L2_BOUND and MAX_ABS_REL of the plain version; each call counted
    once."""
    from tokensgen_tpu_torch.kernels import probes as P

    q, k, v, tq, tk, bias, h = _maxfree_inputs(cuda_device, 4, 300, skv)
    shift = P.score_shift(tq, tk, bias)
    ref = P.attention_maxfree_plain(q, k, v, bias, tq, tk, h, shift)
    for block_q in P.PAIRINNER_BLOCK_Q:
        before = P.cross_smallkv_pairinner.launches
        out = P.cross_smallkv_pairinner(q, k, v, bias, tq, tk, h, block_q)
        torch.cuda.synchronize()
        assert P.cross_smallkv_pairinner.launches == before + 1
        _assert_within_bounds(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [130, 480])
def test_probe_splitkv_shapes_on_card(cuda_device, sq):
    """T4b at every split of `SPLITKV_BLOCK_KV` on 2 samples with per-sample
    tables, 130 (a chunk of 64 ragged: warpgroup 1's second chunk lies past
    Sq) and 480 (7.5 chunks: the last half of the last chunk past Sq, which
    the accumulator's maps clip) q rows against 1,100 keys (every split
    size leaves a ragged last split), a -1e9 mask over the whole second split
    of sample 1 (its partials add nothing) beside the first third of its
    keys; called twice (the reduce-add's order varies between calls), both
    within REL_L2_BOUND and MAX_ABS_REL of the plain version; each call
    counted once."""
    from tokensgen_tpu_torch.kernels import probes as P

    q, k, v, tq, tk, bias, h = _maxfree_inputs(cuda_device, 4, sq, 1100, seed=sq)
    for split in P.SPLITKV_BLOCK_KV:
        masked = bias.clone()
        masked[1, split:2 * split] = -1e9
        shift = P.score_shift(tq, tk, masked)
        ref = P.attention_maxfree_plain(q, k, v, masked, tq, tk, h, shift)
        for _ in range(2):
            before = P.cross_smallq_splitkv.launches
            out = P.cross_smallq_splitkv(q, k, v, masked, tq, tk, h, split, shift=shift)
            torch.cuda.synchronize()
            assert P.cross_smallq_splitkv.launches == before + 1
            _assert_within_bounds(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["fused_attention_cross_smallkv", "fused_attention_cross_smallq"])
def test_probe_pair2_cross_shapes_on_card(cuda_device, shape):
    """T3b at `_case`'s two cross shapes (2,200 q rows x 130 keys, 130 x
    2,200), ragged in q and kv, against the plain version within
    REL_L2_BOUND and MAX_ABS_REL; one launch counted."""
    from tokensgen_tpu_torch.kernels import probes as P

    q, k, v, tq, tk, bias, h = _case(shape, cuda_device)
    shift = P.score_shift(tq, tk, bias)
    before = P.attention_pair2.launches
    out = P.attention_pair2(q, k, v, bias, tq, tk, h)
    torch.cuda.synchronize()
    assert P.attention_pair2.launches == before + 1
    _assert_within_bounds(out, P.attention_maxfree_plain(q, k, v, bias, tq, tk, h, shift))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attention_splitpv", "attention_pair2", "cross_smallkv_pairloop",
                                  "cross_smallkv_pairinner", "cross_smallq_splitkv"])
def test_probe_maxfree_subnormal_p_on_card(cuda_device, name):
    """T3a and T3b (joint 300 x 517), T5 and T4a (300 x 130), T4b (300 x
    1,100: three splits at its default) with an explicit shift that
    puts every p of every row (its unmasked keys) between 2^-149 and
    2^-126, f32's subnormals: q's tables scaled by 1/8 narrow the scores,
    the shift takes the largest to -127. Held to the plain version (which
    keeps subnormal f32 p and subnormal bf16 p) within REL_L2_BOUND and
    MAX_ABS_REL: the kernels' exponential must not flush them."""
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.kernels import probes as P

    skv = {"cross_smallq_splitkv": 1100}.get(name, 130 if name.startswith("cross_") else 517)
    q, k, v, tq, tk, bias, h = _maxfree_inputs(cuda_device, 4, 300, skv, seed=8)
    tq = tuple(x / 8 for x in tq[:3]) + (tq[3],)
    qn = A._prologue32(A.split_heads(q, h), tuple(x * A._LOG2E for x in tq[:3]) + (tq[3],),
                       1e-6, True).to(torch.bfloat16)
    kn = A.apply_prologue_plain(A.split_heads(k, h), tk, 1e-6, True)
    s = torch.einsum("bhqd,bhkd->bhqk", qn.float(), kn.float()) + bias[:, None, None, :] * A._LOG2E
    live = (bias > -1e8)[:, None, None, :].expand_as(s)
    shift = s[live].max().item() + 127.0
    assert s[live].min().item() - shift >= -149.0  # every unmasked p is subnormal
    ref = P.attention_maxfree_plain(q, k, v, bias, tq, tk, h, shift)
    out = getattr(P, name)(q, k, v, bias, tq, tk, h, shift=shift)
    torch.cuda.synchronize()
    _assert_within_bounds(out, ref)


# the float32 K4 against `attention_plain` in float32 on the same inputs:
# both keep float32 throughout (TF32 off for the plain version's matmuls) and
# differ only in summation order and in exp2 with the scale folded into q.
# Bound: relative L2 error <= F32_REL_L2_BOUND and max abs error <=
# F32_MAX_ABS_REL of the output's largest magnitude (as chip_smoke.py), far
# under what dropping the last key of DINOv2's 257 moves (~6% relative).
F32_REL_L2_BOUND = 1e-5
F32_MAX_ABS_REL = 2.0 ** -14


def _assert_f32_within_bounds(out, ref):
    diff = out - ref
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (diff.norm() / ref.norm()).item() <= F32_REL_L2_BOUND
    assert diff.abs().max().item() <= F32_MAX_ABS_REL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,d,masked", [
    (49, 16, 257, 257, 64, False),  # DINOv2-large: a 1-row q tail and a 1-key kv tail
    (2, 3, 130, 517, 64, True),  # ragged q and kv tails, a key-bias mask on one sample
    (2, 4, 256, 384, 64, False),  # whole tiles of q rows and of keys
    (2, 3, 130, 517, 32, True), (2, 3, 130, 517, 16, True),
    # the body's tails: 1 and 7 q rows of a 64-row tile; 9, 65 and 257 keys
    # (one past a multiple of 8 and of 64: an n8 last tile after 0, 1 and 4
    # full ones, or a full tile of 9)
    (2, 3, 1, 257, 64, False), (2, 3, 7, 65, 64, True), (2, 3, 7, 9, 32, False),
    (2, 3, 65, 9, 16, True),
    (2, 2, 257, 2053, 64, True),  # many kv tiles
    (2, 3, 70, 257, 64, "all")])  # every key of sample 1 masked: a uniform softmax
def test_f32_bhsd_matches_plain_on_card(cuda_device, monkeypatch, b, h, sq, skv, d, masked):
    """The float32 K4 (`flash_attention_bhsd_f32`, and `flash_attention` /
    `flash_attention_bhsd` routing float32 to it) vs `attention_plain` in
    float32, on the strided [B, H, S, d] views of merged [B, S, H*d]
    tensors as DINOv2 makes them, within the float32 bounds; each call
    counted once and by the float32 entry point only. ``masked``: a -1e9
    key bias on the first third of sample 1's keys (True) or on all of them
    ("all"). At DINOv2's shape the plain version without the last key fails
    the bounds."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(8)
    dev = cuda_device

    def x(s):
        merged = torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32)).to(dev)
        return merged.view(b, s, h, d).transpose(1, 2)

    q, k, v = x(sq), x(skv), x(skv)
    bias = None
    if masked:
        bias = torch.zeros(b, skv, device=dev)
        bias[1, : skv // 3 if masked is True else skv] = -1e9
    scale = d ** -0.5
    ref = TA.attention_plain(q, k, v, TA._bias_or_zeros(bias, k, None), scale)
    TA.reset_launch_counts()
    outs = [TA.flash_attention_bhsd_f32(q, k, v, bias, scale),
            TA.flash_attention_bhsd(q, k, v, bias, scale),
            TA.flash_attention(q, k, v, bias, scale)]
    torch.cuda.synchronize()
    counts = TA.launch_counts()
    assert counts["flash_attention_bhsd_f32"] == 3 and counts["flash_attention_bhsd"] == 0
    for out in outs:
        assert out.shape == (b, h, sq, d)
        _assert_f32_within_bounds(out, ref)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    if (b, sq, skv) == (49, 257, 257):
        short = TA.attention_plain(q, k[:, :, :-1], v[:, :, :-1],
                                   TA._bias_or_zeros(None, k[:, :, :-1], None), scale)
        diff = short - ref
        assert (diff.norm() / ref.norm()).item() > F32_REL_L2_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64])
def test_f32_bhsd_contiguous_operands_on_card(cuda_device, monkeypatch, d):
    """The float32 K4 on contiguous [B, H, S, d] operands (heads S * d
    apart, where DINOv2's views keep them d apart: other strides for the
    body's TMA tensor maps), a ragged q and kv, within the float32 bounds."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, s, d)).astype(np.float32)).to(cuda_device)
               for s in (100, 300, 300))
    ref = TA.attention_plain(q, k, v, TA._bias_or_zeros(None, k, None), d ** -0.5)
    out = TA.flash_attention_bhsd_f32(q, k, v, None, d ** -0.5)
    torch.cuda.synchronize()
    _assert_f32_within_bounds(out, ref)


@pytest.mark.cuda
def test_f32_bhsd_refuses_what_it_lacks(cuda_device):
    """The float32 K4 raises on a head dim it is not built for (128), on a
    gradient (there is no float32 K5), on the lse and on misaligned rows,
    instead of falling back; nothing is counted."""
    dev = cuda_device
    x = torch.zeros(1, 2, 65, 64, device=dev)
    TA.reset_launch_counts()
    with pytest.raises(ValueError):
        TA.flash_attention_bhsd_f32(*(torch.zeros(1, 2, 65, 128, device=dev),) * 3)
    with pytest.raises(ValueError):
        TA.flash_attention(x.clone().requires_grad_(), x, x)
    with pytest.raises(ValueError):
        TA.flash_attention_bhsd(x, x, x, with_lse=True)
    odd = torch.zeros(1, 2, 65, 66, device=dev)[..., 1:65]
    with pytest.raises(ValueError):
        TA.flash_attention_bhsd_f32(odd, odd, odd)
    with pytest.raises(TypeError):
        TA.flash_attention_bhsd_f32(x, x.to(torch.bfloat16), x)
    assert all(n == 0 for n in TA.launch_counts().values())
