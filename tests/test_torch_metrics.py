"""Port parity: the validation metrics (tokensgen_tpu_torch/metrics/quality.py,
metrics/lpips.py) against the JAX package's (tokensgen_tpu/metrics/) on the
same frames, made from a seed: PSNR, SSIM, ΔE*ab and `evaluate_video` within
1e-6 relative (float64 on both sides; SSIM's window sums in another order),
the perceptual proxy likewise, and LPIPS on random VGG16 + lin-head weights
in the published torch layout within 1e-5 (float32 convolutions). Each test
prints the deltas it measures."""

import numpy as np
import pytest
import torch

from tokensgen_tpu.metrics import lpips as JL
from tokensgen_tpu.metrics import quality as JQ
from tokensgen_tpu_torch.metrics import lpips as TL
from tokensgen_tpu_torch.metrics import quality as TQ


def _frames(seed=0, shape=(3, 48, 64, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape)
    return a, np.clip(a + 0.1 * rng.normal(size=shape), 0, 1)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("fn", ["psnr", "ssim", "delta_e_ab", "perceptual_distance"])
def test_image_metrics_match_jax(fn):
    """Each metric on images [H, W, 3] (and SSIM on a gray [H, W] image):
    within 1e-6 relative."""
    a, b = _frames(shape=(64, 80, 3))
    cases = [(a, b)] + ([(a[..., 0], b[..., 0])] if fn == "ssim" else [])
    for x, y in cases:
        got, want = getattr(TQ, fn)(x, y), getattr(JQ, fn)(x, y)
        print(f"{fn}{x.shape}: port {got!r} jax {want!r} (relative {_rel(got, want):.2e})")
        assert np.isfinite(got) and _rel(got, want) <= 1e-6
    assert TQ.psnr(a, a) == JQ.psnr(a, a) == float("inf")


def test_evaluate_video_matches_jax():
    """`evaluate_video` on videos of unequal lengths (the shared frames
    count): the same keys, each within 1e-6 relative; with LPIPS weights an
    ``lpips`` entry too."""
    pred, target = _frames(1, (4, 40, 56, 3))
    want = JQ.evaluate_video(pred, target[:3])
    got = TQ.evaluate_video(pred, target[:3])
    assert got.keys() == want.keys() == {"psnr", "ssim", "delta_e"}
    for k in want:
        print(f"evaluate_video {k}: port {got[k]!r} jax {want[k]!r}")
        assert _rel(got[k], want[k]) <= 1e-6
    vgg, lins = _lpips_weights()
    got = TQ.evaluate_video(pred, target, lpips_params=TL.convert_lpips(vgg, lins, device="cpu"))
    want = JQ.evaluate_video(pred, target, lpips_params=JL.convert_lpips(vgg, lins))
    assert got.keys() == want.keys() and "lpips" in got
    assert _rel(got["lpips"], want["lpips"]) <= 1e-5


def _lpips_weights(seed=2):
    """Random torchvision VGG16 ``features`` weights (He-scaled) and
    non-negative lin heads, in the torch artifacts' layout and names."""
    rng = np.random.default_rng(seed)
    vgg, cin = {}, 3
    convs = [c for c in JL.VGG_CFG if c != "M"]
    for idx, cout in zip(JL.TORCHVISION_CONV_IDX, convs):
        vgg[f"features.{idx}.weight"] = (rng.normal(size=(cout, cin, 3, 3))
                                         * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        vgg[f"features.{idx}.bias"] = (0.01 * rng.normal(size=cout)).astype(np.float32)
        cin = cout
    lins = {f"lin{k}.model.1.weight": np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32)
            for k, c in enumerate(JL.TAP_CHANNELS)}
    return vgg, lins


def test_lpips_matches_jax(tmp_path):
    """LPIPS of two videos on random VGG weights: `lpips_video` within 1e-5
    relative of the JAX one, and the per-image distances too; the weights
    read from torch files (`load_lpips_params`, both lin-head namings)."""
    vgg, lins = _lpips_weights()
    pred, target = _frames(3, (2, 40, 48, 3))
    want = JL.lpips_video(JL.convert_lpips(vgg, lins), pred, target)
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, tmp_path / "vgg.pth")
    renamed = {f"lins.{k}.model.1.weight": v for k, v in enumerate(lins.values())}
    torch.save({k: torch.from_numpy(v) for k, v in renamed.items()}, tmp_path / "lins.pth")
    params = TL.load_lpips_params(str(tmp_path / "vgg.pth"), str(tmp_path / "lins.pth"),
                                  device="cpu")
    got = TL.lpips_video(params, pred, target)
    print(f"lpips_video: port {got!r} jax {want!r} (relative {_rel(got, want):.2e})")
    assert got > 0 and _rel(got, want) <= 1e-5
    a, b = pred.astype(np.float32) * 2 - 1, target.astype(np.float32) * 2 - 1
    d_t = TL.lpips_distance(TL.convert_lpips(vgg, lins, device="cpu"), torch.from_numpy(a),
                            torch.from_numpy(b)).numpy()
    d_j = np.asarray(JL.lpips_distance(JL.convert_lpips(vgg, lins), a, b))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5)
    assert TL.lpips_video(params, pred, pred) == 0.0
    with pytest.raises(KeyError, match="lin head 0"):
        TL.convert_lpips(vgg, {}, device="cpu")


def test_lpips_loaders_require_a_device():
    """`convert_lpips` and `load_lpips_params` take ``device`` as a keyword
    with no default: an entry point of the port does not fall back to the
    CPU."""
    with pytest.raises(TypeError):
        TL.convert_lpips({}, {})
    with pytest.raises(TypeError):
        TL.load_lpips_params("vgg.pth", "lins.pth")
    with pytest.raises(TypeError):
        TL.convert_lpips({}, {}, "cpu")
