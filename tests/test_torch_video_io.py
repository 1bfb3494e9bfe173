"""Port parity: the video loader and writer (`tokensgen_tpu_torch/data/
video_io.py`) and the resolution transforms (`data/transforms.py`) against
the JAX package's (`tokensgen_tpu/data/video_io.py`, `data/transforms.py`),
on mp4s that the JAX package's `write_video` writes: fps resampling, time
window, crop and pad, bit-equal; the port's `write_video` read back by the
JAX `read_frames`, bit-equal."""

import sys

import numpy as np
import pytest

from tokensgen_tpu.data import transforms as JT
from tokensgen_tpu.data import video_io as JV
from tokensgen_tpu_torch.data import transforms as TT
from tokensgen_tpu_torch.data import video_io as TV


def _frames(n=30, h=36, w=52, seed=0):
    """A smooth moving pattern with some noise, float in [-1, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    f = [np.stack([np.sin((x + 2 * t) / 7.0), np.cos((y - t) / 5.0),
                   np.sin((x + y + 3 * t) / 11.0)], -1) for t in range(n)]
    return np.clip(np.stack(f) * 0.8 + rng.normal(scale=0.05, size=(n, h, w, 3)), -1, 1
                   ).astype(np.float32)


@pytest.fixture(scope="module")
def mp4(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("video") / "src.mp4")
    JV.write_video(path, _frames(), fps=20)
    return path


@pytest.mark.parametrize("kw", [
    dict(sample_fps=10, output_res=(32, 48)),  # every other frame, crop
    dict(sample_fps=7, start_t=0.3, end_t=1.2, output_res=(32, 48)),  # window, fractional step
    dict(sample_fps=20, output_res=(24, 24), max_frames=9),  # crop to square
    dict(sample_fps=10, output_res=(64, 48), pad_to_fit=True),  # pad, upscale
    dict(sample_fps=13, output_res=(30, 60), crop_to_fit=False),  # fit inside + pad
])
def test_load_video_matches_jax(mp4, kw):
    ref = JV.load_video(mp4, **kw)
    got = TV.load_video(mp4, **kw)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert got.shape[2:4] == kw["output_res"] and got.min() >= -1 and got.max() <= 1
    np.testing.assert_array_equal(got, ref)


def test_metadata_and_read_frames_match_jax(mp4):
    assert TV.video_metadata(mp4) == JV.video_metadata(mp4) == (30, 20.0)
    np.testing.assert_array_equal(TV.read_frames(mp4), JV.read_frames(mp4))
    idx = np.array([0, 3, 3, 17, 29, 40])  # repeats and past the end
    got = TV.read_frames(mp4, idx)
    assert got.shape[0] == 5
    np.testing.assert_array_equal(got, JV.read_frames(mp4, idx))


def test_write_video_read_back_by_jax(tmp_path):
    """The port writes the same file the JAX package writes (float in
    [-1, 1], in [0, 1], and uint8), and JAX decodes it to the same frames."""
    frames = _frames(n=12, h=32, w=48, seed=1)
    for video in (frames, (frames + 1) / 2, ((frames + 1) * 127.5).astype(np.uint8)):
        tp, jp = str(tmp_path / "t.mp4"), str(tmp_path / "j.mp4")
        TV.write_video(tp, video, fps=10)
        JV.write_video(jp, video, fps=10)
        got = JV.read_frames(tp)
        assert got.shape == (12, 32, 48, 3)
        np.testing.assert_array_equal(got, JV.read_frames(jp))
        # a lossy codec, but close to what was written
        assert np.abs(got - (frames + 1) * 127.5).mean() < 12


def test_save_videos_grid_matches_jax(tmp_path):
    videos = np.stack([_frames(n=6, h=16, w=24, seed=s) for s in range(5)])
    tp, jp = str(tmp_path / "t.mp4"), str(tmp_path / "j.mp4")
    TV.save_videos_grid(tp, videos, fps=8)
    JV.save_videos_grid(jp, videos, fps=8)
    got = JV.read_frames(tp)
    assert got.shape == (6, 32, 72, 3)  # 2 rows x 3 columns, the last tile blank
    np.testing.assert_array_equal(got, JV.read_frames(jp))


@pytest.mark.parametrize("target,pad,crop", [((32, 48), False, True), ((64, 40), True, True),
                                             ((40, 40), False, False), ((20, 90), True, False)])
def test_resolution_control_and_inverse_match_jax(target, pad, crop):
    frames = ((_frames(n=4, h=36, w=52) + 1) * 127.5).astype(np.uint8)
    jrc, trc = (m.ResolutionControl(target, pad_to_fit=pad, crop_to_fit=crop) for m in (JT, TT))
    fwd = trc(frames)
    np.testing.assert_array_equal(fwd, jrc(frames))
    assert fwd.shape == (4, *target, 3)
    inv = trc.inverse(fwd)
    np.testing.assert_array_equal(inv, jrc.inverse(fwd))
    assert inv.shape == frames.shape
    np.testing.assert_array_equal(TT.resize_for_rectangle_crop(frames, target),
                                  JT.resize_for_rectangle_crop(frames, target))


def test_missing_cv2_raises_import_error(mp4, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        TV.load_video(mp4)
    with pytest.raises(ImportError, match="cv2"):
        TV.write_video("unused.mp4", np.zeros((1, 8, 8, 3), np.uint8))
