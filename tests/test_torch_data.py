"""Port parity: the MiraData datasets and the batch stream
(tokensgen_tpu_torch/data/mira.py) against the JAX package's
(tokensgen_tpu/data/mira.py) on the same files and seeds: items, collate and
`batch_iterator` at ``num_workers=0`` bit-equal (the same stdlib generator,
the same cv2 decode), scene-detect sampling bit-equal, the CSV rows equal to
pandas' (ISO-8859-1, a non-ASCII caption, missing fields); the port's own
behaviour: the locked draws under a decode pool, an error raised through
the prefetch thread, and the empty-epoch ValueError (the JAX epoch loop
spins there)."""

import os
import sys
import threading

import numpy as np
import pandas as pd
import pytest

from tokensgen_tpu.data import mira as JM
from tokensgen_tpu.data.video_io import write_video
from tokensgen_tpu_torch.data import mira as TM

VIDEOS = {7: 100, 1003: 64, 2048: 20}  # index -> frames at 30 fps (2048: 6 at 10 fps)
CAPTIONS = {7: "a red kite", 1003: "un café, au coin", 2048: ""}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Three 30 fps mp4s of 48x80 in the sharded layout, a CSV in
    ISO-8859-1 (a quoted caption with a comma and an "é", an empty one) and
    a scene-detect file."""
    root = tmp_path_factory.mktemp("mira")
    rng = np.random.default_rng(0)
    for idx, n in VIDEOS.items():
        path = JM.mira_video_path(str(root / "videos"), idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_video(path, rng.uniform(0, 255, size=(n, 48, 80, 3)).astype(np.uint8), fps=30.0)
    csv = root / "videos.csv"
    with open(csv, "w", encoding="ISO-8859-1") as f:
        f.write("index,dense_caption,extra\n")
        for idx, cap in CAPTIONS.items():
            f.write(f'{idx},"{cap}",NA\n' if "," in cap else f"{idx},{cap},x\n")
    scenes = root / "scenes.txt"
    scenes.write_text("7 0,40|45,99\n1003 0,20\n2048 \n")
    return root


def _same_item(tds, jds, i):
    """Item ``i`` of both datasets equal, or both raising ValueError (a video
    too short for one chunk)."""
    try:
        want = jds[i]
    except ValueError:
        with pytest.raises(ValueError, match="too short"):
            tds[i]
        return
    _same(tds[i], want)


def _same(a, b):
    """Items or batches equal bit for bit (arrays by value and dtype)."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_csv_rows_match_pandas(layout):
    """`read_csv_rows` gives pandas' rows as text: the é kept, a missing
    field (NA) as "nan", as str() of pandas' NaN."""
    want = pd.read_csv(layout / "videos.csv", encoding="ISO-8859-1")
    rows = TM.read_csv_rows(str(layout / "videos.csv"))
    assert len(rows) == len(want)
    for i, row in enumerate(rows):
        assert {k: str(v) for k, v in want.iloc[i].items()} == row
    assert rows[1]["dense_caption"] == "un café, au coin" and rows[2]["dense_caption"] == "nan"


@pytest.mark.parametrize("kw", [
    dict(random_sample=True, random_flip=True),
    dict(random_sample=False, i_drop_rate=0.3, t_drop_rate=0.3, ti_drop_rate=0.3),
    dict(random_sample=True, use_frames_padding=True, max_num_chunks=3),
    dict(random_sample=True, index_range=(1, -1)),
], ids=["flip", "dropout", "padding", "index_range"])
def test_mira_items_bit_equal(layout, kw):
    """MiraDataset items of each row, twice over (the generator's state
    carries on), equal the JAX items: pixels, prompt, start frame, drop
    flag; a too-short video raises ValueError in both."""
    args = (str(layout / "videos.csv"), str(layout / "videos"))
    common = dict(height=32, width=48, sample_fps=10.0, chunk_size=9, seed=3)
    common.update(max_num_chunks=kw.pop("max_num_chunks", 2))
    jds, tds = JM.MiraDataset(*args, **common, **kw), TM.MiraDataset(*args, **common, **kw)
    assert len(jds) == len(tds)
    for _ in range(2):
        for i in range(len(tds)):
            _same_item(tds, jds, i)


def test_scene_detect_bit_equal(layout):
    """Scene-detect sampling: the parsed scenes and unqualified set, and the
    items (the scene pick by the window-start weights, unqualified rows
    replaced by random ones) equal the JAX ones."""
    args = (str(layout / "videos.csv"), str(layout / "videos"))
    kw = dict(height=32, width=48, sample_fps=10.0, chunk_size=9, max_num_chunks=1,
              use_scene_detect=True, scene_detect_file=str(layout / "scenes.txt"), seed=5)
    want = JM.parse_scene_detect_file(str(layout / "scenes.txt"), 27)
    assert TM.parse_scene_detect_file(str(layout / "scenes.txt"), 27) == want
    jds, tds = JM.MiraDataset(*args, **kw), TM.MiraDataset(*args, **kw)
    assert tds.unqualified_videos == jds.unqualified_videos
    for _ in range(3):
        for i in range(len(tds)):
            _same_item(tds, jds, i)


def _latent_dir(root, kind):
    rng = np.random.default_rng(1)
    for idx, chunks in ((7, 3), (1003, 1), (2048, 5)):
        shard = root / kind / f"{idx // 1000:09d}"
        shard.mkdir(parents=True, exist_ok=True)
        if kind == "latents":
            np.save(shard / f"{idx}_vae_c{chunks:02d}.npy",
                    rng.normal(size=(3 * chunks, 16, 4, 6)).astype(np.float16))
        else:
            np.save(shard / f"{idx}_vip.npy",
                    rng.normal(size=(4 * chunks, 8, 2, 3)).astype(np.float32))
    return str(root / kind)


@pytest.mark.parametrize("kind", ["latents", "tokens"])
def test_precomputed_datasets_bit_equal(layout, tmp_path, kind):
    """VAEMiraDataset (the port reads through the native reader) and
    VIPMiraDataset: padding to max_num_chunks, valid counts, caption
    dropout, each item and `load_many` equal to the JAX ones."""
    d = _latent_dir(tmp_path, kind)
    csv = str(layout / "videos.csv")
    if kind == "latents":
        kw = dict(max_num_chunks=4, nf_per_chunk=3, t_drop_rate=0.4, seed=2)
        jds, tds = JM.VAEMiraDataset(csv, d, **kw), TM.VAEMiraDataset(csv, d, **kw)
    else:
        kw = dict(max_num_chunks=4, t_drop_rate=0.4, seed=2)
        jds, tds = JM.VIPMiraDataset(csv, d, **kw), TM.VIPMiraDataset(csv, d, **kw)
    for i in range(len(tds)):
        _same(tds[i], jds[i])
    if kind == "latents":
        for a, b in zip(tds.load_many([2, 0, 1]), jds.load_many([2, 0, 1])):
            _same(a, b)
        assert [it["valid_num_chunks"] for it in tds.load_many([0, 1, 2])] == [3, 1, 4]


@pytest.mark.parametrize("shuffle,drop_last,shards", [(True, True, 1), (False, False, 1),
                                                     (True, False, 2)])
def test_batch_iterator_bit_equal(layout, tmp_path, shuffle, drop_last, shards):
    """collate and batch_iterator at num_workers=0 (with and without the
    prefetch thread, host shards): the same batches in the same order as
    the JAX stream, the too-short video skipped in both."""
    args = (str(layout / "videos.csv"), str(layout / "videos"))
    kw = dict(height=32, width=48, sample_fps=10.0, chunk_size=9, max_num_chunks=2, seed=4)
    for prefetch in (0, 2):
        total = 0
        for shard in range(shards):
            it_kw = dict(shuffle=shuffle, seed=11, drop_last=drop_last, num_shards=shards,
                         shard_index=shard, prefetch=prefetch)
            want = list(JM.batch_iterator(JM.MiraDataset(*args, **kw), 1, **it_kw))
            got = list(TM.batch_iterator(TM.MiraDataset(*args, **kw), 1, **it_kw))
            assert len(got) == len(want)
            total += len(got)
            for a, b in zip(got, want):
                _same(a, b)
        assert total == 2  # the 6-frame video skipped
    d = _latent_dir(tmp_path, "latents")
    vkw = dict(max_num_chunks=5, nf_per_chunk=3, seed=1)
    want = list(JM.batch_iterator(JM.VAEMiraDataset(str(layout / "videos.csv"), d, **vkw), 2,
                                  seed=3, drop_last=drop_last))
    got = list(TM.batch_iterator(TM.VAEMiraDataset(str(layout / "videos.csv"), d, **vkw), 2,
                                 seed=3, drop_last=drop_last))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)


def test_webvideo_items_bit_equal(tmp_path):
    """WebVideoDataset: frames, depth and motion of a row with all three,
    and the random re-draw for rows missing them, equal the JAX items."""
    import cv2

    rng = np.random.default_rng(2)
    for vid in ("11", "12"):
        for kind in ("frames", "depth"):
            d = tmp_path / kind / vid
            d.mkdir(parents=True)
            for n in range(5):
                img = rng.integers(0, 255, size=(30, 40, 3), dtype=np.uint8)
                cv2.imwrite(str(d / f"{vid}_{n}.jpg"), img)
        if vid == "11":  # 12 has no motion file: re-drawn
            (tmp_path / "motion" / vid).mkdir(parents=True)
            (tmp_path / "motion" / vid / f"{vid}_average_motion.txt").write_text("0.25\n")
    (tmp_path / "web.csv").write_text("videoid,name\n11,a cat\n12,a dog\n")
    kw = dict(depth_dir=str(tmp_path / "depth"), motion_dir=str(tmp_path / "motion"),
              sample_size=24, sample_n_frames=4, seed=6)
    args = (str(tmp_path / "web.csv"), str(tmp_path / "frames"))
    jds, tds = JM.WebVideoDataset(*args, **kw), TM.WebVideoDataset(*args, **kw)
    for _ in range(2):
        for i in range(2):
            _same(tds[i], jds[i])


class _Slow:
    """A dataset whose items each draw twice from a shared `_Draws` around a
    sleep, so that a decode pool's threads interleave their draws."""

    def __init__(self, n, seed):
        self.n, self.rng = n, TM._Draws(seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import time

        a = self.rng.randint(0, 1 << 30)
        time.sleep(0.001)
        return {"i": i, "draws": np.array([a, self.rng.randint(0, 1 << 30)])}


def test_locked_draws_under_a_decode_pool():
    """16 decode threads (more than this host's cores), a short switch
    interval: every item arrives once, in order, and the pool's draws are
    exactly the generator's sequence (none lost or repeated by a torn
    compound draw), though which item got which depends on the timing."""
    import random

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ds = _Slow(64, seed=9)
        batches = list(TM.batch_iterator(ds, 4, shuffle=False, num_workers=16))
    finally:
        sys.setswitchinterval(old)
    items = np.concatenate([b["i"] for b in batches])
    draws = np.concatenate([b["draws"].reshape(-1) for b in batches])
    ref = random.Random(9)
    assert items.tolist() == list(range(64))
    assert sorted(draws.tolist()) == sorted(ref.randint(0, 1 << 30) for _ in range(128))


def test_errors_reach_the_consumer_and_close_stops_the_thread(layout):
    """An error in the prefetch thread is raised to the consumer (the JAX
    stream ends silently); closing a stream stops its thread."""
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError(f"item {i} broke")

    with pytest.raises(RuntimeError, match="broke"):
        list(TM.batch_iterator(Broken(), 2))
    ds = TM.MiraDataset(str(layout / "videos.csv"), str(layout / "videos"), height=32, width=48,
                        chunk_size=9, seed=1)
    before = {t.ident for t in threading.enumerate()}
    it = TM.batch_iterator(ds, 1, num_workers=2)
    next(it)
    it.close()
    left = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
    assert not left, left


@pytest.mark.parametrize("case", ["short", "all_fail"])
def test_empty_epoch_raises(layout, case):
    """An epoch that yields no batch (the dataset shorter than one batch
    under drop_last, or every item failing) raises ValueError naming the
    sizes instead of spinning (the JAX CLIs' epoch loops spin)."""
    args = (str(layout / "videos.csv"), str(layout / "videos"))
    if case == "short":
        ds, b = TM.MiraDataset(*args, height=32, width=48, chunk_size=9, seed=1), 8
    else:  # every video shorter than one chunk of 90 frames
        ds, b = TM.MiraDataset(*args, height=32, width=48, chunk_size=90, seed=1), 1
    with pytest.raises(ValueError, match=f"3 items over 1 host shard.*batch size {b}"):
        next(TM.epoch_batches(ds, b, seed=0))
