"""MiraData-style training datasets, host-side numpy (port of
`tokensgen_tpu/data/mira.py`).

* `MiraDataset`: CSV (``index``, ``dense_caption``) over the sharded
  ``<dir>/<index//1000:09d>/<index>.mp4`` layout: fps resampling to
  ``sample_fps``, a random temporal window and its compressed-frame
  ``start_frame_idx``, a center rectangle crop, optional scene-detect
  segment sampling, padding to ``max_num_chunks`` with ``valid_num_chunks``,
  CFG dropout of image / text / both;
* `VAEMiraDataset`: precomputed VAE latents (``<index>_vae_c<NN>.npy``,
  `calculate_vae_latents`), zero-padded to ``max_num_chunks``, read in
  batches through the native reader (`data/native_store.py`);
* `VIPMiraDataset`: precomputed condensed tokens (``<index>_vip.npy``);
* `WebVideoDataset`: the WebVid10M frames / depth / motion layout.

Items are numpy dicts; `batch_iterator` shuffles, shards, collates and
prefetches on a thread, optionally decoding on a thread pool.

The CSVs are read with the stdlib `csv` module in ISO-8859-1 (the JAX
package reads them with pandas, which the card's machine lacks): every
field is text, and a field pandas reads as missing (empty, ``NaN``, ``NA``,
...) comes back as ``"nan"``, as ``str()`` of pandas' NaN does. Each item
draws from one `random.Random(seed)`, the JAX package's generator, so with
``num_workers=0`` items and batches equal the JAX ones bit for bit. With a
decode pool several threads draw from that generator; a lock makes each
draw whole (the JAX package draws without one), though which item gets
which draw still depends on the threads' timing.
"""

from __future__ import annotations

import csv
import os
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tokensgen_tpu_torch.data.transforms import import_cv2, resize_for_rectangle_crop
from tokensgen_tpu_torch.data.video_io import read_frames, video_metadata

# what pandas.read_csv reads as a missing value by default
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
# what an item's decode may raise for one bad row: the loader skips that row
ITEM_ERRORS = (IOError, ValueError, FileNotFoundError)


def read_csv_rows(path: str, encoding: str = "ISO-8859-1") -> List[Dict[str, str]]:
    """The CSV's rows as dicts of text keyed by the header."""
    with open(path, newline="", encoding=encoding) as f:
        return [{k: ("nan" if v is None or v in _NA_STRINGS else v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def mira_video_path(video_dir: str, index: int) -> str:
    return os.path.join(video_dir, f"{index // 1000:09d}", f"{index}.mp4")


def parse_scene_detect_file(path: str, min_native_frames: float):
    """``(scenes: {name: [(start, end), ...]}, unqualified: set)`` from a
    scene-detect file: a line is ``<video_name> <start,end>|<start,end>|...``
    in native frames; scenes of ``min_native_frames`` or fewer are dropped,
    and a video with none left is unqualified."""
    scenes: Dict[str, List[Tuple[int, int]]] = {}
    unqualified = set()
    with open(path, "r") as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) > 1 and len(parts[1].strip()) != 0:
                name, segs = parts[0], parts[1]
                qualified = []
                for seg in segs.strip().split("|"):
                    start, end = seg.split(",")
                    if int(end) - int(start) > min_native_frames:
                        qualified.append((int(start), int(end)))
                if qualified:
                    scenes[name] = qualified
                else:
                    unqualified.add(name)
    return scenes, unqualified


class _Draws:
    """A `random.Random(seed)` whose draws each hold a lock."""

    def __init__(self, seed: Optional[int]):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def random(self) -> float:
        with self._lock:
            return self._rng.random()

    def randint(self, a: int, b: int) -> int:
        with self._lock:
            return self._rng.randint(a, b)

    def randrange(self, n: int) -> int:
        with self._lock:
            return self._rng.randrange(n)


class MiraDataset:
    def __init__(
        self,
        csv_file: str,
        video_dir: str,
        height: int = 480,
        width: int = 720,
        sample_fps: float = 10.0,
        chunk_size: int = 49,
        max_num_chunks: int = 2,
        random_sample: bool = True,
        random_flip: bool = False,
        index_range: Optional[Tuple[int, int]] = None,
        i_drop_rate: float = 0.05,
        t_drop_rate: float = 0.05,
        ti_drop_rate: float = 0.05,
        use_frames_padding: bool = False,
        use_scene_detect: bool = False,
        scene_detect_file: Optional[str] = None,
        seed: Optional[int] = None,
    ):
        self.video_dir = video_dir
        self.height, self.width = height, width
        self.sample_fps = sample_fps
        self.chunk_size = chunk_size
        self.max_num_chunks = max_num_chunks
        self.random_sample = random_sample
        self.random_flip = random_flip
        self.i_drop_rate = i_drop_rate
        self.t_drop_rate = t_drop_rate
        self.ti_drop_rate = ti_drop_rate
        self.use_frames_padding = use_frames_padding
        self.rng = _Draws(seed)

        rows = read_csv_rows(csv_file)
        if index_range is not None:
            lo = 0 if index_range[0] == -1 else index_range[0]
            hi = len(rows) if index_range[1] == -1 else index_range[1]
            rows = rows[lo:hi]
        self.rows = rows

        self.use_scene_detect = use_scene_detect
        self.scene_detect: Dict[str, List[Tuple[int, int]]] = {}
        self.unqualified_videos: set = set()
        if use_scene_detect:
            # qualification threshold in native frames, assuming a ~30 fps source
            min_native = self.max_num_chunks * self.chunk_size / self.sample_fps * 30
            self.scene_detect, self.unqualified_videos = parse_scene_detect_file(
                scene_detect_file, min_native)

    def __len__(self) -> int:
        return len(self.rows)

    def _scene_sample_idx(self, scenes, fps: float, want: int) -> Optional[np.ndarray]:
        """One qualifying scene (chosen with probability proportional to its
        count of window starts) as its fps-resampled native-frame grid; None
        when no scene holds a full window."""
        grids, n_starts = [], []
        for start_f, end_f in scenes:
            num_f = int((end_f - start_f) / fps * self.sample_fps)
            grid = np.linspace(start_f, end_f, num_f, endpoint=False).astype(np.int64)
            if len(grid) < want:
                continue  # a malformed scene file: drop the short scene
            grids.append(grid)
            n_starts.append(num_f - want + 1)
        if not grids:
            return None
        cum = np.cumsum([0] + n_starts, dtype=np.float64)
        cum /= max(1.0, cum[-1])
        pick = 0
        if self.random_sample:
            pick = int(np.searchsorted(cum, self.rng.random(), side="right")) - 1
        return grids[pick]

    def __getitem__(self, i: int) -> Dict:
        # scene-detect-unqualified videos are skipped: a random row instead
        sample_idx = None
        while True:
            if self.use_scene_detect and len(self.unqualified_videos) >= len(self.rows):
                raise RuntimeError("every video is scene-detect-unqualified")
            while self.use_scene_detect and self.rows[i]["index"] in self.unqualified_videos:
                i = self.rng.randint(0, len(self.rows) - 1)
            row = self.rows[i]
            path = mira_video_path(self.video_dir, int(row["index"]))
            n, fps = video_metadata(path)
            want = self.chunk_size * self.max_num_chunks

            scenes = self.scene_detect.get(row["index"]) if self.use_scene_detect else None
            if scenes:
                sample_idx = self._scene_sample_idx(scenes, fps, want)
                if sample_idx is None:
                    # no scene fits a full window: skip the row like an unqualified one
                    self.unqualified_videos.add(row["index"])
                    continue
            else:
                num_f = int(n / fps * self.sample_fps)
                sample_idx = np.linspace(0, n, num_f, endpoint=False).astype(np.int64)
            break

        start_idx = 0
        if self.random_sample and len(sample_idx) > want:
            start_idx = self.rng.randint(0, len(sample_idx) - want)
            sample_idx = sample_idx[start_idx:]

        # the window's first frame in compressed (latent) frames
        ccs = (self.chunk_size - 1) // 4 + 1
        compressed_start = (
            start_idx // self.chunk_size * ccs
            + int((start_idx % self.chunk_size) / float(self.chunk_size - 1) * (ccs - 1)))

        num_chunks = min(len(sample_idx) // self.chunk_size, self.max_num_chunks)
        if num_chunks == 0:
            raise ValueError(f"video too short: {path}")
        sample_idx = sample_idx[: num_chunks * self.chunk_size]

        frames = read_frames(path, sample_idx)  # [F, H, W, 3] uint8
        frames = resize_for_rectangle_crop(frames.astype(np.float32) / 255.0,
                                           (self.height, self.width))
        pixel_values = frames * 2.0 - 1.0
        if self.random_flip and self.rng.random() < 0.5:
            pixel_values = pixel_values[:, :, ::-1]

        valid_num_chunks = num_chunks
        if self.use_frames_padding and num_chunks < self.max_num_chunks:
            pad = np.repeat(pixel_values[-1:],
                            self.chunk_size * (self.max_num_chunks - num_chunks), axis=0)
            pixel_values = np.concatenate([pixel_values, pad], axis=0)

        prompt = row["dense_caption"]
        drop_image_embed = 0
        r = self.rng.random()
        if r < self.i_drop_rate:
            drop_image_embed = 1
        elif r < self.i_drop_rate + self.t_drop_rate:
            prompt = ""
        elif r < self.i_drop_rate + self.t_drop_rate + self.ti_drop_rate:
            prompt = ""
            drop_image_embed = 1

        out = {
            "pixel_values": np.ascontiguousarray(pixel_values, dtype=np.float32),
            "prompt": prompt,
            "start_frame_idx": compressed_start,
            "video_index": int(row["index"]),
            "drop_image_embed": drop_image_embed,
        }
        if self.use_frames_padding:
            out["valid_num_chunks"] = valid_num_chunks
        return out


def _pad_chunks(x: np.ndarray, per_chunk: int, max_chunks: int) -> Tuple[np.ndarray, int]:
    """``x`` [per_chunk * chunks, ...] cut or zero-padded to ``max_chunks``
    chunks, and its count of valid chunks."""
    valid = min(x.shape[0] // per_chunk, max_chunks)
    x = x[: valid * per_chunk]
    if valid < max_chunks:
        pad = np.zeros(((max_chunks - valid) * per_chunk,) + x.shape[1:], x.dtype)
        x = np.concatenate([x, pad], axis=0)
    return x, valid


class VAEMiraDataset:
    """Precomputed VAE latents ``<latent_dir>/<shard>/<index>_vae_c<NN>.npy``
    [13 * chunks, 16, 60, 90], zero-padded to ``max_num_chunks``."""

    def __init__(self, csv_file: str, latent_dir: str, max_num_chunks: int = 24,
                 nf_per_chunk: int = 13, t_drop_rate: float = 0.05,
                 seed: Optional[int] = None):
        self.latent_dir = latent_dir
        self.max_num_chunks = max_num_chunks
        self.nf_per_chunk = nf_per_chunk
        self.t_drop_rate = t_drop_rate
        self.rng = _Draws(seed)
        self.rows = read_csv_rows(csv_file)

    def __len__(self) -> int:
        return len(self.rows)

    def _latent_path(self, index: int) -> str:
        shard = os.path.join(self.latent_dir, f"{index // 1000:09d}")
        for name in os.listdir(shard):
            if name.startswith(f"{index}_vae_c"):
                return os.path.join(shard, name)
        raise FileNotFoundError(f"no latents for video {index} in {shard}")

    def load_many(self, idxs: Sequence[int]) -> List[Dict]:
        """The items of ``idxs``, their files read together by the native
        reader's thread pool."""
        from tokensgen_tpu_torch.data.native_store import load_npy_batch

        paths = [self._latent_path(int(self.rows[i]["index"])) for i in idxs]
        return [self._make_item(i, lat) for i, lat in zip(idxs, load_npy_batch(paths))]

    def __getitem__(self, i: int) -> Dict:
        return self.load_many([i])[0]

    def _make_item(self, i: int, lat: np.ndarray) -> Dict:
        row = self.rows[i]
        lat, valid = _pad_chunks(lat, self.nf_per_chunk, self.max_num_chunks)
        prompt = row["dense_caption"]
        if self.rng.random() < self.t_drop_rate:
            prompt = ""
        return {
            "vae_latents": lat.astype(np.float32),
            "prompt": prompt,
            "valid_num_chunks": valid,
            "video_index": int(row["index"]),
        }


class VIPMiraDataset:
    """Precomputed condensed tokens ``<token_dir>/<shard>/<index>_vip.npy``
    [4 * chunks, 3072, 8, 12]; the same padding and caption dropout."""

    def __init__(self, csv_file: str, token_dir: str, max_num_chunks: int = 24,
                 tokens_per_chunk: int = 4, t_drop_rate: float = 0.05,
                 seed: Optional[int] = None):
        self.token_dir = token_dir
        self.max_num_chunks = max_num_chunks
        self.tokens_per_chunk = tokens_per_chunk
        self.t_drop_rate = t_drop_rate
        self.rng = _Draws(seed)
        self.rows = read_csv_rows(csv_file)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> Dict:
        row = self.rows[i]
        index = int(row["index"])
        path = os.path.join(self.token_dir, f"{index // 1000:09d}", f"{index}_vip.npy")
        toks, valid = _pad_chunks(np.load(path), self.tokens_per_chunk, self.max_num_chunks)
        prompt = row["dense_caption"]
        if self.rng.random() < self.t_drop_rate:
            prompt = ""
        return {
            "vip_tokens": toks.astype(np.float32),
            "prompt": prompt,
            "valid_num_chunks": valid,
            "video_index": index,
        }


class WebVideoDataset:
    """WebVid10M preprocessed frames: per CSV row (``videoid``, ``name``),
    RGB frames ``<video_dir>/<videoid>/*_<n>.jpg`` (sorted by the number
    after the last ``_``, the first ``sample_n_frames`` kept), depth frames
    in the same layout under ``depth_dir``, and a motion value in
    ``<motion_dir>/<videoid>/<videoid>_average_motion.txt``; a row missing
    any of them, or short of frames, is replaced by a random row. Frames
    come back center-cropped, resized to ``sample_size`` and in [-1, 1]."""

    def __init__(self, csv_file: str, video_dir: str, depth_dir: Optional[str] = None,
                 motion_dir: Optional[str] = None, sample_size: int = 256,
                 sample_n_frames: int = 14, seed: int = 0):
        self.video_dir = video_dir
        self.depth_dir = depth_dir or video_dir
        self.motion_dir = motion_dir or video_dir
        self.sample_size = ((sample_size, sample_size)
                            if isinstance(sample_size, int) else tuple(sample_size))
        self.sample_n_frames = sample_n_frames
        self.rows = read_csv_rows(csv_file, encoding="utf-8")
        self.rng = _Draws(seed)

    def __len__(self) -> int:
        return len(self.rows)

    @staticmethod
    def _frame_no(name: str) -> int:
        return int(name.rsplit("_", 1)[1].split(".")[0])

    def _load_frames(self, folder: str) -> np.ndarray:
        cv2 = import_cv2()
        names = sorted(os.listdir(folder), key=self._frame_no)[:self.sample_n_frames]
        frames = []
        for n in names:
            img = cv2.imread(os.path.join(folder, n), cv2.IMREAD_COLOR)
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        return np.stack(frames)  # [F, H, W, 3] uint8

    def _crop_resize(self, frames: np.ndarray) -> np.ndarray:
        cv2 = import_cv2()
        f, h, w, _ = frames.shape
        m = min(h, w)
        top, left = (h - m) // 2, (w - m) // 2
        frames = frames[:, top:top + m, left:left + m]
        th, tw = self.sample_size
        if (m, m) != (th, tw):
            frames = np.stack([cv2.resize(fr, (tw, th), interpolation=cv2.INTER_LINEAR)
                               for fr in frames])
        return frames

    def __getitem__(self, idx: int) -> Dict:
        for _ in range(8 * len(self.rows) + 8):
            row = self.rows[idx]
            vid = row["videoid"]
            frame_dir = os.path.join(self.video_dir, vid)
            depth_dir = os.path.join(self.depth_dir, vid)
            motion_file = os.path.join(self.motion_dir, vid, f"{vid}_average_motion.txt")
            ok = (os.path.isdir(frame_dir) and os.path.isdir(depth_dir)
                  and os.path.isfile(motion_file)
                  and len(os.listdir(frame_dir)) >= self.sample_n_frames
                  and len(os.listdir(depth_dir)) >= self.sample_n_frames)
            if ok:
                break
            idx = self.rng.randrange(len(self.rows))
        else:
            raise RuntimeError("no qualified WebVid item found")

        px = self._crop_resize(self._load_frames(frame_dir))
        depth = self._crop_resize(self._load_frames(depth_dir))
        with open(motion_file) as fh:
            motion = float(fh.read().strip())

        def to_chw(x):
            return (x.transpose(0, 3, 1, 2).astype(np.float32) / 255.0 - 0.5) / 0.5

        return {
            "pixel_values": to_chw(px),  # [F, 3, H, W] in [-1, 1]
            "depth_pixel_values": to_chw(depth),
            "motion_values": motion,
            "caption": row.get("name", ""),
            "videoid": vid,
        }


def collate(items: Sequence[Dict]) -> Dict:
    out: Dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def _batches(dataset, order: List[int], batch_size: int, drop_last: bool,
             num_workers: int) -> Iterator[Dict]:
    """Collated batches over ``order``; an item that raises one of
    `ITEM_ERRORS` is skipped."""
    if hasattr(dataset, "load_many"):
        for lo in range(0, len(order), batch_size):
            idxs = order[lo:lo + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            try:
                items = dataset.load_many(idxs)
            except ITEM_ERRORS:
                continue
            yield collate(items)
        return

    def try_get(i):
        try:
            return dataset[i]
        except ITEM_ERRORS:
            return None

    batch = []
    if num_workers > 0:
        # a decode pool with a bounded window in flight (cv2's decode and
        # resize release the interpreter lock)
        with ThreadPoolExecutor(num_workers) as ex:
            it = iter(order)
            inflight = deque()

            def submit_next():
                i = next(it, None)
                if i is not None:
                    inflight.append(ex.submit(try_get, i))

            for _ in range(max(num_workers + 1, batch_size)):
                submit_next()
            try:
                while inflight:
                    item = inflight.popleft().result()
                    submit_next()
                    if item is None:
                        continue
                    batch.append(item)
                    if len(batch) == batch_size:
                        yield collate(batch)
                        batch = []
            finally:
                for fut in inflight:  # an abandoned stream decodes no further
                    fut.cancel()
    else:
        for i in order:
            item = try_get(i)
            if item is None:
                continue
            batch.append(item)
            if len(batch) == batch_size:
                yield collate(batch)
                batch = []
    if batch and not drop_last:
        yield collate(batch)


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, num_shards: int = 1, shard_index: int = 0,
                   prefetch: int = 2, num_workers: int = 0, slot: int = 0,
                   slots: int = 1) -> Iterator[Dict]:
    """One epoch of collated batches: the order shuffled by
    ``random.Random(seed)``, this host's ``shard_index``-th of
    ``num_shards`` strided shares of it, items that fail to decode skipped.
    With ``slots`` > 1 (the data-parallel ranks of one host) the host's
    share is cut into batches of ``batch_size * slots`` and this rank reads
    positions ``[slot * batch_size, (slot + 1) * batch_size)`` of each (an
    incomplete last one dropped under ``drop_last``).
    ``num_workers`` > 0 maps ``dataset[i]`` on a thread pool; a dataset with
    ``load_many`` reads each batch in one call. With ``prefetch`` > 0 a
    thread makes up to that many batches ahead; an error there is raised to
    the consumer, and closing the iterator stops the thread."""
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed).shuffle(order)
    order = order[shard_index::num_shards]
    if slots > 1:
        width = batch_size * slots
        if drop_last:
            order = order[:len(order) - len(order) % width]
        order = [i for lo in range(0, len(order), width)
                 for i in order[lo + slot * batch_size:lo + (slot + 1) * batch_size]]
    gen = _batches(dataset, order, batch_size, drop_last, num_workers)
    if prefetch <= 0:
        yield from gen
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            gen.close()

    t = threading.Thread(target=worker, daemon=True, name="batch_iterator")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=60)


def epoch_batches(dataset, batch_size: int, seed: int, **kwargs) -> Iterator[Dict]:
    """`batch_iterator` over epoch after epoch, epoch ``e`` shuffled with
    ``seed + e``. Raises ValueError when an epoch yields no batch (the
    dataset, or this host's share of it, is shorter than one batch under
    ``drop_last``, or every item failed): the loop would spin forever."""
    epoch = 0
    while True:
        n = 0
        for batch in batch_iterator(dataset, batch_size, seed=seed + epoch, **kwargs):
            n += 1
            yield batch
        if n == 0:
            shards = kwargs.get("num_shards", 1)
            raise ValueError(
                f"epoch {epoch} yielded no batch: {len(dataset)} items over {shards} "
                f"host shard(s), batch size {batch_size}, drop_last "
                f"{kwargs.get('drop_last', True)} (a share shorter than one batch, or every "
                f"item failed to load)")
        epoch += 1
