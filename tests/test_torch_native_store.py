"""The port's native latent-store reader (tokensgen_tpu_torch/data/
native_store.py, csrc/latent_store.cpp, built with g++ at first use): the
arrays it reads are bytes equal to `np.load` (the plain reader beside it)
over dtypes, shapes, Fortran order and empty files, for files the JAX
package's reader reads too; a missing file raises, a failed build raises
with the compiler's output (no fallback)."""

import os

import numpy as np
import pytest

from tokensgen_tpu.data import native_store as JN
from tokensgen_tpu_torch.data import native_store as TN


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(26, 16, 6, 9)).astype(np.float16),
              rng.normal(size=(3, 5)).astype(np.float32),
              np.asfortranarray(rng.integers(0, 255, size=(7, 4), dtype=np.uint8)),
              np.zeros((0, 3), np.float64),
              rng.normal(size=(100_003,)).astype(np.float32)]
    paths = []
    for i, a in enumerate(arrays):
        p = str(root / f"a{i}.npy")
        np.save(p, a)
        paths.append(p)
    return paths


def test_reads_equal_np_load(files):
    """Each array: dtype, shape, order and bytes equal to np.load (and to
    the JAX package's reader), read on 1 and 8 threads."""
    plain = TN.load_npy_plain(files)
    for threads in (1, 8):
        got = TN.load_npy_batch(files, n_threads=threads)
        for g, p in zip(got, plain):
            assert g.dtype == p.dtype and g.shape == p.shape
            assert g.flags.f_contiguous == p.flags.f_contiguous
            assert g.tobytes(order="A") == p.tobytes(order="A")
    for g, j in zip(TN.load_npy_batch(files), JN.load_npy_batch(files)):
        assert g.tobytes(order="A") == np.asarray(j).tobytes(order="A")
    raw = TN.read_files_batch(files)
    assert [len(b) for b in raw] == [os.path.getsize(p) for p in files]
    assert TN.native_library().ls_version() == TN.ABI_VERSION


def test_missing_file_raises(files, tmp_path):
    with pytest.raises(FileNotFoundError, match="absent.npy"):
        TN.load_npy_batch([files[0], str(tmp_path / "absent.npy")])
    assert TN.load_npy_batch([]) == []


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError holding g++'s
    error; nothing falls back to Python."""
    bad = tmp_path / "latent_store.cpp"
    bad.write_text("int ls_version() { return undefined_name; }\n")
    monkeypatch.setattr(TN, "SOURCE", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN._Native, "lib", None)
    with pytest.raises(RuntimeError, match="undefined_name"):
        TN.build()
    with pytest.raises(RuntimeError, match="undefined_name"):
        TN.load_npy_batch([str(bad)])
