"""Port parity: the port's safetensors reader and writer
(`tokensgen_tpu_torch/convert/safetensors_io.py`) against the JAX package's
(`tokensgen_tpu/convert/safetensors_io.py`), on files that each side writes,
bit-equal; and the "/"-joined param-tree layout against the JAX package's
flax round trip, bit-equal."""

import numpy as np
import pytest
import torch

from tokensgen_tpu.convert import safetensors_io as J
from tokensgen_tpu_torch.convert import safetensors_io as T

DTYPES = (np.float32, np.float16, np.int8, np.uint8, np.bool_, np.int64)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (3, 5, 2) if i % 2 else (7, 4)
        if dt == np.bool_:
            out[f"t{i}"] = rng.random(shape) > 0.5
        elif np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            out[f"t{i}"] = rng.integers(info.min, info.max, size=shape, dtype=dt,
                                        endpoint=True)
        else:
            out[f"t{i}"] = rng.normal(size=shape).astype(dt)
    out["empty"] = np.zeros((0, 3), np.float32)
    return out


def _same(got: torch.Tensor, want: np.ndarray):
    """Bit-equal: same dtype, shape and bytes."""
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape
    assert g.tobytes() == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reader_matches_jax(tmp_path, writer):
    """F32, F16, I8, U8, BOOL, I64 (and an empty tensor): the port reads what
    either side wrote as the JAX reader does, bit for bit."""
    arrays = _arrays()
    path = str(tmp_path / "x.safetensors")
    (J.save_safetensors if writer == "jax" else T.save_safetensors)(path, arrays)
    ref = J.load_safetensors(path)
    got = T.load_safetensors(path)
    assert list(got) == list(ref) == list(arrays)
    for name, arr in arrays.items():
        _same(got[name], ref[name])
        _same(got[name], arr)


def test_bf16_stays_bf16_and_upcasts_like_jax(tmp_path):
    """BF16 (written by the port from a torch tensor): the port keeps it
    bf16; its exact f32 upcast equals the JAX reader's f32, bit for bit."""
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(6, 9, generator=gen) * 100).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("inf"), -0.0, 1e-40, -3.0e38]).to(torch.bfloat16)
    path = str(tmp_path / "bf16.safetensors")
    T.save_safetensors(path, {"w": x, "f": np.arange(5, dtype=np.float32)})
    got = T.load_safetensors(path)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
    ref = J.load_safetensors(path)
    _same(got["w"].float(), ref["w"])
    _same(got["f"], ref["f"])


def test_reader_maps_the_file(tmp_path):
    """Tensors are views of a private mapping: writable, and writes do not
    reach the file; a JAX-written (unpadded) header leaves odd offsets, which
    the reader copies out aligned."""
    path = str(tmp_path / "m.safetensors")
    J.save_safetensors(path, {"a": np.arange(12, dtype=np.float32), "b": np.ones(3, np.int8),
                              "c": np.arange(4, dtype=np.int64)})
    got = T.load_safetensors(path)
    got["a"][0] = 99.0
    assert T.load_safetensors(path)["a"][0].item() == 0.0
    for name, ref in J.load_safetensors(path).items():
        _same(T.load_safetensors(path)[name], ref)


def test_param_tree_matches_flax_round_trip(tmp_path):
    """save_param_tree / load_param_tree against the JAX package's (flax
    flatten / unflatten): the same file bytes from the same tree, and the
    same tree from either's file."""
    rng = np.random.default_rng(2)
    tree = {"blocks": {"attn": {"to_q": {"kernel": rng.normal(size=(2, 4, 4)),
                                         "bias": rng.normal(size=(2, 4))}},
                       "norm": {"scale": rng.normal(size=(2, 4)).astype(np.float32)}},
            "proj_out": {"kernel": rng.normal(size=(4, 3)).astype(np.float32)},
            "latents": rng.normal(size=(1, 6, 4))}
    jp, tp = str(tmp_path / "j.safetensors"), str(tmp_path / "t.safetensors")
    assert J.save_param_tree(jp, tree) == T.save_param_tree(tp, tree) == 5
    ref = J.load_safetensors(jp)
    got = T.load_safetensors(tp)
    assert list(got) == list(ref)
    for name in ref:
        _same(got[name], ref[name])

    def check(t_tree, j_tree):
        assert set(t_tree) == set(j_tree)
        for k, v in j_tree.items():
            if isinstance(v, dict):
                check(t_tree[k], v)
            else:
                _same(t_tree[k], np.asarray(v))

    check(T.load_param_tree(jp), J.load_param_tree(jp))
    check(T.load_param_tree(tp), J.load_param_tree(tp))


def test_reader_refuses_a_non_safetensors_file(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"not a safetensors file")
    with pytest.raises(ValueError, match="not a safetensors file"):
        T.load_safetensors(str(bad))
