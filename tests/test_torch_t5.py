"""Port parity: the T5 v1.1 encoder (`tokensgen_tpu_torch/models/t5.py`) and
the text encoder around it (`models/text_encoder.py`) against the JAX
package's `T5Encoder` / `T5TextEncoder` / `make_text_encoder`, on a tiny
random HF-layout T5 dir written by tests/_tiny_t5.py (weights and a
WordLevel tokenizer.json) and on the converted t5.safetensors that the JAX
package's `save_param_tree(convert_t5(...))` writes. f32, a padded mask:
1e-5; bf16 (T5-XXL's dtype): 2 bf16 eps of the largest magnitude. Token
ids and masks equal."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.convert.safetensors_io import load_safetensors as jax_load_safetensors
from tokensgen_tpu.convert.safetensors_io import save_param_tree as jax_save_param_tree
from tokensgen_tpu.convert.torch_weights import convert_t5
from tokensgen_tpu.models import t5 as JT
from tokensgen_tpu.models import text_encoder as JTE
from tokensgen_tpu_torch.convert.from_jax import t5_state_dict
from tokensgen_tpu_torch.models import t5 as TT
from tokensgen_tpu_torch.models import text_encoder as TTE

from _tiny_t5 import write_tiny_t5_dir, write_tiny_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["a tiny smoke test", "", "the red vehicle on a snow mountain road and an unknown word",
           "gen prompt"]


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("t5") / "text_encoder")
    write_tiny_t5_dir(d, d_model=24)
    return d


def _jax_params(d):
    sd = jax_load_safetensors(os.path.join(d, "model.safetensors"))
    return sd, convert_t5(sd, 2)


def _ids_and_mask():
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 120, size=(2, 12)).astype(np.int64)
    mask = np.ones((2, 12), np.int64)
    mask[0, 9:] = 0  # padded tails
    mask[1, 5:] = 0
    return ids, mask


def test_relative_position_bucket_matches_jax():
    rel = np.arange(-300, 300)[None, :] - np.arange(0, 20)[:, None]
    for buckets, dist in ((32, 128), (16, 64)):
        np.testing.assert_array_equal(TT._relative_position_bucket(rel, buckets, dist),
                                      JT._relative_position_bucket(rel, buckets, dist))


@pytest.mark.parametrize("masked", [True, False])
def test_encoder_matches_jax_hf_layout(t5_dir, masked):
    """The HF state dict loads strictly (no mapper) and the encoder matches
    JAX `T5Encoder` on the converted params, padded rows included."""
    sd, params = _jax_params(t5_dir)
    cfg = TT.T5Config.tiny(d_model=24)
    model = TT.T5Encoder(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    ids, mask = _ids_and_mask()
    ref = JT.T5Encoder(JT.T5Config.tiny(d_model=24)).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask).astype(bool) if masked else None)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask) if masked else None)
    assert out.dtype == torch.float32 and out.shape == (2, 12, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_encoder_bf16_matches_jax(t5_dir, masked):
    """The bf16 path (T5-XXL's: d_model >= 1024) against JAX `T5Encoder` in
    bf16 on the same weights, padded rows included. XLA and PyTorch round
    their bf16 intermediates at different points, so the two agree to 2
    bf16 eps of the output's largest magnitude (measured: under 1.2 eps)."""
    sd, params = _jax_params(t5_dir)
    model = TT.T5Encoder(TT.T5Config.tiny(d_model=24, dtype=torch.bfloat16)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    ids, mask = _ids_and_mask()
    ref = JT.T5Encoder(JT.T5Config.tiny(d_model=24, dtype=jnp.bfloat16)).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask).astype(bool) if masked else None)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask) if masked else None)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    atol = 2 * torch.finfo(torch.bfloat16).eps * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=atol)


def test_encoder_matches_jax_converted_tree(t5_dir, tmp_path):
    """A JAX-written converted t5.safetensors through `t5_state_dict` and
    `T5TextEncoder.from_converted`'s config inference."""
    from tokensgen_tpu_torch.convert.safetensors_io import load_param_tree

    _, params = _jax_params(t5_dir)
    path = str(tmp_path / "t5.safetensors")
    jax_save_param_tree(path, params)
    tree = load_param_tree(path)
    cfg = TTE._config_from_param_tree(tree)
    assert cfg == TT.T5Config.tiny(d_model=24)
    model = TT.T5Encoder(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in t5_state_dict(tree, 2).items()},
                          strict=True)
    assert model.shared.weight is model.encoder.embed_tokens.weight
    ids, mask = _ids_and_mask()
    ref = JT.T5Encoder(JT.T5Config.tiny(d_model=24)).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask).astype(bool))
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_config_from_shapes():
    """Widths and depth from an HF state dict's shapes; bf16 from 1024 wide."""
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    sd = {"shared.weight": meta(32128, 4096),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": meta(32, 64),
          "encoder.block.0.layer.0.SelfAttention.q.weight": meta(4096, 4096),
          "encoder.block.0.layer.1.DenseReluDense.wi_0.weight": meta(10240, 4096),
          "encoder.block.23.layer.1.layer_norm.weight": meta(4096)}
    assert TTE._config_from_state_dict(sd) == TT.T5Config.xxl()
    assert TT.T5Config.xxl().dtype == torch.bfloat16


def test_text_encoder_matches_jax(t5_dir):
    """Tokenizer (the `tokenizers` package here, `transformers.AutoTokenizer`
    in the JAX package) and encoder: ids and masks equal, padded to and
    truncated at max_length; embeddings 1e-5."""
    for max_length in (8, 226):
        ref = JTE.T5TextEncoder.from_pretrained(t5_dir, max_length=max_length)
        enc = TTE.T5TextEncoder.from_pretrained(t5_dir, max_length=max_length, device="cpu")
        want = ref.tokenizer(PROMPTS, padding="max_length", max_length=max_length,
                             truncation=True, return_tensors="np")
        ids, mask = enc.tokenizer(PROMPTS, max_length)
        np.testing.assert_array_equal(ids, want["input_ids"])
        np.testing.assert_array_equal(mask, want["attention_mask"])
        assert ids.shape == (len(PROMPTS), max_length)
        assert mask[2].all() == (max_length == 8)  # the long prompt is truncated at 8
        out = enc(PROMPTS)
        assert out.dtype == torch.float32 and out.shape == (len(PROMPTS), max_length, 24)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref(PROMPTS)), rtol=1e-5, atol=1e-5)


def test_text_encoder_tokenizer_in_sibling_dir(t5_dir, tmp_path):
    """The CogVideoX-5b layout: weights in text_encoder/, tokenizer in the
    sibling tokenizer/ (and a tokenizer_dir given explicitly)."""
    root = tmp_path / "ckpt"
    write_tiny_t5_dir(str(root / "text_encoder"), d_model=24, with_tokenizer=False)
    write_tiny_tokenizer(str(root / "tokenizer"))
    enc = TTE.T5TextEncoder.from_pretrained(str(root / "text_encoder"), max_length=8,
                                            device="cpu")
    ref = TTE.T5TextEncoder.from_pretrained(str(root / "text_encoder"), max_length=8,
                                            tokenizer_dir=t5_dir, device="cpu")
    torch.testing.assert_close(enc(PROMPTS), ref(PROMPTS), rtol=0, atol=0)


def test_handwritten_tokenizer_json_matches_the_library(tmp_path):
    """chip_smoke.py writes its tokenizer.json as JSON, with no tokenizer
    library: it tokenizes as the one tests/_tiny_t5.py builds with the
    `tokenizers` package and as HF's AutoTokenizer reads it."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from transformers import AutoTokenizer

    words = ["a", "tiny", "smoke", "test", "prompt", "gen", "the", "red", "vehicle", "snow",
             "mountain", "road"]
    chip_smoke.write_wordlevel_tokenizer(str(tmp_path / "hand"), words)
    write_tiny_tokenizer(str(tmp_path / "lib"))
    hand = TTE.FastTokenizer(str(tmp_path / "hand"))
    lib = TTE.FastTokenizer(str(tmp_path / "lib"))
    hf = AutoTokenizer.from_pretrained(str(tmp_path / "hand"))
    for max_length in (8, 226):
        got = hand(PROMPTS, max_length)
        for a, b in zip(got, lib(PROMPTS, max_length)):
            np.testing.assert_array_equal(a, b)
        want = hf(PROMPTS, padding="max_length", max_length=max_length, truncation=True,
                  return_tensors="np")
        np.testing.assert_array_equal(got[0], want["input_ids"])
        np.testing.assert_array_equal(got[1], want["attention_mask"])


def _dir_without(tmp_path, part):
    d = tmp_path / f"no_{part}"
    write_tiny_t5_dir(str(d), d_model=24, with_tokenizer=part != "tokenizer")
    if part == "weights":
        os.remove(d / "model.safetensors")
        write_tiny_tokenizer(str(d))
    return str(d)


@pytest.mark.parametrize("part,match", [("tokenizer", "tokenizer.json"),
                                        ("weights", "no .safetensors"),
                                        ("dir", "not found")])
def test_make_text_encoder_raises_like_jax(tmp_path, part, match):
    """A configured checkpoint that does not load raises in both packages,
    and falls back to the hash encoder (the same embeddings) only when
    allowed."""
    d = str(tmp_path / "absent") if part == "dir" else _dir_without(tmp_path, part)
    with pytest.raises(RuntimeError, match="failed to load T5"):
        JTE.make_text_encoder(d, max_length=8, embed_dim=24)
    with pytest.raises(RuntimeError, match=match):
        TTE.make_text_encoder(d, max_length=8, embed_dim=24, device="cpu")
    ref = JTE.make_text_encoder(d, max_length=8, embed_dim=24, allow_hash_fallback=True)
    enc = TTE.make_text_encoder(d, max_length=8, embed_dim=24, allow_hash_fallback=True,
                                device="cpu")
    assert isinstance(enc.inner, TTE.HashTextEncoder)
    np.testing.assert_array_equal(enc(PROMPTS).numpy(), np.asarray(ref(PROMPTS)))


def test_missing_tokenizers_package_raises_import_error(t5_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="`tokenizers` package"):
        TTE.make_text_encoder(t5_dir, max_length=8, embed_dim=24, device="cpu")
    enc = TTE.make_text_encoder(t5_dir, max_length=8, embed_dim=24, allow_hash_fallback=True,
                                device="cpu")
    assert isinstance(enc.inner, TTE.HashTextEncoder)


def test_converted_route_needs_a_tokenizer_dir(t5_dir, tmp_path):
    _, params = _jax_params(t5_dir)
    path = str(tmp_path / "t5.safetensors")
    jax_save_param_tree(path, params)
    with pytest.raises(RuntimeError, match="no tokenizer dir"):
        TTE.make_text_encoder(None, max_length=8, embed_dim=24, converted_path=path,
                              device="cpu")
    enc = TTE.make_text_encoder(None, max_length=8, embed_dim=24, converted_path=path,
                                tokenizer_dir=t5_dir, device="cpu")
    ref = JTE.make_text_encoder(None, max_length=8, embed_dim=24, converted_path=path,
                                tokenizer_dir=t5_dir)
    np.testing.assert_allclose(enc(PROMPTS).numpy(), np.asarray(ref(PROMPTS)), rtol=1e-5,
                               atol=1e-5)


def test_gap_to_hf_is_the_gelu_form(t5_dir):
    """HF's "gated-gelu" T5 uses the tanh GELU (`gelu_new`); the JAX module,
    and so the port, the exact one. On this fixture the port is 1e-4..1e-3
    from HF as shipped (the JAX package's own oracle test holds JAX to HF at
    1e-3) and within 1e-5 of HF once HF's activation is made exact: the gap
    is the activation, not the port."""
    from transformers import T5Config as HFT5Config
    from transformers.models.t5.modeling_t5 import T5EncoderModel

    sd, _ = _jax_params(t5_dir)
    hf = T5EncoderModel(HFT5Config(
        vocab_size=128, d_model=24, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        dropout_rate=0.0, feed_forward_proj="gated-gelu", is_encoder_decoder=False,
        use_cache=False)).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    model = TT.T5Encoder(TT.T5Config.tiny(d_model=24)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    ids, mask = (torch.from_numpy(a) for a in _ids_and_mask())

    def gap():
        with torch.no_grad():
            ref = hf(input_ids=ids, attention_mask=mask).last_hidden_state
            out = model(ids, mask)
        return max((out[b, :n] - ref[b, :n]).abs().max().item()
                   for b, n in enumerate(mask.sum(1).tolist()))

    shipped = gap()
    for blk in hf.encoder.block:
        blk.layer[1].DenseReluDense.act = torch.nn.GELU()  # exact
    exact = gap()
    print(f"port vs HF T5 (tiny fixture, attended rows): max |diff| {shipped:.3e} with HF's "
          f"tanh GELU, {exact:.3e} with the exact GELU")
    assert 1e-4 < shipped < 1e-3 and exact < 1e-5
