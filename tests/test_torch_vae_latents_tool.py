"""Port parity: `python -m tokensgen_tpu_torch.calculate_vae_latents` against
the JAX package's root `calculate_vae_latents.py` at --smoke geometry (the
tiny VAE, 9 frames a chunk) on the same MiraData layout, the same VAE
weights and the same noise (the port's ``noise_fn`` replays
``PRNGKey(i * 100 + chunk)``): the f32 latents within 1e-4, the files (names,
shapes, f16, the --fit-stats mean / std) equal in layout and, within 1e-4 and
one f16 ulp (2^-10 relative: f32 values 1e-4 apart may round to neighbouring
f16 values), in value; each package's `VAEMiraDataset` reads the
other's files. Also the refusals about ``vae_checkpoint`` and the two VAE
layouts it reads (a converted tree file, an HF dir of diffusers names)."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from tokensgen_tpu.convert.safetensors_io import save_param_tree as jsave_tree
from tokensgen_tpu.convert.torch_weights import convert_vae
from tokensgen_tpu.data import mira as JM
from tokensgen_tpu.data.video_io import write_video
from tokensgen_tpu.models import vae3d as JV
from tokensgen_tpu_torch import calculate_vae_latents as CVL
from tokensgen_tpu_torch.convert.from_jax import to_torch, vae_state_dict
from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
from tokensgen_tpu_torch.convert.torch_weights import vae_to_diffusers
from tokensgen_tpu_torch.data import mira as TM
from tokensgen_tpu_torch.models import vae3d as TV

from _torch_parity import np_tree, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEOS = {7: 40, 1003: 31}  # frames at 10 fps: 4 and 3 chunks of 9


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both tools (--smoke --fit-stats) on one layout with the same weights
    (JAX `init(PRNGKey(0))`, jitted) and noise; the port's also returns its
    f32 latents per row."""
    root = tmp_path_factory.mktemp("latents_tool")
    rng = np.random.default_rng(0)
    for idx, n in VIDEOS.items():
        path = JM.mira_video_path(str(root / "videos"), idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_video(path, rng.uniform(0, 255, size=(n, 64, 96, 3)).astype(np.uint8), fps=10)
    (root / "index.csv").write_text("index,dense_caption\n7,a test video\n1003,another one\n")
    jcfg = JV.VAEConfig.tiny(sample_height=32, sample_width=48)
    params = jax.jit(JV.AutoencoderKLCogVideoX(jcfg).init)(jax.random.PRNGKey(0),
                                                           jnp.zeros((1, 9, 32, 48, 3)))
    tvae = TV.AutoencoderKLCogVideoX(TV.VAEConfig.tiny(sample_height=32, sample_width=48))
    tvae.load_state_dict(to_torch(vae_state_dict(np_tree(params))), strict=True)
    outs = {}
    for kind in ("jax", "torch"):
        cfg = {"latent_output_dir": str(root / kind),
               "train_data_params": {"csv_file": str(root / "index.csv"),
                                     "video_dir": str(root / "videos"), "sample_fps": 10,
                                     "max_num_chunks": 4}}
        (root / f"{kind}.yaml").write_text(yaml.safe_dump(cfg))
        outs[kind] = str(root / kind)
    mp = pytest.MonkeyPatch()
    try:
        # the JAX tool's eager init costs ~45 s: hand it the same params jitted
        mp.setattr(JV.AutoencoderKLCogVideoX, "init", lambda self, *a, **k: params)
        mp.setattr(sys, "argv", ["calculate_vae_latents.py", "--config",
                                 str(root / "jax.yaml"), "--smoke", "--fit-stats"])
        runpy.run_path(os.path.join(REPO, "calculate_vae_latents.py"), run_name="__main__")
        mp.setattr(CVL, "build_on_device", lambda ctor, device, gen: tvae.eval())
        lat32 = {}
        encode = CVL.encode_video_latents

        def keep(vae, pixels, nf_px, row, noise_fn, device):
            lat32[row] = out = encode(vae, pixels, nf_px, row, noise_fn, device)
            return out

        mp.setattr(CVL, "encode_video_latents", keep)
        written = CVL.main(["--config", str(root / "torch.yaml"), "--smoke", "--fit-stats",
                            "--device", "cpu"], noise_fn=jax_noise)
    finally:
        mp.undo()
    return dict(root=root, params=params, jcfg=jcfg, outs=outs, written=written, lat32=lat32)


def jax_noise(i, cid, shape):
    """The JAX tool's sample noise of row ``i``, chunk ``cid``."""
    return t(jax.random.normal(jax.random.PRNGKey(i * 100 + cid), shape, jnp.float32))


def _files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d) for p, _, fs in os.walk(d) for f in fs)


def test_latents_match_jax(run):
    """The port's f32 latents of each row against the JAX tool's arithmetic
    on the same pixels, weights and noise (chunked encode, sample, scale,
    [13c, 16, h, w]): 1e-4."""
    ds = JM.MiraDataset(str(run["root"] / "index.csv"), str(run["root"] / "videos"), height=32,
                        width=48, chunk_size=9, max_num_chunks=4, random_sample=False,
                        i_drop_rate=0, t_drop_rate=0, ti_drop_rate=0)
    vae = JV.VAERunner(run["jcfg"], run["params"])
    for i in range(len(ds)):
        px = jnp.asarray(ds[i]["pixel_values"])[None]
        lats = []
        for cid in range(px.shape[1] // 9):
            moments = vae.encode(px[:, cid * 9:(cid + 1) * 9])
            lat = JV.sample_latent(moments, jax.random.PRNGKey(i * 100 + cid))
            lats.append(np.asarray(lat * run["jcfg"].scaling_factor).transpose(0, 1, 4, 2, 3)[0])
        want = np.concatenate(lats)
        got = run["lat32"][i]
        chunks = VIDEOS[list(VIDEOS)[i]] // 9
        assert got.shape == want.shape == (3 * chunks, 16, 4, 6)
        err = float(np.abs(got - want).max())
        print(f"row {i}: max |port - jax| {err:.3e} (bound 1e-4)")
        assert err <= 1e-4


def test_files_match_jax_and_interchange(run):
    """The same files (names, shapes, f16 latents; f32 mean / std of shape
    [16*h*w]) within 1e-4 and one f16 ulp; `main` returns them; each
    package's VAEMiraDataset reads the other's directory, bit-equal to its
    own read of it."""
    jd, td = run["outs"]["jax"], run["outs"]["torch"]
    assert _files(jd) == _files(td) == ["000000000/7_vae_c04.npy", "000000001/1003_vae_c03.npy",
                                        "mean_shard0.npy", "std_shard0.npy"]
    assert run["written"] == [os.path.join(td, "000000000/7_vae_c04.npy"),
                              os.path.join(td, "000000001/1003_vae_c03.npy")]
    for name in _files(jd):
        a, b = np.load(os.path.join(td, name)), np.load(os.path.join(jd, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.dtype == (np.float32 if name.startswith(("mean", "std")) else np.float16)
        err = np.abs(a.astype(np.float32) - b.astype(np.float32))
        print(f"{name}: max |port - jax| {float(err.max()):.3e}")
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=2.0 ** -10,
                                   atol=1e-4, err_msg=name)
    csv = str(run["root"] / "index.csv")
    kw = dict(max_num_chunks=5, nf_per_chunk=3, t_drop_rate=0.0)
    for d in (jd, td):
        j, p = JM.VAEMiraDataset(csv, d, **kw), TM.VAEMiraDataset(csv, d, **kw)
        for a, b in zip(p.load_many([0, 1]), j.load_many([0, 1])):
            assert a.keys() == b.keys() and a["valid_num_chunks"] == b["valid_num_chunks"]
            np.testing.assert_array_equal(a["vae_latents"], b["vae_latents"])


def test_shards_take_every_nth_row(run, tmp_path):
    """--num-shards 2 --shard-index 1 writes row 1 only, and its stats file
    is mean_shard1 / std_shard1."""
    cfg = yaml.safe_load((run["root"] / "torch.yaml").read_text())
    cfg["latent_output_dir"] = str(tmp_path / "out")
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    written = CVL.main(["--config", str(tmp_path / "c.yaml"), "--smoke", "--fit-stats",
                        "--device", "cpu", "--num-shards", "2", "--shard-index", "1"])
    assert [os.path.basename(p) for p in written] == ["1003_vae_c03.npy"]
    assert _files(str(tmp_path / "out")) == ["000000001/1003_vae_c03.npy", "mean_shard1.npy",
                                             "std_shard1.npy"]


@pytest.mark.parametrize("ckpt,err,match", [
    (None, ValueError, "no `vae_checkpoint`"),
    ("absent", FileNotFoundError, "vae_checkpoint not found"),
    ("empty_dir", FileNotFoundError, "has no .safetensors"),
])
def test_refuses_without_vae_weights(tmp_path, ckpt, err, match):
    """Outside --smoke: no vae_checkpoint, a path that does not exist, or a
    dir without weights is refused, as by the JAX tool."""
    (tmp_path / "empty_dir").mkdir()
    cfg = {"latent_output_dir": str(tmp_path / "out"), "train_data_params": {}}
    if ckpt:
        cfg["vae_checkpoint"] = str(tmp_path / ckpt)
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    with pytest.raises(err, match=match):
        CVL.main(["--config", str(tmp_path / "c.yaml"), "--device", "cpu"])


def test_loads_converted_file_and_hf_dir(run, tmp_path):
    """`load_vae` reads a converted param-tree file (written by the JAX
    package) and an HF dir of diffusers names (which the JAX package's
    convert_vae reads to the same tree): both give the JAX weights."""
    tree = np_tree(run["params"])
    want = vae_state_dict(tree)
    path = str(tmp_path / "vae.safetensors")
    jsave_tree(path, tree)
    tcfg = TV.VAEConfig.tiny(sample_height=32, sample_width=48)
    hf = tmp_path / "vae"
    hf.mkdir()
    diffusers = vae_to_diffusers(to_torch(want))
    save_safetensors(str(hf / "diffusion_pytorch_model.safetensors"), diffusers)
    back = convert_vae({k: v.numpy() for k, v in diffusers.items()}, run["jcfg"])
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, tree))
    for src in (path, str(hf)):
        got = CVL.load_vae(src, tcfg, "cpu").state_dict()
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
