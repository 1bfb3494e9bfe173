"""Helpers for the JAX-vs-PyTorch parity tests (tests/test_torch_*.py):
param trees to numpy, and a noise source for the port that replays the JAX
package's own key derivation, so both samplers see the same random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def np_tree(params):
    """flax params (possibly wrapped in {"params": ...}) -> nested numpy dicts."""
    tree = params["params"] if "params" in params else params
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def jax_noise(base_rng=None, fifo_rng=None, base_steps=0, fifo_iters=0, latents_key=None,
              vip_rng=None):
    """A port ``noise_fn`` drawing each tagged sample from the key the JAX
    package uses for it: base steps (`sampling/base.py` split + fold_in 1),
    FIFO ranks (`sampling/fifo.py` fold_in rid, fold_in 1) and the tail
    renoise (fold_in 999), the pipeline's initial latents, and the VIP
    encode's VAE latent samples (`pipelines/to2v.py` fold_in chunk)."""
    base_keys = jax.random.split(base_rng, base_steps) if base_rng is not None else None
    fifo_keys = jax.random.split(fifo_rng, fifo_iters) if fifo_rng is not None else None

    def draw(tag, shape):
        kind = tag[0]
        if kind == "base":
            key = base_keys[tag[1]]
            key = key if tag[2] == 0 else jax.random.fold_in(key, 1)
        elif kind == "fifo":
            key = jax.random.fold_in(fifo_keys[tag[1]], tag[2])
            key = key if tag[3] == 0 else jax.random.fold_in(key, 1)
        elif kind == "tail":
            key = jax.random.fold_in(fifo_keys[tag[1]], 999)
        elif kind == "latents":
            key = latents_key
        elif kind == "vip":
            key = jax.random.fold_in(vip_rng, tag[1])
        else:
            raise KeyError(tag)
        return t(jax.random.normal(key, tuple(shape), jnp.float32))

    return draw


def random_params(init, *args, seed=0, **kwargs):
    """Random params of ``init(*args, **kwargs)``'s tree structure and
    shapes, without compiling it (`jax.eval_shape`), as a ``{"params": ...}`` tree of numpy
    f32 arrays: kernels normal(0, 1/sqrt(fan_in)), norm scales 1 + 0.1 n,
    biases and other leaves 0.02 n (n standard normal)."""
    import flax

    rng = np.random.default_rng(seed)
    shapes = flax.traverse_util.flatten_dict(jax.eval_shape(init, *args, **kwargs)["params"])
    out = {}
    for key, sd in shapes.items():
        n = rng.normal(size=sd.shape)
        if key[-1] == "kernel":
            val = n / np.sqrt(np.prod(sd.shape[:-1]))
        elif key[-1] == "scale":
            val = 1.0 + 0.1 * n
        else:
            val = 0.02 * n
        out[key] = val.astype(np.float32)
    return {"params": flax.traverse_util.unflatten_dict(out)}
