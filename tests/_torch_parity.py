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


def jax_noise(base_rng=None, fifo_rng=None, base_steps=0, fifo_iters=0, latents_key=None):
    """A port ``noise_fn`` drawing each tagged sample from the key the JAX
    package uses for it: base steps (`sampling/base.py` split + fold_in 1),
    FIFO ranks (`sampling/fifo.py` fold_in rid, fold_in 1) and the tail
    renoise (fold_in 999), and the pipeline's initial latents."""
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
        else:
            raise KeyError(tag)
        return t(jax.random.normal(key, tuple(shape), jnp.float32))

    return draw
