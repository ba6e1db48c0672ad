"""The JAX package's perception generators' draws, for the port's builders
(``training/matting.composite_from_draws``,
``training/detection.scene_from_draws``): JAX's ``synth_batch`` /
``synth_det_batch`` / ``_texture`` split their keys as below, and the port
builds the same images from the same draws. Shared by
tests/test_torch_perception_training.py and
tests/test_torch_perception_gates.py."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.training import detection as jtd
from monoport_tpu.training import matting as jtm
from monoport_tpu_torch.training import detection as ptd
from monoport_tpu_torch.training import matting as ptm

# -- the JAX package's draws, in the port's draw layout -----------------------
def _jax_texture_u(key):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return jnp.concatenate([jax.random.uniform(k1, (3,)),
                            jax.random.uniform(k2, (6,)),
                            jax.random.uniform(k3, (3,)),
                            jax.random.uniform(k4, (3,))])


def _jax_skeleton_u(key):
    ks = jax.random.split(key, 16)
    return jnp.stack([jax.random.uniform(ks[k], ()) for k in range(14)])


def _jax_composite_draws(key, size):
    """``training/matting.synth_composite``'s draws from ``key``."""
    k_skel, k_fg, k_bg, k_noise, k_blob, k_keep = jax.random.split(key, 6)
    kb1, kb2, kb3 = jax.random.split(k_blob, 3)
    return {"skeleton": _jax_skeleton_u(k_skel), "fg": _jax_texture_u(k_fg),
            "bg": _jax_texture_u(k_bg),
            "noise": jax.random.normal(k_noise, (size, size, 3)),
            "blob_c": jax.random.uniform(kb1, (3, 2)),
            "blob_r": jax.random.uniform(kb2, (3,)),
            "blob_tex": _jax_texture_u(kb3),
            "keep": jax.random.uniform(k_keep, ())}


def _jax_scene_draws(key, size):
    """``training/detection.synth_scene``'s draws from ``key``."""
    keys = jax.random.split(key, jtd.MAX_PEOPLE + 4)
    kb1, kb2, kb3 = jax.random.split(keys[1], 3)
    kd1, kd2, kd3, kd4 = jax.random.split(keys[2], 4)
    people = []
    for i in range(jtd.MAX_PEOPLE):
        k_skel, k_place, k_keep = jax.random.split(keys[3 + i], 3)
        ks = jax.random.split(k_place, 3)
        people.append({
            "skeleton": _jax_skeleton_u(k_skel),
            "scale": jax.random.uniform(ks[0], ()),
            "shift": jnp.stack([jax.random.uniform(ks[1], ()),
                                jax.random.uniform(ks[2], ())]),
            "keep": jax.random.uniform(k_keep, ()),
            "person_tex": _jax_texture_u(jax.random.fold_in(keys[3 + i], 7))})
    out = {k: jnp.stack([p[k] for p in people]) for k in people[0]}
    out.update({"bg": _jax_texture_u(keys[0]),
                "blob_c": jax.random.uniform(kb1, (5, 2)),
                "blob_r": jax.random.uniform(kb2, (5,)),
                "blob_tex": _jax_texture_u(kb3),
                "dist_a": jax.random.uniform(kd1, (2, 2)),
                "dist_d": jax.random.uniform(kd2, (2, 2)),
                "dist_r": jax.random.uniform(kd3, (2,)),
                "dist_tex": _jax_texture_u(kd4),
                "noise": jax.random.normal(keys[-1], (size, size, 3))})
    return out


# JAX under jit, compiled without XLA's backend optimizations (a fraction
# of the compile time on the CPU; the same arithmetic)
FAST = {"xla_backend_optimization_level": 0}


def compile_fast(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST)


@functools.lru_cache(maxsize=None)
def _draws_fn(kind, size):
    """One key's draws, compiled once a size (a batch is a loop over its
    keys: the same bits as JAX's vmap)."""
    one = _jax_composite_draws if kind == "matte" else _jax_scene_draws
    return compile_fast(functools.partial(one, size=size), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def synth_fn(kind, batch, size):
    fn = jtm.synth_batch if kind == "matte" else jtd.synth_det_batch
    return compile_fast(functools.partial(fn, batch=batch, size=size),
                    jax.random.PRNGKey(0))


def port_draws(kind: str, key, batch: int, size: int) -> dict:
    """The draws of JAX's ``synth_batch`` / ``synth_det_batch(key, batch,
    size)`` as the port's draw dict of CPU tensors."""
    fn = _draws_fn(kind, size)
    ds = [fn(k) for k in jax.random.split(key, batch)]
    return {k: torch.from_numpy(np.stack([np.asarray(d[k], np.float32)
                                          for d in ds])) for k in ds[0]}


def port_composites(key, batch, size):
    return ptm.composite_from_draws(port_draws("matte", key, batch, size),
                                    size)


def port_scenes(key, batch, size):
    return ptd.scene_from_draws(port_draws("scene", key, batch, size), size)


def port_background(key, size):
    """JAX's ``_texture(key, grid)`` from its draws -> [1, S, S, 3]."""
    u = torch.from_numpy(np.asarray(_jax_texture_u(key), np.float32))
    return ptm.texture_from_uniforms(u, ptm.pixel_grid(size, "cpu"))[None]
