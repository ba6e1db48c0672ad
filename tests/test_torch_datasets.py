"""PyTorch port, training datasets: the numpy copies (synthetic blobs, the
PPL fixtures and datasets, the multiprocess loader) give bit-equal items
to the JAX package's for the same seeds; the capsule and superquadric
builders, fed the JAX package's own draws, give bodies, occupancy,
renders, colours, GT canvases and points within 1e-5 of its generators;
the port's generators give the documented shapes and ranges."""

import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monoport_tpu.config import get_cfg_defaults as jax_cfg
from monoport_tpu.training.datasets import capsule as jcap
from monoport_tpu.training.datasets import superquadric as jsq
from monoport_tpu_torch.training.datasets import capsule as cap
from monoport_tpu_torch.training.datasets import superquadric as sq

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=0.0)

# the JAX generators under jit (eagerly, each call compiles op by op)
J = {"skeleton3d": jax.jit(jcap.skeleton3d,
                           static_argnames=("scale_range",)),
     "render_front": jax.jit(jcap.render_front, static_argnums=1,
                             static_argnames=("base_color",)),
     "sample_points": jax.jit(jcap.sample_points, static_argnums=2),
     "sample_surface_points": jax.jit(jcap.sample_surface_points,
                                      static_argnums=2),
     "sq_body": jax.jit(jsq.sq_body),
     "sq_render_front": jax.jit(jsq.render_front, static_argnums=1),
     "sq_sample_surface_points": jax.jit(jsq.sample_surface_points,
                                         static_argnums=2),
     "sq_sample_points": jax.jit(jsq.sample_points, static_argnums=2)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(kw or TOL))


# -- numpy copies ------------------------------------------------------------
def _items_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_synthetic_items_bit_equal():
    from monoport_tpu.training.datasets import SyntheticBlobDataset as J
    from monoport_tpu_torch.training.datasets import SyntheticBlobDataset as P

    j, p = (D(size=48, num_sample_geo=200, length=3, seed=2) for D in (J, P))
    for i in range(3):
        _items_equal(p[i], j[i])
    _items_equal(p.as_train_batch([0, 2]), j.as_train_batch([0, 2]))


def _tree(root: str) -> dict:
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                files[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return files


@pytest.mark.parametrize("kind", ["dynamic", "static"])
def test_ppl_fixture_and_items_bit_equal(kind, tmp_path):
    """The port's fixture writes the JAX fixture's files byte for byte; its
    PPL datasets give equal items (training scale / flip on, the same
    ``random`` / ``np.random`` seeds; the colour jitter draws from an
    unseeded generator in both, so it is off), colour samples included."""
    from monoport_tpu.training.datasets import fixture as jfix
    from monoport_tpu.training.datasets import ppl as jppl
    from monoport_tpu_torch.training.datasets import fixture as pfix
    from monoport_tpu_torch.training.datasets import ppl as pppl

    kw = ({"subjects": ("c0",), "rich": True, "textured": True,
           "broken": False, "seed": 11} if kind == "dynamic" else {})
    make = f"make_{kind}_fixture"
    info_j = getattr(jfix, make)(str(tmp_path / "j"), **kw)
    info_p = getattr(pfix, make)(str(tmp_path / "p"), **kw)
    assert info_j.keys() == info_p.keys()
    tree_j, tree_p = _tree(str(tmp_path / "j")), _tree(str(tmp_path / "p"))
    assert tree_j.keys() == tree_p.keys() and tree_j == tree_p

    cfg = jax_cfg().dataset
    cfg.rotation_step = 120
    cfg.num_sample_geo = 64
    cfg.num_sample_color = 32 if kind == "dynamic" else 0
    cfg.blur = cfg.aug_bri = cfg.aug_con = cfg.aug_sat = 0.0
    cls = "PPLDynamicDataset" if kind == "dynamic" else "PPLStaticDataset"
    dj = getattr(jppl, cls)(cfg, str(tmp_path / "p"), training=True)
    dp = getattr(pppl, cls)(cfg, str(tmp_path / "p"), training=True)
    assert len(dj) == len(dp) > 0
    for i in range(len(dp)):
        items = []
        for ds in (dj, dp):
            random.seed(i)
            np.random.seed(i)
            items.append(ds[i])
        _items_equal(items[1], items[0])


def _blobs(size, n, length):
    from monoport_tpu_torch.training.datasets import SyntheticBlobDataset
    return SyntheticBlobDataset(size=size, num_sample_geo=n, length=length)


def _jax_blobs(size, n, length):
    from monoport_tpu.training.datasets import SyntheticBlobDataset
    return SyntheticBlobDataset(size=size, num_sample_geo=n, length=length)


def test_loader_matches_jax_and_reports_worker_failure():
    from monoport_tpu.training.datasets.loader import DataLoader as JL
    from monoport_tpu_torch.training.datasets.loader import DataLoader as PL

    got = list(PL(_blobs, (32, 64, 6), batch_size=2, num_workers=2,
                  seed=1).epoch(1))
    want = list(JL(_jax_blobs, (32, 64, 6), batch_size=2, num_workers=0,
                   seed=1).epoch(1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _items_equal(g, w)

    class Boom:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("broken sample")

    with pytest.raises(RuntimeError, match="DataLoader worker failed"):
        list(PL(lambda: Boom(), (), batch_size=2, num_workers=1).epoch(0))


# -- capsule builders on the JAX package's draws ------------------------------
def _skeleton_uniforms(key) -> np.ndarray:
    return np.asarray([jax.random.uniform(k, ())
                       for k in jax.random.split(key, 20)])


def _clothe_uniforms(key, k) -> np.ndarray:
    return np.stack([np.asarray(jax.random.uniform(s, (k,)))
                     for s in jax.random.split(key, 3)])


def _appearance_uniforms(key) -> np.ndarray:
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return np.concatenate([np.asarray(jax.random.uniform(k1, (3,))),
                           np.asarray(jax.random.uniform(k2, ()))[None],
                           np.asarray(jax.random.uniform(k3, (2,))),
                           np.asarray(jax.random.uniform(k4, (2,)))])


def _point_draws(key, n, k) -> dict:
    k1, k2, k3, k4 = jax.random.split(key, 4)
    n_surf = (n * 4) // 5
    return {"seg": torch.from_numpy(np.asarray(
                jax.random.randint(k1, (n_surf,), 0, k)).astype(np.int64)),
            "t": _t(jax.random.uniform(k2, (n_surf, 1))),
            "noise": _t(jax.random.normal(k3, (n_surf, 3))),
            "radial": _t(jax.random.normal(k4, (n_surf, 1))),
            "unif": _t(jax.random.uniform(jax.random.fold_in(key, 7),
                                          (n - n_surf, 3)))}


HARD = dict(scale_range=(0.45, 1.0), pose_spread=1.35, z_spread=0.35)


@pytest.fixture(scope="module")
def bodies():
    """(JAX caps, port caps, JAX appearance, port appearance) for a
    clothed hard-curriculum body, built from the same draws."""
    k_skel, k_cloth, k_app = jax.random.split(jax.random.PRNGKey(3), 3)
    jcaps = jcap.clothe(k_cloth, J["skeleton3d"](k_skel, **HARD))
    caps = cap.clothe_from_uniforms(
        cap.skeleton_from_uniforms(_t(_skeleton_uniforms(k_skel)), **HARD),
        _t(_clothe_uniforms(k_cloth, 10)))
    japp = jcap.sample_appearance(k_app)
    app = cap.appearance_from_uniforms(_t(_appearance_uniforms(k_app)))
    return jcaps, caps, japp, app


@pytest.mark.parametrize("kw", [{}, HARD], ids=["plain", "hard"])
def test_skeleton_from_uniforms_matches_jax(kw):
    key = jax.random.PRNGKey(11)
    want = J["skeleton3d"](key, **kw)
    got = cap.skeleton_from_uniforms(_t(_skeleton_uniforms(key)), **kw)
    assert got[0].shape == (cap.N_SEGMENTS, 3)
    for g, w in zip(got, want):
        _close(g, w)


def test_capsule_builders_match_jax(bodies):
    jcaps, caps, japp, app = bodies
    for g, w in zip(caps[3], jcaps[3]):
        _close(g, w)
    for k in japp:
        _close(app[k], japp[k])
    pts = np.random.RandomState(0).uniform(-1, 1, (500, 3)).astype(
        np.float32)
    _close(cap.capsule_occupancy(_t(pts), caps),
           jcap.capsule_occupancy(jnp.asarray(pts), jcaps))
    for flat in (False, True):
        image, mask = cap.render_front(caps, 48, appearance=app, flat=flat)
        jimage, jmask = J["render_front"](jcaps, 48, appearance=japp,
                                          flat=flat)
        assert mask.sum() > 50
        _close(image, jimage)
        _close(mask, jmask)
        _close(cap.surface_color(_t(pts), appearance=app, flat=flat),
               jcap.surface_color(jnp.asarray(pts), appearance=japp,
                                  flat=flat))
    base = (0.7, 0.5, 0.4)
    _close(cap.render_front(caps, 32, base_color=base)[0],
           J["render_front"](jcaps, 32, base_color=base)[0])
    depth = np.random.RandomState(1).uniform(0, 33, (33, 33)).astype(
        np.float32)
    valid = depth > 10
    _close(cap.gt_texture_canvas(_t(depth), torch.from_numpy(valid), 33,
                                 appearance=app),
           jcap.gt_texture_canvas(jnp.asarray(depth), jnp.asarray(valid),
                                  33, appearance=japp))


def test_capsule_points_match_jax(bodies):
    jcaps, caps, _, _ = bodies
    key = jax.random.PRNGKey(5)
    want_pts, want_labels = J["sample_points"](key, jcaps, 300, sigma=0.035)
    pts, labels = cap.points_from_draws(caps, _point_draws(key, 300, 10),
                                        sigma=0.035)
    _close(pts, want_pts)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    assert 0.2 < float(labels.mean()) < 0.8

    k1, k2, k3 = jax.random.split(key, 3)
    got = cap.surface_points_from_draws(
        caps, torch.from_numpy(np.asarray(
            jax.random.randint(k1, (200,), 0, 10)).astype(np.int64)),
        _t(jax.random.uniform(k2, (200, 1))),
        _t(jax.random.normal(k3, (200, 3))))
    _close(got, J["sample_surface_points"](key, jcaps, 200))


# -- superquadric builders ----------------------------------------------------
def test_superquadric_builders_match_jax():
    key = jax.random.PRNGKey(21)
    k_skel, k_e1, k_e2, k_an, k_el = jax.random.split(key, 5)
    want = J["sq_body"](key)
    body = sq.sq_body_from_uniforms(
        _t(_skeleton_uniforms(k_skel)),
        _t(np.stack([np.asarray(jax.random.uniform(k, (10,)))
                     for k in (k_e1, k_e2, k_an, k_el)])))
    for k in want:
        _close(body[k], want[k])
    pts = np.random.RandomState(2).uniform(-1, 1, (400, 3)).astype(
        np.float32)
    _close(sq.sq_occupancy(_t(pts), body),
           jsq.sq_occupancy(jnp.asarray(pts), want))
    image, mask = sq.render_front(body, 40)
    jimage, jmask = J["sq_render_front"](want, 40)
    assert mask.sum() > 30
    _close(image, jimage)
    _close(mask, jmask)

    def surface_draws(key, n):
        k_dir, k_seg, k_t = jax.random.split(key, 3)
        return {"seg": torch.from_numpy(np.asarray(jax.random.randint(
                    k_seg, (n,), 0, 10)).astype(np.int64)),
                "t": _t(jax.random.uniform(k_t, (n, 1))),
                "d": _t(jax.random.normal(k_dir, (n, 3)))}

    k_pts = jax.random.PRNGKey(4)
    surf = sq.surface_points_from_draws(body, **surface_draws(k_pts, 120))
    _close(surf, J["sq_sample_surface_points"](k_pts, want, 120))
    k_surf, k_rad, k_uni = jax.random.split(k_pts, 3)
    pts, labels = sq.points_from_draws(body, {
        "surface": surface_draws(k_surf, 160),
        "radial": _t(jax.random.normal(k_rad, (160, 3))),
        "unif": _t(jax.random.uniform(k_uni, (40, 3)))})
    want_pts, want_labels = J["sq_sample_points"](k_pts, want, 200)
    _close(pts, want_pts)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))


# -- the port's generators ----------------------------------------------------
def test_generators_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    for batch in (cap.synth_train_batch(gen, 2, 32, 100, hard=True),
                  cap.synth_train_batch(gen, 1, 32, 100),
                  sq.mixed_train_batch(gen, 3, 32, 100),
                  sq.synth_train_batch(gen, 2, 32, 100)):
        b = len(batch["images"])
        assert batch["images"].shape == (b, 32, 32, 3)
        assert batch["points"].shape == (b, 100, 3)
        assert batch["labels"].shape == (b, 100, 1)
        torch.testing.assert_close(batch["calibs"],
                                   torch.eye(4).expand(b, 4, 4))
        assert batch["images"].min() >= -1 and batch["images"].max() <= 1
        assert set(batch["labels"].unique().tolist()) <= {0.0, 1.0}
        assert batch["points"][:, 80:].abs().max() <= 1.0     # uniform fifth
        # the background is 0 after masking, and there is a body
        assert (batch["images"] != 0).any(-1).float().mean() > 0.02
    caps = cap.skeleton3d(gen)
    pts = cap.sample_surface_points(gen, caps, 64)
    assert pts.shape == (64, 3)
    # on a capsule surface: the occupancy there is ~0.5
    occ = cap.capsule_occupancy(pts, caps)
    assert (occ > 0.45).all()
    app = cap.sample_appearance(gen)
    assert 0.35 <= float(app["base"].min()) and float(app["base"].max()) < 0.9
    body = sq.sq_body(gen)
    assert body["e1"].shape == (cap.N_SEGMENTS,)
    assert (body["elong"] >= 1.0).all() and (body["elong"] < 1.25).all()
    surf = sq.sample_surface_points(gen, body, 50)
    f = sq.sq_occupancy(surf, body)
    assert ((f - 0.5).abs() < 0.05).all()
