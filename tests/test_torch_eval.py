"""PyTorch port, the evaluation layer: ``monoport_tpu_torch/evaluate.py``
and the apps ``apps/eval_netg``, ``eval_netc``, ``eval_crossfam``,
``eval_rotated_anchored`` and ``demo_synthetic`` against the JAX
package's scripts of the same names, on the CPU.

The golden: ``python tests/test_torch_eval.py --write`` (JAX on the CPU,
f32, ``use_pallas=False``, matmul precision "highest", committed weights)
writes ``monoport_tpu_torch/data/eval_golden.npz``:

* the JAX draws the port cannot make: ``capsule/<seed>/{a,b,r}``
  (``skeleton3d(PRNGKey(seed))``) and ``sq/<seed>/{a,b,r,e1,e2,aniso,
  elong}`` (``superquadric.sq_body(PRNGKey(seed))``) for the held-out
  seeds, and ``fixture/mask``, the PPL fixture's PIL silhouette;
* ``bench/<key>``: ``bench_real``'s quality keys on body 31337 at the
  bench profile, and ``bench/valid``;
* ``netg/<seed>`` / ``netc/<seed>``: eval_netg's IOU and eval_netc's
  PSNR at the bench profile;
* ``trained/{iou,psnr,valid}``: ``tests/test_trained_pipeline.py``'s
  body 4242 at its reduced 129 profile;
* ``crossfam/<family>/{iou,iou_z48,psnr,valid}``: eval_crossfam at 129,
  seed 31337 (``iou`` over the script's 64 z-slices, ``iou_z48`` over the
  JAX test's 48; no PSNR for the ellipsoid);
* ``rotated/<key>``: eval_rotated_anchored's keys at its own profile,
  unrounded (plans as anchor arrays, 0 = a per-point level).

Masks are stored as bool, no image: the port renders each body itself,
and ``test_committed_bodies_render_as_jax`` holds those renders to JAX's.
"""

import functools
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

from monoport_tpu_torch import evaluate  # noqa: E402
from monoport_tpu_torch.training.datasets import capsule as cap  # noqa: E402
from monoport_tpu_torch.training.datasets import superquadric as sq  # noqa

torch.set_num_threads(2)
DATA = os.path.join(ROOT, "monoport_tpu", "data")
SQ_KEYS = ("a", "b", "r", "e1", "e2", "aniso", "elong")


def jax_script(name: str):
    """A module of the JAX package's ``scripts/`` (imports JAX)."""
    path = os.path.join(ROOT, "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _jax_iou(valid, gt) -> float:
    got = np.asarray(valid) > 0.5
    return float((got & gt).sum() / max((got | gt).sum(), 1))


def _jax_psnr(out, engine, res: int, flat: bool = False) -> float:
    import jax.numpy as jnp

    from monoport_tpu.recon.depth_peel import visualize
    from monoport_tpu.training.datasets.capsule import gt_texture_canvas
    from monoport_tpu.training.metrics import masked_psnr

    canvas = gt_texture_canvas(jnp.asarray(out["depth"]),
                               jnp.asarray(out["valid"]), res, flat=flat)
    gt_vis, _ = visualize(canvas, engine.render_size)
    m = np.asarray(out["mask"])
    m = (m[..., 0] if m.ndim == 3 else m) > 0.5
    return masked_psnr(np.asarray(out["render_tex"]), np.asarray(gt_vis),
                       m)[0]


def write_golden(path: str = evaluate.GOLDEN) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from monoport_tpu.config import get_cfg_defaults
    from monoport_tpu.engine import EngineCfg, ReconEngine
    from monoport_tpu.models import MonoPortNet
    from monoport_tpu.recon.depth_peel import depth_peel
    from monoport_tpu.recon.hierarchy import HierarchicalRecon
    from monoport_tpu.training.datasets import superquadric as jsq
    from monoport_tpu.training.datasets.capsule import (capsule_occupancy,
                                                        render_front,
                                                        skeleton3d)
    from monoport_tpu.training.datasets.fixture import RADII, _render_rgba
    from monoport_tpu.utils.params_io import load_params

    crossfam = jax_script("eval_crossfam")
    rotated = jax_script("eval_rotated_anchored")
    cfg = get_cfg_defaults()
    netG, netC = MonoPortNet(cfg.netG), MonoPortNet(cfg.netC)
    params_g = {"params": load_params(os.path.join(
        DATA, "netg_capsule.npz"))[0]}
    params_c = {"params": load_params(os.path.join(
        DATA, "netc_capsule.npz"))[0]}
    eye = jnp.eye(4, dtype=jnp.float32)[None]
    golden: dict = {}
    bodies = {}
    for seed in evaluate.HELD_OUT_SEEDS:
        caps = skeleton3d(jax.random.PRNGKey(seed))
        body = jsq.sq_body(jax.random.PRNGKey(seed))
        bodies[seed] = (caps, body)
        for name, arr in zip("abr", caps):
            golden[f"capsule/{seed}/{name}"] = np.asarray(arr, np.float32)
        for name in SQ_KEYS:
            golden[f"sq/{seed}/{name}"] = np.asarray(body[name], np.float32)
    rgba = np.asarray(_render_rgba(0, 512), dtype=np.float32) / 255.0
    golden["fixture/mask"] = rgba[..., 3] > 0.5

    # the bench profile (eval_netg.py:52-58, bench.py:189-205) in f32
    bench = ReconEngine(netG, netC, recon=HierarchicalRecon(
        resolutions=(17, 33, 65), budgets=(0, 4096, 16384),
        select="uncertain"), config=EngineCfg.flat(
        mode="ray", fine_res=257, ray_taps=6, ray_window=192,
        compute_dtype=jnp.float32, use_pallas=False, march_levels=(33, 65)))
    for seed in evaluate.HELD_OUT_SEEDS:
        caps = bodies[seed][0]
        image = render_front(caps, 512)[0][None]
        out = bench.frame(params_g, image, params_c, image, calib=eye)
        gt = crossfam.gt_silhouette(
            lambda pts: capsule_occupancy(pts, caps), 257, 64)
        golden[f"netg/{seed}"] = _jax_iou(out["valid"], gt)
        golden[f"netc/{seed}"] = _jax_psnr(out, bench, 257)
        print(f"seed{seed}: iou {golden[f'netg/{seed}']:.4f} psnr "
              f"{golden[f'netc/{seed}']:.2f}", flush=True)
        if seed != evaluate.BENCH_SEED:
            continue
        # bench_real's path exactness (bench.py:742-767)
        dense = HierarchicalRecon(resolutions=evaluate.DENSE_RESOLUTIONS,
                                  select="uncertain")
        feats = bench._feats_f32(netG.apply(bench._cast(params_g),
                                            bench._cast(image),
                                            method="filter"))

        def query(pts):
            return netG.apply(bench._cast(params_g), feats, pts, eye,
                              method="query", head_fn=bench._head_fn(
                                  netG, bench._cast(params_g)))[0]

        oracle = depth_peel(dense(query), "front", 0.5)
        got_v = np.asarray(out["valid"]) > 0.5
        want_v = np.asarray(oracle.valid) > 0.5
        err = np.abs(np.asarray(out["depth"])
                     - np.asarray(oracle.depth))[got_v & want_v]
        golden["bench/real_model_vs_gt_iou"] = golden[f"netg/{seed}"]
        golden["bench/real_ray_vs_dense_iou"] = _jax_iou(got_v, want_v)
        golden["bench/real_depth_err_med_voxels"] = float(
            np.median(err[np.isfinite(err)]))
        golden["bench/real_tex_psnr_db"] = golden[f"netc/{seed}"]
        golden["bench/valid"] = got_v
        print({k: v for k, v in golden.items() if k.startswith("bench/")
               and k != "bench/valid"}, flush=True)

    # the reduced 129 profile (tests/test_trained_pipeline.py,
    # eval_crossfam.py --cpu)
    reduced = ReconEngine(netG, netC, recon=HierarchicalRecon(
        resolutions=(17, 33), budgets=(0, 4096), select="uncertain"),
        config=EngineCfg.flat(mode="ray", fine_res=129, ray_taps=6,
                              ray_window=96))

    def readings(image, occ_fn, flat=False, tex=True):
        out = reduced.frame(params_g, image[None], params_c, image[None],
                            calib=eye)
        res = {"valid": np.asarray(out["valid"]) > 0.5,
               "iou": _jax_iou(out["valid"],
                               crossfam.gt_silhouette(occ_fn, 129, 64)),
               "iou_z48": _jax_iou(out["valid"],
                                   crossfam.gt_silhouette(occ_fn, 129, 48))}
        if tex:
            res["psnr"] = _jax_psnr(out, reduced, 129, flat)
        return res

    caps = bodies[4242][0]
    trained = readings(render_front(caps, 512)[0],
                       lambda pts: capsule_occupancy(pts, caps))
    golden["trained/iou"] = trained["iou_z48"]
    golden["trained/psnr"] = trained["psnr"]
    golden["trained/valid"] = trained["valid"]
    caps, body = bodies[evaluate.BENCH_SEED]
    occ = lambda pts: jsq.sq_occupancy(pts, body)  # noqa: E731
    radii = jnp.asarray(RADII)
    fams = {
        "capsule": readings(render_front(caps, 512)[0],
                            lambda pts: capsule_occupancy(pts, caps)),
        "sq": readings(jsq.render_front(body, 512)[0], occ),
        "sq_flat": readings(jsq.render_front(body, 512, flat=True)[0], occ,
                            flat=True),
        "ellipsoid": readings(
            jnp.asarray(crossfam.fixture_image()),
            lambda pts: (jnp.square(pts / radii).sum(-1) <= 1.0
                         ).astype(jnp.float32), tex=False)}
    for fam, res in fams.items():
        for key, value in res.items():
            golden[f"crossfam/{fam}/{key}"] = value
        print(fam, {k: v for k, v in res.items() if k != "valid"},
              flush=True)

    # eval_rotated_anchored at its own profile (its main() unrounded)
    caps = bodies[evaluate.BENCH_SEED][0]
    image = render_front(caps, 512)[0][None]
    engines = {k: rotated.build(k) for k in evaluate.ROTATED_MODES}
    for yaw, pitch in evaluate.POSES:
        calib = jnp.asarray(rotated.pifu_calib(rotated.orbit_extrinsic(
            yaw, pitch), np.eye(4, dtype=np.float32)))
        tag = f"y{int(yaw)}p{int(pitch)}"
        frames = {k: eng.frame(pg, image, pc, image, calib)
                  for k, (eng, pg, pc) in engines.items()}
        gt = rotated.gt_silhouette_view(caps, calib)
        vd = np.asarray(frames[None]["valid"]) > 0.5
        rot = {"iou_gt_pp": _jax_iou(vd, gt)}
        for k in evaluate.ROTATED_MODES[1:]:
            plan = engines[k][0]._rot_anchor_plan(calib, image.shape[1])
            rot[f"plan_{k}"] = np.asarray([p or 0 for p in plan], np.int32)
            va = np.asarray(frames[k]["valid"]) > 0.5
            rot[f"iou_anch{k}_vs_pp"] = _jax_iou(va, vd)
            rot[f"iou_gt_anch{k}"] = _jax_iou(va, gt)
            dd = np.abs(np.asarray(frames[k]["depth"])
                        - np.asarray(frames[None]["depth"]))[va & vd]
            rot[f"depth_mad_anch{k}"] = float(dd.mean())
            rot[f"depth_p95_anch{k}"] = float(np.percentile(dd, 95))
            rot[f"tex_mad_anch{k}"] = float(np.abs(
                np.asarray(frames[k]["render_tex"])
                - np.asarray(frames[None]["render_tex"])).mean())
            rot[f"dropped_anch{k}"] = np.asarray(
                frames[k]["compact_dropped"], np.int32)
        for key, value in rot.items():
            golden[f"rotated/{tag}_{key}"] = value
        print(tag, {k: v for k, v in rot.items()}, flush=True)
    np.savez_compressed(path, **golden)
    return golden


@pytest.fixture(scope="module")
def golden():
    return evaluate.load_golden()


# -- the committed bodies ---------------------------------------------------
@pytest.mark.parametrize("seed", evaluate.HELD_OUT_SEEDS)
def test_committed_bodies_are_the_jax_draws(golden, seed):
    import jax

    from monoport_tpu.training.datasets import capsule as jcap
    from monoport_tpu.training.datasets import superquadric as jsq

    key = jax.random.PRNGKey(seed)
    caps = evaluate.capsule_body(seed, "cpu", golden)
    for got, want in zip(caps, jcap.skeleton3d(key)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    body = evaluate.sq_body(seed, "cpu", golden)
    jbody = jsq.sq_body(key)
    for name in SQ_KEYS:
        np.testing.assert_array_equal(body[name].numpy(),
                                      np.asarray(jbody[name]))


@functools.lru_cache(maxsize=None)
def _jax_render(family: str):
    """JAX's front render of a body (arrays), jitted: its 48-step march
    runs op by op otherwise."""
    import jax

    from monoport_tpu.training.datasets import capsule as jcap
    from monoport_tpu.training.datasets import superquadric as jsq

    if family == "capsule":
        return jax.jit(lambda caps: jcap.render_front(caps, 512)[0])
    return jax.jit(lambda body: jsq.render_front(
        body, 512, flat=family == "sq_flat")[0])


@pytest.mark.parametrize("seed,family", [
    *((s, "capsule") for s in evaluate.HELD_OUT_SEEDS),
    *((s, "sq") for s in evaluate.HELD_OUT_SEEDS),
    (evaluate.BENCH_SEED, "sq_flat")])
def test_committed_bodies_render_as_jax(golden, seed, family):
    """The port's 512^2 renders of the committed bodies (the eval's
    inputs) are JAX's within 1e-5: capsule and superquadric (shaded; flat
    for the cross-family seed)."""
    if family == "capsule":
        arrays = evaluate.capsule_body(seed, "cpu", golden)
        got = cap.render_front(arrays, 512)[0]
        want = _jax_render(family)(tuple(a.numpy() for a in arrays))
    else:
        body = evaluate.sq_body(seed, "cpu", golden)
        got = sq.render_front(body, 512, flat=family == "sq_flat")[0]
        want = _jax_render(family)({k: v.numpy() for k, v in body.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_fixture_image_matches_jax(golden):
    """The committed fixture silhouette gives eval_crossfam's PIL image."""
    want = jax_script("eval_crossfam").fixture_image()
    got = evaluate.fixture_image("cpu", golden).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_missing_seed_raises(golden):
    with pytest.raises(KeyError, match="test_torch_eval.py --write"):
        evaluate.capsule_body(12345, "cpu", golden)
    with pytest.raises(KeyError, match="no sq body for seed 1"):
        evaluate.sq_body(1, "cpu", golden)


# -- the metrics against the JAX scripts' -----------------------------------
@pytest.mark.parametrize("family", ["capsule", "sq", "ellipsoid"])
def test_gt_silhouette_matches_jax(golden, family):
    """``gt_silhouette`` equals eval_crossfam's (eval_netg's is the same
    union) for each family's occupancy, at 65 x 16 slices and 33 x 48."""
    import jax
    import jax.numpy as jnp

    from monoport_tpu.training.datasets import capsule as jcap
    from monoport_tpu.training.datasets import superquadric as jsq
    from monoport_tpu.training.datasets.fixture import RADII

    key = jax.random.PRNGKey(4242)
    if family == "capsule":
        caps, jcaps = evaluate.capsule_body(4242, "cpu", golden), \
            jcap.skeleton3d(key)
        occ = evaluate.capsule_occ(caps)
        jocc = lambda p: jcap.capsule_occupancy(p, jcaps)  # noqa: E731
    elif family == "sq":
        body, jbody = evaluate.sq_body(4242, "cpu", golden), jsq.sq_body(key)
        occ = evaluate.sq_occ(body)
        jocc = lambda p: jsq.sq_occupancy(p, jbody)  # noqa: E731
    else:
        radii = jnp.asarray(RADII)
        occ = evaluate.ellipsoid_occupancy
        jocc = lambda p: (jnp.square(p / radii).sum(-1)  # noqa: E731
                          <= 1.0).astype(jnp.float32)
    crossfam = jax_script("eval_crossfam")
    for res, n_z in ((65, 16), (33, 48)):
        got = evaluate.gt_silhouette(occ, res, n_z).numpy()
        want = crossfam.gt_silhouette(jocc, res, n_z)
        assert got.any()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pose", evaluate.POSES[1::2])
def test_gt_silhouette_view_matches_jax(golden, pose):
    """With a calib, ``gt_silhouette`` is eval_rotated_anchored's
    view-space ``gt_silhouette_view``."""
    import jax

    from monoport_tpu.training.datasets import capsule as jcap

    calib = evaluate.pose_calib(*pose)
    caps = evaluate.capsule_body(31337, "cpu", golden)
    got = evaluate.gt_silhouette(evaluate.capsule_occ(caps), 65, 12,
                                 calib=calib).numpy()
    want = jax_script("eval_rotated_anchored").gt_silhouette_view(
        jcap.skeleton3d(jax.random.PRNGKey(31337)), calib, res=65, n_z=12)
    assert got.any()
    np.testing.assert_array_equal(got, want)


def test_silhouette_iou():
    rng = np.random.RandomState(0)
    a, b = rng.rand(2, 33, 33) > 0.6
    want = (a & b).sum() / (a | b).sum()
    assert evaluate.silhouette_iou(torch.from_numpy(a),
                                   torch.from_numpy(b)) == pytest.approx(
        want, abs=1e-12)
    empty = torch.zeros(4, 4, dtype=torch.bool)
    assert evaluate.silhouette_iou(empty, empty) == 0.0


class _Eng:
    render_size = 48


@pytest.mark.parametrize("flat", [False, True])
def test_texture_psnr_matches_jax(flat):
    """``texture_psnr`` against the scripts' gt_texture_canvas ->
    visualize -> masked_psnr on the same seeded frame (33^2 maps, a 48^2
    render): within 1e-4 dB."""
    import jax.numpy as jnp

    from monoport_tpu.recon.depth_peel import visualize as jvis

    rng = np.random.RandomState(1 + flat)
    res = 33
    depth = rng.uniform(4, 28, (res, res)).astype(np.float32)
    valid = rng.rand(res, res) > 0.3
    canvas = np.where(valid[..., None],
                      rng.rand(res, res, 3).astype(np.float32), 1.0)
    tex, mask = jvis(jnp.asarray(canvas, jnp.float32), _Eng.render_size)
    out = {"depth": depth, "valid": valid, "render_tex": np.asarray(tex),
           "mask": np.asarray(mask)}
    want = _jax_psnr(out, _Eng, res, flat)
    got, _ = evaluate.texture_psnr(
        {k: torch.from_numpy(np.array(v)) for k, v in out.items()}, _Eng,
        res, flat=flat)
    assert np.isfinite(want)
    assert got == pytest.approx(want, abs=1e-4)


# -- the apps ---------------------------------------------------------------
def test_app_arguments():
    """The apps take the scripts' arguments; the card is the default."""
    from monoport_tpu_torch.apps import (demo_synthetic, eval_crossfam,
                                         eval_netc, eval_netg,
                                         eval_rotated_anchored)

    a = eval_netg.parse_args([])
    assert a.ckpt == [eval_netg.DEFAULT_NETG] and not a.cpu
    a = eval_netg.parse_args(["g1.npz", "g2.npz", "--cpu"])
    assert a.ckpt == ["g1.npz", "g2.npz"] and a.cpu
    a = eval_netc.parse_args(["g.npz", "c.npz", "1", "2"])
    assert (a.netg, a.netc, a.seeds) == ("g.npz", "c.npz", [1, 2])
    a = eval_netc.parse_args([])
    assert a.seeds == list(evaluate.HELD_OUT_SEEDS)
    a = eval_crossfam.parse_args(["--cpu", "--no_tex", "x.npz"])
    assert a.cpu and a.no_tex and a.ckpt == ["x.npz"]
    assert eval_crossfam.fine_res(a) == 129
    assert eval_crossfam.fine_res(eval_crossfam.parse_args([])) == 257
    assert eval_crossfam.fine_res(
        eval_crossfam.parse_args(["--fine_res", "65"])) == 65
    a = eval_rotated_anchored.parse_args(["--texels", "1", "2.5"])
    assert a.texels == [1.0, 2.5] and not a.cpu
    a = demo_synthetic.parse_args([])
    assert (a.steps, a.size, a.out, a.cpu) == (300, 128, "out", False)


def test_apps_raise_without_a_card(monkeypatch):
    """No silent CPU fall back: without ``--cpu`` the apps need CUDA."""
    from monoport_tpu_torch.apps import demo_synthetic, eval_netg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for app in (eval_netg, demo_synthetic):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            app.main([])


def test_eval_netc_reads_a_missing_seed_as_an_error():
    from monoport_tpu_torch.apps import eval_netc

    with pytest.raises(KeyError, match="seed 5"):
        eval_netc.main(["--cpu", eval_netc.DEFAULT_NETG,
                        eval_netc.DEFAULT_NETC, "5"])


def test_demo_synthetic_smoke(tmp_path):
    """``demo_synthetic`` on the CPU at a tiny size writes its three files
    with the script's metric keys."""
    from monoport_tpu_torch.apps import demo_synthetic

    out = str(tmp_path / "demo")
    metrics = demo_synthetic.main(["--steps", "4", "--size", "64", "--out",
                                   out, "--cpu"])
    assert sorted(os.listdir(out)) == ["mesh.obj", "metrics.json",
                                       "recon_norm.png"]
    with open(os.path.join(out, "metrics.json")) as f:
        saved = json.load(f)
    assert set(saved) == {"iou", "train_iou", "verts", "faces"}
    assert saved == {k: metrics[k] for k in saved}
    assert all(np.isfinite(metrics["losses"]))
    from PIL import Image

    with Image.open(os.path.join(out, "recon_norm.png")) as png:
        assert (png.mode, png.size) == ("RGB", (256, 256))


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        write_golden()
    else:
        sys.exit("usage: python tests/test_torch_eval.py --write")
