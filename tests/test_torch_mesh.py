"""PyTorch port, the mesh: ``parallel/mesh.make_mesh`` and its specs
against the JAX package's, the Trainer's (dp, sp) choice against the JAX
Trainer's, ``ReconEngine(mesh=)`` frames and the data-parallel train step
on gloo ranks of this machine's CPU.

The ranks run in spawned torch-only processes (tests/torch_mesh_ranks.py);
the JAX side runs here on the 8 virtual devices of tests/conftest.py.

Tolerances: a sharded frame against the port's unsharded frame 1e-5 (the
JAX mesh tests', tests/test_engine_mesh.py) with ``compact_dropped`` equal,
and against the JAX frame as tests/test_torch_engine.py holds a frame; the
sharded train step (dp 2 x sp 2) against the JAX package's sharded step on
the same global batch: loss 1e-6, parameters atol 5e-5 / rtol 5e-3 (the
JAX package's own tolerance for its sharded step, tests/test_sharding.py).
Both steps run in f64: the port's f32 gradients agree with JAX's f32 ones
only to JAX's f32 GroupNorm moments (tests/test_torch_training.py), which
SGD would carry into the parameters above that tolerance.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_ranks as ranks  # noqa: E402
from monoport_tpu.config import CN as JCN  # noqa: E402
from monoport_tpu.engine import EngineCfg as JaxEngineCfg  # noqa: E402
from monoport_tpu.engine import ReconEngine as JaxEngine  # noqa: E402
from monoport_tpu.models import MonoPortNet as JaxNet  # noqa: E402
from monoport_tpu.parallel import mesh as jmesh  # noqa: E402
from monoport_tpu.parallel import train_step as jts  # noqa: E402
from monoport_tpu.recon.hierarchy import HierarchicalRecon as JaxRecon  # noqa: E402,E501
from monoport_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from monoport_tpu_torch import weights  # noqa: E402
from monoport_tpu_torch.config import CN  # noqa: E402
from monoport_tpu_torch.models.monoport_net import (  # noqa: E402
    MonoPortNet, head_channels_for)
from monoport_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from monoport_tpu_torch.parallel import train_step as ts  # noqa: E402
from monoport_tpu_torch.training.trainer import mesh_shape  # noqa: E402
from tests.test_torch_engine import (FLIP_FRACTION, ROT_CALIB,  # noqa: E402
                                     _opts)
from tests.test_torch_training import _flat  # noqa: E402

torch.set_num_threads(2)


# -- make_mesh ------------------------------------------------------------------
@pytest.fixture
def fake_world():
    """A process group of ``world`` ranks in this process, seen from
    ``rank`` (torch's fake backend: groups are real, collectives no-ops)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world: int, rank: int = 0):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def _members(group):
    return None if group is None else dist.get_process_group_ranks(group)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_matches_jax(n, fake_world):
    """The default dp and the rank layout are JAX's; the ``points`` group
    of a rank is its row, the ``data`` group its column."""
    want = jmesh.make_mesh(n)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for rank in sorted({0, n - 1}):
        if n > 1:
            fake_world(n, rank)
        got = pmesh.make_mesh(n)
        assert got.shape == dict(want.shape)
        assert got.axis_names == tuple(want.axis_names)
        np.testing.assert_array_equal(got.ranks, ids)
        i, j = got.coords
        assert got.ranks[i, j] == rank
        assert got.index("data") == i and got.index("points") == j
        if n == 1:
            assert all(g is None for g in got.groups.values())
            continue
        assert _members(got.group()) == list(range(n))
        sp = got.shape["points"]
        assert _members(got.group("points")) == (
            got.ranks[i].tolist() if sp > 1 else None)
        assert _members(got.group("data")) == (
            got.ranks[:, j].tolist() if got.shape["data"] > 1 else None)


def test_make_mesh_needs_a_process_group(fake_world):
    """No fallback to a mesh of one: more ranks than the world raises;
    a rank left out of the mesh has no groups."""
    assert not dist.is_initialized()
    assert pmesh.make_mesh().size == 1
    for kw in ({"n_devices": 2}, {"devices": [0, 1]}):
        with pytest.raises(RuntimeError, match="init_process_group"):
            pmesh.make_mesh(**kw)
    fake_world(4, rank=3)
    with pytest.raises(ValueError, match="dp=3"):
        pmesh.make_mesh(dp=3)
    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.make_mesh(8)
    out = pmesh.make_mesh(n_devices=2, dp=2)        # the dp-only mesh
    assert out.shape == {"data": 2, "points": 1}
    assert not out.active and all(g is None for g in out.groups.values())
    with pytest.raises(ValueError, match="not a rank of the mesh"):
        ranks.ReconEngine(_port_net(_opts("G")), device="cpu", mesh=out)


def test_batch_specs_and_shards_match_jax():
    """``batch_sharding`` keeps the JAX package's keys and specs, and
    ``shard_batch`` cuts each rank the piece JAX puts on that device;
    an uneven split raises."""
    want = jmesh.make_mesh(8)                       # (4, 2)
    specs = jmesh.batch_sharding(want)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    got_specs = pmesh.batch_sharding(None)
    assert set(got_specs) == set(specs)
    for k, s in specs.items():
        assert got_specs[k] == tuple(s.spec), k
    assert pmesh.replicated(None) == tuple(jmesh.replicated(want).spec)
    rng = np.random.RandomState(0)
    batch = {"images": rng.rand(8, 4, 4, 3), "points": rng.rand(8, 6, 3),
             "calibs": rng.rand(8, 4, 4), "labels": rng.rand(8, 6, 1),
             "feat_prior": rng.rand(8, 2, 2, 5)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    shards = {k: {s.device.id: np.asarray(s.data) for s in jax.device_put(
        v, specs[k]).addressable_shards} for k, v in batch.items()}
    for (i, j), rank in np.ndenumerate(ids):
        mesh = pmesh.Mesh(ranks=ids, rank=int(rank), coords=(i, j),
                          groups={})
        piece = pmesh.shard_batch(mesh, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        for k in batch:
            np.testing.assert_array_equal(piece[k].numpy(),
                                          shards[k][rank], err_msg=k)
    mesh = pmesh.Mesh(ranks=ids, rank=0, coords=(0, 0), groups={})
    with pytest.raises(ValueError, match="split evenly"):
        pmesh.shard_batch(mesh, {"images": torch.zeros(6, 2)})
    with pytest.raises(ValueError, match="split evenly"):
        pmesh.shard_batch(mesh, {"points": torch.zeros(8, 5, 3)})


# -- the Trainer's choice -------------------------------------------------------
TRAINER_TABLE = [(world, bs, nsg) for world in (1, 2, 4, 8)
                 for bs, nsg in ((1, 5000), (2, 5000), (4, 4096), (8, 6),
                                 (2, 7), (6, 5000), (3, 9))]


def test_trainer_mesh_shape_matches_jax(tmp_path, monkeypatch):
    """``mesh_shape`` is the JAX Trainer's dp/sp rule: at each world size
    (the JAX Trainer on the first ``world`` virtual devices) the JAX
    Trainer's mesh shape, or no mesh."""
    devices = jax.devices()
    for world, bs, nsg in TRAINER_TABLE:
        monkeypatch.setattr(jax, "devices", lambda: devices[:world])
        cfg = _jax_cfg(tmp_path, bs, nsg)
        jt = JaxTrainer(JaxNet(cfg.netG), cfg, steps_per_epoch=1)
        want = None if jt.mesh is None else (jt.mesh.shape["data"],
                                             jt.mesh.shape["points"])
        assert mesh_shape(world, bs, nsg) == want, (world, bs, nsg)
    assert mesh_shape(8, 4, 4096) == (4, 2)
    assert mesh_shape(4, 2, 7) == (2, 1)             # a dp-only mesh


def _jax_cfg(tmp_path, bs, nsg):
    from monoport_tpu.config import get_cfg_defaults as jax_defaults

    cfg = jax_defaults()
    cfg.checkpoints_path = str(tmp_path / "ckpt")
    cfg.results_path = str(tmp_path / "results")
    cfg.batch_size = bs
    cfg.dataset.num_sample_geo = nsg
    return cfg


# -- sharded frames ---------------------------------------------------------------
# the nets of tests/test_torch_engine.py's setup (1-stack HGFilter at 64
# channels, ResnetFilter, a soft-onehot netG), weights drawn by the port
def _port_net(opts: dict, prior: int = 0, seed: int = 0) -> MonoPortNet:
    net = MonoPortNet(CN(opts), head_channels_for(CN(opts), prior))
    return ts.init_params(net, torch.Generator().manual_seed(seed))


NETS = {"G": (_opts("G"), 0, 0), "S": (_opts("G", soft=True), 0, 2),
        "C": (_opts("C"), 64, 1)}
# case -> (netG, mode, calib, RotatedCfg knobs, compact_hint)
CASES = {
    "frontal": ("G", "ray", None, {}, None),
    # an adaptive budget below the ceiling, as tests/test_engine_mesh.py
    "rotated_anchored": ("G", "ray", ROT_CALIB,
                         {"compact": 0.625, "anchors": 2}, 0.3),
    "hierarchy": ("G", "dense", None, {}, None),
    "softonehot": ("S", "ray", None, {}, None),
}
# world -> the meshes each world runs (name -> dp)
WORLDS = {2: {"sp2": None}, 4: {"dp2_sp2": None, "sp4": 1}}
EYE = np.eye(4, dtype=np.float32)[None]


def _jax_frame(nets: dict, name: str, image: np.ndarray) -> dict:
    netg, mode, calib, rot, hint = CASES[name]
    (g, pg), (c, pc) = nets[netg], nets["C"]
    flat = dict(render_size=32, mode=mode, fine_res=33, ray_taps=4,
                ray_window=24, march_levels=(9, 17) if mode == "ray" else None)
    if rot:
        flat.update(compact_rotated=rot["compact"], rot_anchors=rot["anchors"])
    eng = JaxEngine(g, c, recon=JaxRecon(resolutions=(9, 17),
                                         budgets=(0, 2048)),
                    config=JaxEngineCfg.flat(**flat))
    img = jnp.asarray(image)
    return jax.tree.map(np.asarray, eng.frame(
        pg, img, pc, img, jnp.asarray(EYE if calib is None else calib),
        compact_hint=hint))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The ranks' frames of every world (started first, they run while
    the JAX frames are computed here) and the JAX frames."""
    image = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    states = {k: (opts, _port_net(opts, prior, seed).state_dict())
              for k, (opts, prior, seed) in NETS.items()}
    cases = {name: {"netG": netg, "mode": mode, "rotated": rot,
                    "hint": hint, "calib": EYE if calib is None else calib}
             for name, (netg, mode, calib, rot, hint) in CASES.items()}
    runs = {}
    for world, meshes in WORLDS.items():
        tmp = str(tmp_path_factory.mktemp(f"world{world}"))
        path = os.path.join(tmp, "payload.pt")
        torch.save({"nets": states, "cases": cases, "image": image,
                    "meshes": meshes}, path)
        runs[world] = ranks.start(world, tmp, ranks.frames_rank, path)
    jnets = {k: (JaxNet(JCN(opts)), weights.flax_params_from_torch(state))
             for k, (opts, state) in states.items()}
    want = {name: _jax_frame(jnets, name, image) for name in CASES}
    return {world: ranks.results(run) for world, run in runs.items()}, want


def _close_to_jax(got: dict, want: dict):
    """tests/test_torch_engine.py's hold of a frame on the JAX frame."""
    assert set(got) == set(want)
    va, vb = got["valid"], want["valid"]
    assert vb.mean() > 0.05                  # the random net does hit
    assert (va != vb).mean() < FLIP_FRACTION
    for key, atol in (("depth", 2e-4), ("render_norm", 2e-3),
                      ("render_tex", 2e-3)):
        a, b = got[key].astype(np.float64), want[key].astype(np.float64)
        ok = np.isfinite(b)                  # depth_peel's 0/0, both sides
        np.testing.assert_array_equal(np.isfinite(a), ok, err_msg=key)
        assert (np.abs(a - b)[ok] > atol).sum() / a.size < FLIP_FRACTION
    for key in ("compact_dropped", "recon_counts"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", [(w, m) for w in WORLDS for m in WORLDS[w]],
                         ids=lambda wm: f"world{wm[0]}-{wm[1]}")
def test_sharded_frame(frames, mesh, case):
    """Every rank's sharded frame equals the port's unsharded frame within
    1e-5 (``compact_dropped`` equal) and agrees with the JAX frame."""
    sharded_frames, jax_frames = frames
    world, name = mesh
    single = sharded_frames[world][0]["single", case]
    for rank, res in enumerate(sharded_frames[world]):
        got = res[name, case]
        assert set(got) == set(single)
        for key, want in single.items():
            if key in ("compact_dropped", "recon_counts", "valid"):
                np.testing.assert_array_equal(got[key], want, err_msg=key)
            else:
                np.testing.assert_allclose(got[key], want, atol=1e-5,
                                           rtol=0, err_msg=f"{rank} {key}")
        _close_to_jax(got, jax_frames[case])
    if case == "rotated_anchored":
        assert single["compact_dropped"].any()      # the hint drops rays


# -- the sharded train step ---------------------------------------------------
def _train_opts(norm: str) -> dict:
    return {"projection": "orthogonal",
            "normalizer": {"IMF": "PIFuNomalizer"},
            "backbone": {"IMF": "PIFuHGFilters", "num_stack": 1,
                         "num_hourglass": 1, "hourglass_dim": 16,
                         "norm": norm, "hg_down": "ave_pool"},
            "head": {"IMF": "PIFuNetGMLP"}, "loss": {"IMF": "MSE"}}


NORMS = ("group", "batch_train")
HEAD = (17, 1024, 512, 256, 128, 1)
# SGD with momentum, the global-norm clip and weight decay: the clip reads
# the global gradient, the decay the replicated parameters
TX = dict(optim="sgd", learning_rate=0.5, momentum=0.9, weight_decay=1e-3,
          grad_clip=1.0)


def _train_batch(seed=0, b=4, size=64, n=256) -> dict:
    rng = np.random.RandomState(seed)
    return {"images": rng.rand(b, size, size, 3) * 2 - 1,
            "points": rng.uniform(-1.1, 1.1, (b, n, 3)),
            "calibs": np.tile(np.diag([1.0, 1.0, 0.9, 1.0]), (b, 1, 1)),
            "labels": (rng.rand(b, n, 1) > 0.5) * 1.0}


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """World 4, dp 2 x sp 2: each net's step from the same weights as the
    JAX step, in f64 (the ranks run while the JAX steps compile)."""
    batch = {k: torch.from_numpy(v) for k, v in _train_batch().items()}
    nets = {}
    for norm in NORMS:
        net = ts.init_params(MonoPortNet(CN(_train_opts(norm)),
                                         head_channels=HEAD),
                             torch.Generator().manual_seed(1)).double()
        nets[norm] = (_train_opts(norm), HEAD, net.state_dict(), batch)
    tmp = str(tmp_path_factory.mktemp("train"))
    path = os.path.join(tmp, "payload.pt")
    torch.save({"nets": nets, "dp": 2, "tx": TX, "scan": "batch_train"},
               path)
    run = ranks.start(4, tmp, ranks.train_rank, path)
    want = {norm: _jax_sharded_step(norm, nets[norm][2]) for norm in NORMS}
    return ranks.results(run), want


def _jax_sharded_step(norm: str, state: dict) -> dict:
    variables = weights.flax_params_from_torch(
        {k: v.float() for k, v in state.items()})
    with jax.enable_x64(True):
        f64 = lambda t: jnp.asarray(np.asarray(t, np.float64))  # noqa: E731
        params = jax.tree.map(f64, variables["params"])
        stats = (jax.tree.map(f64, variables["batch_stats"])
                 if "batch_stats" in variables else None)
        tx = jts.make_optimizer(**TX)
        jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params), tx=tx,
                                batch_stats=stats)
        step = jts.make_train_step(JaxNet(JCN(_train_opts(norm))),
                                   mesh=jmesh.make_mesh(4, dp=2))
        jstate, loss = step(jstate, jax.tree.map(f64, _train_batch()))
        out = {"params": jstate.params}
        if stats is not None:
            out["batch_stats"] = jstate.batch_stats
        return {"loss": float(loss), "variables": jax.tree.map(
            lambda a: np.asarray(a, np.float64), out)}


@pytest.mark.parametrize("name", NORMS)
def test_sharded_train_step_matches_jax(sharded_steps, name):
    """Every rank's step equals JAX's sharded step on the global batch,
    and the ranks hold the same parameters and running stats after it
    (the others started from other draws)."""
    results, want = sharded_steps
    first = results[0][name]["state"]
    for res in results:
        got = res[name]
        np.testing.assert_allclose(float(got["loss"]), want[name]["loss"],
                                   atol=1e-6, rtol=0)
        for k, v in got["state"].items():
            assert torch.equal(v, first[k]), k
    moved = _flat(weights.flax_params_from_torch(
        {k: v.double() for k, v in first.items()}))
    ref = _flat(want[name]["variables"])
    assert set(moved) == set(ref)
    assert any(k.startswith("batch_stats/") for k in ref) == (
        name == "batch_train")
    for k, w in ref.items():
        np.testing.assert_allclose(moved[k], w, atol=5e-5, rtol=5e-3,
                                   err_msg=k)


def test_sharded_scan_equals_its_steps(sharded_steps):
    """``make_scan_train_step`` under the mesh equals its steps one by one
    (a batch_train net: the running stats ride along)."""
    results, _ = sharded_steps
    for res in results:
        (l1, s1), (l2, s2) = res["scan"]
        assert torch.equal(l1, l2)
        for k in s1:
            assert torch.equal(s1[k], s2[k]), k
