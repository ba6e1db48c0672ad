"""PyTorch port, isolation: every module of monoport_tpu_torch (the apps,
perception, render, host pipeline, the alternative backbones, the
checkpoint converter, training, the perception nets' training, the mesh,
the utilities, profiling among them, the evaluation layer with its
apps, the PPL training recipes and the checkpoint and floor-prop apps
included) and chip_smoke.py import without pulling in jax or
monoport_tpu, nor matplotlib (checked in a fresh interpreter, since this
test process has both loaded)."""

import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)

PROBE = r"""
import importlib, pkgutil, sys
import monoport_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(monoport_tpu_torch.__path__,
                                              "monoport_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "monoport_tpu"))
print(len(mods), bad)
assert len(mods) >= 20, mods
assert {"monoport_tpu_torch.apps.rtl_main", "monoport_tpu_torch.apps.infer",
        "monoport_tpu_torch.pipeline.segmentation",
        "monoport_tpu_torch.render.rasterizer",
        "monoport_tpu_torch.convert", "monoport_tpu_torch.convert.torch_loader",
        "monoport_tpu_torch.models.backbones.hrnet",
        "monoport_tpu_torch.models.backbones.yolov4",
        "monoport_tpu_torch.training.trainer",
        "monoport_tpu_torch.parallel.train_step",
        "monoport_tpu_torch.parallel.mesh",
        "monoport_tpu_torch.utils.profiling",
        "monoport_tpu_torch.training.datasets.capsule",
        "monoport_tpu_torch.training.datasets.superquadric",
        "monoport_tpu_torch.utils.params_io",
        "monoport_tpu_torch.apps.train",
        "monoport_tpu_torch.apps.train_capsule_netG",
        "monoport_tpu_torch.apps.train_capsule_netC",
        "monoport_tpu_torch.training.matting",
        "monoport_tpu_torch.training.detection",
        "monoport_tpu_torch.apps.train_matting",
        "monoport_tpu_torch.apps.train_detection",
        "monoport_tpu_torch.utils.compile_cache",
        "monoport_tpu_torch.utils.plot",
        "monoport_tpu_torch.utils.objloader_native",
        "monoport_tpu_torch.evaluate",
        "monoport_tpu_torch.apps.eval_netg",
        "monoport_tpu_torch.apps.eval_netc",
        "monoport_tpu_torch.apps.eval_crossfam",
        "monoport_tpu_torch.apps.eval_rotated_anchored",
        "monoport_tpu_torch.apps.demo_synthetic",
        "monoport_tpu_torch.apps.train_ppl",
        "monoport_tpu_torch.apps.convert_model",
        "monoport_tpu_torch.apps.make_floor_prop"} <= set(mods), mods
assert not bad, bad
# utils.plot imports matplotlib inside its function only
assert "matplotlib" not in sys.modules
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
