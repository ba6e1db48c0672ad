"""Nothing the harness runs loads JAX or the JAX package, and the
reference loads nothing of the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import json
import os
import subprocess
import sys

from cardbench.harness.manifest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "monoport_tpu"}

PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, body=body)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_imports_no_jax():
    names = _top_level("import cardbench.run, cardbench.calibrate")
    assert not names & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    names = _top_level("import cardbench.reference.frame as f, "
                       "cardbench.reference.nets, cardbench.reference.recon, "
                       "cardbench.reference.served, "
                       "cardbench.reference.segmentation, "
                       "cardbench.reference.floor, cardbench.reference.jpeg\n"
                       "f.frame_path('dense')")
    assert not names & (FORBIDDEN | {"monoport_tpu_torch"})


def test_a_run_loads_no_jax():
    names = _top_level(
        "import torch; torch.set_num_threads(2)\n"
        "from cardbench.tests.small import SmallManifest\n"
        "from cardbench import run\n"
        "res, _ = run.run(SmallManifest(bodies=2), 'hg4-orbit', 5, 0.5, "
        "False, device='cpu', t_start=time.perf_counter())\n"
        "assert res['correct'], res")
    assert "monoport_tpu_torch" in names
    assert not names & FORBIDDEN


def test_a_served_run_loads_no_jax():
    names = _top_level(
        "import torch; torch.set_num_threads(2)\n"
        "from cardbench.tests.test_cardbench_serve import ServeManifest\n"
        "from cardbench import run\n"
        "res, _ = run.run(ServeManifest(), 'hg4-serve', 5, 2.0, False, "
        "device='cpu', t_start=time.perf_counter())\n"
        "assert res['attempted'] > 0, res")
    assert "monoport_tpu_torch" in names
    assert not names & FORBIDDEN
