"""The small multi-view configuration of the port's multi-view tests (CPU:
``test_torch_multiview.py``; card: ``test_torch_cuda.py``): the benchmark's
``monoport-hg4-mv4`` cut to a 1-stack HG netG at 64^2 with a narrow
5-layer head, seeded weights whose last layer has a -8 weight on z, levels
9-17-33 (every candidate within its budget), on a ring of yaws 0/30/60/90
(the pooled z is then not 0). Imports no JAX."""

import json

from cardbench.harness.manifest import Manifest

SEED = 2718281828
RECON = dict(resolutions=(9, 17, 33), budgets=(0, 4352, 31232))
SMALL_YAWS = (0.0, 30.0, 60.0, 90.0)


def small_config() -> dict:
    config = json.loads(json.dumps(Manifest().config("monoport-hg4-mv4")))
    config["image_size"] = 64
    g = config["netG"]
    g["backbone"].update(num_stack=1, num_hourglass=1, hourglass_dim=32)
    g["head"]["widths"] = [33, 48, 32, 24, 16, 1]
    config["weights"] = {"kind": "seeded",
                         "head": {"last_scale": 1.0, "last_z_weight": -8.0}}
    config["profile"].update(render_size=32)
    config["profile"]["hierarchy"].update(
        resolutions=list(RECON["resolutions"]), budgets=list(RECON["budgets"]))
    return config


def ring_spec(bodies: int = 2, yaws=SMALL_YAWS) -> dict:
    """The ``ring4`` traffic with ``bodies`` bodies on the ring ``yaws``."""
    spec = dict(Manifest.traffic("ring4"), bodies=bodies)
    spec["camera"] = dict(spec["camera"], yaws=list(yaws))
    return spec
