"""A cell's configuration cut to a size the CPU runs in seconds, for the
benchmark's own tests: the same files and code paths, smaller shapes, the
weights drawn from the seed (by the configuration's own recipe where it
has one, the head's last layer unscaled: the fine lattice is 8x coarser),
f32."""

from __future__ import annotations

import copy

from cardbench.harness.manifest import Manifest


def small_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["image_size"] = 64
    g = c["netG"]
    if g["backbone"]["IMF"] == "PIFuHGFilters":
        g["backbone"].update(num_stack=2, num_hourglass=1, hourglass_dim=16)
        g["head"]["widths"] = [17, 32, 16, 1]
    else:
        g["head"]["widths"] = [g["head"]["widths"][0], 32, 16, 1]
    if "netC" in c:
        c["netC"]["head"]["widths"] = [256 + g["head"]["widths"][0], 32, 16, 3]
    recipe = c["weights"] if c["weights"]["kind"] == "seeded" else {
        "kind": "seeded"}                       # the npz's widths are cut
    c["weights"] = dict(recipe, head={"last_scale": 1.0,
                                      "last_z_weight": -8.0})
    p = c["profile"]            # the fields the profile's mode has
    p.update({k: v for k, v in dict(
        compute_dtype="float32", fine_res=33, window=24, march_levels=[9, 17],
        render_size=32).items() if k in p})
    c["profile"]["hierarchy"].update(resolutions=[5, 9, 17],
                                     budgets=[0, 512, 2048])
    return c


class SmallManifest(Manifest):
    """The repository's manifest with every configuration cut to
    ``small_config`` and the traffic to ``bodies`` bodies."""

    def __init__(self, bodies: int = 4, **kw):
        super().__init__(**kw)
        self.bodies = bodies

    def config(self, name: str) -> dict:
        return small_config(super().config(name))

    def traffic(self, name: str) -> dict:
        spec = dict(Manifest.traffic(name))
        spec["bodies"] = self.bodies
        if spec["camera"]["kind"] == "orbit":
            spec["camera"] = dict(spec["camera"], poses=8, pitch_step=45.0)
        return spec
