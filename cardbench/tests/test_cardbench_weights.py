"""The seeded recipe's norm statistics: every BatchNorm's running mean
and variance are those of its input over the traffic's images."""

import pytest
import torch

from cardbench.harness import traffic, weights
from cardbench.reference.nets import ImplicitNet

from .small import SmallManifest


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_norm_stats_fitted_to_the_traffic():
    m = SmallManifest(bodies=3)
    config = m.config("monoport-hrnet-w18-small-v2")
    assert config["weights"]["norm_stats"] == "traffic"
    tr = traffic.generate(m.traffic("frontal"), 7, config["image_size"], "cpu")
    state = weights.states(config, 7, "cpu", tr.images)["netG"]
    drawn = weights.seeded_state(config["netG"], config["weights"], 7, "cpu")
    net = ImplicitNet(config["netG"])
    net.load_state_dict(state)
    seen = []

    def look(mod, args):
        x = args[0]
        seen.append((x.mean(dim=(0, 2, 3)) - mod.running_mean).abs().max()
                    + (x.var(dim=(0, 2, 3)) - mod.running_var).abs().max())

    for mod in net.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(look)
    with torch.no_grad():
        net.filter(tr.images)
    assert seen and max(float(d) for d in seen) < 1e-3
    moved = [k for k in state if not torch.equal(state[k], drawn[k])]
    assert moved and all(k.endswith(("running_mean", "running_var"))
                         for k in moved)

