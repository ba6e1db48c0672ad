"""A configuration brings its reference as new files: a backbone is found
by its IMF name in a backbone directory, a frame path by its mode in a
frame directory, and what is in neither raises."""

import json

import numpy as np
import pytest
import torch

from cardbench.harness import weights, work
from cardbench.harness.manifest import Manifest
from cardbench.reference import nets
from cardbench.reference.frame import frame_path, reference_frame

TINY = '''
import torch.nn as nn
import torch.nn.functional as F

from cardbench.reference.nets import BatchNorm


class Tiny(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 3, stride=2, padding=1)
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=2, padding=1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        return [(self.conv2(x).permute(0, 2, 3, 1),)]


def build(spec):
    return Tiny(spec["width"])
'''


def _spec(imf):
    return {"projection": "orthogonal",
            "backbone": {"IMF": imf, "width": 8, "norm": "batch"},
            "head": {"widths": [9, 16, 1], "last_op": "sigmoid"}}


@pytest.fixture
def backbones(tmp_path, monkeypatch):
    (tmp_path / "TinyLookupFilters.py").write_text(TINY)
    monkeypatch.setattr(nets, "BACKBONE_DIR", str(tmp_path))
    return tmp_path


def test_backbone_found_in_a_directory(tmp_path):
    (tmp_path / "TinyDirFilters.py").write_text(TINY)
    net = nets.backbone({"IMF": "TinyDirFilters", "width": 4},
                        directory=str(tmp_path))
    out = net(torch.zeros(1, 16, 16, 3))
    assert out[-1][-1].shape == (1, 4, 4, 4)


def test_a_new_backbone_by_name_alone(backbones):
    """Built, seeded, its norms fitted and run through ``ImplicitNet``,
    and its convolutions counted, with no file of the benchmark edited."""
    spec = _spec("TinyLookupFilters")
    recipe = {"kind": "seeded",
              "head": {"last_scale": 1.0, "last_z_weight": -8.0}}
    images = torch.rand(3, 32, 32, 3)
    state = weights.seeded_state(spec, recipe, 5, "cpu")
    weights.fit_norm_stats(spec, state, images)
    net = nets.ImplicitNet(spec)
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        feats = net.filter(images[:1])
        occ = net.query(feats, torch.rand(1, 50, 3) * 2 - 1,
                        torch.eye(4)[None])
    assert occ.shape == (1, 50, 1) and torch.isfinite(occ).all()
    assert set(state) >= {"image_filter.bn1.running_var",
                          "surface_classifier.filters_1.weight"}
    assert work.backbone_flops(spec["backbone"], 32) == pytest.approx(
        2.0 * (3 * 8 * 9 * 16 * 16 + 8 * 8 * 9 * 8 * 8))


def test_unknown_backbone_raises(backbones):
    with pytest.raises(ValueError, match="no reference backbone"):
        nets.backbone({"IMF": "NoSuchFilters"})
    with pytest.raises(ValueError, match="no reference backbone"):
        nets.ImplicitNet(_spec("NoSuchFilters"))


FRAME = '''
class Frame:
    def __init__(self, config, nets):
        self.config = config


def queries(config, calib, rows):
    return [("netG", "point", n, 1) for n in rows]
'''


def test_frame_path_found_by_mode(tmp_path):
    (tmp_path / "sparse.py").write_text(FRAME)
    path = frame_path("sparse", directory=str(tmp_path))
    assert path.queries({}, None, (3, 4)) == [("netG", "point", 3, 1),
                                              ("netG", "point", 4, 1)]
    assert frame_path("dense").Frame.__name__ == "Frame"


def test_unknown_mode_raises():
    config = json.loads(json.dumps(Manifest().config("monoport-hg4-quality")))
    config["profile"]["mode"] = "no-such-mode"
    with pytest.raises(ValueError, match="no reference frame path"):
        reference_frame(config, {"netG": None})
    with pytest.raises(ValueError, match="no reference frame path"):
        work.frame_head_works(config, np.eye(4)[None], None, (1,))
    with pytest.raises(ValueError, match="no reference frame path"):
        frame_path("ray")
