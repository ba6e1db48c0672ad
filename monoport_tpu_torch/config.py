"""Configuration system of the PyTorch port.

A copy of the JAX package's minimal yacs-compatible CfgNode and default
tree (``monoport_tpu/config.py``), kept here so that the port imports
nothing of ``monoport_tpu``. Supports ``merge_from_file`` (YAML, imported
only when called), ``merge_from_list`` (dotted key/value pairs) and
``freeze``. Factory-name dispatch ("IMF") resolves through the explicit
registries of ``monoport_tpu_torch.models``.
"""

from __future__ import annotations

import ast
import copy
from typing import Any


class CfgNode(dict):
    """Dict with attribute access, freezing, and yacs-style merging."""

    def __init__(self, init=None):
        super().__init__()
        self.__dict__["_frozen"] = False
        if init is not None:
            # accept any Mapping (incl. flax FrozenDict from module fields)
            for k, v in init.items():
                self[k] = CfgNode(v) if hasattr(v, "items") else v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "__dict__":
            object.__setattr__(self, name, value)
            return
        if self.__dict__.get("_frozen"):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    # -- freezing -----------------------------------------------------------
    def freeze(self) -> "CfgNode":
        self.__dict__["_frozen"] = True
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        self.__dict__["_frozen"] = False
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # -- merging ------------------------------------------------------------
    def merge_from_dict(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, f"override list must be key/value pairs: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass
            node[leaf] = value

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, CfgNode) else v
            for k, v in self.items()
        }

    def __deepcopy__(self, memo):
        new = CfgNode()
        for k, v in self.items():
            new[k] = copy.deepcopy(v, memo)
        return new

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


CN = CfgNode


def _net_defaults(backbone: str, head: str, loss: str) -> CfgNode:
    net = CN()
    net.mean = (0.5, 0.5, 0.5)
    net.std = (0.5, 0.5, 0.5)
    net.ckpt_path = ""
    net.projection = "orthogonal"
    net.backbone = CN({"IMF": backbone})
    net.normalizer = CN({"IMF": "PIFuNomalizer", "soft_onehot": False,
                         "soft_dim": 64})
    net.head = CN({"IMF": head})
    net.loss = CN({"IMF": loss})
    # not in the tree, which is the JAX package's: ``num_views``, the views
    # of one subject a multi-view net pools (models/monoport_net.py), read
    # with the default 1 and set as any key (``netG.num_views 4``)
    return net


def get_cfg_defaults() -> CfgNode:
    """Default config tree (parity: reference common/config.py:4-94, plus
    TPU-specific knobs under ``tpu`` and ``recon``)."""
    c = CN()
    # trainer
    c.name = "default"
    c.checkpoints_path = "./data/checkpoints/"
    c.results_path = "./data/results/"
    c.learning_rate = 1e-3
    c.weight_decay = 0.0
    c.momentum = 0.0
    c.optim = "RMSprop"
    c.schedule = [15, 20]
    c.gamma = 0.1
    # global-norm gradient clip, 0 = off. Not in the reference config;
    # load-bearing for netC (the un-normalized ResnetFilter output
    # explodes under plain adam at lr >= 1e-3 and saturates the tanh
    # head to zero gradients — apps/train_capsule_netC.py measured it)
    c.grad_clip = 0.0
    c.resume = False
    # train loop
    c.batch_size = 4
    c.num_threads = 4
    c.num_epoch = 100
    c.freq_plot = 10
    c.freq_save = 100
    c.freq_eval = 100
    c.freq_vis = 100
    # nets
    c.netG = _net_defaults("PIFuHGFilters", "PIFuNetGMLP", "MSE")
    c.netC = _net_defaults("PIFuResBlkFilters", "PIFuNetCMLP", "L1")
    # dataset (parity: config.py:81-94; roots are config, not hardcoded)
    c.dataset = CN()
    c.dataset.root_render = ""
    c.dataset.root_sample = ""
    c.dataset.aug_bri = 0.4
    c.dataset.aug_con = 0.4
    c.dataset.aug_sat = 0.4
    c.dataset.aug_hue = 0.0
    c.dataset.blur = 1.0
    c.dataset.num_sample_geo = 5000
    c.dataset.num_sample_color = 0
    c.dataset.sigma_geo = 0.05
    c.dataset.sigma_color = 0.001
    c.dataset.pre_load = False
    c.dataset.align_hip = False
    c.dataset.score_filter = 0.0
    c.dataset.scale_uniform = False
    # yaw sampling stride in degrees (reference hardcodes every 1 degree,
    # ppl_dynamic.py:58-59; configurable here so miniature fixture trees
    # don't need 360 renders per motion)
    c.dataset.rotation_step = 1
    # network input resolution after crop+resize (reference hardcodes 512,
    # dataset/utils.py:14-71; configurable so CI can train small)
    c.dataset.input_size = 512
    # hierarchical reconstruction (replaces ImplicitSegCUDA's Seg3dLossless)
    c.recon = CN()
    c.recon.resolutions = [17, 33, 65, 129, 257]
    c.recon.balance_value = 0.5
    c.recon.budgets = [0, 16384, 32768, 131072, 262144]  # 0 = dense level
    c.recon.boundary_tau = 0.20
    c.recon.dilate = 1
    # 'uncertain' (Seg3dTopk-style) by default: on budget overflow the
    # most-confident voxels are dropped first, so the iso-band survives
    # instead of silently truncating the far side of the scan order
    c.recon.select = "uncertain"       # or "first" (scan order, cheapest)
    # mode 'dense' = exact full-resolution volume; 'ray' = coarse volume +
    # per-ray refinement (the real-time path; see recon/ray_refine.py)
    c.recon.mode = "dense"
    c.recon.fine_res = 257
    c.recon.ray_taps = 6
    c.recon.ray_window = 0            # 0 = full frame; e.g. 192 = bbox window
    # ray mode only: volume-free march pyramid on frontal frames
    # (recon/ray_refine.ray_pyramid; [] disables).
    c.recon.march_levels = [33, 65]
    # rotated view calibs (orbit camera) also march, via the exact
    # per-point query; False = r2 behavior (hierarchy fallback)
    c.recon.march_rotated = True
    # TPU execution
    c.tpu = CN()
    c.tpu.compute_dtype = "bfloat16"
    c.tpu.param_dtype = "float32"
    c.tpu.use_pallas = True
    c.tpu.mesh_axes = CN({"data": 1, "points": 1})
    return c
