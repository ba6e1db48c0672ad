"""monoport_tpu_torch — the PyTorch/CUDA port of ``monoport_tpu``.

The JAX package ``monoport_tpu`` stays the reference; this package
reimplements its frames in PyTorch: the real-time frames, frontal and
rotated (free viewpoint), the dense/hierarchy frames, clips and mesh
extraction, with the ray, anchored-ray, per-point and gathering-ray MLPs
as hand-written Hopper kernels (``ops/cuda/fused_ray_mlp.py``,
``ops/cuda/fused_mlp.py``, ``ops/cuda/fused_gather_mlp.py``). It imports
``torch`` and never ``jax`` or ``monoport_tpu``. Public functions keep the
JAX package's layouts (NHWC features, point-major ``[B, N, 3]`` points,
``[B, R, T]`` taps) so the two are compared like with like.

Entry points (``ReconEngine``, ``load_default_networks``) run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import CfgNode, CN, get_cfg_defaults

__all__ = ["CfgNode", "CN", "get_cfg_defaults", "__version__"]
