from .camera import (BaseCamera, CameraPose, PerspectiveCamera, make_rotate,
                     orbit_extrinsic)
from .rasterizer import (AlbedoRender, NormalRender, PrtRender, ShRender,
                         rasterize)
from .sh import evaluate_sh_basis, sh_rotation_matrix

__all__ = ["BaseCamera", "CameraPose", "PerspectiveCamera", "make_rotate",
           "orbit_extrinsic", "rasterize", "AlbedoRender", "NormalRender",
           "ShRender", "PrtRender", "evaluate_sh_basis",
           "sh_rotation_matrix"]
