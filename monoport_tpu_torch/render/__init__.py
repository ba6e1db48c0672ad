from .camera import make_rotate, orbit_extrinsic

__all__ = ["make_rotate", "orbit_extrinsic"]
