from .depth_normalizer import DepthNormalizer, PIFuNomalizer

__all__ = ["DepthNormalizer", "PIFuNomalizer"]
