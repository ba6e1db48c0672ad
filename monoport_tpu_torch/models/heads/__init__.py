from .surface_classifier import (HEAD_SPECS, HEADS, PIFuNetCMLP, PIFuNetGMLP,
                                 SurfaceClassifier)

__all__ = ["SurfaceClassifier", "PIFuNetGMLP", "PIFuNetCMLP", "HEADS",
           "HEAD_SPECS"]
