from .loader import DataLoader
from .synthetic import SyntheticBlobDataset
from .ppl import PPLDynamicDataset, PPLStaticDataset
from .utils import load_image, projection, make_batches

__all__ = ["DataLoader", "SyntheticBlobDataset", "PPLDynamicDataset", "PPLStaticDataset",
           "load_image", "projection", "make_batches"]
