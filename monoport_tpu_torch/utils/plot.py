"""Debug visualization (port of ``monoport_tpu/utils/plot.py``).

``plot_mask3D`` mirrors the implicit_seg helper the reference imports for
debugging the occupancy volume. matplotlib is imported inside the
function: importing this module needs none.
"""

from __future__ import annotations

import numpy as np


def plot_mask3D(mask, title: str = "mask", point_limit: int = 20000,
                save_path: str | None = None):
    """Scatter-plot the occupied voxels of a [D, H, W] (or [1, 1, D, H, W])
    mask, a numpy array or a tensor. -> ``save_path`` when given (the
    figure is written and closed), else the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if hasattr(mask, "detach"):
        mask = mask.detach().float().cpu().numpy()
    m = np.asarray(mask)
    while m.ndim > 3:
        m = m[0]
    occ = np.argwhere(m > 0.5)
    if len(occ) > point_limit:
        occ = occ[np.random.RandomState(0).choice(
            len(occ), point_limit, replace=False)]
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    if len(occ):
        ax.scatter(occ[:, 2], occ[:, 1], occ[:, 0], s=1, alpha=0.5)
    ax.set_title(title)
    for setter, dim in ((ax.set_xlim, 2), (ax.set_ylim, 1),
                        (ax.set_zlim, 0)):
        setter(0, m.shape[dim])
    if save_path:
        fig.savefig(save_path, dpi=80)
        plt.close(fig)
        return save_path
    return fig
