"""The comparison that decides ``correct``: the checked frames of the
window against the reference frames of the same inputs.

Shares pooled over every checked frame: ``valid_disagree`` the pixels
where the two silhouettes differ, over their union (1 - IOU);
``depth_bad`` the pixels valid in both whose depths differ by more than
the ``depth`` tolerance (fine voxels); ``norm_bad`` and ``tex_bad`` the
pixels that are subject in both renders whose normal or texture render
differs by more than the ``norm`` or ``tex`` tolerance (the largest
channel error, display units). Where the reference's path gives its
occupancy volume (``sdf``) and the margin of each pixel's ray
(``valid_margin``: how far the ray's largest occupancy lies from the
iso-level): ``valid_bad`` the silhouette pixels that differ where that
margin is over the ``valid`` tolerance, and ``sdf_bad`` the voxels on
different sides of the iso-level where the reference's occupancy lies
more than the ``sdf`` tolerance from it, each over the union of the two
sides' (the knife edges that f32 rounding alone flips are left out). A
non-finite value counts as off; a share with nothing to count reads 1,
as if every pixel were off (an empty frame proves nothing). The cell's
limits file gives the tolerances and the limit of each share it
compares.

Pooled shares, not a worst frame: the march pyramid decides at a coarse
level which surface a ray refines, and where an occupancy sits near the
iso-level there, bf16 rounding alone moves a thin limb's crossing or
silhouette in a frame. The silhouette is counted once, in
``valid_disagree``; the renders are compared where both frames have the
subject. A served frame's own shares (the matte, the served canvas over
the subject and over the floor, the JPEG) are ``serve.served_counts``'s.
"""

from __future__ import annotations

import torch

NUMBERS = ("valid_disagree", "valid_bad", "depth_bad", "norm_bad",
           "tex_bad", "sdf_bad", "alpha_bad", "served_bad", "floor_bad",
           "jpeg_bad")


def _subject(img: torch.Tensor) -> torch.Tensor:
    return ~(img >= 1.0).all(dim=-1)


def _off(err: torch.Tensor, tol: float) -> int:
    return int((~(err <= tol)).sum())


def _far(margin: torch.Tensor, tol: float) -> int:
    return int((margin > tol).sum())


def _largest(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _p995(err: torch.Tensor) -> float:
    if err.numel() == 0:
        return 0.0
    return float(torch.quantile(err.double().flatten()[:16_000_000], 0.995))


def inside(out: dict, level: float) -> torch.Tensor:
    """The voxels of a frame's volume above the iso-level: its ``inside``
    (what a cell keeps of the volume) or its ``sdf`` > ``level``."""
    return out["inside"] if "inside" in out else out["sdf"] > level


def frame_counts(got: dict, want: dict, tols: dict,
                 level: float | None = None) -> dict:
    """One frame's {number: [pixels off, pixels counted]} and, for the
    record, the 99.5th percentile of each error (``*_p995``) and the
    largest reference margin of a flipped pixel or voxel (``*_flip``);
    ``level``: the profile's iso-level, for the volume."""
    gv, wv = got["valid"].bool(), want["valid"].bool()
    both = gv & wv
    union = int((gv | wv).sum())
    depth_err = (got["depth"].float() - want["depth"].float()).abs()[both]
    out = {"valid_disagree": [int((gv != wv).sum()), union],
           "depth_bad": [_off(depth_err, tols["depth"]), int(both.sum())],
           "depth_p995": _p995(depth_err)}
    if "valid" in tols and "valid_margin" in want:
        flip = want["valid_margin"][gv != wv]
        out["valid_bad"] = [_far(flip, tols["valid"]), union]
        out["valid_flip"] = _largest(flip)
    if "sdf" in tols and "sdf" in want and level is not None:
        gi, wi = inside(got, level), inside(want, level)
        flip = (want["sdf"].float() - level).abs()[gi != wi]
        out["sdf_bad"] = [_far(flip, tols["sdf"]), int((gi | wi).sum())]
        out["sdf_flip"] = _largest(flip)
    for key, name in (("render_norm", "norm"), ("render_tex", "tex")):
        if key in got and key in want and name in tols:
            a, b = got[key].float(), want[key].float()
            err = (a - b).abs().amax(dim=-1)[_subject(a) & _subject(b)]
            out[f"{name}_bad"] = [_off(err, tols[name]), int(err.numel())]
            out[f"{name}_p995"] = _p995(err)
    return out


def pooled(per_frame: list) -> dict:
    """The shares over all checked frames (1 where nothing was
    counted)."""
    out = {}
    for k in NUMBERS:
        if per_frame and k in per_frame[0]:
            off = sum(f[k][0] for f in per_frame)
            total = sum(f[k][1] for f in per_frame)
            out[k] = off / total if total else 1.0
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the numbers ``limits``
    names: every one read and under its limit."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
