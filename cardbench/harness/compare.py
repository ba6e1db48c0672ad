"""The comparison that decides ``correct``: the checked frames of the
window against the reference frames of the same inputs.

Shares pooled over every checked frame: ``valid_disagree`` the pixels
where the two silhouettes differ, over their union (1 - IOU);
``depth_bad`` the pixels valid in both whose depths differ by more than
the ``depth`` tolerance (fine voxels); ``norm_bad`` and ``tex_bad`` the
pixels that are subject in both renders whose normal or texture render
differs by more than the ``norm`` or ``tex`` tolerance (the largest
channel error, display units). A non-finite value counts as off. The
cell's limits file gives the tolerances and the limit of each share it
compares.

Pooled shares, not a worst frame: the march pyramid decides at a coarse
level which surface a ray refines, and where an occupancy sits near the
iso-level there, bf16 rounding alone moves a thin limb's crossing or
silhouette in a frame. The silhouette is counted once, in
``valid_disagree``; the renders are compared where both frames have the
subject.
"""

from __future__ import annotations

import torch

NUMBERS = ("valid_disagree", "depth_bad", "norm_bad", "tex_bad")


def _subject(img: torch.Tensor) -> torch.Tensor:
    return ~(img >= 1.0).all(dim=-1)


def _off(err: torch.Tensor, tol: float) -> int:
    return int((~(err <= tol)).sum())


def _p995(err: torch.Tensor) -> float:
    if err.numel() == 0:
        return 0.0
    return float(torch.quantile(err.double().flatten()[:16_000_000], 0.995))


def frame_counts(got: dict, want: dict, tols: dict) -> dict:
    """One frame's {number: [pixels off, pixels counted]} and, for the
    record, the 99.5th percentile of each error (``*_p995``)."""
    gv, wv = got["valid"].bool(), want["valid"].bool()
    both = gv & wv
    depth_err = (got["depth"].float() - want["depth"].float()).abs()[both]
    out = {"valid_disagree": [int((gv != wv).sum()), int((gv | wv).sum())],
           "depth_bad": [_off(depth_err, tols["depth"]), int(both.sum())],
           "depth_p995": _p995(depth_err)}
    for key, name in (("render_norm", "norm"), ("render_tex", "tex")):
        if key in got and key in want and name in tols:
            a, b = got[key].float(), want[key].float()
            err = (a - b).abs().amax(dim=-1)[_subject(a) & _subject(b)]
            out[f"{name}_bad"] = [_off(err, tols[name]), int(err.numel())]
            out[f"{name}_p995"] = _p995(err)
    return out


def pooled(per_frame: list) -> dict:
    """The shares over all checked frames."""
    out = {}
    for k in NUMBERS:
        if per_frame and k in per_frame[0]:
            off = sum(f[k][0] for f in per_frame)
            out[k] = off / max(sum(f[k][1] for f in per_frame), 1)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the numbers ``limits``
    names: every one read and under its limit."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
