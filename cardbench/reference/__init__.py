"""The benchmark's plain reference of a frame (imports nothing of the
system under test).

A configuration brings what this package lacks as new files, found by
name. A backbone whose ``IMF`` is not one of ``nets.backbone``'s three is
``backbones/<IMF>.py``: it exports ``build(spec) -> nn.Module`` for the
configuration's ``backbone`` entry, whose forward takes NHWC images and
returns a list of stages, each a sequence of NHWC feature maps, with
parameter names as the checkpoints have them. A profile ``mode`` other
than ``'ray'`` is ``frames/<mode>.py``: it exports ``Frame(config,
nets)``, with ``plan``, ``hint_after`` and ``__call__(image_g, image_c,
calib, hint)`` returning ``depth``, ``valid``, ``render_norm`` and, with
netC, ``render_tex``, and ``rows(image_g, calib)``, the rows of each
query of its frame; and ``queries(config, calib, rows)``, the head
queries those rows make, which ``harness/work.py`` counts. Such a file is
plain PyTorch in float32, imports this package's modules by absolute name
(``cardbench.reference.nets``) and nothing of the system under test.
"""
