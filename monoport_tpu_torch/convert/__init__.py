from .torch_loader import (convert_backbone_state, convert_head_state,
                           convert_monoport_state, load_darknet_conv137,
                           load_legacy_pifu, merge_backbone_pretrained)

__all__ = ["convert_backbone_state", "convert_head_state",
           "convert_monoport_state", "load_darknet_conv137",
           "load_legacy_pifu", "merge_backbone_pretrained"]
