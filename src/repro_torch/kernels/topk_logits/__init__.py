from repro_torch.kernels.topk_logits.ops import topk_logits
from repro_torch.kernels.topk_logits.ref import (topk_logits_ref,
                                                 topk_logits_tiles_ref)

__all__ = ["topk_logits", "topk_logits_ref", "topk_logits_tiles_ref"]
