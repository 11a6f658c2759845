from repro_torch.kernels.sparse_ce.ops import (sparse_ce_lse_gather,
                                               topk_distill_ce)
from repro_torch.kernels.sparse_ce.ref import (sparse_ce_lse_gather_ref,
                                               topk_distill_ce_ref)

__all__ = ["sparse_ce_lse_gather", "topk_distill_ce",
           "sparse_ce_lse_gather_ref", "topk_distill_ce_ref"]
