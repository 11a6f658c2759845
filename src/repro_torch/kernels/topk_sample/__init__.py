from repro_torch.kernels.topk_sample.ops import (K_CAP_DEFAULT, gumbel_rows,
                                                 topk_sample)
from repro_torch.kernels.topk_sample.ref import topk_sample_ref

__all__ = ["K_CAP_DEFAULT", "gumbel_rows", "topk_sample", "topk_sample_ref"]
