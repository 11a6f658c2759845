from repro_torch.kernels.gtc_compress.ops import gtc_compress
from repro_torch.kernels.gtc_compress.ref import gtc_compress_ref

__all__ = ["gtc_compress", "gtc_compress_ref"]
