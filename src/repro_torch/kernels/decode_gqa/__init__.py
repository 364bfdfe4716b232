from repro_torch.kernels.decode_gqa.ops import decode_attention
from repro_torch.kernels.decode_gqa.ref import (decode_attention_naive,
                                                decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_ref",
           "decode_attention_naive"]
