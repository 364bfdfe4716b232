from repro_torch.kernels.ssd_chunk.ops import ssd_forward, ssd_intra
from repro_torch.kernels.ssd_chunk.ref import (ssd_chunked_ref,
                                               ssd_decode_step, ssd_intra_ref,
                                               ssd_scan_ref)

__all__ = ["ssd_forward", "ssd_intra", "ssd_intra_ref", "ssd_chunked_ref",
           "ssd_scan_ref", "ssd_decode_step"]
