from repro_torch.kernels.attn.ops import (DEFAULT_PAGE, identity_block_table,
                                         paged_decode_attention)
from repro_torch.kernels.attn.ref import paged_decode_ref

__all__ = ["paged_decode_attention", "identity_block_table", "DEFAULT_PAGE",
           "paged_decode_ref"]
