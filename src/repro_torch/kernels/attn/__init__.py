from repro_torch.kernels.attn.ops import (DEFAULT_PAGE, flash_attention,
                                         flash_ok,
                                         identity_block_table,
                                         packed_flash_attention,
                                         paged_decode_attention)
from repro_torch.kernels.attn.ref import (flash_prefill_ref, gather_pages,
                                          packed_prefill_ref,
                                          paged_decode_ref)

__all__ = ["flash_attention", "packed_flash_attention",
           "paged_decode_attention", "identity_block_table", "flash_ok",
           "DEFAULT_PAGE", "flash_prefill_ref",
           "packed_prefill_ref", "paged_decode_ref", "gather_pages"]
