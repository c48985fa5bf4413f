from .attention import (decode_attention, dense_attention, flash_attention,
                        segment_mask, use_decode_kernel, use_flash)

__all__ = ["decode_attention", "dense_attention", "flash_attention",
           "segment_mask", "use_decode_kernel", "use_flash"]
