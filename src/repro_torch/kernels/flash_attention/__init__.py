from .flash_attention import (flash_attention, flash_attention_autograd,
                              flash_attention_bwd)
from .ref import attention_lse_ref, attention_ref, flash_attention_bwd_ref

__all__ = ["flash_attention", "flash_attention_autograd",
           "flash_attention_bwd", "attention_ref", "attention_lse_ref",
           "flash_attention_bwd_ref"]
