from .adamw import BLOCK_ELEMS, CAPACITY, Launch, adamw_step, plan, sq_norm
from .ref import adamw_step_ref, sq_norm_ref

__all__ = ["sq_norm", "adamw_step", "sq_norm_ref", "adamw_step_ref", "plan",
           "Launch", "BLOCK_ELEMS", "CAPACITY"]
