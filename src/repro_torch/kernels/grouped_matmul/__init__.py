from .grouped_matmul import grouped_matmul, grouped_matmul_autograd, variant
from .ref import grouped_matmul_ref

__all__ = ["grouped_matmul", "grouped_matmul_autograd", "grouped_matmul_ref",
           "variant"]
