from .a2a_pack import BULK_MIN_BYTES, a2a_pack, a2a_unpack, variant
from .ref import a2a_pack_ref, a2a_unpack_ref

__all__ = ["a2a_pack", "a2a_unpack", "a2a_pack_ref", "a2a_unpack_ref",
           "variant", "BULK_MIN_BYTES"]
