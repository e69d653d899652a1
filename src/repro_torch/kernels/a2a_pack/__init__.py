from .a2a_pack import a2a_pack, a2a_unpack
from .ref import a2a_pack_ref, a2a_unpack_ref

__all__ = ["a2a_pack", "a2a_unpack", "a2a_pack_ref", "a2a_unpack_ref"]
