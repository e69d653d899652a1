"""Model code: the MoE layer, the decoder LM for the dense and moe block
kinds, and the ``build_model`` surface."""

from .dist import DistContext, choose_ep_axes
from .model import Model, build_model

__all__ = ["DistContext", "choose_ep_axes", "Model", "build_model"]
