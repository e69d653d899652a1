"""Model code: the MoE layer, the recurrent blocks, the decoder LM for every
decoder-only block kind, the encoder-decoder, and the ``build_model``
surface."""

from .dist import DistContext, choose_ep_axes
from .model import Model, build_model

__all__ = ["DistContext", "choose_ep_axes", "Model", "build_model"]
