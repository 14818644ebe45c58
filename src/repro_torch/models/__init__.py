"""The LM stack of the port: shared layers (``common``), the decoder LM
(``transformer``) and ``build_model`` (``registry``)."""
from .registry import build_model
from .transformer import Model, params_from_reference

__all__ = ["Model", "build_model", "params_from_reference"]
