"""Config name -> Model facade (the port of ``repro.models.registry``)."""
from ..configs import get_config
from .transformer import Model


def build_model(name_or_cfg, *, plain: bool = False) -> Model:
    """The port's model of a config name or a ``ModelConfig``;
    ``plain=True`` keeps the card's decode attention on the plain
    version (a reference path for checks)."""
    cfg = (name_or_cfg if not isinstance(name_or_cfg, str)
           else get_config(name_or_cfg))
    return Model(cfg, plain=plain)
