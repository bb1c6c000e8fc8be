from . import api, layout, ops

__all__ = ["api", "layout", "ops"]
