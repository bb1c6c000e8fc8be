from . import dense

__all__ = ["dense"]
