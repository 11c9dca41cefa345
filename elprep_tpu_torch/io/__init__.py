from . import sam

__all__ = ["sam"]
