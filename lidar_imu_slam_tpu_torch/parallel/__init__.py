from . import streams

__all__ = ["streams"]
