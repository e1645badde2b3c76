from . import kernel, work

__all__ = ["kernel", "work"]
