from . import kernel, ops, ref, work

__all__ = ["kernel", "ops", "ref", "work"]
