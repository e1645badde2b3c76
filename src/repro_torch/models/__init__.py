from . import attention, common, convert, lm, mlp

__all__ = ["attention", "common", "convert", "lm", "mlp"]
