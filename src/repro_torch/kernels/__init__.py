from . import flash_attention, ssd

__all__ = ["flash_attention", "ssd"]
