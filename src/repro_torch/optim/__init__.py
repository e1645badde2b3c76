from .adamw import AdamWConfig, adamw_update, init_opt_state

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state"]
