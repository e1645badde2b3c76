from .fault_tolerance import StragglerDetector

__all__ = ["StragglerDetector"]
