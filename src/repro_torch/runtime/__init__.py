from .fault_tolerance import (
    FaultToleranceReport,
    Heartbeat,
    StragglerDetector,
    run_with_restarts,
)

__all__ = ["Heartbeat", "StragglerDetector", "run_with_restarts",
           "FaultToleranceReport"]
