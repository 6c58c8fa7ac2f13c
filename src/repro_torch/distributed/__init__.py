"""Parameter annotation shared by the models, and the trainer's fault
tolerance (the rest of ``repro.distributed`` is still to port)."""
from .fault_tolerance import (EXIT_PREEMPTED, PreemptionGuard, StepStats,
                              run_with_retries)
from .sharding import Param, is_param, split_tree

__all__ = ["Param", "is_param", "split_tree", "EXIT_PREEMPTED",
           "PreemptionGuard", "StepStats", "run_with_retries"]
