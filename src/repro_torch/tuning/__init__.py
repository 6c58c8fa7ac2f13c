"""Autotuning: empirical async-strategy search with a persistent registry.

The counterpart of ``repro.tuning``, measuring the card's kernels (or, on
the CPU, their plain torch versions):

  SearchSpace / TuningTask   enumerate candidates, prune by the card's
                             limits and analytically
  Autotuner                  time survivors (warmup/repeat/outliers)
  Registry                   schema-versioned JSON cache with provenance
  tuned(...)                 best-config lookup for a call site
  apply_registry_defaults()  install winners as kernel defaults

CLI:  PYTHONPATH=src python -m repro_torch.tuning.cli tune --kernel stream
"""
from .registry import (Measurement, Registry, SchemaMismatch, TuningRecord,
                       SCHEMA_VERSION, default_registry_path, make_key)
from .search_space import (Candidate, KernelSpec, SearchSpace, TuningTask,
                           KERNELS, SPECS, default_task, issue_ahead,
                           predict_time, strategy_depth_waits)
from .autotuner import (Autotuner, TimingStats, apply_registry_defaults,
                        apply_tuned_kernel_defaults, decode_config,
                        time_callable, tune_kernel, tuned)

__all__ = [
    "Autotuner", "Candidate", "KernelSpec", "KERNELS", "Measurement",
    "Registry", "SCHEMA_VERSION", "SchemaMismatch", "SearchSpace", "SPECS",
    "TimingStats", "TuningRecord", "TuningTask", "apply_registry_defaults",
    "apply_tuned_kernel_defaults", "decode_config", "default_registry_path",
    "default_task", "issue_ahead", "make_key", "predict_time",
    "strategy_depth_waits", "time_callable", "tune_kernel", "tuned",
]
