"""Cost model and kernel specs (the autotuner comes with a later slice)."""
