"""Scenarios, the CUDA-event timer, the runner and the ``bench.cli`` front end."""
