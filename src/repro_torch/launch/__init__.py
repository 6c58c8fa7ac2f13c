"""Launch-layer entry points of the port: ``serve`` (``ServingLoop`` and
``python -m repro_torch.launch.serve``)."""
