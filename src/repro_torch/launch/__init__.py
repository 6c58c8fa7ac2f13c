"""Launch-layer entry points of the port: ``serve`` (``ServingLoop`` and
``python -m repro_torch.launch.serve``) and ``train`` (``build_train_step``,
``train_loop`` and ``python -m repro_torch.launch.train``)."""
