"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100, ``sm_90a``).

The package mirrors ``repro``'s module names.  It imports ``torch`` and
never ``jax`` or ``repro``: the JAX package is the reference the tests hold
this port against, on shared numpy inputs.  See ``README.md`` here.
"""
