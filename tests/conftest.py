import os
import sys

# tests must see the single real CPU device (the dry-run, and only the
# dry-run, forces 512 placeholder devices via its own XLA_FLAGS)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one (on the "
        "card: python -m pytest -m card tests/test_torch_batched_card.py)")
