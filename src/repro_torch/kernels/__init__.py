"""Hand-written Hopper kernels with their plain-torch versions and oracles.

``ops`` holds the entry points.  A CUDA tensor launches the kernel (built
from ``repro_torch/csrc`` at first use) or raises; a CPU tensor takes the
kernel's plain version.
"""
