"""Declarative benchmark scenarios: kernel x shape x dtype x strategy.

The counterpart of ``repro.bench.scenario`` for the ported kernels.  It
registers the reference's own parity cells under the same names and shapes
(``smoke/*``, ``fig3/stream/*``, ``fig4/hotspot/*``), whose working sets fit
the H100's 50 MB L2, and the ``h100/*`` cells at HBM scale:

  h100/stream/<strategy>   (16384, 4096) f32, iters=1, tile_rows=16,
                           n_tiles=8: 256 MiB in + 256 MiB out
  h100/hotspot/<strategy>  (8192, 8192) f32, iters=1, grid=32 row bands x
                           32 column tiles = 1024 blocks (7.8 per SM):
                           256 MiB each of temp, power and out

``args_from_numpy`` and ``config_from_reference`` carry inputs and configs
across from the reference package, which is how the tests hold the two to
each other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.async_pipeline import Strategy, parse_strategy
from ..kernels import ops, ref
from ..tuning.search_space import KERNELS, SPECS

__all__ = ["Scenario", "register", "get_scenario", "scenarios",
           "call_kernel", "check_output", "CALLERS", "ORACLES", "CHECK_TOL",
           "KERNELS", "args_from_numpy", "config_from_reference"]


@dataclass(frozen=True)
class Scenario:
    """One runnable benchmark cell."""
    name: str                            # unique, hierarchical: "fig3/..."
    kernel: str                          # key into SPECS / ops
    shape: Tuple[int, ...]
    dtype: str = "float32"
    strategy: Optional[Strategy] = None  # None -> the resolved default
    config: Dict[str, Any] = field(default_factory=dict)   # tile overrides
    workload: Dict[str, Any] = field(default_factory=dict) # iters/grid/..
    tags: Tuple[str, ...] = ()
    smoke: bool = False
    section: str = ""                    # paper figure/table it feeds

    def __post_init__(self):
        if self.kernel not in SPECS:
            raise KeyError(f"unknown kernel {self.kernel!r}; "
                           f"known: {tuple(SPECS)}")
        object.__setattr__(self, "shape",
                           tuple(int(s) for s in self.shape))

    def make_args(self, device: Any = "cuda", seed: int = 0) -> Tuple:
        """The inputs, drawn on ``device`` from a generator seeded with
        ``seed``."""
        g = torch.Generator(device=device).manual_seed(seed)
        return SPECS[self.kernel].make_args(self.shape, self.dtype, g,
                                            device)

    def matches(self, *, only: Optional[str] = None,
                kernel: Optional[str] = None,
                strategy: Optional[Strategy] = None,
                tag: Optional[str] = None,
                smoke: Optional[bool] = None) -> bool:
        if only is not None and not any(
                tok and tok in self.name for tok in only.split(",")):
            return False
        if kernel is not None and kernel != self.kernel:
            return False
        if strategy is not None and self.strategy not in (None, strategy):
            return False
        if tag is not None and tag not in self.tags:
            return False
        if smoke is not None and self.smoke != smoke:
            return False
        return True


#: kernel -> fn(args, config, workload) -> tensor.  The config dict holds
#: exactly the KERNEL_DEFAULTS keys; workload holds the problem parameters
#: a figure sweeps.
CALLERS: Dict[str, Callable[..., Any]] = {
    "stream": lambda a, cfg, w: ops.stream(
        a[0], iters=w.get("iters", 4), **cfg),
    "hotspot": lambda a, cfg, w: ops.hotspot(
        a[0], a[1], iters=w.get("iters", 1), grid=w.get("grid", 1), **cfg),
}

#: kernel -> fn(args, workload) -> reference output (kernels.ref oracle).
ORACLES: Dict[str, Callable[..., Any]] = {
    "stream": lambda a, w: ref.stream_ref(a[0], iters=w.get("iters", 4)),
    "hotspot": lambda a, w: ref.hotspot_ref(a[0], a[1],
                                            iters=w.get("iters", 1)),
}

#: max |kernel - oracle| each kernel is held to (the reference's values)
CHECK_TOL: Dict[str, float] = {"stream": 1e-5, "hotspot": 1e-2}


def call_kernel(sc: Scenario, args: Tuple, config: Dict[str, Any]):
    return CALLERS[sc.kernel](args, config, sc.workload)


def check_output(sc: Scenario, args: Tuple, out) -> float:
    """Max abs error of ``out`` against the plain-torch oracle."""
    want = ORACLES[sc.kernel](args, sc.workload)
    return float((out.float() - want.float()).abs().max())


def args_from_numpy(kernel: str, arrays: Sequence[np.ndarray],
                    device: Any = "cuda") -> Tuple[torch.Tensor, ...]:
    """The port's arguments for ``kernel`` from numpy arrays (bfloat16
    arrays, as numpy receives them from JAX, keep their bits)."""
    if kernel not in SPECS:
        raise KeyError(f"unknown kernel {kernel!r}; known: {tuple(SPECS)}")
    out = []
    for a in arrays:
        a = np.array(a, order="C")      # a writable copy torch may own
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out.append(t.to(device))
    return tuple(out)


def config_from_reference(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The port's config for a reference config dict; ``strategy`` may be
    the reference's enum or its string."""
    out = dict(cfg)
    if "strategy" in out:
        s = out["strategy"]
        out["strategy"] = parse_strategy(getattr(s, "value", s))
    return out


_SCENARIOS: Dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    """Add ``sc`` to the registry; re-registering a name with a different
    definition is an error."""
    existing = _SCENARIOS.get(sc.name)
    if existing is not None and existing != sc:
        raise ValueError(f"scenario {sc.name!r} already registered "
                         f"with a different definition")
    _SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; run "
                       f"`python -m repro_torch.bench.cli list`") from None


def scenarios(*, only: Optional[str] = None, kernel: Optional[str] = None,
              strategy: Optional[Strategy] = None, tag: Optional[str] = None,
              smoke: Optional[bool] = None) -> List[Scenario]:
    return [s for _, s in sorted(_SCENARIOS.items())
            if s.matches(only=only, kernel=kernel, strategy=strategy,
                         tag=tag, smoke=smoke)]


def _register_defaults() -> None:
    register(Scenario(name="smoke/stream", kernel="stream", shape=(256, 256),
                      workload={"iters": 4}, tags=("smoke",), smoke=True,
                      section="smoke"))
    register(Scenario(name="smoke/hotspot", kernel="hotspot",
                      shape=(32, 126), workload={"iters": 2},
                      tags=("smoke",), smoke=True, section="smoke"))
    for strategy in Strategy:
        # paper Fig. 3 and Fig. 4 parity cells, as the reference has them
        for iters in (1, 32):
            register(Scenario(
                name=f"fig3/stream/{strategy.value}/iters={iters}",
                kernel="stream", shape=(256, 256), strategy=strategy,
                config={"tile_rows": 16, "n_tiles": 8},
                workload={"iters": iters},
                tags=("fig3", "paper"), section="fig3"))
        register(Scenario(
            name=f"fig4/hotspot/{strategy.value}", kernel="hotspot",
            shape=(32, 126), strategy=strategy, workload={"iters": 2},
            tags=("fig4", "paper"), section="fig4"))
        # HBM-scale cells: ~10x the L2, every SM holding several blocks
        register(Scenario(
            name=f"h100/stream/{strategy.value}", kernel="stream",
            shape=(16384, 4096), strategy=strategy,
            config={"tile_rows": 16, "n_tiles": 8}, workload={"iters": 1},
            tags=("h100",), section="fig3"))
        register(Scenario(
            name=f"h100/hotspot/{strategy.value}", kernel="hotspot",
            shape=(8192, 8192), strategy=strategy,
            workload={"iters": 1, "grid": 32}, tags=("h100",),
            section="fig4"))


_register_defaults()
