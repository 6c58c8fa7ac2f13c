"""Host side of the paper's asynchronous-copy strategies.

The counterpart of ``repro.core.async_pipeline`` lines 71-166: ``Strategy``,
``PipelineSpec`` and ``as_spec`` keep the reference's semantics exactly, so a
config dict means the same pipeline in both packages.  The device side — the
loops that execute each strategy with ``cp.async``, ``cp.async.bulk`` and
``mbarrier`` — is ``repro_torch/csrc/async_pipeline.cuh``.

``smem_budget`` gives the shared-memory bytes one block of a kernel needs
for a spec, term by term as the reference's VMEM models count them
(``tuning/search_space._stream_vmem`` / ``_hotspot_vmem``), plus what the
Hopper kernel actually allocates.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

__all__ = ["Strategy", "ALL_STRATEGIES", "parse_strategy", "PipelineSpec",
           "as_spec", "SmemBudget", "smem_budget", "SMEM_PER_BLOCK"]

#: shared memory one H100 block may opt into (227 KB of the SM's 256 KB)
SMEM_PER_BLOCK = 232_448


class Strategy(enum.Enum):
    SYNC = "sync"
    REGISTER_BYPASS = "register_bypass"
    OVERLAP = "overlap"
    DROP_OFF = "drop_off"
    TMA = "tma"


ALL_STRATEGIES: Tuple[Strategy, ...] = tuple(Strategy)


def parse_strategy(name: Union[str, Strategy]) -> Strategy:
    """Parse a strategy name, case-insensitively; the error names the valid
    choices so a CLI ``--strategy`` typo is self-explaining."""
    if isinstance(name, Strategy):
        return name
    try:
        return Strategy(str(name).strip().lower())
    except ValueError:
        valid = ", ".join(s.value for s in Strategy)
        raise ValueError(
            f"unknown strategy {name!r}; valid strategies: {valid}") from None


_SINGLE_BUFFERED = (Strategy.SYNC, Strategy.REGISTER_BYPASS)


@dataclass(frozen=True)
class PipelineSpec:
    """The shape of one kernel's async pipeline — strategy, input ring depth,
    wait-group depth, and output (write-back) ring depth.

    ``wait_group`` caps how many input copies may remain in flight when the
    wait for tile i is posted (``cp.async.wait_group N``): the kernels issue
    tile ``i + A`` before waiting tile ``i`` where
    ``A = min(wait_group, depth - 1)``; ``wait_group=None`` means the
    deepest safe issue-ahead, ``depth - 1``.
    """
    strategy: Strategy = Strategy.OVERLAP
    depth: int = 2
    wait_group: Optional[int] = None
    out_depth: int = 2

    def __post_init__(self):
        object.__setattr__(self, "strategy", parse_strategy(self.strategy))
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.wait_group is not None and self.wait_group < 0:
            raise ValueError(
                f"wait_group must be >= 0 or None, got {self.wait_group}")
        if self.out_depth < 1:
            raise ValueError(f"out_depth must be >= 1, got {self.out_depth}")

    @property
    def ring_depth(self) -> int:
        """Input ring slots: single-buffered strategies take one slot; async
        strategies at least two."""
        return 1 if self.strategy in _SINGLE_BUFFERED else max(self.depth, 2)

    @property
    def ahead(self) -> int:
        """Issue-ahead distance A: tile i+A is started before tile i's wait.
        TMA always runs at the deepest issue-ahead: its mbarrier counts
        transaction bytes per slot, so there is no wait-group axis."""
        if self.strategy in _SINGLE_BUFFERED:
            return 0
        limit = self.ring_depth - 1
        if self.strategy is Strategy.TMA:
            return limit
        return limit if self.wait_group is None \
            else max(0, min(self.wait_group, limit))

    @classmethod
    def from_config(cls, config: dict) -> "PipelineSpec":
        """Build a spec from a flat kernel-config dict (``KERNEL_DEFAULTS``
        style); unrelated keys are ignored."""
        wg = config.get("wait_group")
        return cls(strategy=parse_strategy(
                       config.get("strategy", Strategy.OVERLAP)),
                   depth=int(config.get("depth", 2)),
                   wait_group=None if wg is None else int(wg),
                   out_depth=int(config.get("out_depth", 2)))


def as_spec(spec: Union[PipelineSpec, Strategy], *, depth: int = 2,
            wait_group: Optional[int] = None,
            out_depth: int = 2) -> PipelineSpec:
    """Coerce a bare Strategy into a PipelineSpec."""
    if isinstance(spec, PipelineSpec):
        return spec
    return PipelineSpec(strategy=spec, depth=depth, wait_group=wait_group,
                        out_depth=out_depth)


class SmemBudget(NamedTuple):
    """Shared-memory bytes of one block, by term."""
    in_ring: int        # ring_depth slots of every input operand's tile
    staging: int        # SYNC's staging copy of every input tile
    out_ring: int       # out_depth slots of the output tile
    barriers: int       # TMA's per-slot mbarriers (8 bytes each)
    sync: bool

    @property
    def total(self) -> int:
        """The reference's model: in ring + staging + out ring."""
        return self.in_ring + self.staging + self.out_ring

    @property
    def card(self) -> int:
        """What the Hopper kernel allocates.  SYNC's loads land in registers
        and are stored straight into the staging tile, so it has no ring."""
        ring = 0 if self.sync else self.in_ring
        return ring + self.staging + self.out_ring + self.barriers


def smem_budget(spec: Union[PipelineSpec, Strategy],
                in_tiles: Sequence[int], out_tile: int) -> SmemBudget:
    """Shared-memory terms for one block: ``in_tiles`` are the bytes of one
    tile of each input operand, ``out_tile`` the bytes of one output tile."""
    spec = as_spec(spec)
    slot = sum(int(b) for b in in_tiles)
    sync = spec.strategy is Strategy.SYNC
    return SmemBudget(
        in_ring=spec.ring_depth * slot,
        staging=slot if sync else 0,
        out_ring=spec.out_depth * int(out_tile),
        barriers=8 * spec.ring_depth if spec.strategy is Strategy.TMA else 0,
        sync=sync)
