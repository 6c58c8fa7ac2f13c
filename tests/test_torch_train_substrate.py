"""The port's training substrate on the CPU: ``synth_batch`` bitwise
against the reference's, the prefetcher's replay from a step, the
checkpointer (roundtrip, asynchronous saves and their garbage collection,
the atomic LATEST, a missing key, restoring onto a device, and a snapshot
an in-place update after an asynchronous save does not reach), and the
fault-tolerance pieces (retries, the preemption guard, straggler
statistics)."""
import os
import signal
import threading

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.data import synth_batch as ref_synth_batch
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import Prefetcher, synth_batch
from repro_torch.distributed import (EXIT_PREEMPTED, PreemptionGuard,
                                     StepStats, run_with_retries)
from repro_torch.optim import adamw_init


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi-3-vision-4.2b",
                                  "whisper-medium"])
@pytest.mark.parametrize("step", [0, 7])
def test_synth_batch_is_the_references_bit_for_bit(arch, step):
    want = ref_synth_batch(ref_smoke(arch), batch=3, seq=40, seed=5,
                           step=step)
    got = synth_batch(get_smoke_config(arch), batch=3, seq=40, seed=5,
                      step=step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


def test_prefetcher_replays_from_a_step():
    """A prefetcher started at step 3 hands over synth_batch(3), (4), ...
    as tensors on its device, the same as one started at 0 reaches them."""
    cfg = get_smoke_config("qwen2-1.5b")
    kw = dict(batch=2, seq=16, seed=1, device="cpu")
    first = Prefetcher(cfg, start_step=0, **kw)
    from_zero = [next(first) for _ in range(6)]
    first.close()
    second = Prefetcher(cfg, start_step=3, **kw)
    try:
        for step in range(3, 6):
            got = next(second)
            want = synth_batch(cfg, batch=2, seq=16, seed=1, step=step)
            for k, v in want.items():
                assert torch.equal(got[k], torch.from_numpy(v))
                assert torch.equal(got[k], from_zero[step][k])
        assert second.step == 6
    finally:
        second.close()
    assert not second.thread.is_alive()


def test_prefetcher_hands_over_a_producer_failure():
    cfg = get_smoke_config("qwen2-1.5b")
    pre = Prefetcher(cfg, batch=3, seq=16, seed=0, device="cpu")
    pre.cfg = None                      # the next batch it makes fails
    with pytest.raises(AttributeError):
        for _ in range(pre.q.maxsize + 2):
            next(pre)
    pre.close()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"layers.0.w": torch.randn(4, 6, generator=g),
              "emb": torch.randn(10, 4, generator=g).to(torch.bfloat16)}
    return {"params": params, "opt": adamw_init(params)}


def _equal_trees(a, b):
    assert torch.equal(a["params"]["layers.0.w"], b["params"]["layers.0.w"])
    assert torch.equal(a["params"]["emb"], b["params"]["emb"])
    assert int(a["opt"].step) == int(b["opt"].step)
    for k in a["params"]:
        assert torch.equal(a["opt"].m[k], b["opt"].m[k])
        assert torch.equal(a["opt"].v[k], b["opt"].v[k])


def test_checkpoint_roundtrip_layout_and_types(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _state()
    tree["opt"].m["emb"].fill_(0.5)
    ck.save(7, tree, extra_meta={"arch": "x"})
    assert ck.latest_step() == 7
    assert (tmp_path / "LATEST").read_text() == "step_00000007"
    assert sorted(os.listdir(tmp_path / "step_00000007")) == [
        "arrays.npz", "meta.json"]
    meta = ck.meta()
    assert meta["step"] == 7 and meta["arch"] == "x"
    assert "opt/m/emb" in meta["keys"] and "params/layers.0.w" in meta["keys"]
    got = ck.restore(_state(seed=1))
    _equal_trees(got, tree)
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert type(got["opt"]).__name__ == "AdamWState"


def test_async_saves_keep_the_last_ones_and_latest_is_atomic(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    tree = _state()
    for step in (1, 2, 3, 4):
        ck.save(step, tree)
    ck.wait()
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) \
        == ["step_00000003", "step_00000004"]
    assert ck.latest_step() == 4
    # LATEST is replaced by a rename: no temporary file is left beside it
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_a_torn_save_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    """A save that dies after its arrays but before its rename leaves
    LATEST at the previous step, which restores."""
    ck = Checkpointer(str(tmp_path))
    tree = _state()
    ck.save(1, tree)
    real = os.rename

    def dies(src, dst):
        if src.endswith(".tmp") and "step_" in src:
            raise OSError("preempted mid-save")
        return real(src, dst)
    monkeypatch.setattr(os, "rename", dies)
    with pytest.raises(OSError):
        ck.save(2, _state(seed=3))
    monkeypatch.setattr(os, "rename", real)
    assert ck.latest_step() == 1
    _equal_trees(ck.restore(_state(seed=4)), tree)


def test_restore_missing_key_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": {"a": torch.zeros(2)}})
    with pytest.raises(KeyError, match="missing keys"):
        ck.restore({"params": {"a": torch.zeros(2), "b": torch.zeros(2)}})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"a": torch.zeros(1)})


def test_restore_onto_a_target_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _state()
    ck.save(1, tree)
    like = _state(seed=2)
    got = ck.restore(like, device="meta")
    assert got["params"]["layers.0.w"].device.type == "meta"
    assert got["params"]["emb"].dtype == torch.bfloat16
    cpu = ck.restore(like, device=torch.device("cpu"))
    _equal_trees(cpu, tree)


def test_async_save_then_in_place_update_restores_the_snapshot(
        tmp_path, monkeypatch):
    """The parameters are updated in place.  An asynchronous save whose
    writer is held back until after the update still writes the values of
    the moment it was called."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    tree = _state()
    want = {k: v.clone() for k, v in tree["params"].items()}
    gate = threading.Event()
    write = ck._write

    def held(*args):
        gate.wait(10)
        return write(*args)
    monkeypatch.setattr(ck, "_write", held)
    ck.save(1, tree)
    with torch.no_grad():
        for p in tree["params"].values():
            p.add_(1.0)
    gate.set()
    ck.wait()
    got = ck.restore(_state(seed=5))["params"]
    for k, v in want.items():
        assert torch.equal(got[k], v)
        assert not torch.equal(got[k], tree["params"][k])


def test_run_with_retries_recovers_from_transient_failures():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"
    assert run_with_retries(flaky, backoff=0.0) == "ok" and len(calls) == 3
    with pytest.raises(OSError):
        run_with_retries(lambda: (_ for _ in ()).throw(OSError("disk")),
                         max_retries=1, backoff=0.0)
    with pytest.raises(ValueError):        # not retryable: raised at once
        run_with_retries(lambda: (_ for _ in ()).throw(ValueError("bad")),
                         backoff=0.0)


def test_preemption_guard_sets_the_flag_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) is before
    assert EXIT_PREEMPTED == 143


def test_step_stats_flag_stragglers():
    stats = StepStats()
    flags = [stats.record(i, dt, factor=3.0)
             for i, dt in enumerate([1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 1.0])]
    assert flags == [False] * 5 + [True, False]
    assert stats.straggler_events == [5]
