"""The port's AdamW (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same numpy parameters and gradients, its schedule
step by step, a descent, and the in-place update the card's cached kernel
operands rely on.

Tolerance: 1e-6 on parameters and moments (the same f32 arithmetic in
the same order; the two frameworks may fuse a multiply-add differently,
one f32 rounding of values of magnitude ~1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro.optim import lr_schedule as ref_schedule
from repro_torch.models import layers
from repro_torch.optim import (adamw_init, adamw_update, global_norm,
                               lr_schedule)

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: they run many small
    torch ops, which the default pool (a thread a core) slows many times
    over when several test processes share the cores (see
    tests/test_torch_flash_replay.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(rng, scale=1.0):
    return {"w": (rng.normal(size=(16, 24)) * scale).astype(np.float32),
            "b": (rng.normal(size=(24,)) * scale).astype(np.float32),
            "scale": (rng.normal(size=(7,)) * scale).astype(np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("clip_norm,grad_scale", [(0.0, 1.0), (1.0, 1.0),
                                                   (1.0, 0.01)],
                         ids=["no-clip", "clipped", "under-clip"])
def test_adamw_update_matches_reference(clip_norm, grad_scale):
    """Three steps from the same parameters and gradients: parameters,
    moments, the step and the global norm each step, with clipping off, on
    and on but below the norm."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = ref_init(ref_p)
    got_p = _torch(params)
    got_s = adamw_init(got_p)
    for step in range(3):
        grads = _tree(rng, grad_scale)
        lr = 1e-2 * (step + 1)
        ref_p, ref_s, ref_gn = ref_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, ref_s, ref_p,
            lr=lr, weight_decay=0.1, clip_norm=clip_norm)
        got_s, got_gn = adamw_update(_torch(grads), got_s, got_p, lr=lr,
                                     weight_decay=0.1, clip_norm=clip_norm)
        assert int(got_s.step) == int(ref_s.step) == step + 1
        np.testing.assert_allclose(float(got_gn), float(ref_gn), rtol=TOL)
        for k in params:
            for got, want in ((got_p[k], ref_p[k]), (got_s.m[k], ref_s.m[k]),
                              (got_s.v[k], ref_s.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=TOL, atol=TOL)


def test_lr_schedule_matches_reference_at_every_step():
    for warmup, total in ((10, 100), (1, 7), (5, 5)):
        for step in range(total + 3):
            want = float(ref_schedule(jnp.asarray(step, jnp.int32), lr=3e-4,
                                      warmup=warmup, total=total))
            got = lr_schedule(step, lr=3e-4, warmup=warmup, total=total)
            assert got == pytest.approx(want, rel=TOL, abs=1e-12), step


def test_global_norm():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    want = np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                       for v in tree.values()))
    assert float(global_norm(_torch(tree))) == pytest.approx(want, rel=TOL)


def test_adamw_descends_a_quadratic():
    """0.5 |p - target|^2 from a distance of ~5: 200 steps at lr 0.1 bring
    it within 0.5, with no weight decay."""
    rng = np.random.default_rng(2)
    target = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    p = {"x": target + 5.0 * torch.from_numpy(
        rng.normal(size=(32,)).astype(np.float32))}
    state = adamw_init(p)
    start = float((p["x"] - target).norm())
    for _ in range(200):
        state, _ = adamw_update({"x": p["x"] - target}, state, p, lr=0.1,
                                weight_decay=0.0, clip_norm=0.0)
    assert float((p["x"] - target).norm()) < 0.5 < start


def test_update_moves_version_and_linear_uses_the_new_weight():
    """The update writes the parameter in place (the same storage, its
    ``_version`` moved), so the operand ``layers`` keeps beside it is made
    again and the next kernel-route ``linear`` reads the new weight."""
    rng = np.random.default_rng(3)
    w = torch.nn.Parameter(torch.from_numpy(
        rng.normal(size=(24, 16)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(5, 24)).astype(np.float32))
    p = {"w": w}
    kernel = lambda: layers.kernel_linear(x, w, torch.float32)  # noqa: E731
    before = kernel().detach()
    op = layers.kernel_operand(w, torch.float32)
    version, ptr = w._version, w.data_ptr()
    state = adamw_init(p)
    adamw_update({"w": torch.ones_like(w)}, state, p, lr=0.1)
    assert w.data_ptr() == ptr and w._version > version
    new_op = layers.kernel_operand(w, torch.float32)
    assert new_op is not op and torch.equal(new_op[:24, :16], w.detach())
    after = kernel().detach()
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, x @ w.detach(), rtol=1e-5, atol=1e-5)
