"""The f32 flash attention design's arithmetic, replayed lane by lane on the
CPU (``mma_replay`` in tests/test_torch_flash_attention.py: its 3xTF32
``mma.sync`` fragments, relabelled KV rows and permuted d columns, and its
online softmax over kc-row sub-tiles), against the reference's Pallas
kernel in interpret mode, at each slot size the card runs.

A file of its own: the replay takes most of the flash attention tests'
time, and a file runs on one worker when the tests are spread by file."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                         # noqa: E402

from repro.kernels import ops as ref_ops                        # noqa: E402
from test_torch_flash_attention import (_close, _qkv,           # noqa: E402
                                        mma_replay)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: they run thousands of
    small torch ops, which the default pool (a thread a core) slows many
    times over when several test processes share the cores (the 24 lane
    replays: 521 s in 6 processes at the default, 21 s at one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _reference_arrays(h, kvh, causal, window):
    q, k, v = _qkv((h, 256, 64), (kvh, 256, 64), 7)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, bq=128, bk=128)
    return (q, k, v), np.asarray(want)


def _reference(h, kvh, causal, window):
    """The inputs and the reference's output for (h, kvh, causal, window),
    computed once and handed out as copies."""
    (q, k, v), want = _reference_arrays(h, kvh, causal, window)
    return (q.copy(), k.copy(), v.copy()), want.copy()


@pytest.mark.parametrize("kc", [8, 16, 32])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96),
                                           (False, 200)])
@pytest.mark.parametrize("h,kvh", [(4, 2), (2, 1)])
def test_mma_replay_matches_reference(kc, causal, window, h, kvh):
    """The kernel's 3xTF32 fragments, KV relabelling and sub-tiled online
    softmax hold the reference's Pallas kernel (interpret mode) to 2e-5, at
    the card's slots (DROP_OFF's 8 rows in two chains, the others' 32) and
    at 16."""
    (q, k, v), want = _reference(h, kvh, causal, window)
    got = mma_replay(*(torch.from_numpy(t) for t in (q, k, v)),
                     causal=causal, window=window, kc=kc,
                     chains=2 if kc == 8 else 1)
    _close(got, want)
