"""The batched bf16 kernel's transposed forms on the card: each one
bit-identical to the forward kernel on host-transposed contiguous copies
(the check that isolates the layout logic), and the strategies other than
TMA refused with no launch.  These tests need a CUDA card and skip
without one; on the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_batched_card.py
"""
import pytest
import torch

from repro_torch.core.async_pipeline import PipelineSpec, Strategy
from repro_torch.kernels import matmul

TMA = PipelineSpec(Strategy.TMA, 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stacks(dev, e, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(e, m, k, generator=g, device=dev).bfloat16()
    b = torch.randn(e, k, n, generator=g, device=dev).bfloat16()
    return a, b


@pytest.mark.card
@pytest.mark.parametrize("form", ["trans_a", "trans_b"])
@pytest.mark.parametrize("e,m,k,n", [(3, 128, 256, 384), (2, 256, 384, 640),
                                     (4, 1408, 256, 256)])
def test_transposed_form_equals_the_host_copy_route(card, form, e, m, k, n):
    """op(a) op(b) from the stacks as they lie against the forward kernel
    on ``.transpose(1, 2).contiguous()`` copies: the same bits (tiles of
    128 rows by 256 columns with an odd strip count, of 256 by 128, and
    of 128 at an M of 11 tiles), and one launch of the form."""
    a, b = _stacks(card, e, m, k, n, e + m + k + n)
    stored = {"trans_a": (a.transpose(1, 2).contiguous(), b),
              "trans_b": (a, b.transpose(1, 2).contiguous())}[form]
    before = dict(matmul.BATCHED_T_LAUNCHES)
    got = matmul.matmul_batched_cuda(*stored, spec=TMA, **{form: True})
    want = matmul.matmul_batched_cuda(a, b, spec=TMA)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert matmul.BATCHED_T_LAUNCHES[form] == before[form] + 1
    torch.testing.assert_close(got, matmul.matmul_batched_plain(a, b),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.card
@pytest.mark.parametrize("strategy", [s for s in Strategy
                                      if s is not Strategy.TMA])
def test_transposed_forms_refuse_other_strategies(card, strategy):
    a, b = _stacks(card, 2, 128, 128, 128, 0)
    before = dict(matmul.BATCHED_T_LAUNCHES)
    for form in ("trans_a", "trans_b"):
        with pytest.raises(ValueError, match="built for TMA"):
            matmul.matmul_batched_cuda(a, b, spec=PipelineSpec(strategy),
                                       **{form: True})
    assert matmul.BATCHED_T_LAUNCHES == before
