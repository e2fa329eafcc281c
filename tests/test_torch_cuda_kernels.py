"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
without one. On the card, without JAX (this file imports torch only):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
from lifelong_clip_tpu_torch.ops import kernel_check as kc

pytestmark = pytest.mark.cuda

LORA_KEYS = ("a_in", "b_in", "a_out", "b_out")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _inputs(dev, b, t, d, r, seed=0):
    x, blk, lora, gy, _ = kc.make_inputs(b, t, d, 1, r, False, seed,
                                         device=dev)
    return x, [blk[k] for k in kc.BLOCK_KEYS], lora, gy


# (b, t, d, heads, lora r, causal, weight_grads): head dims 64, 32 and 16;
# T on and off a multiple of 16; the vision block's T = 197
CASES = [(2, 13, 128, 2, 4, False, False), (3, 77, 256, 4, 0, True, True),
         (2, 197, 192, 3, 4, False, True), (2, 9, 128, 4, 4, True, False),
         (2, 32, 64, 4, 2, False, True)]


@pytest.mark.parametrize("b,t,d,heads,r,causal,wg", CASES)
def test_kernels_match_plain_versions(cuda, b, t, d, heads, r, causal, wg):
    """Through the op's autograd Function, each output on the part the
    kernels compute (y - x, the LoRA-in term of qkv, dx - g, every grad),
    with the tolerances stated in ``ops/kernel_check.py``."""
    x, blk, lora, gy, mask = kc.make_inputs(b, t, d, heads, r, causal, 0,
                                            device=cuda)
    kc.check_case(x, blk, lora, gy, mask, heads, 0.25 if r else 0.0, wg)


def test_backward_is_deterministic(cuda):
    """No atomics: two backward passes on the same inputs agree bit for bit,
    the row contractions included."""
    x, blk, lora, gy = _inputs(cuda, 4, 197, 192, 4, seed=1)
    bargs = (*blk[:5], 3, 0.25, None, lora, True)
    first = fba._cuda_backward(x, gy, *bargs)
    second = fba._cuda_backward(x, gy, *bargs)
    for a, b in zip(first[0], second[0]):
        assert torch.equal(a, b)
    for k in LORA_KEYS:
        assert torch.equal(first[1][k], second[1][k]), k


def test_op_launches_kernels_and_counts_them(cuda):
    x, blk, lora, gy = _inputs(cuda, 2, 13, 128, 4, seed=2)
    lora = {k: v.requires_grad_() for k, v in lora.items()}
    fba.reset_launches()
    y = fba.fused_ln_attention_block(x, *blk, 2, 0.25, None, lora, False)
    y.backward(gy)
    assert fba.LAUNCHES == {"fused_ln_attention_fwd": 1,
                            "fused_ln_attention_bwd": 1}
    for k in LORA_KEYS:   # bf16 primals get bf16 grads
        assert lora[k].grad.dtype == torch.bfloat16, k


def test_unsupported_shape_raises_on_the_card(cuda):
    """A CUDA tensor the kernels cannot take raises; no plain fallback."""
    x, blk, _, _ = _inputs(cuda, 1, 9, 96, 0)
    with pytest.raises(ValueError):
        fba.fused_ln_attention_block(x, *blk, 2)   # head dim 48
