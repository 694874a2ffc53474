"""The hash dropout kernel (`csrc/hash_dropout.cu`) against its plain
version `_hash_dropout_ref` on a CUDA card, bits compared exactly: f32,
bf16 and f16, both modes, forward and backward, an element count that is
no multiple of a vector, a view off 16-byte alignment, and the mask
kernel of the `axis` form. The kernel has no CPU mode, so without a card
the test skips (`skipif`); it imports no JAX, so it runs on the card as it is
(`python -m pytest tests/test_torch_dropout_kernel_card.py`).
"""
import pytest
import torch

from paddle_tpu_torch.ops import dropout as D


def _bits_equal(a, b):
    it = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card: the kernel has no CPU mode")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("upscale", [True, False])
def test_kernel_bit_equal_to_plain_on_card(dtype, upscale):
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randn(4099 * 8 + 3, generator=gen, device="cuda").to(dtype)
    for x in (base[:-3].view(4099, 8), base, base[1:]):
        for p in (0.1, 0.5):
            D.reset_counts()
            y = D.hash_dropout(x, p, 12345, upscale)
            g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            xg = x.detach().requires_grad_()
            (dx,) = torch.autograd.grad(
                D.hash_dropout(xg, p, 12345, upscale), xg, g)
            assert D.dropout_kernel_launches["hash_dropout"] == 2
            assert D.dropout_kernel_launches["hash_dropout_bwd"] == 1
            assert not any(D.dropout_plain_launches.values())
            assert _bits_equal(y, D._hash_dropout_ref(x, 12345, p, upscale))
            assert _bits_equal(dx, D._hash_dropout_ref(g, 12345, p, upscale))
    keep = D.hash_keep_mask(99, (7, 1, 33), 0.3, "cuda")
    assert torch.equal(keep, D._hash_keep_ref(99, (7, 1, 33), 0.3, "cuda"))
