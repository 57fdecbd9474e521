"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode; their arithmetic is held against the JAX package on the
CPU by tests/test_torch_kernels.py). This file imports nothing of JAX, so
on a machine with a GPU and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import quantize_kv
from deeplearning4j_tpu_torch.ops import attention_kernels as ak


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tensor(rng, shape, dtype, device):
    return torch.as_tensor(rng.standard_normal(shape),
                           dtype=torch.float32).to(device, dtype)


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_packed_fp32_matches_plain(card, head_dim, causal):
    rng = np.random.default_rng(head_dim)
    heads, b, t = 3, 2, 72          # 72: a partial 64-key and 16-row tile
    q, k, v = (_tensor(rng, (b, t, heads * head_dim), torch.float32, card)
               for _ in range(3))
    before = ak.mha_attention_packed.launches
    o, lse = ak.mha_packed_forward(q, k, v, heads, causal)
    ro, rlse = ak.mha_packed_forward_reference(q, k, v, heads, causal)
    torch.cuda.synchronize()
    assert ak.mha_attention_packed.launches == before + 1
    # fp32 end to end; online vs whole-row softmax reassociates the sums
    torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_packed_bf16_matches_plain(card, p_dtype):
    rng = np.random.default_rng(7)
    q, k, v = (_tensor(rng, (1, 128, 12 * 64), torch.bfloat16, card)
               for _ in range(3))
    o, lse = ak.mha_packed_forward(q, k, v, 12, True, None, p_dtype)
    ro, rlse = ak.mha_packed_forward_reference(q, k, v, 12, True, None,
                                               p_dtype)
    torch.cuda.synchronize()
    # bf16 output rounds on both sides, and p is rounded for P.V under a
    # running max here and the row max there: 2^-6 of the largest |o|;
    # bf16 probabilities: the JAX package's 5e-2 bound for that mode
    tol = (2 ** -6 if p_dtype == torch.float32 else 5e-2) \
        * max(ro.float().abs().max().item(), 1.0)
    assert (o.float() - ro.float()).abs().max().item() <= tol
    # lse: fp32 sums of the same p (1e-3), or of p rounded to bf16 under
    # different maxima (2^-8 relative in l: the same 5e-2 bound)
    lse_tol = 1e-3 if p_dtype == torch.float32 else 5e-2
    assert (lse - rlse).abs().max().item() <= lse_tol


def test_packed_refuses_unbuilt_head_dim(card):
    q = torch.zeros(1, 8, 2 * 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ak.mha_packed_forward(q, q, q, 2)


def _paged_case(rng, block, q_dtype, device):
    S, NB, H, D, nbmax = 6, 11, 2, 64, 4
    q = _tensor(rng, (S, H, D), q_dtype, device)
    kp = _tensor(rng, (NB, block, H, D), torch.float32, device)
    vp = _tensor(rng, (NB, block, H, D), torch.float32, device)
    tables = torch.zeros((S, nbmax), dtype=torch.int32)
    tables[0, :1] = torch.tensor([1])
    tables[1, :2] = torch.tensor([2, 3])
    tables[2, :4] = torch.tensor([4, 5, 6, 7])
    tables[3, :3] = torch.tensor([8, 9, 10])
    tables[4, :1] = torch.tensor([3])          # shares slot 1's block
    pos = torch.tensor([0, block + 3, 4 * block - 1, 2 * block + 7, 5, 0],
                       dtype=torch.int32)    # slot 5: dead, scratch row
    return q, kp, vp, tables.to(device), pos.to(device)


@pytest.mark.parametrize("block", [4, 16])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_matches_plain(card, block, pool, q_dtype):
    rng = np.random.default_rng(block)
    q, kp, vp, tables, pos = _paged_case(rng, block, q_dtype, card)
    scales = {}
    if pool == "int8":
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(getattr(torch, pool)), vp.to(getattr(torch, pool))
    before = ak.paged_decode_attention.launches
    out = ak.paged_decode_attention(q, kp, vp, tables, pos,
                                    block_size=block, **scales)
    ref = ak.paged_decode_attention_reference(q, kp, vp, tables, pos,
                                              block_size=block, **scales)
    torch.cuda.synchronize()
    assert ak.paged_decode_attention.launches == before + 1
    assert bool(torch.isfinite(out.float()).all())
    if q_dtype == torch.float32:
        # fp32 on both sides; only the softmax's summation order differs
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        # bf16 output: one rounding apart at most, 2^-7 of the largest |o|
        tol = 2 ** -7 * max(ref.float().abs().max().item(), 1.0)
        assert (out.float() - ref.float()).abs().max().item() <= tol
