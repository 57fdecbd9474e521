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


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _bound(ref, rel):
    return rel * max(ref.float().abs().max().item(), 1.0)


# bf16 results against the plain version, per element: |a - b| <= 2^-7 |b|
# (one bf16 ulp of the output; each side rounds once) + a floor in units of
# the rms of b's row (one head's D values), never of the tensor's largest
# |b|, so late causal rows are held as tightly as the first. Forward: p is
# rounded to bf16 for P.V under the running max there and the row max here,
# independently, moving o by ~2^-8.7 of the row's rms (one standard
# deviation): floor 2^-5. Backward: ds rounds to bf16 on both sides, and an
# element whose dp or delta (fp32 sums in another order) sits at a rounding
# boundary lands one ulp away, moving a gradient row by ~2^-8 of one term:
# floor 2^-6.
FWD_FLOOR, BWD_FLOOR = 2 ** -5, 2 ** -6


def _within(a, b, d, floor):
    a = a.float().unflatten(-1, (-1, d))
    b = b.float().unflatten(-1, (-1, d))
    rms = b.square().mean(-1, keepdim=True).sqrt()
    return bool(((a - b).abs() <= 2 ** -7 * b.abs() + floor * rms).all())


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
    if p_dtype == torch.float32:
        assert _within(o, ro, 64, FWD_FLOOR)
    else:
        # bf16 probabilities: the JAX package's 5e-2 bound for that mode
        assert _max_err(o, ro) <= _bound(ro, 5e-2)
    # lse: fp32 sums of the same p (1e-3), or of p rounded to bf16 under
    # different maxima (2^-8 relative in l: the same 5e-2 bound)
    lse_tol = 1e-3 if p_dtype == torch.float32 else 5e-2
    assert (lse - rlse).abs().max().item() <= lse_tol


def test_packed_refuses_unbuilt_head_dim(card):
    q = torch.zeros(1, 8, 2 * 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ak.mha_packed_forward(q, q, q, 2)


def test_backward_kernels_refuse_unbuilt_head_dim(card):
    """The backward kernels are built for head_dim 64 only."""
    q = torch.zeros(1, 8, 2 * 32, device=card)
    lse = torch.zeros(1, 2, 8, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ak.mha_packed_backward(q, q, q, q, lse, 2)
    q3, vec = torch.zeros(2, 8, 32, device=card), torch.zeros(2, 1, 8,
                                                               device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ak.flash_bwd_dq(q3, q3, q3, q3, vec, vec)
    with pytest.raises(ValueError, match="head_dim"):
        ak.flash_bwd_dkv(q3, q3, q3, q3, vec, vec)


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




@pytest.mark.parametrize("t", [72, 1032])     # partial 16-row / 64-key tiles
@pytest.mark.parametrize("causal", [True, False])
def test_packed_backward_matches_plain(card, t, causal):
    rng = np.random.default_rng(t)
    heads, d = 3, 64
    q, k, v, do = (_tensor(rng, (2, t, heads * d), torch.float32, card)
                   for _ in range(4))
    _, lse = ak.mha_packed_forward(q, k, v, heads, causal)
    before = ak.mha_packed_backward.launches
    got = ak.mha_packed_backward(q, k, v, do, lse, heads, causal)
    ref = ak.mha_packed_backward_reference(q, k, v, do, lse, heads, causal)
    torch.cuda.synchronize()
    assert ak.mha_packed_backward.launches == before + 1
    for a, b in zip(got, ref):
        # fp32 end to end; the dq pass's delta and every sum reassociate
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_packed_backward_bf16_matches_plain(card, p_dtype):
    rng = np.random.default_rng(8)
    q, k, v, do = (_tensor(rng, (1, 128, 12 * 64), torch.bfloat16, card)
                   for _ in range(4))
    _, lse = ak.mha_packed_forward(q, k, v, 12, True, None, p_dtype)
    got = ak.mha_packed_backward(q, k, v, do, lse, 12, True, None, p_dtype)
    ref = ak.mha_packed_backward_reference(q, k, v, do, lse, 12, True, None,
                                           p_dtype)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        if p_dtype == torch.float32:
            assert _within(a, b, 64, BWD_FLOOR)
        else:
            # bf16 p: the JAX package's 5e-2 bound for that mode
            assert _max_err(a, b) <= _bound(b, 5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [72, 1032])
@pytest.mark.parametrize("causal", [True, False])
def test_streamed_kernels_match_plain(card, dtype, t, causal):
    rng = np.random.default_rng(t + 1)
    q, k, v, do = (_tensor(rng, (3, t, 64), dtype, card) for _ in range(4))
    counts = (ak.flash_forward.launches, ak.flash_bwd_dq.launches,
              ak.flash_bwd_dkv.launches)
    o, lse = ak.flash_forward(q, k, v, causal, t, t)
    ro, rlse = ak.flash_forward_reference(q, k, v, causal)
    delta = (do.float() * ro.float()).sum(-1).reshape(3, 1, t)
    dq = ak.flash_bwd_dq(q, k, v, do, rlse, delta, causal)
    dk, dv = ak.flash_bwd_dkv(q, k, v, do, rlse, delta, causal)
    rdq = ak.flash_bwd_dq_reference(q, k, v, do, rlse, delta, causal)
    rdk, rdv = ak.flash_bwd_dkv_reference(q, k, v, do, rlse, delta, causal)
    torch.cuda.synchronize()
    assert (ak.flash_forward.launches, ak.flash_bwd_dq.launches,
            ak.flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    if dtype == torch.float32:
        # fp32 end to end; online vs whole-row softmax reassociates
        torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
        for a, b in ((dq, rdq), (dk, rdk), (dv, rdv)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    else:
        assert _within(o, ro, 64, FWD_FLOOR)
        # lse: fp32 sums of the same p in another order
        assert _max_err(lse, rlse) <= 1e-3
        for a, b in ((dq, rdq), (dk, rdk), (dv, rdv)):
            assert _within(a, b, 64, BWD_FLOOR)


# ---------------------------- bf16 forward on the tensor cores (rows 1, 3)


def _forward_bf16(card, seed, impl, t, causal, p_dtype=torch.float32):
    """Inputs, kernel ``(o, lse)`` and plain ``(o, lse)`` of the bf16
    head_dim-64 forward: packed (2, t, 3 x 64) or streamed (3, t, 64)."""
    rng = np.random.default_rng(seed)
    if impl == "packed":
        q, k, v = (_tensor(rng, (2, t, 3 * 64), torch.bfloat16, card)
                   for _ in range(3))
        got = ak.mha_packed_forward(q, k, v, 3, causal, None, p_dtype)
        ref = ak.mha_packed_forward_reference(q, k, v, 3, causal, None,
                                              p_dtype)
    else:
        q, k, v = (_tensor(rng, (3, t, 64), torch.bfloat16, card)
                   for _ in range(3))
        got = ak.flash_forward(q, k, v, causal, t, t)
        ref = ak.flash_forward_reference(q, k, v, causal)
    return (q, k, v), got, ref


# 8: one partial query and key tile; 72: a full 64-row tile and a partial
# one; 1032: sixteen full tiles and a partial one, whose keys past the
# sequence are zero-filled and masked
@pytest.mark.parametrize("t", [8, 72, 1032])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["packed", "streamed"])
def test_forward_bf16_tiles(card, impl, t, causal):
    counter = ak.mha_attention_packed if impl == "packed" \
        else ak.flash_forward
    before = counter.launches
    _, (o, lse), (ro, rlse) = _forward_bf16(card, t + 20, impl, t, causal)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert _within(o, ro, 64, FWD_FLOOR)
    # lse: fp32 sums of the same p in another order
    assert _max_err(lse, rlse) <= 1e-3


@pytest.mark.parametrize("t", [72, 1032])
@pytest.mark.parametrize("causal", [True, False])
def test_packed_forward_bf16_p_tiles(card, t, causal):
    _, (o, lse), (ro, rlse) = _forward_bf16(card, t + 30, "packed", t,
                                            causal, torch.bfloat16)
    torch.cuda.synchronize()
    # bf16 p, rounded under the running max there and the row max here:
    # the JAX package's 5e-2 bound for that mode, on o and on lse
    assert _max_err(o, ro) <= _bound(ro, 5e-2)
    assert _max_err(lse, rlse) <= 5e-2


def test_forward_bf16_is_deterministic(card):
    """No atomics and a fixed order of sums: two calls on the same inputs
    agree bit for bit."""
    (q, k, v), first, _ = _forward_bf16(card, 40, "packed", 520, True)
    again = ak.mha_packed_forward(q, k, v, 3, True)
    (sq, sk, sv), sfirst, _ = _forward_bf16(card, 41, "streamed", 1032,
                                            False)
    sagain = ak.flash_forward(sq, sk, sv, False, 1032, 1032)
    torch.cuda.synchronize()
    for a, b in zip(first + sfirst, again + sagain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["packed", "streamed"])
def test_forward_first_causal_row_is_its_score(card, impl):
    """The first query of a causal head sees one key: its lse is that one
    score bit for bit, summed over D in sequence as the backward and the
    plain version sum it (bf16 products are exact in fp32), and o is v's
    first row."""
    (q, k, v), (o, lse), _ = _forward_bf16(card, 42, impl, 200, True)
    torch.cuda.synchronize()
    if impl == "packed":
        q0, k0, v0, o0 = (x[:, 0].unflatten(-1, (3, 64))
                          for x in (q, k, v, o))
        lse0 = lse[:, :, 0]
    else:
        q0, k0, v0, o0 = (x[:, 0] for x in (q, k, v, o))
        lse0 = lse[:, 0, 0]
    qs = (q0.float() * 0.125).to(torch.bfloat16).float()
    score = torch.zeros(qs.shape[:-1], device=card)
    for d in range(64):
        score = score + qs[..., d] * k0[..., d].float()
    assert torch.equal(lse0, score)
    assert torch.equal(o0, v0)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_backward_on_kernel_lse_zeroes_first_causal_row(card, p_dtype):
    """The chain training runs: the backward kernel fed the forward
    kernel's lse gives the first causal row's dq exactly 0, as the plain
    backward does on the same lse, and holds every gradient to the plain
    one."""
    rng = np.random.default_rng(43)
    q, k, v, do = (_tensor(rng, (2, 128, 3 * 64), torch.bfloat16, card)
                   for _ in range(4))
    _, lse = ak.mha_packed_forward(q, k, v, 3, True, None, p_dtype)
    got = ak.mha_packed_backward(q, k, v, do, lse, 3, True, None, p_dtype)
    ref = ak.mha_packed_backward_reference(q, k, v, do, lse, 3, True, None,
                                           p_dtype)
    torch.cuda.synchronize()
    zero = torch.zeros_like(got[0][:, 0])
    assert torch.equal(got[0][:, 0], zero)
    assert torch.equal(ref[0][:, 0], zero)
    for a, b in zip(got, ref):
        if p_dtype == torch.float32:
            assert _within(a, b, 64, BWD_FLOOR)
        else:
            # bf16 p: the JAX package's 5e-2 bound for that mode
            assert _max_err(a, b) <= _bound(b, 5e-2)


@pytest.mark.parametrize("head_dim", [16, 32, 128])
def test_packed_bf16_other_head_dims_match_plain(card, head_dim):
    """bf16 at head dims other than 64 keeps the FMA template."""
    rng = np.random.default_rng(44 + head_dim)
    q, k, v = (_tensor(rng, (2, 72, 3 * head_dim), torch.bfloat16, card)
               for _ in range(3))
    o, lse = ak.mha_packed_forward(q, k, v, 3, True)
    ro, rlse = ak.mha_packed_forward_reference(q, k, v, 3, True)
    torch.cuda.synchronize()
    assert _within(o, ro, head_dim, FWD_FLOOR)
    assert _max_err(lse, rlse) <= 1e-3


def test_forward_libraries_run_on_tensor_cores(card):
    """The built forward libraries hold wgmma (HGMMA) instructions."""
    import os
    import subprocess

    from deeplearning4j_tpu_torch.ops import _build

    names = ("mha_packed_fwd", "flash_fwd")
    _build.build(names)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        assert sum(" HGMMA" in line for line in sass.splitlines()) > 0, name


# ------------------------- bf16 backward on the tensor cores (rows 2, 4, 5)


def _packed_bwd_bf16(card, seed, b, t, heads, causal, p_dtype):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_tensor(rng, (b, t, heads * 64), torch.bfloat16, card)
                   for _ in range(4))
    _, lse = ak.mha_packed_forward_reference(q, k, v, heads, causal, None,
                                             p_dtype)
    return (q, k, v, do, lse), ak.mha_packed_backward(
        q, k, v, do, lse, heads, causal, None, p_dtype)


def _streamed_bwd_bf16(card, seed, bh, t, causal):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_tensor(rng, (bh, t, 64), torch.bfloat16, card)
                   for _ in range(4))
    o, lse = ak.flash_forward_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).reshape(bh, 1, t)
    dq = ak.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = ak.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return (q, k, v, do, lse, delta), (dq, dk, dv)


# 8: one partial tile; 72: a full 64-row tile and a partial one; 1032:
# sixteen full tiles and a partial one
@pytest.mark.parametrize("t", [8, 72, 1032])
@pytest.mark.parametrize("causal", [True, False])
def test_packed_backward_bf16_tiles(card, t, causal):
    ins, got = _packed_bwd_bf16(card, t, 2, t, 3, causal, torch.float32)
    ref = ak.mha_packed_backward_reference(*ins, 3, causal)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _within(a, b, 64, BWD_FLOOR)


@pytest.mark.parametrize("t", [72, 1032])
def test_packed_backward_bf16_p_tiles(card, t):
    ins, got = _packed_bwd_bf16(card, t + 3, 2, t, 3, True, torch.bfloat16)
    ref = ak.mha_packed_backward_reference(*ins, 3, True, None,
                                           torch.bfloat16)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        # bf16 p: the JAX package's 5e-2 bound for that mode
        assert _max_err(a, b) <= _bound(b, 5e-2)


# 1001: not a multiple of 8 (the streamed passes take any T)
@pytest.mark.parametrize("t", [8, 72, 1001, 1032])
@pytest.mark.parametrize("causal", [True, False])
def test_streamed_backward_bf16_tiles(card, t, causal):
    ins, got = _streamed_bwd_bf16(card, t + 5, 3, t, causal)
    rdq = ak.flash_bwd_dq_reference(*ins, causal)
    rdk, rdv = ak.flash_bwd_dkv_reference(*ins, causal)
    torch.cuda.synchronize()
    for a, b in zip(got, (rdq, rdk, rdv)):
        assert _within(a, b, 64, BWD_FLOOR)


def test_streamed_backward_bf16_long_context(card):
    """One head of the T=8192 causal training shape (rows 4-5)."""
    ins, got = _streamed_bwd_bf16(card, 13, 1, 8192, True)
    rdq = ak.flash_bwd_dq_reference(*ins, True)
    rdk, rdv = ak.flash_bwd_dkv_reference(*ins, True)
    torch.cuda.synchronize()
    for a, b in zip(got, (rdq, rdk, rdv)):
        assert _within(a, b, 64, BWD_FLOOR)


def test_backward_bf16_is_deterministic(card):
    """Two passes without atomics: two calls on the same inputs agree bit
    for bit."""
    ins, first = _packed_bwd_bf16(card, 14, 2, 520, 3, False, torch.float32)
    again = ak.mha_packed_backward(*ins, 3, False)
    sins, sfirst = _streamed_bwd_bf16(card, 15, 2, 1032, True)
    sagain = (ak.flash_bwd_dq(*sins, True),
              *ak.flash_bwd_dkv(*sins, True))
    torch.cuda.synchronize()
    for a, b in zip(first + sfirst, again + sagain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["packed", "streamed"])
def test_backward_bf16_keys_past_seq_add_nothing(card, impl):
    """Keys past the sequence are zero-filled in the tile and must give
    p = 0 (zero keys would give s = 0 and p = exp(-lse) otherwise): under
    the causal mask the first 72 queries of a T=128 case see only the
    first 72 keys, so their dq equals the T=72 case's on the same prefix."""
    n = 72
    if impl == "packed":
        ins, got = _packed_bwd_bf16(card, 16, 2, 128, 3, True, torch.float32)
        q, k, v, do, _ = (x[:, :n].contiguous() for x in ins)
        _, lse = ak.mha_packed_forward_reference(q, k, v, 3, True)
        short = ak.mha_packed_backward(q, k, v, do, lse, 3, True)[0]
        long_dq = got[0][:, :n]
    else:
        ins, got = _streamed_bwd_bf16(card, 17, 3, 128, True)
        q, k, v, do = (x[:, :n].contiguous() for x in ins[:4])
        lse, delta = (x[..., :n].contiguous() for x in ins[4:])
        short = ak.flash_bwd_dq(q, k, v, do, lse, delta, True)
        long_dq = got[0][:, :n]
    torch.cuda.synchronize()
    assert _within(long_dq, short, 64, BWD_FLOOR)


@pytest.mark.parametrize("impl", ["packed", "flash"])
def test_autograd_matches_plain_autograd(card, impl):
    rng = np.random.default_rng(9)
    # head_dim 64 on both layouts: packed (B, T, 2 heads x 64), streamed
    # (BH, T, 64)
    shape = (2, 200, 2 * 64) if impl == "packed" else (4, 200, 64)
    q, k, v, g = (_tensor(rng, shape, torch.float32, card)
                  for _ in range(4))

    def run(fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*xs), xs, g)

    if impl == "packed":
        before = ak.mha_packed_backward.launches
        got = run(lambda a, b, c: ak.mha_attention_packed(a, b, c, 2, True))
        with ak.higher_order_attention():
            ref = run(lambda a, b, c: ak.mha_attention_packed(a, b, c, 2,
                                                              True))
        assert ak.mha_packed_backward.launches == before + 1
    else:
        before = ak.flash_bwd_dkv.launches
        got = run(lambda a, b, c: ak.flash_attention(a, b, c, True, 100,
                                                     100))
        with ak.higher_order_attention():
            ref = run(lambda a, b, c: ak.flash_attention(a, b, c, True))
        assert ak.flash_bwd_dkv.launches == before + 1
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        # fp32: kernels against autograd through plain attention
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["packed", "flash"])
def test_double_backward_raises_on_card(card, impl):
    rng = np.random.default_rng(10)
    q, k, v = (_tensor(rng, (1, 64, 64), torch.float32, card)
               .requires_grad_() for _ in range(3))
    o = ak.mha_attention_packed(q, k, v, 1) if impl == "packed" \
        else ak.flash_attention(q, k, v)
    (gq,) = torch.autograd.grad(o.square().sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="higher_order_attention"):
        gq.sum().backward()


def test_paged_reads_out_of_range_ids_as_plain(card):
    rng = np.random.default_rng(11)
    q, kp, vp, tables, pos = _paged_case(rng, 4, torch.float32, card)
    nb = kp.shape[0]
    tables[1, :2] = torch.tensor([nb, -1], dtype=torch.int32)
    tables[2, :4] = torch.tensor([-3, 31, -40, 5], dtype=torch.int32)
    out = ak.paged_decode_attention(q, kp, vp, tables, pos, block_size=4)
    ref = ak.paged_decode_attention_reference(q, kp, vp, tables, pos,
                                              block_size=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launches_the_packed_kernels(card, remat):
    """One make_train_step step of a small bf16 MLM on the card: the packed
    backward launches once per layer; the forward once, or twice with remat
    (the checkpoint recomputes each block in the backward)."""
    from deeplearning4j_tpu_torch.models import (
        TransformerConfig, init_params, make_train_step)

    cfg = TransformerConfig(vocab_size=64, hidden=128, layers=2, heads=2,
                            mlp_dim=128, max_seq=64, remat=remat,
                            attention_impl="flash")
    params = init_params(cfg, seed=0, device=card)
    init_state, step = make_train_step(cfg)
    opt_state = init_state(params)
    rng = np.random.default_rng(12)
    batch = {"tokens": torch.as_tensor(rng.integers(0, 64, (2, 64)),
                                       device=card),
             "targets": torch.as_tensor(rng.integers(0, 64, (2, 64)),
                                        device=card),
             "weights": torch.ones(2, 64, device=card)}
    fwd = ak.mha_attention_packed.launches
    bwd = ak.mha_packed_backward.launches
    params, opt_state, loss = step(params, opt_state, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert ak.mha_attention_packed.launches - fwd == (4 if remat else 2)
    assert ak.mha_packed_backward.launches - bwd == 2


# ------------------------------------------ fused cross-entropy and AdamW

from deeplearning4j_tpu_torch.ops import updaters, xent_kernels  # noqa: E402


def _xent_case(rng, n, v, dtype, device):
    x = _tensor(rng, (n, v), torch.float32, device).mul_(3).to(dtype)
    t = torch.as_tensor(rng.integers(0, v, n), device=device)
    t[:4] = torch.tensor([-1, v, -9, v + 5])   # outside [0, V): add nothing
    return x, t


# 30522: BERT's vocab, whose bf16 rows start 4-byte but not 16-byte aligned;
# 1000 and 333 (odd): other head/body/tail splits of a row
@pytest.mark.parametrize("n,v", [(40, 30522), (16, 1000), (24, 333)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_matches_plain(card, n, v, dtype):
    rng = np.random.default_rng(v)
    x, t = _xent_case(rng, n, v, dtype, card)
    g = torch.as_tensor(rng.random(n), dtype=torch.float32, device=card)
    counts = (xent_kernels.softmax_cross_entropy.launches,
              xent_kernels.softmax_cross_entropy_backward.launches)
    loss, lse = xent_kernels.softmax_cross_entropy_forward(x, t)
    grad = xent_kernels.softmax_cross_entropy_backward(x, t, lse, g)
    rloss, rlse = xent_kernels.xent_forward_reference(x, t)
    rgrad = xent_kernels.xent_backward_reference(x, t, rlse, g)
    torch.cuda.synchronize()
    assert (xent_kernels.softmax_cross_entropy.launches,
            xent_kernels.softmax_cross_entropy_backward.launches) == \
        tuple(c + 1 for c in counts)
    assert loss.dtype == lse.dtype == torch.float32 and grad.dtype == dtype
    # fp32 sums of the same V terms in another order
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(loss, rloss, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(loss[:4], lse[:4], rtol=0, atol=0)
    if dtype == torch.float32:
        # exp's last ulp on both sides
        torch.testing.assert_close(grad, rgrad, rtol=1e-5, atol=1e-8)
    else:
        # one bf16 ulp: the same fp32 value rounded on both sides
        diff = (grad.float() - rgrad.float()).abs()
        assert bool((diff <= 2 ** -7 * rgrad.float().abs() + 1e-8).all())


def test_xent_autograd_and_double_backward(card):
    rng = np.random.default_rng(13)
    x, t = _xent_case(rng, 32, 512, torch.bfloat16, card)
    x.requires_grad_()
    before = xent_kernels.softmax_cross_entropy_backward.launches
    (grad,) = torch.autograd.grad(
        xent_kernels.softmax_cross_entropy(x, t).sum(), x, create_graph=True)
    assert xent_kernels.softmax_cross_entropy_backward.launches == before + 1
    _, rlse = xent_kernels.xent_forward_reference(x.detach(), t)
    rgrad = xent_kernels.xent_backward_reference(
        x.detach(), t, rlse, torch.ones(32, device=card))
    diff = (grad.float() - rgrad.float()).abs()
    assert bool((diff <= 2 ** -7 * rgrad.float().abs() + 1e-8).all())
    with pytest.raises(RuntimeError, match="first-order"):
        grad.float().sum().backward()


def test_xent_refuses_unsupported_dtype(card):
    x = torch.zeros(8, 16, dtype=torch.float16, device=card)
    t = torch.zeros(8, dtype=torch.long, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        xent_kernels.softmax_cross_entropy_forward(x, t)


def _adamw_tree(rng, dtype, device):
    shapes = {"w": (1024, 128), "e": (3000, 128), "b": (7,), "odd": (5, 3)}
    return {k: _tensor(rng, s, dtype, device) for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_adamw_matches_plain(card, dtype):
    """Two applies over one launch each: p, m, v and count against the
    plain version applied leaf by leaf to a copy."""
    rng = np.random.default_rng(14)
    params = _adamw_tree(rng, dtype, card)
    ref_p = {k: p.clone() for k, p in params.items()}
    opt = updaters.fused_adamw(3e-3, weight_decay=0.01)
    state = opt.init(params)
    ref_m = [torch.zeros_like(p) for p in updaters.tree_leaves(ref_p)]
    ref_v = [torch.zeros_like(p) for p in updaters.tree_leaves(ref_p)]
    before = updaters.fused_adamw.launches
    for step in (1, 2):
        grads = {k: _tensor(rng, p.shape, dtype, card)
                 for k, p in params.items()}
        opt.apply(params, state, grads)
        bc1, bc2 = updaters.bias_corrections(step, 0.9, 0.999)
        for i, (p, g) in enumerate(zip(updaters.tree_leaves(ref_p),
                                       updaters.tree_leaves(grads))):
            new = updaters.adamw_reference(p, g, ref_m[i], ref_v[i], bc1,
                                           bc2, lr=3e-3, b1=0.9, b2=0.999,
                                           eps=1e-8, wd=0.01)
            for dst, src in zip((p, ref_m[i], ref_v[i]), new):
                dst.copy_(src)
    torch.cuda.synchronize()
    assert updaters.fused_adamw.launches == before + 2
    assert state["count"] == 2
    got = updaters.tree_leaves(params) + state["mu"] + state["nu"]
    want = updaters.tree_leaves(ref_p) + ref_m + ref_v
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        # every operation rounded once in fp32 on both sides (the kernel
        # contracts nothing into an FMA): equal up to an ulp
        torch.testing.assert_close(a, b, rtol=2 ** -22 if dtype ==
                                   torch.float32 else 2 ** -7, atol=1e-12)


def test_fused_adamw_refuses_unsupported_dtype(card):
    p = {"w": torch.zeros(16, dtype=torch.float16, device=card)}
    opt = updaters.fused_adamw(1e-3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        opt.apply(p, opt.init(p), {"w": torch.zeros_like(p["w"])})
