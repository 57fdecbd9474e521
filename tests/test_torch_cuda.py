"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode; their arithmetic is held against the JAX package on the
CPU by tests/test_torch_kernels.py). This file imports nothing of JAX, so
on a machine with a GPU and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import time

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


def _within(a, b, d, floor, terms=None):
    """The rule above; ``terms`` (per element the sum of |the bf16-rounded
    terms| added in fp32 to make ``a``) allows half an ulp, 2^-8, of each
    term more."""
    a = a.float().unflatten(-1, (-1, d))
    b = b.float().unflatten(-1, (-1, d))
    rms = b.square().mean(-1, keepdim=True).sqrt()
    allowed = 2 ** -7 * b.abs() + floor * rms
    if terms is not None:
        allowed = allowed + 2 ** -8 * terms.float().unflatten(-1, (-1, d))
    return bool(((a - b).abs() <= allowed).all())


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
    """A zero-width head refuses on the card; every width from 1 up runs
    (the widths past 256 in 256-wide chunks, within one CTA's shared
    memory: ``test_packed_head_dims_match_plain``)."""
    from deeplearning4j_tpu_torch.profiler import cuda_launches

    q = torch.zeros(1, 8, 0, device=card)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        ak.mha_packed_forward(q, q, q, 2)

    def smem(d):   # shared memory per block, as the driver holds it
        x = torch.randn(1, 64, 2 * d, device=card, dtype=torch.bfloat16)
        return [g["shared_memory"] for g in cuda_launches(
            lambda: ak.mha_packed_forward(x, x, x, 2))]

    assert smem(512) == smem(256)
    assert len(smem(256)) == 1 and smem(256)[0] <= ak.MAX_BLOCK_SMEM_BYTES


def test_backward_kernels_refuse_unbuilt_head_dim(card):
    """The backward kernels refuse a zero-width head, as the forward."""
    q = torch.zeros(1, 8, 0, device=card)
    lse = torch.zeros(1, 2, 8, device=card)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        ak.mha_packed_backward(q, q, q, q, lse, 2)
    q3, vec = torch.zeros(2, 8, 0, device=card), torch.zeros(2, 1, 8,
                                                              device=card)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        ak.flash_bwd_dq(q3, q3, q3, q3, vec, vec)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        ak.flash_bwd_dkv(q3, q3, q3, q3, vec, vec)


def _check_head_dim(got, ref, d, dtype, floor, fp32_tol):
    """fp32: end to end, sums reassociated (``fp32_tol``); bf16: the
    per-element rule (``_within``) at the row of one head's d values."""
    for a, b in zip(got, ref):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=fp32_tol, atol=fp32_tol)
        else:
            assert _within(a, b, d, floor)


# Head dims off the built widths run padded to the next one (16, 32, 64,
# 128, 256): 8 and 48 and 96 and 160 pad, 16 and 256 are exact; bf16 at
# these takes the FMA templates, forward and backward; 160 and 256 take the
# 256-wide instances on opted-in dynamic shared memory; 320 and 512 the
# chunked kernels (two 256-wide chunks, the second of 320 mostly padding)
@pytest.mark.parametrize("head_dim", [8, 16, 48, 96, 160, 256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_packed_head_dims_match_plain(card, head_dim, dtype, causal):
    rng = np.random.default_rng(100 + head_dim)
    heads, t = 3, 72
    q, k, v, do = (_tensor(rng, (2, t, heads * head_dim), dtype, card)
                   for _ in range(4))
    o, lse = ak.mha_packed_forward(q, k, v, heads, causal)
    ro, rlse = ak.mha_packed_forward_reference(q, k, v, heads, causal)
    got = ak.mha_packed_backward(q, k, v, do, rlse, heads, causal)
    ref = ak.mha_packed_backward_reference(q, k, v, do, rlse, heads, causal)
    torch.cuda.synchronize()
    _check_head_dim([o], [ro], head_dim, dtype, FWD_FLOOR, 1e-5)
    assert _max_err(lse, rlse) <= (1e-5 if dtype == torch.float32 else 1e-3)
    _check_head_dim(got, ref, head_dim, dtype, BWD_FLOOR, 1e-4)


@pytest.mark.parametrize("head_dim", [8, 16, 48, 96, 160, 256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_streamed_head_dims_match_plain(card, head_dim, dtype, causal):
    rng = np.random.default_rng(200 + head_dim)
    bh, t = 3, 72
    q, k, v, do = (_tensor(rng, (bh, t, head_dim), dtype, card)
                   for _ in range(4))
    o, lse = ak.flash_forward(q, k, v, causal, t, t)
    ro, rlse = ak.flash_forward_reference(q, k, v, causal)
    delta = (do.float() * ro.float()).sum(-1).reshape(bh, 1, t)
    dq = ak.flash_bwd_dq(q, k, v, do, rlse, delta, causal)
    dk, dv = ak.flash_bwd_dkv(q, k, v, do, rlse, delta, causal)
    rdq = ak.flash_bwd_dq_reference(q, k, v, do, rlse, delta, causal)
    rdk, rdv = ak.flash_bwd_dkv_reference(q, k, v, do, rlse, delta, causal)
    torch.cuda.synchronize()
    _check_head_dim([o], [ro], head_dim, dtype, FWD_FLOOR, 1e-5)
    assert _max_err(lse, rlse) <= (1e-5 if dtype == torch.float32 else 1e-3)
    _check_head_dim([dq, dk, dv], [rdq, rdk, rdv], head_dim, dtype,
                    BWD_FLOOR, 1e-4)


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


# ------------------------------------------- paged decode, split (row 6)


def _split_case(rng, block, nbmax, d, q_dtype, pool, device):
    """Slots whose pos sit on the split edges of ``paged_decode_plan``,
    past the table, at -1, and a dead slot; each live slot's blocks are
    distinct ids of a 2-head pool."""
    heads = 2
    per, _ = ak.paged_decode_plan(nbmax, block)
    span = per * block                          # positions of one split
    length = nbmax * block
    pos = [0, span - 1, span, min(2 * span, length - 1), length - 1,
           length + 5, -1, 0]                   # last: dead slot
    S, NB = len(pos), nbmax * len(pos) + 1
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = np.zeros((S, nbmax), np.int32)
    for s, p in enumerate(pos[:-1]):
        tables[s] = perm[s * nbmax:(s + 1) * nbmax]
    q = _tensor(rng, (S, heads, d), q_dtype, device)
    kf = _tensor(rng, (NB, block, heads, d), torch.float32, device)
    vf = _tensor(rng, (NB, block, heads, d), torch.float32, device)
    scales = {}
    if pool == "int8":
        kp, ks = quantize_kv(kf)
        vp, vs = quantize_kv(vf)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kf.to(getattr(torch, pool)), vf.to(getattr(torch, pool))
    return (q, kp, vp, torch.as_tensor(tables, device=device),
            torch.as_tensor(np.array(pos, np.int32), device=device)), scales


# (block, nbmax, head_dim): one split (no merge launch); 8 splits of 4
# blocks at the serving shape; 16-block splits; block 64 at head_dim 128
# (over the old kernel's 48 KB stage); padded head dims 48 and 8; heads
# wider than 128 (several 16-byte slices a lane; 200 leaves int8 rows off
# the 16-byte vector), up to the widest instance, 1024, in blocks of one
# position; 1280 on the wide kernel (two 1024-dim chunks), in one split and
# in several
SPLIT_CASES = [(16, 4, 64), (16, 32, 64), (4, 40, 32), (64, 8, 128),
               (8, 16, 48), (16, 8, 8), (16, 8, 256), (4, 40, 200),
               (1, 70, 1024), (16, 4, 1280), (16, 8, 1280)]


@pytest.mark.parametrize("block,nbmax,head_dim", SPLIT_CASES)
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_paged_splits_match_plain(card, block, nbmax, head_dim, pool):
    rng = np.random.default_rng(block * 1000 + nbmax + head_dim)
    q_dtype = torch.bfloat16 if pool == "bfloat16" else torch.float32
    args, scales = _split_case(rng, block, nbmax, head_dim, q_dtype, pool,
                               card)
    before = ak.paged_decode_attention.launches
    out = ak.paged_decode_attention(*args, block_size=block, **scales)
    again = ak.paged_decode_attention(*args, block_size=block, **scales)
    ref = ak.paged_decode_attention_reference(*args, block_size=block,
                                              **scales)
    torch.cuda.synchronize()
    # one count a call, whatever the launches inside
    assert ak.paged_decode_attention.launches == before + 2
    assert bool(torch.isfinite(out.float()).all())
    # the splits merge in split-index order: the same bits every call
    assert torch.equal(out, again)
    # pos < 0 attends nothing and gives zeros, as the JAX package's Pallas
    # kernel does (its gather reference, like the plain version here,
    # softmaxes a row of masked scores instead): held apart from the rest
    assert bool((out[6] == 0).all())
    live = [s for s in range(out.shape[0]) if s != 6]
    out, ref = out[live], ref[live]
    if q_dtype == torch.float32:
        # fp32 on both sides; only the softmax's summation order differs
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        # bf16 output: one rounding apart at most, 2^-7 of the largest |o|
        assert _max_err(out, ref) <= 2 ** -7 * max(
            ref.float().abs().max().item(), 1.0)


def test_paged_refuses_heads_past_its_widest(card):
    """Paged decode refuses only a zero-width head; 1280 runs
    (``test_paged_splits_match_plain``)."""
    q = torch.zeros(2, 1, 0, device=card)
    pool = torch.zeros(3, 4, 1, 0, device=card)
    tables = torch.zeros(2, 1, dtype=torch.int32, device=card)
    pos = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        ak.paged_decode_attention(q, pool, pool, tables, pos, block_size=4)


def test_paged_replays_in_a_cuda_graph(card):
    """The split plan reads no positions from the card, so a call captures
    into a CUDA graph; replays follow pos as it changes in place."""
    rng = np.random.default_rng(5)
    args, scales = _split_case(rng, 16, 32, 64, torch.bfloat16, "bfloat16",
                               card)
    q, kp, vp, tables, pos = args
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ak.paged_decode_attention(*args, block_size=16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ak.paged_decode_attention(*args, block_size=16)
    for moved in (False, True):
        if moved:
            pos.add_(37).clamp_(max=511)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ak.paged_decode_attention(*args,
                                                          block_size=16))


# ---------------------------------------------- fused AdamW (row 9)


def _adamw_check(params, moments, steps, rng, card):
    """Apply ``steps`` times with gradients freshly allocated every step
    (new addresses), against the plain version leaf by leaf."""
    opt = updaters.fused_adamw(3e-3, weight_decay=0.01)
    state = opt.init(params)
    if moments is not None:
        state["mu"], state["nu"] = moments
    leaves = updaters.tree_leaves(params)
    ref_p = [p.clone() for p in leaves]
    ref_m = [m.clone() for m in state["mu"]]
    ref_v = [v.clone() for v in state["nu"]]
    kept = []
    for step in range(1, steps + 1):
        grads = [_tensor(rng, p.shape, p.dtype, card) for p in leaves]
        kept.append(grads)              # the next step's land elsewhere
        opt.apply(params, state, grads)
        bc1, bc2 = updaters.bias_corrections(step, 0.9, 0.999)
        for i, g in enumerate(grads):
            new = updaters.adamw_reference(ref_p[i], g, ref_m[i], ref_v[i],
                                           bc1, bc2, lr=3e-3, b1=0.9,
                                           b2=0.999, eps=1e-8, wd=0.01)
            for dst, src in zip((ref_p[i], ref_m[i], ref_v[i]), new):
                dst.copy_(src)
    torch.cuda.synchronize()
    got = leaves + state["mu"] + state["nu"]
    for a, b in zip(got, ref_p + ref_m + ref_v):
        assert a.dtype == b.dtype
        # every operation rounded once in fp32 on both sides (the kernel
        # contracts nothing into an FMA): equal up to an ulp of its dtype
        rel = 2 ** -22 if a.dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(a, b, rtol=rel, atol=1e-12)


def test_fused_adamw_new_grad_addresses_every_step(card):
    rng = np.random.default_rng(21)
    params = _adamw_tree(rng, torch.float32, card)
    _adamw_check(params, None, 3, rng, card)


def test_fused_adamw_mixed_dtypes_vector_path(card):
    """bf16 params with fp32 moments: each operand loads four elements at
    a time by its own dtype; (5, 3) leaves a scalar tail."""
    rng = np.random.default_rng(22)
    params = _adamw_tree(rng, torch.bfloat16, card)
    leaves = updaters.tree_leaves(params)
    moments = ([torch.zeros_like(p, dtype=torch.float32) for p in leaves],
               [torch.zeros_like(p, dtype=torch.float32) for p in leaves])
    _adamw_check(params, moments, 2, rng, card)


def test_fused_adamw_tree_wider_than_one_launch(card):
    """300 leaves (more than the 256 one parameter struct holds), an empty
    leaf and a leaf one element off its 16-byte alignment."""
    rng = np.random.default_rng(23)
    base = torch.zeros(1001, device=card)
    params = {f"l{i:03d}": _tensor(rng, (int(rng.integers(1, 3000)),),
                                   torch.float32, card) for i in range(298)}
    params["empty"] = torch.zeros(0, device=card)
    params["offset"] = base[1:]
    params["offset"].copy_(_tensor(rng, (1000,), torch.float32, card))
    before = updaters.fused_adamw.launches
    _adamw_check(params, None, 2, rng, card)
    assert updaters.fused_adamw.launches == before + 2


# ------------------------------- the paged engine's block lifecycle (row 6)

from deeplearning4j_tpu_torch.models import (  # noqa: E402
    TransformerConfig, init_params)
from deeplearning4j_tpu_torch.serving import GenerationEngine  # noqa: E402

_LIFE_CFG = dict(vocab_size=64, hidden=64, layers=2, heads=2, mlp_dim=128,
                 max_seq=64, causal=True, remat=False)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_swap_round_trip_is_bit_exact(card, kv_dtype):
    """Blocks copied to pinned host buffers and back into other blocks
    equal the originals bit for bit: bf16 values, or int8 values and their
    fp32 scales."""
    cfg = TransformerConfig(**_LIFE_CFG, dtype=torch.bfloat16,
                            attention_impl="flash")
    params = init_params(cfg, seed=0, device=card)
    with GenerationEngine(params, cfg, slots=2, max_len=64, block_size=8,
                          kv_dtype=kv_dtype, device=card) as eng:
        gen = torch.Generator(device=card).manual_seed(5)
        for lc in eng._cache["layers"]:
            for name, leaf in lc.items():
                if leaf.dtype == torch.int8:
                    leaf.copy_(torch.randint(-127, 128, leaf.shape,
                                             generator=gen, device=card))
                else:
                    leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                           device=card).to(leaf.dtype))
        src, dst = [3, 7, 1], [9, 2, 12]
        payload, nbytes = eng._blocks_to_host(src)
        assert all(t.is_pinned() for layer in payload for t in layer.values())
        eng._blocks_from_host(dst, payload)
        torch.cuda.synchronize()
        names = set()
        for lc in eng._cache["layers"]:
            for name, leaf in lc.items():
                names.add(name)
                assert torch.equal(leaf[dst], leaf[src]), name
        want = {"k", "v"} | ({"k_scale", "v_scale"} if kv_dtype == "int8"
                             else set())
        assert names == want
        assert nbytes == len(src) * eng.kv_block_bytes


def test_decode_feed_with_copy_on_write_matches_on_both_routes(card):
    """Streams on a 10-token prefix (its tail block copied on write, 8-token
    blocks) feed their suffixes through the paged decode step: token-equal
    to plain submits of prefix + suffix on the fused and gather routes, in
    fp32; the fused route launches the paged kernel."""
    cfg = TransformerConfig(**_LIFE_CFG, dtype=torch.float32,
                            attention_impl="flash")
    params = init_params(cfg, seed=1, device=card)
    rng = np.random.default_rng(31)
    pre = rng.integers(0, 64, 10).astype(np.int32)
    sfx = [rng.integers(0, 64, 3).astype(np.int32) for _ in range(4)]
    streams = {}
    for route in ("fused", "gather"):
        with GenerationEngine(params, cfg, slots=4, max_len=64, block_size=8,
                              paged_attention=route, device=card) as eng:
            plain = [eng.generate(np.concatenate([pre, s]), max_new_tokens=6,
                                  timeout=120) for s in sfx]
            before = ak.paged_decode_attention.launches
            pid = eng.register_prefix(pre)
            hs = [eng.submit(s, prefix_id=pid, max_new_tokens=6)
                  for s in sfx]
            got = [h.result(timeout=120) for h in hs]
            assert eng.metrics.kv_cow_copies_total.value == 4
            assert eng.metrics.prefills_total.value == 4   # the plain ones
            launched = ak.paged_decode_attention.launches - before
        assert got == plain, route
        assert (launched > 0) == (route == "fused")
        streams[route] = got
    assert streams["fused"] == streams["gather"]


# ------------------------------ speculative decoding: the verify step (row 6)


def test_verify_step_fused_matches_gather(card):
    """The verify step's k+1 single-query reads through the paged kernel
    (fused) against the gather route, fp32, on a pool with a copy-on-write
    pair, a slot past its mapped blocks and a dead slot: the same samples
    and ``accepted``, the pools within fp32 summation order."""
    from deeplearning4j_tpu_torch.models import make_verify_step
    cfg = TransformerConfig(**_LIFE_CFG, dtype=torch.float32,
                            attention_impl="flash")
    params = init_params(cfg, seed=3, device=card)
    rng = np.random.default_rng(41)
    nb, block, k = 20, 8, 4
    tables = np.zeros((4, 8), np.int32)
    tables[0, :3] = [2, 4, 6]
    tables[1, :8] = [1, 3, 5, 7, 8, 9, 10, 11]
    tables[2, :2] = [12, 13]
    lengths = np.array([18, 60, 14, 0])
    cow_src = np.array([0, 14, 0, 0])
    cow_dst = np.array([0, 11, 0, 0])
    tokens = rng.integers(1, 64, (4, k + 1))
    keys = np.stack([rng.integers(0, 2 ** 32, 2, dtype=np.uint32)
                     for _ in range(4)])
    out = {}
    for route in ("gather", "fused"):
        g = torch.Generator(device="cpu").manual_seed(9)
        shape = (nb, block, cfg.heads, cfg.head_dim)
        cache = {"layers": [{n: torch.randn(shape, generator=g).to(card)
                             for n in ("k", "v")}
                            for _ in range(cfg.layers)]}
        fn = make_verify_step(cfg, block, k, paged_attention=route)
        before = ak.paged_decode_attention.launches
        _, samples, accepted = fn(params, cache, tables, lengths, tokens,
                                  keys, [3, 7, 1, 0], [0.0, 0.8, 0.0, 0.0],
                                  [0, 40, 0, 0], cow_src, cow_dst)
        launched = ak.paged_decode_attention.launches - before
        assert launched == (cfg.layers * (k + 1) if route == "fused" else 0)
        out[route] = (samples.cpu(), accepted.cpu(), cache)
    (gs, ga, gc), (fs, fa, fc) = out["gather"], out["fused"]
    # slot 0 reads only mapped blocks; slot 1 up to its capacity (positions
    # 60..63); slot 2 the first two positions (14, 15)
    assert torch.equal(fs[0], gs[0])
    assert torch.equal(fs[1, :4], gs[1, :4])
    assert torch.equal(fs[2, :2], gs[2, :2])
    assert torch.equal(fa[:2], ga[:2])
    for lf, lg in zip(fc["layers"], gc["layers"]):
        for name in ("k", "v"):
            torch.testing.assert_close(lf[name][1:], lg[name][1:],
                                       rtol=1e-5, atol=1e-5)


def test_speculative_streams_match_plain(card):
    """The speculative engine (fused, fp32, a smaller draft, k 3) gives the
    plain engine's greedy and sampled streams; the verify step launches
    the paged kernel."""
    from deeplearning4j_tpu_torch.serving import SpecConfig
    cfg = TransformerConfig(**_LIFE_CFG, dtype=torch.float32,
                            attention_impl="flash")
    dcfg = TransformerConfig(**dict(_LIFE_CFG, hidden=32, layers=1,
                                    mlp_dim=64), dtype=torch.float32,
                             attention_impl="flash")
    params = init_params(cfg, seed=4, device=card)
    dparams = init_params(dcfg, seed=5, device=card)
    rng = np.random.default_rng(51)
    reqs = [(rng.integers(0, 64, int(rng.integers(3, 20))).astype(np.int32),
             dict(max_new_tokens=12, eos_id=None, seed=i,
                  **({} if i % 2 else dict(temperature=0.8, top_k=40))))
            for i in range(6)]
    streams = {}
    for spec in (None, SpecConfig(dparams, dcfg, k=3),
                 SpecConfig(params, cfg, k=3)):
        with GenerationEngine(params, cfg, slots=4, max_len=64,
                              block_size=8, paged_attention="fused",
                              speculative=spec, device=card) as eng:
            hs = [eng.submit(p, **kw) for p, kw in reqs]
            streams[spec is None, spec and spec.draft_cfg is cfg] = [
                h.result(timeout=120) for h in hs]
            if spec is not None and spec.draft_cfg is cfg:
                assert eng.metrics.spec_acceptance_rate.value >= 0.9
    plain = streams[True, None]
    assert streams[False, False] == plain
    assert streams[False, True] == plain


# ------------------- the engine's resilience layer on the card (rows 1, 6)

def test_retried_faults_leave_streams_clean(card):
    """Transient faults at the prefill and at decode steps, absorbed by
    retries, re-run the same kernels: bf16 streams on the fused route are
    token-equal to a clean run, retries == faults fired."""
    from deeplearning4j_tpu_torch.serving import FaultPlan, RetryPolicy
    cfg = TransformerConfig(**_LIFE_CFG, dtype=torch.bfloat16,
                            attention_impl="flash")
    params = init_params(cfg, seed=6, device=card)
    rng = np.random.default_rng(61)
    ps = [rng.integers(0, 64, int(rng.integers(3, 30))).astype(np.int32)
          for _ in range(6)]
    kw = dict(slots=4, max_len=64, block_size=8, paged_attention="fused",
              device=card)
    with GenerationEngine(params, cfg, **kw) as eng:
        clean = [h.result(timeout=120) for h in
                 [eng.submit(p, max_new_tokens=16) for p in ps]]
    plan = (FaultPlan(seed=3).fail("generation.prefill", at=(0, 3))
            .fail("generation.decode_step", rate=0.2, at=(1,)))
    with GenerationEngine(params, cfg, retry_policy=RetryPolicy(
            max_attempts=4, seed=0), **kw) as eng:
        before = ak.paged_decode_attention.launches
        with plan:
            got = [h.result(timeout=120) for h in
                   [eng.submit(p, max_new_tokens=16) for p in ps]]
        assert got == clean
        assert eng.metrics.retries_total.value == len(plan.fired()) >= 3
        assert eng.metrics.failed_total.value == 0
        assert ak.paged_decode_attention.launches > before


def test_watchdog_restart_on_the_card(card):
    """A decode step held past the watchdog: the live stream fails typed,
    the restart builds a new pool on the card, and a stream served while
    the stale thread's late step writes into the old pool is clean."""
    from deeplearning4j_tpu_torch.serving import (
        FaultPlan, WatchdogTimeoutError)
    cfg = TransformerConfig(**_LIFE_CFG, dtype=torch.bfloat16,
                            attention_impl="flash")
    params = init_params(cfg, seed=7, device=card)
    rng = np.random.default_rng(71)
    p0, p1 = (rng.integers(0, 64, 9).astype(np.int32) for _ in range(2))
    with GenerationEngine(params, cfg, slots=2, max_len=64, block_size=8,
                          paged_attention="fused", device=card) as eng:
        clean = eng.generate(p1, max_new_tokens=40, timeout=120)
        eng.arm_watchdog(300)
        stale, old_pool = eng._thread, eng._cache
        plan = FaultPlan(seed=0).delay("generation.decode_step", ms=1200,
                                       at=(1,))
        with plan:
            h = eng.submit(p0, max_new_tokens=8)
            with pytest.raises(WatchdogTimeoutError):
                h.result(timeout=60)
            late = eng.submit(p1, max_new_tokens=40,
                              on_token=lambda _t: time.sleep(0.03))
            got = late.result(timeout=120)
        stale.join(timeout=10)
        assert not stale.is_alive()
        assert got == clean
        assert eng.watchdog_restarts == 1 and eng._cache is not old_pool


def test_watchdog_restart_held_before_the_launch_on_the_card(card):
    """The scheduler held past the watchdog at the top of a turn, before
    its decode step launches: the restart swaps in a new pool on the
    card, the stale thread's late step launches into the pool it bound
    (never the new one), and a stream served meanwhile is clean."""
    import threading

    from deeplearning4j_tpu_torch.serving import WatchdogTimeoutError
    cfg = TransformerConfig(**_LIFE_CFG, dtype=torch.bfloat16,
                            attention_impl="flash")
    params = init_params(cfg, seed=7, device=card)
    rng = np.random.default_rng(72)
    p0, p1 = (rng.integers(0, 64, 9).astype(np.int32) for _ in range(2))
    with GenerationEngine(params, cfg, slots=2, max_len=64, block_size=8,
                          paged_attention="fused", device=card) as eng:
        clean = eng.generate(p1, max_new_tokens=40, timeout=120)
        eng.arm_watchdog(300)
        stale, old_pool = eng._thread, eng._cache
        held = threading.Event()
        turn, decode, launches = eng._decode_iteration, eng._decode, []

        def holding(*a):
            if threading.current_thread() is stale and not held.is_set():
                held.set()
                time.sleep(1.2)
            return turn(*a)

        def spy(params, cache, *a):
            launches.append((threading.current_thread(), cache))
            return decode(params, cache, *a)

        eng._decode_iteration, eng._decode = holding, spy
        h = eng.submit(p0, max_new_tokens=8)
        with pytest.raises(WatchdogTimeoutError):
            h.result(timeout=60)
        got = eng.submit(p1, max_new_tokens=40,
                         on_token=lambda _t: time.sleep(0.03)).result(
                             timeout=120)
        stale.join(timeout=10)
        assert not stale.is_alive()
        assert got == clean
        assert eng.watchdog_restarts == 1 and eng._cache is not old_pool
        assert any(t is stale and c is old_pool for t, c in launches)
        assert all(c is not eng._cache for t, c in launches if t is stale)


def test_front_door_stream_over_rpc_equals_the_engine(card):
    """One stream through the fleet front door, dispatched over HTTP to a
    host on the card (``HostRpcServer`` on 127.0.0.1, ``RemoteHost``
    heartbeats), equals the engine's own stream for the prompt, and the
    batching ``InferenceEngine`` over ``CausalLMAdapter`` gives the
    direct call's logits bit for bit on the same padded bucket."""
    from deeplearning4j_tpu_torch.models.bert import make_infer_last_logits
    from deeplearning4j_tpu_torch.serving import (
        CausalLMAdapter, ClusterDirectory, ClusterFrontDoor, HeartbeatPump,
        HostRpcServer, LoopbackHost, LoopbackTransport, ModelRegistry,
        RemoteHost)
    cfg = TransformerConfig(**_LIFE_CFG, dtype=torch.bfloat16,
                            attention_impl="flash")
    params = init_params(cfg, seed=8, device=card)
    rng = np.random.default_rng(80)
    p = rng.integers(0, 64, 11).astype(np.int32)
    reg = ModelRegistry()
    try:
        reg.deploy("lm", CausalLMAdapter(params, cfg, device=card),
                   buckets=(1, 2, 4))
        eng = reg.engine("lm", max_wait_ms=0)
        x = rng.integers(0, 64, (3, 16)).astype(np.int32)
        pad = np.concatenate([x, np.zeros((1, 16), np.int32)])
        direct = make_infer_last_logits(cfg)(
            params, torch.from_numpy(pad).to(card)).cpu().numpy()
        assert np.array_equal(eng.output(x), direct[:3])
        g = reg.generation_engine("lm", slots=2, max_len=64, block_size=8,
                                  paged_attention="fused")
        want = g.generate(p, max_new_tokens=24, timeout=120)
        srv = HostRpcServer(LoopbackHost(0, generation=g))
        try:
            d = ClusterDirectory(heartbeat_timeout_s=30.0)
            rem = RemoteHost(0, srv.url)
            d.join(rem)
            HeartbeatPump(rem, LoopbackTransport(d)).pump_once()
            fd = ClusterFrontDoor(d)
            seen = []
            got = fd.submit_generate(p, max_new_tokens=24,
                                     on_token=seen.append).result(
                                         timeout=120)
            assert got == want == seen
            assert fd.routed_by_host.to_dict() == {"h0": 1.0}
        finally:
            srv.stop()
    finally:
        reg.shutdown()


# ------------------------- the ring's schedule in one process (rows 3-5)

from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    sequence_parallel as sp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,pairs", [
    ("ring", lambda n: n * n), ("ring causal", lambda n: n * (n + 1) // 2),
    ("zigzag", lambda n: n * (2 * n + 1))])
def test_ring_loop_matches_flash_attention(card, kind, pairs, dtype):
    """The kernel ring of ``ring_flash_attention`` (plain or causal) and
    the zigzag, run over 4 virtual ranks in one process (per pair the
    streamed kernels, lse and delta in the global frame), against the
    streamed kernels over the whole T: B=2, H=2, T=512, D=64 (blocks of
    128; zigzag halves of 64). Each of rows 3, 4 and 5 launches n^2,
    n(n+1)/2 or n(2n+1) times. The output is held against the whole-T
    forward; dq, dk, dv against the whole-T backward passes fed that
    forward's lse and the delta of the ring's own output (each rounding
    of the output moves delta, and with it every gradient of the row).
    In bf16 each gradient is a sum of pair terms that leave their kernels
    rounded to bf16: half an ulp of each more is allowed
    (``magnitudes=True`` sums |terms|)."""
    n, t = 4, 512
    rng = np.random.default_rng(len(kind))
    q, k, v, do = (_tensor(rng, (2, 2, t, 64), dtype, card)
                   for _ in range(4))
    causal = kind != "ring"
    counts = (ak.flash_forward.launches, ak.flash_bwd_dq.launches,
              ak.flash_bwd_dkv.launches)

    def run(magnitudes=False):
        if kind != "zigzag":
            return sp.ring_flash_loop(q, k, v, n, causal, do, magnitudes)
        zz = torch.as_tensor(sp.zigzag_indices(t, n), device=card)
        inv = torch.argsort(zz)
        o, g = sp.zigzag_ring_flash_loop(q[:, :, zz], k[:, :, zz],
                                         v[:, :, zz], n, do[:, :, zz],
                                         magnitudes)
        return o[:, :, inv], [x[:, :, inv] for x in g]

    o, g = run()
    torch.cuda.synchronize()
    assert (ak.flash_forward.launches, ak.flash_bwd_dq.launches,
            ak.flash_bwd_dkv.launches) == tuple(c + pairs(n) for c in counts)
    terms = run(magnitudes=True)[1]
    q3, k3, v3, do3, o3 = (x.reshape(4, t, 64) for x in (q, k, v, do, o))
    ro, lse = ak.flash_forward(q3, k3, v3, causal)
    delta = (do3.float() * o3.float()).sum(-1)[:, None, :]
    rg = (ak.flash_bwd_dq(q3, k3, v3, do3, lse, delta, causal),
          *ak.flash_bwd_dkv(q3, k3, v3, do3, lse, delta, causal))
    ro, rg = ro.reshape(o.shape), [x.reshape(o.shape) for x in rg]
    if dtype == torch.float32:
        # fp32 both ways; the merges reassociate the softmax sums
        torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
        for a, b in zip(g, rg):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    else:
        assert _within(o, ro, 64, FWD_FLOOR)
        for a, b, m in zip(g, rg, terms):
            assert _within(a, b, 64, BWD_FLOOR, m)
