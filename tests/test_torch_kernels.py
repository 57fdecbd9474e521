"""Parity of the PyTorch port's attention kernels (deeplearning4j_tpu_torch/
ops/attention_kernels.py) with the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, as the JAX package's own tests do.
Inputs are drawn from a seed with numpy and handed to both; dtypes are
pinned because the test suite runs JAX with x64 enabled. The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.models import quantize_kv as jax_quantize_kv
from deeplearning4j_tpu.ops.pallas_kernels import (
    _mha_packed_forward, paged_decode_attention as jax_paged_decode)
from deeplearning4j_tpu_torch.models import quantize_kv
from deeplearning4j_tpu_torch.ops import attention_kernels as ak


def _packed_inputs(seed, b, t, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, hd)).astype(np.float32)
            for _ in range(3)]


def _jax_packed(q, k, v, heads, causal, p_dtype):
    o, lse = _mha_packed_forward(
        *(jnp.asarray(x, jnp.float32) for x in (q, k, v)), heads,
        causal=causal, scale=None, interpret=True, p_dtype=p_dtype)
    return np.asarray(o), np.asarray(lse)


class TestPackedForward:
    @pytest.mark.parametrize("causal", [True, False])
    def test_fp32_matches_pallas_kernel(self, causal):
        q, k, v = _packed_inputs(0, 2, 24, 64)
        ref_o, ref_lse = _jax_packed(q, k, v, 4, causal, jnp.float32)
        o, lse = ak.mha_packed_forward(
            *(torch.from_numpy(x) for x in (q, k, v)), 4, causal)
        # same fp32 arithmetic; only the summation order differs
        np.testing.assert_allclose(o.numpy(), ref_o, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5,
                                   atol=1e-5)

    def test_bf16_probabilities_within_jax_bound(self):
        q, k, v = _packed_inputs(1, 1, 32, 32)
        ref_o, ref_lse = _jax_packed(q, k, v, 2, True, jnp.bfloat16)
        o, lse = ak.mha_packed_forward(
            *(torch.from_numpy(x) for x in (q, k, v)), 2, True, None,
            torch.bfloat16)
        # p = exp_bf16(s - m) rounds at bf16 resolution on both sides; the
        # JAX package bounds this mode at 5e-2 (pallas_kernels.py)
        np.testing.assert_allclose(o.numpy(), ref_o, rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=5e-2,
                                   atol=5e-2)

    def test_wrapper_returns_o_and_counts_no_cpu_launch(self):
        q, k, v = (torch.from_numpy(x) for x in _packed_inputs(2, 1, 16, 32))
        before = ak.mha_attention_packed.launches
        o = ak.mha_attention_packed(q, k, v, 2, True)
        o2, _ = ak.mha_packed_forward_reference(q, k, v, 2, True)
        assert torch.equal(o, o2)
        # the counter counts kernel launches only: CPU tensors launch none
        assert ak.mha_attention_packed.launches == before

    def test_rejects_bad_operands(self):
        q = torch.zeros(1, 8, 12)
        with pytest.raises(ValueError, match="multiple of heads"):
            ak.mha_packed_forward(q, q, q, 5)
        with pytest.raises(ValueError, match="share one"):
            ak.mha_packed_forward(q, q, torch.zeros(1, 8, 16), 4)
        with pytest.raises(TypeError):
            ak.mha_packed_forward(q.double(), q.double(), q.double(), 4)

    def test_shape_envelope_matches_jax(self):
        from deeplearning4j_tpu.ops.pallas_kernels import (
            packed_kernel_shape_ok as jax_ok)
        for t in (1, 8, 12, 512, 1024, 1032):
            assert ak.packed_kernel_shape_ok(t) == jax_ok(t)


def _paged_case(seed, block):
    """Odd positions, a full block boundary, position 0, a slot sharing a
    block with another, and a dead slot (all-scratch row, pos 0)."""
    rng = np.random.default_rng(seed)
    S, NB, H, D, nbmax = 6, 11, 2, 16, 4
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, block, H, D)).astype(np.float32)
    vp = rng.standard_normal((NB, block, H, D)).astype(np.float32)
    tables = np.zeros((S, nbmax), np.int32)
    tables[0, :1] = [1]
    tables[1, :2] = [2, 3]
    tables[2, :4] = [4, 5, 6, 7]
    tables[3, :3] = [8, 9, 10]
    tables[4, :1] = [3]          # shares slot 1's block
    pos = np.array([0, block + 3, 4 * block - 1, 2 * block + 7, 5, 0],
                   np.int32)
    return q, kp, vp, tables, pos


class TestPagedDecode:
    @pytest.mark.parametrize("block", [4, 8, 16])
    def test_matches_pallas_kernel(self, block):
        q, kp, vp, tables, pos = _paged_case(block, block)
        ref = np.asarray(jax_paged_decode(
            *(jnp.asarray(x) for x in (q, kp, vp, tables, pos)),
            block_size=block, interpret=True))
        out = ak.paged_decode_attention(
            *(torch.from_numpy(x) for x in (q, kp, vp, tables, pos)),
            block_size=block)
        assert np.all(np.isfinite(out.numpy()))
        # fp32 softmax on both sides: online there, whole-row here
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("block", [4, 16])
    def test_int8_pool_matches_pallas_kernel(self, block):
        q, kp, vp, tables, pos = _paged_case(10 + block, block)
        kq, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(kp)))
        vq, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(vp)))
        ref = np.asarray(jax_paged_decode(
            *(jnp.asarray(x) for x in (q, kq, vq, tables, pos)),
            block_size=block, k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs), interpret=True))
        out = ak.paged_decode_attention(
            *(torch.from_numpy(x) for x in (q, kq, vq, tables, pos)),
            block_size=block, k_scale=torch.from_numpy(ks),
            v_scale=torch.from_numpy(vs))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

    def test_rejects_bad_operands(self):
        q, kp, vp, tables, pos = (torch.from_numpy(x)
                                  for x in _paged_case(0, 8))
        with pytest.raises(ValueError, match="block_size"):
            ak.paged_decode_attention(q, kp, vp, tables, pos, block_size=4)
        with pytest.raises(ValueError, match="together"):
            ak.paged_decode_attention(q, kp, vp, tables, pos, block_size=8,
                                      k_scale=torch.zeros(11, 8, 2))
        with pytest.raises(ValueError, match="int8 pool needs"):
            ak.paged_decode_attention(q, kp.to(torch.int8),
                                      vp.to(torch.int8), tables, pos,
                                      block_size=8)

    def test_quantize_kv_bit_equal(self):
        x = np.random.default_rng(3).standard_normal(
            (4, 8, 2, 16)).astype(np.float32)
        x[0, 0, 0] = 0.0                        # the 1e-8 scale floor
        # amax 127 makes the scale exactly 1: x/scale hits .5 ties, which
        # round half to even
        x[1, 1, 1, :5] = [127.0, 0.5, -0.5, 1.5, 2.5]
        jq, js = jax_quantize_kv(jnp.asarray(x))
        q, s = quantize_kv(torch.from_numpy(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
