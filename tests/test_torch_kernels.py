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

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import quantize_kv as jax_quantize_kv
from deeplearning4j_tpu.ops.pallas_kernels import (
    _mha_packed_forward, paged_decode_attention as jax_paged_decode)
from deeplearning4j_tpu_torch.models import quantize_kv
from deeplearning4j_tpu_torch.ops import attention_kernels as ak


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch side of these tests is small; one intra-op thread keeps it
    from competing for every core with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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

    def test_out_of_range_block_ids_read_as_the_jax_gather(self):
        from deeplearning4j_tpu.ops.pallas_kernels import (
            paged_decode_attention_reference as jax_paged_ref)
        q, kp, vp, tables, pos = _paged_case(7, 8)
        nb = kp.shape[0]
        # NB and 31 clamp to NB - 1; -1 counts from the end (NB - 1), -3
        # too (NB - 3); -40 (< -NB) clamps to 0 after the wrap
        tables[1, :2] = [nb, -1]
        tables[2, :4] = [-3, 31, -40, 5]
        ref = np.asarray(jax_paged_ref(
            *(jnp.asarray(x) for x in (q, kp, vp, tables, pos)),
            block_size=8))
        out = ak.paged_decode_attention(
            *(torch.from_numpy(x) for x in (q, kp, vp, tables, pos)),
            block_size=8)
        # fp32 softmax on both sides over the same gathered blocks
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

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


# ---------------------------------------------------------------------------
# Packed backward (row 2), autograd, higher-order escape
# ---------------------------------------------------------------------------
def _t(*xs):
    return [torch.from_numpy(np.array(x, np.float32)) for x in xs]


def _jax_packed_vjp(q, k, v, g, heads, causal, p_dtype):
    from deeplearning4j_tpu.ops.pallas_kernels import mha_attention_packed

    def f(q_, k_, v_):
        return mha_attention_packed(q_, k_, v_, heads, causal, None, True,
                                    p_dtype)
    o, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.float32) for x in (q, k, v)))
    return np.asarray(o), [np.asarray(x)
                           for x in vjp(jnp.asarray(g, jnp.float32))]


class TestPackedBackward:
    @pytest.mark.parametrize("t", [16, 24])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
    def test_plain_backward_matches_pallas_vjp(self, t, causal, p_dtype):
        q, k, v = _packed_inputs(20 + t, 2, t, 32)
        g = np.random.default_rng(t).standard_normal(q.shape).astype(
            np.float32)
        _, ref = _jax_packed_vjp(q, k, v, g, 2, causal,
                                 getattr(jnp, p_dtype))
        tp = getattr(torch, p_dtype)
        tq, tk, tv, tg = _t(q, k, v, g)
        _, lse = ak.mha_packed_forward(tq, tk, tv, 2, causal, None, tp)
        got = ak.mha_packed_backward(tq, tk, tv, tg, lse, 2, causal, None, tp)
        # fp32 p: the same fp32 arithmetic, only summation order differs
        # (2e-5: the gradients sum T products of O(1) terms); bf16 p: p is
        # rebuilt at bf16 resolution on both sides from lse values that
        # agree to 1e-6, so an element can round to a neighbouring bf16
        # value — the JAX package's own 5e-2 bound for this mode
        tol = 2e-5 if p_dtype == "float32" else 5e-2
        for name, a, b in zip("qkv", got, ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol,
                                       err_msg=f"d{name}")

    def test_backward_counts_no_cpu_launch(self):
        q, k, v, g = _t(*_packed_inputs(5, 1, 16, 32), np.ones((1, 16, 32)))
        _, lse = ak.mha_packed_forward(q, k, v, 2)
        before = ak.mha_packed_backward.launches
        ak.mha_packed_backward(q, k, v, g, lse, 2)
        assert ak.mha_packed_backward.launches == before
        with pytest.raises(ValueError, match="lse"):
            ak.mha_packed_backward(q, k, v, g, lse[:, :1], 2)

    @pytest.mark.parametrize("causal", [True, False])
    def test_autograd_matches_jax(self, causal):
        q, k, v = _packed_inputs(30, 2, 16, 32)
        g = np.random.default_rng(31).standard_normal(q.shape).astype(
            np.float32)
        ref_o, ref = _jax_packed_vjp(q, k, v, g, 4, causal, jnp.float32)
        tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
        o = ak.mha_attention_packed(tq, tk, tv, 4, causal)
        grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
        # same fp32 arithmetic both sides, summation order aside
        np.testing.assert_allclose(o.detach().numpy(), ref_o, rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(grads, ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)

    def test_mha_attention_4d_is_one_head_per_row(self):
        from deeplearning4j_tpu.ops.pallas_kernels import mha_attention
        rng = np.random.default_rng(32)
        q, k, v, g = (rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
                      for _ in range(4))
        o, vjp = jax.vjp(lambda *a: mha_attention(*a, True, None, True),
                         *(jnp.asarray(x) for x in (q, k, v)))
        ref = vjp(jnp.asarray(g))
        tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
        to = ak.mha_attention(tq, tk, tv, True)
        grads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(g))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(o),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(grads, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                       atol=2e-5)


class TestHigherOrder:
    @pytest.mark.parametrize("impl", ["packed", "flash"])
    def test_double_backward_raises_naming_the_escape(self, impl):
        q, k, v = (x.requires_grad_()
                   for x in _t(*_packed_inputs(40, 2, 16, 16)))
        if impl == "packed":
            o = ak.mha_attention_packed(q, k, v, 2, True)
        else:
            o = ak.flash_attention(q, k, v, True)
        (gq,) = torch.autograd.grad(o.square().sum(), q, create_graph=True)
        with pytest.raises(RuntimeError, match="higher_order_attention"):
            gq.sum().backward()

    @pytest.mark.parametrize("impl", ["packed", "flash"])
    def test_hvp_inside_context_matches_jax(self, impl):
        from deeplearning4j_tpu.ops import pallas_kernels as pk
        rng = np.random.default_rng(41)
        q, k, v, u = (rng.standard_normal((2, 16, 16)).astype(np.float32)
                      for _ in range(4))
        if impl == "packed":
            def jf(q_):
                return (pk.mha_attention_packed(q_, jnp.asarray(k),
                                               jnp.asarray(v), 2, True, None,
                                               True) ** 2).sum()

            def tf(q_):
                return ak.mha_attention_packed(q_, tk, tv, 2,
                                               True).square().sum()
        else:
            def jf(q_):
                return (pk.flash_attention(q_, jnp.asarray(k),
                                           jnp.asarray(v), True,
                                           interpret=True) ** 2).sum()

            def tf(q_):
                return ak.flash_attention(q_, tk, tv, True).square().sum()
        with pk.higher_order_attention():
            _, ref = jax.jvp(jax.grad(jf), (jnp.asarray(q),),
                             (jnp.asarray(u),))
        tq, tk, tv, tu = _t(q, k, v, u)
        tq.requires_grad_()
        with ak.higher_order_attention():
            (g,) = torch.autograd.grad(tf(tq), tq, create_graph=True)
            (hvp,) = torch.autograd.grad((g * tu).sum(), tq)
        # fp32 second derivatives of the same plain attention; 1e-4 for
        # the longer chains of sums
        np.testing.assert_allclose(hvp.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# Streamed forward, dq, dk/dv (rows 3-5)
# ---------------------------------------------------------------------------
class TestStreamed:
    T, BLK = 64, 16

    def _inputs(self, seed):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal((3, self.T, 16)).astype(np.float32)
                for _ in range(4)]

    @pytest.mark.parametrize("causal", [True, False])
    def test_forward_and_passes_match_pallas(self, causal):
        from deeplearning4j_tpu.ops.pallas_kernels import (
            _flash_forward, _launch_bwd_dkv, _launch_bwd_dq)
        q, k, v, do = self._inputs(50)
        jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
        ro, rlse = _flash_forward(jq, jk, jv, causal=causal,
                                  block_q=self.BLK, block_k=self.BLK,
                                  scale=None, interpret=True)
        delta = jnp.sum(jdo * ro, axis=-1).reshape(3, 1, self.T)
        sc = 1.0 / 4.0
        rdq = _launch_bwd_dq(jq, jk, jv, jdo, rlse, delta, causal, self.BLK,
                             self.BLK, sc, True)
        rdk, rdv = _launch_bwd_dkv(jq, jk, jv, jdo, rlse, delta, causal,
                                   self.BLK, self.BLK, sc, True)
        tq, tk, tv, tdo = _t(q, k, v, do)
        o, lse = ak.flash_forward(tq, tk, tv, causal, self.BLK, self.BLK)
        # fp32 both sides; 16-key blocks there, one whole-row softmax here:
        # the running sums reassociate
        np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), rtol=1e-5,
                                   atol=1e-5)
        # the passes on the JAX package's own lse and delta: same fp32
        # arithmetic, summation order aside
        tlse, tdelta = _t(rlse, delta)
        dq = ak.flash_bwd_dq(tq, tk, tv, tdo, tlse, tdelta, causal)
        dk, dv = ak.flash_bwd_dkv(tq, tk, tv, tdo, tlse, tdelta, causal)
        for a, b in ((dq, rdq), (dk, rdk), (dv, rdv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                       atol=2e-5)

    @pytest.mark.parametrize("causal", [True, False])
    def test_autograd_matches_jax_vjp_4d(self, causal):
        from deeplearning4j_tpu.ops.pallas_kernels import flash_attention
        q, k, v, g = (x.reshape(1, 3, self.T, 16) for x in self._inputs(51))
        o, vjp = jax.vjp(lambda *a: flash_attention(
            *a, causal, self.BLK, self.BLK, None, True),
            *(jnp.asarray(x) for x in (q, k, v)))
        ref = vjp(jnp.asarray(g))
        tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
        to = ak.flash_attention(tq, tk, tv, causal, self.BLK, self.BLK)
        grads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(g))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(o),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(grads, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                       atol=2e-5)

    def test_block_rules_match_jax(self):
        from deeplearning4j_tpu.ops import pallas_kernels as pk
        for t in (8, 100, 512, 1000, 1024, 1536, 2048, 4104, 8192):
            assert ak.auto_flash_block(t) == pk.auto_flash_block(t)
            assert ak.flash_envelope_ok(t) == pk.flash_envelope_ok(t)
        for args in ((1536, None, None), (64, 16, 32), (100, None, 50)):
            assert ak._resolve_flash_blocks(*args) == \
                pk._resolve_flash_blocks(*args)
        with pytest.raises(ValueError, match="power-of-2"):
            pk._resolve_flash_blocks(1031, None, None)
        with pytest.raises(ValueError, match="power-of-2"):
            ak._resolve_flash_blocks(1031, None, None)
        x = torch.zeros(1, 48, 16)
        with pytest.raises(ValueError, match="multiple of the blocks"):
            ak.flash_forward(x, x, x, False, 32, 16)

    def test_passes_count_no_cpu_launch(self):
        q, k, v, do = _t(*self._inputs(52))
        o, lse = ak.flash_forward(q, k, v, True)
        delta = (do * o).sum(-1).reshape(3, 1, self.T)
        counts = (ak.flash_forward.launches, ak.flash_bwd_dq.launches,
                  ak.flash_bwd_dkv.launches)
        ak.flash_bwd_dq(q, k, v, do, lse, delta, True)
        ak.flash_bwd_dkv(q, k, v, do, lse, delta, True)
        assert (ak.flash_forward.launches, ak.flash_bwd_dq.launches,
                ak.flash_bwd_dkv.launches) == counts
        with pytest.raises(ValueError, match="delta"):
            ak.flash_bwd_dq(q, k, v, do, lse, delta[:, :, :8], True)


# ---------------------------------------------------------------------------
# The causal first row: the invariant the CUDA forward reproduces
# ---------------------------------------------------------------------------
class TestCausalFirstRow:
    """The first query of a causal head sees one key, so its softmax is
    exactly 1: lse is that (0, 0) score bit for bit, and the backward fed
    that lse gives the row's dq exactly 0 (p = exp(0) = 1 and delta = dp
    there). Both packages hold it; the CUDA forward keeps it on the card by
    summing that one score in sequence (tests/test_torch_cuda.py)."""

    HEADS, T, D = 2, 24, 32

    def _inputs(self, seed):
        q, k, v = _packed_inputs(seed, 2, self.T, self.HEADS * self.D)
        do = np.random.default_rng(seed + 1).standard_normal(
            q.shape).astype(np.float32)
        return q, k, v, do

    @pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
    def test_port_plain_version(self, p_dtype):
        q, k, v, do = _t(*self._inputs(60))
        tp = getattr(torch, p_dtype)
        _, lse = ak.mha_packed_forward(q, k, v, self.HEADS, True, None, tp)
        # its own scores: the plain version's fp32 q k^T, q scaled first
        s = ak._scores(q * self.D ** -0.5, k, self.HEADS, True)
        assert torch.equal(lse[..., 0], s[..., 0, 0])
        dq, _, _ = ak.mha_packed_backward(q, k, v, do, lse, self.HEADS, True,
                                          None, tp)
        assert torch.equal(dq[:, 0], torch.zeros_like(dq[:, 0]))

    @pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
    def test_jax_pallas_kernels(self, p_dtype):
        q, k, v, do = self._inputs(61)
        _, lse = _jax_packed(q, k, v, self.HEADS, True,
                             getattr(jnp, p_dtype))
        # its own scores: the kernel's fp32 dot of each head's qs and k
        qs = jnp.asarray(q, jnp.float32) * self.D ** -0.5
        for b in range(q.shape[0]):
            for h in range(self.HEADS):
                sl = slice(h * self.D, (h + 1) * self.D)
                s = jax.lax.dot_general(
                    qs[b, :, sl], jnp.asarray(k[b, :, sl], jnp.float32),
                    (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32)
                assert lse[b, h, 0] == np.asarray(s)[0, 0]
        _, (dq, _, _) = _jax_packed_vjp(q, k, v, do, self.HEADS, True,
                                        getattr(jnp, p_dtype))
        assert np.array_equal(dq[:, 0], np.zeros_like(dq[:, 0]))
