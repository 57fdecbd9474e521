"""Parity of the PyTorch port's model half (deeplearning4j_tpu_torch/models)
with the JAX package: the threefry PRNG and sampler, the forward pass, and
paged prefill + decode over both attention routes and both KV storage
modes.

Both packages get the same numpy-drawn parameters and inputs; dtypes are
pinned because the test suite runs JAX with x64 enabled. The JAX side
reaches its Pallas kernels in interpret mode.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import random as trandom
from torch_threads import one_torch_thread  # noqa: F401,E402

JCFG = jbert.TransformerConfig(vocab_size=1024, hidden=128, layers=2,
                               heads=4, mlp_dim=512, max_seq=128,
                               dtype=jnp.float32, causal=True, remat=False,
                               attention_impl="full")


def tcfg(**kw):
    base = dict(vocab_size=1024, hidden=128, layers=2, heads=4, mlp_dim=512,
                max_seq=128, dtype=torch.float32, causal=True, remat=False,
                attention_impl="full")
    base.update(kw)
    return tbert.TransformerConfig(**base)


@pytest.fixture(scope="module")
def np_params():
    p = jbert.init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


@pytest.fixture(scope="module")
def jparams(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


@pytest.fixture(scope="module")
def tparams(np_params):
    return tbert.params_from_numpy(np_params, device="cpu")


# ---------------------------------------------------------------------------
# PRNG and sampling
# ---------------------------------------------------------------------------
class TestThreefry:
    @pytest.mark.parametrize("seed", [0, 7, 123456789, 2 ** 40 + 5])
    def test_keys_fold_in_and_bits_are_jax_bits(self, seed):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(np.asarray(key, np.uint32),
                                      trandom.prng_key(seed))
        with jax.threefry_partitionable(True):
            for step in (0, 1, 63, 2 ** 31 + 3):
                folded = jax.random.fold_in(key, step)
                mine = trandom.fold_in(trandom.prng_key(seed), step)
                np.testing.assert_array_equal(
                    np.asarray(folded, np.int64), mine.numpy())
                bits = jax.random.bits(folded, (777,), jnp.uint32)
                np.testing.assert_array_equal(
                    np.asarray(bits, np.int64),
                    trandom.random_bits(mine, 777).numpy())

    def test_gumbel_values(self):
        with jax.threefry_partitionable(True):
            for seed in range(4):
                key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
                ref = np.asarray(jax.random.gumbel(key, (4096,),
                                                   jnp.float32))
                mine = trandom.gumbel(
                    trandom.as_key(np.asarray(key, np.uint32)), 4096)
                # identical uniforms (the bits are exact); log differs by
                # ulps between the libraries: 1e-6 relative, plus 2 ulps of
                # 1.0 where -log(u) ~ 1 puts the outer log near 0
                np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-6,
                                           atol=2.5e-7)

    @pytest.mark.parametrize("temperature,top_k", [
        (0.0, 0), (0.0, 5), (0.8, 40), (1.3, 0), (0.7, 1)])
    def test_sample_token_matches_jax(self, temperature, top_k):
        rng = np.random.default_rng(int(temperature * 10) + top_k)
        for step in range(6):
            logits = rng.standard_normal(1024).astype(np.float32)
            key = jax.random.PRNGKey(100 + step)
            ref = int(jbert._sample_at(
                jnp.asarray(logits), key, jnp.int32(step),
                jnp.float32(temperature), jnp.int32(top_k)))
            mine = int(tbert.sample_token(
                torch.from_numpy(logits), np.asarray(key, np.uint32),
                temperature, top_k, step))
            assert mine == ref


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
class TestForward:
    @pytest.mark.parametrize("impl", ["full", "flash"])
    def test_logits_match_jax(self, jparams, tparams, impl):
        toks = np.random.default_rng(1).integers(
            0, 1024, (2, 16)).astype(np.int32)
        jcfg = jbert.TransformerConfig(**{
            **{f: getattr(JCFG, f) for f in
               ("vocab_size", "hidden", "layers", "heads", "mlp_dim",
                "max_seq", "dtype", "causal", "remat")},
            "attention_impl": impl})
        ref = np.asarray(jbert.forward(jparams, jnp.asarray(toks), jcfg))
        out = tbert.forward(tparams, torch.from_numpy(toks),
                            tcfg(attention_impl=impl)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)

    def test_bidirectional_flash_matches_full(self, tparams):
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, 1024, (1, 24)).astype(np.int64))
        a = tbert.forward(tparams, toks, tcfg(causal=False))
        b = tbert.forward(tparams, toks,
                          tcfg(causal=False, attention_impl="flash"))
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    def test_unported_attention_raises(self, jparams, tparams, caplog):
        """attention_impl='flash' outside the packed envelope routes as the
        reference routes it without a mesh, and raises nothing: T=100 has
        no usable streamed block, so it takes the einsum path with the
        reference's one-time warning, and matches it."""
        toks = np.random.default_rng(3).integers(0, 1024, (2, 100)).astype(
            np.int32)
        jcfg = jbert.TransformerConfig(**{
            **{f: getattr(JCFG, f) for f in
               ("vocab_size", "hidden", "layers", "heads", "mlp_dim",
                "max_seq", "dtype", "causal", "remat")},
            "attention_impl": "flash"})
        ref = np.asarray(jbert.forward(jparams, jnp.asarray(toks), jcfg))
        tbert._flash_fallback_warned.clear()
        with caplog.at_level(logging.WARNING,
                             logger="deeplearning4j_tpu_torch.models.bert"):
            out = tbert.forward(tparams, torch.from_numpy(toks),
                                tcfg(attention_impl="flash")).numpy()
        assert any("falling back to the XLA einsum path" in r.getMessage()
                   and "T=100" in r.getMessage() for r in caplog.records)
        # fp32 on both sides; the reference's scores are fp64 under x64
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)

    def test_compute_params_keep_layernorm_fp32(self, tparams):
        cp = tbert.compute_params(tparams, tcfg(dtype=torch.bfloat16), "cpu")
        assert cp["tok_emb"].dtype == torch.bfloat16
        assert cp["blocks"][0]["qkv"]["kernel"].dtype == torch.bfloat16
        assert cp["blocks"][0]["ln1"]["scale"].dtype == torch.float32
        assert cp["ln_f"]["bias"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Paged prefill + decode
# ---------------------------------------------------------------------------
BLOCK, MAX_LEN, SLOTS = 8, 64, 3
PROMPTS = [np.random.default_rng(10 + i).integers(0, 1024, n).astype(np.int32)
           for i, n in enumerate((5, 11))]
SAMPLING = [(0.0, 0, 3), (0.8, 40, 4), (0.0, 0, 0)]   # (temp, top_k, seed)


def _layout():
    """Block table: slot 0 -> blocks 1-2, slot 1 -> blocks 3-5, slot 2
    dead (all scratch)."""
    tables = np.zeros((SLOTS, MAX_LEN // BLOCK), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    return tables


def _run_jax(jparams, route, kv_dtype, steps=5):
    cache = jbert.init_kv_cache(JCFG, SLOTS, MAX_LEN, block_size=BLOCK,
                                kv_dtype=kv_dtype)
    prefill = jbert.make_paged_prefill(JCFG, BLOCK, kv_dtype=kv_dtype)
    decode = jbert.make_paged_decode_step(JCFG, BLOCK, kv_dtype=kv_dtype,
                                          paged_attention=route)
    tables = _layout()
    keys = np.stack([np.asarray(jax.random.PRNGKey(s), np.uint32)
                     for _, _, s in SAMPLING])
    lengths = np.zeros(SLOTS, np.int32)
    tokens = np.zeros(SLOTS, np.int32)
    for i, p in enumerate(PROMPTS):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :p.size] = p
        cache, tok = prefill(jparams, cache, jnp.asarray(padded),
                             jnp.asarray(tables[i, :2]), jnp.int32(p.size),
                             jnp.asarray(keys[i]),
                             jnp.float32(SAMPLING[i][0]),
                             jnp.int32(SAMPLING[i][1]), jnp.int32(0))
        lengths[i], tokens[i] = p.size, int(tok)
    out = [tokens.copy()]
    temps = np.array([t for t, _, _ in SAMPLING], np.float32)
    top_ks = np.array([k for _, k, _ in SAMPLING], np.int32)
    zero = np.zeros(SLOTS, np.int32)
    for j in range(steps):
        steps_arr = np.array([j + 1] * SLOTS, np.int32)
        cache, toks = decode(jparams, cache, jnp.asarray(tables),
                             jnp.asarray(lengths), jnp.asarray(tokens),
                             jnp.asarray(keys), jnp.asarray(steps_arr),
                             jnp.asarray(temps), jnp.asarray(top_ks),
                             jnp.asarray(zero), jnp.asarray(zero))
        tokens = np.array(toks, np.int32)
        tokens[2] = 0
        lengths[:2] += 1
        out.append(tokens.copy())
    return np.stack(out), jax.tree_util.tree_map(np.asarray, cache)


def _run_torch(tparams, route, kv_dtype, impl="full", steps=5):
    cfg = tcfg(attention_impl=impl)
    cache = tbert.init_kv_cache(cfg, SLOTS, MAX_LEN, block_size=BLOCK,
                                kv_dtype=kv_dtype, device="cpu")
    prefill = tbert.make_paged_prefill(cfg, BLOCK, kv_dtype=kv_dtype)
    decode = tbert.make_paged_decode_step(cfg, BLOCK, kv_dtype=kv_dtype,
                                          paged_attention=route)
    tables = _layout()
    keys = np.stack([trandom.prng_key(s) for _, _, s in SAMPLING])
    lengths = np.zeros(SLOTS, np.int64)
    tokens = np.zeros(SLOTS, np.int64)
    for i, p in enumerate(PROMPTS):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :p.size] = p
        cache, tok = prefill(tparams, cache, padded, tables[i, :2], p.size,
                             keys[i], SAMPLING[i][0], SAMPLING[i][1], 0)
        lengths[i], tokens[i] = p.size, int(tok)
    out = [tokens.copy()]
    temps = [t for t, _, _ in SAMPLING]
    top_ks = [k for _, k, _ in SAMPLING]
    zero = np.zeros(SLOTS, np.int64)
    for j in range(steps):
        cache, toks = decode(tparams, cache, tables, lengths, tokens, keys,
                             [j + 1] * SLOTS, temps, top_ks, zero, zero)
        tokens = toks.numpy().copy()
        tokens[2] = 0
        lengths[:2] += 1
        out.append(tokens.copy())
    return np.stack(out), cache


class TestPagedGeneration:
    @pytest.mark.parametrize("route,kv_dtype", [
        ("gather", "float32"), ("fused", "float32"),
        ("gather", "int8"), ("fused", "int8")])
    def test_prefill_and_decode_match_jax(self, jparams, tparams, route,
                                          kv_dtype):
        ref_toks, ref_cache = _run_jax(jparams, route, kv_dtype)
        toks, cache = _run_torch(tparams, route, kv_dtype,
                                 impl="flash" if route == "fused" else "full")
        # greedy slot 0 and sampled slot 1 (temperature 0.8, top-k 40)
        np.testing.assert_array_equal(toks[:, :2], ref_toks[:, :2])
        for lc, rc in zip(cache["layers"], ref_cache["layers"]):
            for name in lc:
                got, want = lc[name][1:].numpy(), rc[name][1:]  # live blocks
                if name in ("k", "v") and kv_dtype == "int8":
                    # the same fp32 K/V within 1e-5 can straddle a rounding
                    # boundary: at most one quantization step apart
                    assert np.abs(got.astype(np.int32)
                                  - want.astype(np.int32)).max() <= 1
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-5)

    def test_decode_logits_match_full_forward(self, tparams):
        """The paged step's logits at position n are the full forward's
        last-position logits over the n+1 tokens so far."""
        cfg = tcfg()
        cache = tbert.init_kv_cache(cfg, 1, MAX_LEN, block_size=BLOCK,
                                    device="cpu")
        prefill = tbert.make_paged_prefill(cfg, BLOCK)
        logits_fn = tbert.make_paged_decode_logits(cfg, BLOCK,
                                                   paged_attention="fused")
        p = PROMPTS[1]
        tables = np.array([[1, 2, 3, 0, 0, 0, 0, 0]], np.int32)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :p.size] = p
        _, tok = prefill(tparams, cache, padded, tables[0, :2], p.size,
                         trandom.prng_key(0), 0.0, 0, 0)
        seq = list(p) + [int(tok)]
        for _ in range(3):
            logits = logits_fn(tparams, cache, tables, [len(seq) - 1],
                               [seq[-1]], [0], [0])
            full = tbert.forward(tparams, torch.tensor([seq]), cfg)[0, -1]
            torch.testing.assert_close(logits[0], full, rtol=1e-4, atol=1e-4)
            seq.append(int(logits[0].argmax()))

    def test_cow_copies_block_before_write(self, tparams):
        cfg = tcfg()
        cache = tbert.init_kv_cache(cfg, 2, MAX_LEN, block_size=BLOCK,
                                    device="cpu")
        for lc in cache["layers"]:
            lc["k"][1] = 1.0
        logits_fn = tbert.make_paged_decode_logits(cfg, BLOCK)
        tables = np.zeros((2, 8), np.int32)
        tables[0, 0] = 2
        logits_fn(tparams, cache, tables, [3, 0], [1, 0], [1, 0], [2, 0])
        k = cache["layers"][0]["k"]
        assert torch.all(k[2, :3] == 1.0)       # copied from block 1
        assert not torch.all(k[2, 3] == 1.0)    # this step's write


class TestValidationAndDevice:
    def test_validators(self):
        assert tbert.validate_block_size(8, 64) == 8
        for bad in (0, 6, 128):
            with pytest.raises(ValueError):
                tbert.validate_block_size(bad, 64)
        with pytest.raises(ValueError, match="requires the paged"):
            tbert.validate_kv_dtype("int8", None)
        with pytest.raises(ValueError):
            tbert.validate_kv_dtype("fp8", 8)
        with pytest.raises(ValueError, match="causal"):
            tbert.make_paged_prefill(tcfg(causal=False), 8)
        with pytest.raises(ValueError, match="paged_attention"):
            tbert.make_paged_decode_logits(tcfg(), 8,
                                           paged_attention="other")

    def test_grow_block_table(self):
        t = np.zeros((2, 2), np.int32)
        assert tbert.grow_block_table(t, 1, 0, 7) == 1
        assert tbert.grow_block_table(t, 1, 1, 9) == 2
        assert list(t[1]) == [7, 9]
        with pytest.raises(ValueError, match="full"):
            tbert.grow_block_table(t, 1, 2, 4)

    def test_entry_points_need_cuda_unless_asked_for_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbert.init_params(tcfg())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbert.init_kv_cache(tcfg(), 1, 16, block_size=8)
        assert tbert.init_params(tcfg(layers=1), device="cpu")[
            "tok_emb"].device.type == "cpu"
