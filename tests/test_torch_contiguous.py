"""The PyTorch port's contiguous KV cache (``init_kv_cache(block_size=None)``,
``make_prefill``, ``make_decode_step`` and ``GenerationEngine(paged=False)``
in deeplearning4j_tpu_torch) against the JAX package's, on the CPU.

- The cache functions run the same seeded prompts and decode steps as the
  JAX package's jitted ones (a dead slot in the batch, greedy and sampled
  slots side by side): every sampled token equal, the cache and the
  device-side lengths held to 1e-6.
- Engines: the port runs on ``device="cpu"`` with the JAX engine's weights
  (``params_from_numpy``) at the reference tests' tiny fp32 config; its
  ``paged=False`` streams equal the JAX engine's ``paged=False`` streams
  and the port's own paged streams, greedy and sampled.
- Every ``paged=False`` refusal raises with the reference's message.

The JAX engines' streams are computed once per module. Tolerance:
token-for-token equality; cache tensors 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models.random import prng_key
from deeplearning4j_tpu_torch.serving import GenerationEngine

WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
JCFG = jbert.TransformerConfig(**WIDTHS, dtype=jnp.float32,
                               attention_impl="full")
TCFG = tbert.TransformerConfig(**WIDTHS, dtype=torch.float32,
                               attention_impl="full")
PROMPTS = ((5, 0), (11, 1), (3, 2))     # (length, seed): co-scheduled mix
SAMPLED = dict(temperature=1.0, top_k=8)


def prompt(n, seed=0):
    return np.random.default_rng(seed).integers(
        1, WIDTHS["vocab_size"], n).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch side is tiny; one intra-op thread keeps it from competing
    for every core with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def np_params():
    p = jbert.init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


@pytest.fixture(scope="module")
def tparams(np_params):
    return tbert.params_from_numpy(np_params, device="cpu")


def _streams(eng, sampling):
    hs = [eng.submit(prompt(n, s), max_new_tokens=10, eos_id=None, seed=s,
                     **sampling) for n, s in PROMPTS]
    return [h.result(timeout=120) for h in hs]


@pytest.fixture(scope="module")
def jax_streams(np_params):
    """The JAX engine's paged=False streams, greedy and sampled."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    out = {}
    with JaxEngine(jp, JCFG, slots=2, max_len=32, paged=False) as eng:
        for name, sampling in (("greedy", {}), ("sampled", SAMPLED)):
            out[name] = _streams(eng, sampling)
    return out


# ------------------------------------------------------- the cache layout


def test_init_kv_cache_contiguous_layout():
    cache = tbert.init_kv_cache(TCFG, 3, 16, device="cpu")
    ref = jbert.init_kv_cache(JCFG, 3, 16)
    assert set(cache) == set(ref) == {"layers", "lengths"}
    assert len(cache["layers"]) == len(ref["layers"]) == TCFG.layers
    for lc, rc in zip(cache["layers"], ref["layers"]):
        for name in ("k", "v"):
            assert tuple(lc[name].shape) == rc[name].shape == (3, 16, 2, 16)
            assert lc[name].dtype == torch.float32
            assert not lc[name].any()
    assert cache["lengths"].dtype == torch.int32
    assert tuple(cache["lengths"].shape) == ref["lengths"].shape == (3,)


@pytest.mark.parametrize("kwargs,match", [
    (dict(num_blocks=9), "num_blocks=9 requires block_size"),
    (dict(kv_dtype="int8"), "kv_dtype='int8' requires the paged KV cache"),
    (dict(max_len=65), "exceeds the model's positional table"),
])
def test_init_kv_cache_contiguous_validation(kwargs, match):
    """The reference's refusals, with its messages, on both packages."""
    kw = dict(kwargs)
    max_len = kw.pop("max_len", 16)
    with pytest.raises(ValueError, match=match):
        jbert.init_kv_cache(JCFG, 2, max_len, **kw)
    with pytest.raises(ValueError, match=match):
        tbert.init_kv_cache(TCFG, 2, max_len, device="cpu", **kw)


# ------------------------------------------- prefill and the decode step

SLOTS, MAX_LEN, STEPS = 3, 24, 6
# (temperature, top_k, seed) per slot; slot 2 stays dead (never prefilled)
SAMPLING = [(0.0, 0, 0), (1.0, 8, 1), (0.0, 0, 2)]


def _cache_prompts():
    return [prompt(6, 10), prompt(13, 11)]


def _run_jax_cache(np_params):
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    cache = jbert.init_kv_cache(JCFG, SLOTS, MAX_LEN)
    prefill = jbert.make_prefill(JCFG)
    decode = jbert.make_decode_step(JCFG)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s), np.uint32)
                     for _, _, s in SAMPLING])
    temps = np.array([t for t, _, _ in SAMPLING], np.float32)
    top_ks = np.array([k for _, k, _ in SAMPLING], np.int32)
    tokens = np.zeros(SLOTS, np.int32)
    for i, p in enumerate(_cache_prompts()):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :p.size] = p
        cache, tok = prefill(jp, cache, jnp.asarray(padded), jnp.int32(i),
                             jnp.int32(p.size), jnp.asarray(keys[i]),
                             jnp.float32(temps[i]), jnp.int32(top_ks[i]))
        tokens[i] = int(tok)
    out = [tokens.copy()]
    live = np.array([True, True, False])
    for j in range(STEPS):
        cache, toks = decode(jp, cache, jnp.asarray(tokens),
                             jnp.asarray(live), jnp.asarray(keys),
                             jnp.asarray(np.full(SLOTS, j + 1, np.int32)),
                             jnp.asarray(temps), jnp.asarray(top_ks))
        tokens = np.array(toks, np.int32)
        tokens[2] = 0
        out.append(tokens.copy())
    return np.stack(out), jax.tree_util.tree_map(np.asarray, cache)


def _run_torch_cache(tparams):
    cache = tbert.init_kv_cache(TCFG, SLOTS, MAX_LEN, device="cpu")
    prefill = tbert.make_prefill(TCFG)
    decode = tbert.make_decode_step(TCFG)
    keys = np.stack([prng_key(s) for _, _, s in SAMPLING])
    temps = [t for t, _, _ in SAMPLING]
    top_ks = [k for _, k, _ in SAMPLING]
    tokens = np.zeros(SLOTS, np.int64)
    for i, p in enumerate(_cache_prompts()):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :p.size] = p
        cache, tok = prefill(tparams, cache, padded, i, p.size, keys[i],
                             temps[i], top_ks[i])
        tokens[i] = int(tok)
    out = [tokens.copy()]
    live = np.array([True, True, False])
    for j in range(STEPS):
        cache, toks = decode(tparams, cache, tokens, live, keys,
                             [j + 1] * SLOTS, temps, top_ks)
        tokens = toks.numpy().copy()
        tokens[2] = 0
        out.append(tokens.copy())
    return np.stack(out), cache


def test_prefill_and_decode_step_match_jax(np_params, tparams):
    """Tokens equal, cache rows and lengths as the JAX package's: the dead
    slot writes masked garbage into its own row and keeps length 0, the
    live slots grow by one a step, a write past the row is clipped."""
    jtoks, jcache = _run_jax_cache(np_params)
    ttoks, tcache = _run_torch_cache(tparams)
    np.testing.assert_array_equal(ttoks, jtoks)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  jcache["lengths"])
    assert list(jcache["lengths"]) == [6 + STEPS, 13 + STEPS, 0]
    for lc, rc in zip(tcache["layers"], jcache["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(lc[name].numpy(), rc[name],
                                       rtol=0, atol=1e-6)


def test_decode_step_clips_the_write_position(np_params, tparams):
    """A slot at lengths == max_len writes (and attends) at max_len - 1,
    as the reference's clip does, and its length still grows."""
    cache = tbert.init_kv_cache(TCFG, 1, 8, device="cpu")
    jcache = jbert.init_kv_cache(JCFG, 1, 8)
    cache["lengths"][0] = 8
    jcache = {**jcache, "lengths": jnp.asarray([8], jnp.int32)}
    decode = tbert.make_decode_step(TCFG)
    jdecode = jbert.make_decode_step(JCFG)
    key = prng_key(0)[None]
    cache, tok = decode(tparams, cache, [7], [True], key, [0], [0.0], [0])
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jcache, jtok = jdecode(jp, jcache, jnp.asarray([7], jnp.int32),
                           jnp.asarray([True]), jnp.asarray(key),
                           jnp.asarray([0], jnp.int32),
                           jnp.asarray([0.0], jnp.float32),
                           jnp.asarray([0], jnp.int32))
    assert int(tok[0]) == int(jtok[0])
    assert int(cache["lengths"][0]) == int(jcache["lengths"][0]) == 9
    for lc, rc in zip(cache["layers"], jcache["layers"]):
        np.testing.assert_allclose(lc["k"].numpy(), np.asarray(rc["k"]),
                                   rtol=0, atol=1e-6)


# ------------------------------------------------------ the engine, paged=False


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_engine_paged_false_matches_jax_and_paged(tparams, jax_streams,
                                                  mode):
    sampling = SAMPLED if mode == "sampled" else {}
    with GenerationEngine(tparams, TCFG, slots=2, max_len=32, paged=False,
                          device="cpu") as eng:
        got = _streams(eng, sampling)
        assert eng.metrics.prefills_total.value == len(PROMPTS)
        assert eng.metrics.kv_blocks_total.value == 0   # no pool
        assert eng._cache["lengths"].shape == (2,)
    with GenerationEngine(tparams, TCFG, slots=2, max_len=32,
                          device="cpu") as eng:
        paged = _streams(eng, sampling)
    assert got == jax_streams[mode]
    assert got == paged


def test_engine_paged_false_warmup_and_eos(tparams):
    """warmup probes every rung through the contiguous prefill and decode;
    an EOS retires a stream and frees its slot for the next."""
    with GenerationEngine(tparams, TCFG, slots=1, max_len=32, paged=False,
                          device="cpu") as eng:
        eng.warmup()
        first = eng.generate(prompt(5, 0), max_new_tokens=6, eos_id=None,
                             timeout=60)
        eos = first[2]
        cut = eng.generate(prompt(5, 0), max_new_tokens=6, eos_id=eos,
                           timeout=60)
        again = eng.generate(prompt(5, 0), max_new_tokens=6, eos_id=None,
                             timeout=60)
    assert cut == first[:first.index(eos) + 1]
    assert again == first


REFUSALS = [
    (dict(allocate="on_demand"),
     "allocate='on_demand' requires the paged KV cache"),
    (dict(prefix_cache_blocks=4),
     "prefix_cache_blocks requires the paged KV cache"),
    (dict(swap_threshold_blocks=0),
     "swap_threshold_blocks requires the paged KV cache"),
    (dict(swap_capacity_blocks=8),
     "swap_threshold_blocks requires the paged KV cache"),
    (dict(kv_dtype="int8"), "kv_dtype='int8' requires the paged KV cache"),
    (dict(paged_attention="fused"),
     "paged_attention='fused' requires the paged KV cache"),
]


@pytest.mark.parametrize("kwargs,match", REFUSALS,
                         ids=[next(iter(k)) for k, _ in REFUSALS])
def test_paged_false_refusals(np_params, tparams, kwargs, match):
    """Each paged-only option refuses under paged=False with the
    reference's message, on both packages."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    with pytest.raises(ValueError, match=match):
        JaxEngine(jp, JCFG, slots=2, max_len=32, paged=False, **kwargs)
    with pytest.raises(ValueError, match=match):
        GenerationEngine(tparams, TCFG, slots=2, max_len=32, paged=False,
                         device="cpu", **kwargs)


def test_paged_false_refuses_block_features(tparams):
    """Blocks, prefixes and their byte count do not exist without the
    pool: the reference's messages."""
    with GenerationEngine(tparams, TCFG, slots=2, max_len=32, paged=False,
                          device="cpu") as eng:
        with pytest.raises(ValueError, match="a paged-layout property"):
            eng.kv_block_bytes
        with pytest.raises(ValueError,
                           match="register_prefix requires the paged"):
            eng.register_prefix(prompt(4))
        with pytest.raises(ValueError, match="prefix_id requires the paged"):
            eng.submit(prompt(4), prefix_id="p")
        # the engine still serves after the refusals
        assert len(eng.generate(prompt(4), max_new_tokens=3, eos_id=None,
                                timeout=60)) == 3
