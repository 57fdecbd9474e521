"""Speculative decoding in the PyTorch port (deeplearning4j_tpu_torch:
``make_draft_prefill``, ``make_draft_step``, ``make_verify_step`` and
``GenerationEngine(speculative=SpecConfig(...))``) against the JAX
package's, on the CPU.

- The draft prefill and the draft step (host lengths, a rewind to a
  shorter length, the clip at the draft's table) against the JAX
  package's: proposals equal, the draft cache to 1e-6.
- The verify step on both routes and both pools against the JAX
  package's: samples and ``accepted`` equal, the pool after the writes to
  1e-6 (int8 values exactly), with a copy-on-write pair, a slot whose
  writes run past its mapped blocks (the on-demand edge, scratch-routed)
  and one past the cache's capacity.
- The cases of ``tests/test_speculative.py`` this slice covers:
  ``TestBitwiseParity`` (every k, int8, fused, sampled, preemption),
  ``TestAcceptance`` (self-draft, per-tenant, the governor, demotion),
  the SpecConfig and engine validation and a non-causal draft. Every
  speculative stream equals the JAX engine's plain stream.
- The degrade contract: a draft step that raises costs no stream and
  counts ``spec_fallbacks_total``.

The port runs on ``device="cpu"`` with the JAX package's weights
(``params_from_numpy``) at ``tests/test_speculative.py``'s CFG and DCFG;
the JAX engines' plain streams are computed once per module. Tolerance:
token-for-token equality; cache tensors 1e-6.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving import (
    SpecAcceptanceGovernor as JaxGovernor)
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models.random import prng_key
from deeplearning4j_tpu_torch.serving import (
    GenerationEngine, SpecAcceptanceGovernor, SpecConfig)

WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
DWIDTHS = dict(vocab_size=50, hidden=16, layers=1, heads=2, mlp_dim=32,
               max_seq=64, causal=True, remat=False)
JCFG = jbert.TransformerConfig(**WIDTHS, dtype=jnp.float32,
                               attention_impl="full")
JDCFG = jbert.TransformerConfig(**DWIDTHS, dtype=jnp.float32,
                                attention_impl="full")
CFG = tbert.TransformerConfig(**WIDTHS, dtype=torch.float32,
                              attention_impl="full")
DCFG = tbert.TransformerConfig(**DWIDTHS, dtype=torch.float32,
                               attention_impl="full")
PROMPTS = ((5, 0), (11, 1), (3, 2))   # (length, seed): co-scheduled mix
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


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def np_params():
    return _np(jbert.init_params(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def np_dparams():
    return _np(jbert.init_params(jax.random.PRNGKey(1), JDCFG))


@pytest.fixture(scope="module")
def params(np_params):
    return tbert.params_from_numpy(np_params, device="cpu")


@pytest.fixture(scope="module")
def dparams(np_dparams):
    return tbert.params_from_numpy(np_dparams, device="cpu")


def _submit_all(eng, temperature=0.0, top_k=0, max_new=10):
    hs = [eng.submit(prompt(n, s), max_new_tokens=max_new,
                     temperature=temperature, top_k=top_k, eos_id=None,
                     seed=s) for n, s in PROMPTS]
    return [h.result(timeout=120) for h in hs]


@pytest.fixture(scope="module")
def jax_plain(np_params):
    """The JAX engine's plain (speculative=None) streams of every engine
    configuration the parity cases below run, and the solo streams of the
    preemption case."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    runs = {"base": ({}, {}, 10), "int8": ({"kv_dtype": "int8"}, {}, 10),
            "fused": ({"block_size": 8, "paged_attention": "fused"}, {}, 10),
            "sampled": ({}, SAMPLED, 10), "long": ({}, {}, 16)}
    out = {}
    for name, (kw, sampling, max_new) in runs.items():
        with JaxEngine(jp, JCFG, slots=2, max_len=32, **kw) as eng:
            out[name] = _submit_all(eng, max_new=max_new, **sampling)
    with JaxEngine(jp, JCFG, slots=2, max_len=32, block_size=8) as eng:
        out["solo"] = [eng.generate(prompt(4, s), max_new_tokens=20,
                                    eos_id=None, timeout=120)
                       for s in (0, 1)]
    return out


def run_streams(params, engine_kwargs, temperature=0.0, top_k=0,
                max_new=10):
    with GenerationEngine(params, CFG, slots=2, max_len=32, device="cpu",
                          **engine_kwargs) as eng:
        return _submit_all(eng, temperature, top_k, max_new)


# ----------------------------------------------------------- the draft model

DSLOTS, DLEN = 3, 24
KEYS = np.stack([prng_key(s) for s in (0, 1, 2)])
TEMPS = np.array([0.0, 1.0, 0.0], np.float32)
TOP_KS = np.array([0, 8, 0], np.int32)


def test_draft_prefill_and_step_match_jax(np_dparams, dparams):
    """Two prompts draft-prefilled into rows 0 and 1 (row 2 cold), then
    draft steps at host lengths: forward, a rewind to a shorter length
    (the rejected tail overwritten), and lengths past the cache's end
    (clipped). Proposals equal, the cache to 1e-6."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_dparams)
    jcache = jbert.init_draft_kv_cache(JDCFG, DSLOTS, DLEN)
    tcache = tbert.init_draft_kv_cache(DCFG, DSLOTS, DLEN, device="cpu")
    assert "lengths" not in tcache
    jpre, jstep = jbert.make_draft_prefill(JDCFG), jbert.make_draft_step(
        JDCFG)
    tpre, tstep = tbert.make_draft_prefill(DCFG), tbert.make_draft_step(DCFG)
    for slot, n in ((0, 6), (1, 13)):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = prompt(n, 20 + slot)
        jcache = jpre(jp, jcache, jnp.asarray(padded), jnp.int32(slot))
        tpre(dparams, tcache, padded, slot)
    tokens = np.array([3, 4, 5], np.int32)
    for lengths in ([6, 13, 0], [7, 14, 1], [8, 15, 2], [7, 14, 1],
                    [23, 30, 24]):
        lengths = np.array(lengths, np.int32)
        steps = lengths + 1
        jcache, jprop = jstep(jp, jcache, jnp.asarray(tokens),
                              jnp.asarray(lengths), jnp.asarray(KEYS),
                              jnp.asarray(steps), jnp.asarray(TEMPS),
                              jnp.asarray(TOP_KS))
        _, tprop = tstep(dparams, tcache, tokens, lengths, KEYS, steps,
                         TEMPS, TOP_KS)
        np.testing.assert_array_equal(tprop.numpy(), np.asarray(jprop))
        tokens = np.asarray(jprop, np.int32)
    for lc, rc in zip(tcache["layers"], jcache["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(lc[name].numpy(), np.asarray(rc[name]),
                                       rtol=0, atol=1e-6)


def test_draft_cache_validation():
    for init, cfg in ((jbert.init_draft_kv_cache, JDCFG),
                      (tbert.init_draft_kv_cache, DCFG)):
        with pytest.raises(ValueError, match="draft model's positional"):
            init(cfg, 2, 65)
    noncausal = tbert.TransformerConfig(**dict(DWIDTHS, causal=False))
    for make in (tbert.make_draft_prefill, tbert.make_draft_step):
        with pytest.raises(ValueError, match="speculative drafting needs"):
            make(noncausal)


# ------------------------------------------------------------ the verify step

BLOCK, NB = 8, 14
VK = 3


def _verify_layout():
    """Slot 0: length 10, every write in its mapped blocks. Slot 1: all 4
    entries mapped, length 30 (writes at 32 and 33 pass the cache's
    capacity: scratch), and a copy-on-write pair 12 -> 7 into its table.
    Slot 2: 2 of 4 entries mapped (the on-demand edge: writes at 16 and 17
    land in scratch through the table's zeros), length 14. Slot 3: dead.
    A sample whose causal prefix reaches scratch is garbage (the duplicate
    scratch writes land in either package's order) and is never compared:
    the engine's commit cap never takes it."""
    tables = np.zeros((4, 4), np.int32)
    tables[0, :3] = [2, 4, 6]
    tables[1] = [1, 5, 7, 11]
    tables[2, :2] = [3, 9]
    lengths = np.array([10, 30, 14, 0], np.int32)
    cow_src = np.array([0, 12, 0, 0], np.int32)
    cow_dst = np.array([0, 7, 0, 0], np.int32)
    return tables, lengths, cow_src, cow_dst


# the samples whose causal prefix lies in mapped blocks, per slot
VALID = {0: VK + 1, 1: 2, 2: 2}
VTEMPS = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
VTOP_KS = np.array([0, 8, 0, 0], np.int32)
VSTEPS = np.array([4, 9, 2, 0], np.int32)


def _pools(kv_dtype, seed=3):
    """Random pool contents (the same numpy arrays for both packages)."""
    rng = np.random.default_rng(seed)
    shape = (NB, BLOCK, CFG.heads, CFG.head_dim)
    layers = []
    for _ in range(CFG.layers):
        if kv_dtype == "int8":
            layers.append({
                "k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.uniform(0.001, 0.02,
                                       shape[:3]).astype(np.float32),
                "v_scale": rng.uniform(0.001, 0.02,
                                       shape[:3]).astype(np.float32)})
        else:
            layers.append({n: rng.standard_normal(shape).astype(np.float32)
                           for n in ("k", "v")})
    return layers


@functools.lru_cache(maxsize=None)
def _jax_verify_fn(route, kv_dtype):
    """One jitted JAX verify step per (route, pool): compiled once."""
    return jbert.make_verify_step(JCFG, BLOCK, VK, kv_dtype=kv_dtype,
                                  paged_attention=route)


def _jax_verify(jp, route, kv_dtype, tokens):
    fn = _jax_verify_fn(route, kv_dtype)
    tables, lengths, cow_src, cow_dst = _verify_layout()
    cache = {"layers": [{n: jnp.asarray(a) for n, a in lc.items()}
                        for lc in _pools(kv_dtype)]}
    keys = np.stack([np.asarray(jax.random.PRNGKey(s), np.uint32)
                     for s in range(4)])
    cache, samples, accepted = fn(
        jp, cache, jnp.asarray(tables), jnp.asarray(lengths),
        jnp.asarray(tokens), jnp.asarray(keys), jnp.asarray(VSTEPS),
        jnp.asarray(VTEMPS), jnp.asarray(VTOP_KS), jnp.asarray(cow_src),
        jnp.asarray(cow_dst))
    return (np.asarray(samples), np.asarray(accepted),
            jax.tree_util.tree_map(np.asarray, cache))


def _torch_verify(params, route, kv_dtype, tokens):
    fn = tbert.make_verify_step(CFG, BLOCK, VK, kv_dtype=kv_dtype,
                                paged_attention=route)
    tables, lengths, cow_src, cow_dst = _verify_layout()
    cache = {"layers": [{n: torch.from_numpy(a.copy())
                         for n, a in lc.items()}
                        for lc in _pools(kv_dtype)]}
    keys = np.stack([prng_key(s) for s in range(4)])
    _, samples, accepted = fn(params, cache, tables, lengths, tokens, keys,
                              VSTEPS, VTEMPS, VTOP_KS, cow_src, cow_dst)
    return samples.numpy(), accepted.numpy(), cache


@pytest.mark.parametrize("route", ["gather", "fused"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_verify_step_matches_jax(np_params, params, route, kv_dtype):
    """Proposals built from the JAX samples so slot 0 accepts every one,
    slot 1 the first only and slot 2 none: the samples a commit could take
    (``VALID``) and ``accepted`` equal; the pool after the copy and the k+1
    writes equal outside the scratch block, which takes every routed
    write."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 50, (4, VK + 1)).astype(np.int32)
    for j in range(1, VK + 1):   # slot 0: each proposal the target's own
        samples, _, _ = _jax_verify(jp, route, kv_dtype, tokens)
        tokens[0, j] = samples[0, j - 1]
    samples, _, _ = _jax_verify(jp, route, kv_dtype, tokens)
    tokens[1, 1] = samples[1, 0]
    tokens[1, 2] = (samples[1, 1] + 1) % 50
    tokens[2, 1] = (samples[2, 0] + 1) % 50
    js, ja, jcache = _jax_verify(jp, route, kv_dtype, tokens)
    ts, ta, tcache = _torch_verify(params, route, kv_dtype, tokens)
    for slot, n in VALID.items():
        np.testing.assert_array_equal(ts[slot, :n], js[slot, :n])
    np.testing.assert_array_equal(ta[:3], ja[:3])
    assert list(ja[:3]) == [VK, 1, 0]
    pools = _pools(kv_dtype)
    for lc, rc, orig in zip(tcache["layers"], jcache["layers"], pools):
        for name in lc:
            got, want = lc[name].numpy()[1:], rc[name][1:]
            if got.dtype == np.int8:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                           err_msg=name)
        # the copy landed (block 7 is old block 12: slot 1 writes only
        # positions 30 and 31, in block 11), and slot 2's writes past its
        # mapped blocks left its blocks alone below its length
        np.testing.assert_array_equal(lc["k"].numpy()[7], orig["k"][12])
        np.testing.assert_array_equal(lc["k"].numpy()[9][:6],
                                      orig["k"][9][:6])
        np.testing.assert_array_equal(lc["k"].numpy()[3], orig["k"][3])


def test_verify_step_validation():
    with pytest.raises(ValueError, match="k >= 1"):
        tbert.make_verify_step(CFG, BLOCK, 0)
    with pytest.raises(ValueError, match="paged_attention must be"):
        tbert.make_verify_step(CFG, BLOCK, 2, paged_attention="x")
    with pytest.raises(ValueError, match="kv_dtype"):
        tbert.make_verify_step(CFG, BLOCK, 2, kv_dtype="int4")


# --------------------------------------- the engine: TestBitwiseParity


class TestBitwiseParity:
    def test_greedy_parity_every_k(self, params, dparams, jax_plain):
        for k in (1, 2, 4, 8):
            got = run_streams(params, {
                "speculative": SpecConfig(dparams, DCFG, k=k)})
            assert got == jax_plain["base"], f"k={k} diverged"

    def test_greedy_parity_int8_kv(self, params, dparams, jax_plain):
        for k in (1, 4):
            got = run_streams(params, {
                "kv_dtype": "int8",
                "speculative": SpecConfig(dparams, DCFG, k=k)})
            assert got == jax_plain["int8"], f"int8 k={k} diverged"

    def test_greedy_parity_fused_attention(self, params, dparams,
                                           jax_plain):
        got = run_streams(params, {
            "block_size": 8, "paged_attention": "fused",
            "speculative": SpecConfig(dparams, DCFG, k=2)})
        assert got == jax_plain["fused"]

    def test_sampled_parity(self, params, dparams, jax_plain):
        """The verify step emits the target's own gumbel-max draws, so
        sampled streams are the plain ones too."""
        got = run_streams(params,
                          {"speculative": SpecConfig(dparams, DCFG, k=3)},
                          temperature=1.0, top_k=8)
        assert got == jax_plain["sampled"]

    def test_parity_under_preemption_resume(self, params, dparams,
                                            jax_plain):
        """A tight on-demand pool evicts mid-stream while speculating; the
        resumed streams (recompute through the prefill, which warms the
        draft again) are their solo runs."""
        with GenerationEngine(params, CFG, slots=2, max_len=32,
                              block_size=8, num_blocks=5,
                              allocate="on_demand", queue_capacity=8,
                              speculative=SpecConfig(dparams, DCFG, k=4),
                              device="cpu") as eng:
            hs = [eng.submit(prompt(4, s), max_new_tokens=20, eos_id=None)
                  for s in (0, 1)]
            got = [h.result(timeout=120) for h in hs]
            assert eng.metrics.preemptions_total.value >= 1
        assert got == jax_plain["solo"]


def test_spec_config_validation(params, dparams):
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpecConfig(dparams, DCFG, k=0)
    with pytest.raises(ValueError, match="paged"):
        GenerationEngine(params, CFG, slots=2, max_len=32, paged=False,
                         speculative=SpecConfig(dparams, DCFG),
                         device="cpu")
    small = tbert.TransformerConfig(**dict(DWIDTHS, max_seq=16),
                                    dtype=torch.float32)
    with pytest.raises(ValueError, match="max_seq"):
        GenerationEngine(params, CFG, slots=2, max_len=32,
                         speculative=SpecConfig(dparams, small),
                         device="cpu")
    other = tbert.TransformerConfig(**dict(DWIDTHS, vocab_size=51),
                                    dtype=torch.float32)
    with pytest.raises(ValueError, match="vocab"):
        GenerationEngine(params, CFG, slots=2, max_len=32,
                         speculative=SpecConfig(dparams, other),
                         device="cpu")


def test_non_causal_draft_rejected(params, dparams):
    bidir = tbert.TransformerConfig(**dict(DWIDTHS, causal=False),
                                    dtype=torch.float32)
    with pytest.raises(ValueError, match="draft model must be causal"):
        GenerationEngine(params, CFG, slots=2, max_len=32,
                         speculative=SpecConfig(dparams, bidir),
                         device="cpu")


# ------------------------------------------- the engine: TestAcceptance


class TestAcceptance:
    def test_self_draft_accepts_everything(self, params, jax_plain):
        """Draft == target: every turn commits k tokens, acceptance 1.0."""
        with GenerationEngine(params, CFG, slots=2, max_len=32,
                              speculative=SpecConfig(params, CFG, k=4),
                              device="cpu") as eng:
            base = eng.generate(prompt(5, 0), max_new_tokens=12,
                                eos_id=None, timeout=120)
            snap = eng.metrics.snapshot()
        assert len(base) == 12
        assert base == jax_plain["base"][0][:10] + base[10:]
        assert snap["spec_tokens_proposed"] > 0
        assert snap["spec_acceptance_rate"] == pytest.approx(1.0)
        assert snap["decode_steps_total"] < 12

    def test_acceptance_surfaces_per_tenant(self, params, dparams):
        with GenerationEngine(params, CFG, slots=2, max_len=32,
                              speculative=SpecConfig(dparams, DCFG, k=4),
                              device="cpu") as eng:
            eng.generate(prompt(5, 0), max_new_tokens=8, eos_id=None,
                         timeout=120)
            snap = eng.metrics.snapshot()
        assert snap["spec_tokens_proposed"] >= 4
        spec = snap["spec"]
        assert spec["tenants"], "per-tenant acceptance missing"
        for row in spec["tenants"].values():
            assert 0.0 <= row["acceptance_rate"] <= 1.0
            assert row["proposed"] >= row["accepted"]

    def test_governor_demotes_low_acceptance_tenant(self):
        """The port's governor against the reference's, record by
        record."""
        for cls in (SpecAcceptanceGovernor, JaxGovernor):
            gov = cls(min_acceptance=0.5, min_proposed=8)
            assert not gov.demoted("t")
            gov.record("t", 4, 4)          # below the observation floor
            assert not gov.demoted("t")
            gov.record("t", 8, 0)          # 12 proposed, 4 accepted: 0.33
            assert gov.demoted("t")
            assert gov.snapshot()["t"]["demoted"]
            gov.record("ok", 100, 90)
            assert not gov.demoted("ok")
            assert gov.acceptance_rate("ok") == pytest.approx(0.9)
            off = cls(min_acceptance=0.0)
            off.record("t", 1000, 0)
            assert not off.demoted("t")
        with pytest.raises(ValueError, match="min_proposed"):
            SpecAcceptanceGovernor(min_proposed=0)

    def test_engine_demotes_to_plain_turns(self, params, dparams,
                                           jax_plain):
        got = run_streams(params, {
            "speculative": SpecConfig(dparams, DCFG, k=4,
                                      min_acceptance=0.99,
                                      min_proposed=8)}, max_new=16)
        assert got == jax_plain["long"]


# ------------------------------------------------------ the degrade contract


def test_failing_draft_degrades_to_plain(params, dparams, jax_plain):
    """A draft step that raises costs no stream: every turn falls back to
    the plain decode step, ``spec_fallbacks_total`` counts it, and the
    streams are the plain ones."""
    calls = []

    def broken(*args):
        calls.append(1)
        raise RuntimeError("draft failed")

    with GenerationEngine(params, CFG, slots=2, max_len=32,
                          speculative=SpecConfig(dparams, DCFG, k=3),
                          device="cpu") as eng:
        eng._draft_step = broken
        got = _submit_all(eng)
        fallbacks = eng.metrics.spec_fallbacks_total.value
        failed = eng.metrics.failed_total.value
    assert got == jax_plain["base"]
    assert calls and fallbacks >= len(calls)
    assert failed == 0


def test_speculative_warmup_runs_every_path(params, dparams):
    """warmup probes the rungs (draft prefill, draft step, verify) and the
    plain fallback; the engine then serves the plain streams."""
    with GenerationEngine(params, CFG, slots=2, max_len=32,
                          speculative=SpecConfig(dparams, DCFG, k=2),
                          device="cpu") as eng:
        eng.warmup()
        steps = eng.metrics.decode_steps_total.value
        assert steps > 0 and eng.metrics.spec_tokens_proposed.value > 0
        got = _submit_all(eng)
    with GenerationEngine(params, CFG, slots=2, max_len=32,
                          device="cpu") as eng:
        assert got == _submit_all(eng)
