"""The PyTorch port's paged-KV block lifecycle (deeplearning4j_tpu_torch/
serving: ``paging.py`` and ``generation.py``) against the JAX package's,
on the CPU.

- The host bookkeeping — ``BlockAllocator.free_batch``,
  ``RadixPrefixIndex``, ``PrefixCache``, ``BlockSwapStore`` — is driven by
  the same seeded operation sequences as the reference classes and must
  give the same results at every step.
- Engines: the port runs on ``device="cpu"`` with the JAX engine's
  weights (``params_from_numpy``) at the reference tests' tiny fp32
  config (``tests/test_paged_kv.py``). Shared-prefix streams (mid-block
  and block-aligned prefixes, with and without copy-on-write), on-demand
  streams, preempted greedy and sampled streams (resumed by recompute, by
  the decode feed or by swap-in) and prefix-cache hits are token-equal to
  the JAX engine's streams; prefix-prefill, hit, copy-on-write and
  preemption counts equal the JAX engine's where both schedule
  deterministically (every stream queued before the first is seated).

The tolerance is token-for-token equality.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import TransformerConfig as JaxConfig
from deeplearning4j_tpu.models import init_params as jax_init_params
from deeplearning4j_tpu.serving import BlockAllocator as JaxAllocator
from deeplearning4j_tpu.serving import BlockSwapStore as JaxSwapStore
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving import PrefixCache as JaxPrefixCache
from deeplearning4j_tpu.serving import SwapEntry as JaxSwapEntry
from deeplearning4j_tpu.serving.paging import (
    RadixPrefixIndex as JaxRadix)
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)
from deeplearning4j_tpu_torch.serving import (
    REJECTION_REASONS, BlockAllocator, BlockSwapStore, GenerationEngine,
    KVBlocksExhaustedError, PreemptedError, PrefixCache, RadixPrefixIndex,
    SwapEntry)

WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")
TCFG = TransformerConfig(**WIDTHS, dtype=torch.float32,
                         attention_impl="full")
# the preemption scenario of the reference tests: two 4-token prompts of
# 20 new tokens (3 blocks each at worst) in a pool of 4 usable blocks
TIGHT = dict(slots=2, max_len=32, block_size=8, num_blocks=5,
             allocate="on_demand", queue_capacity=8)
SWAP = dict(swap_threshold_blocks=0, swap_capacity_blocks=64)
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
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


@pytest.fixture(scope="module")
def tparams(np_params):
    return params_from_numpy(np_params, device="cpu")


def serve(eng, specs, timeout=120):
    """Submit every ``(prompt, kwargs)`` while the scheduler is parked in
    the first stream's first token, so the JAX engine and the port seat
    them in the same order; returns the handles."""
    gate = threading.Event()
    fired = []

    def hold(_tok):
        if not fired:
            fired.append(1)
            gate.wait(timeout)

    handles = []
    try:
        for k, (p, kw) in enumerate(specs):
            handles.append(eng.submit(p, on_token=hold if k == 0 else None,
                                      **kw))
    finally:
        gate.set()
    return handles


def results(handles, timeout=120):
    return [h.result(timeout=timeout) for h in handles]


def preempt_specs(sample_kw=None):
    kw = dict(max_new_tokens=20, eos_id=None, **(sample_kw or {}))
    return [(prompt(4, s), dict(kw, seed=s)) for s in (0, 1)]


def class_specs():
    """A batch-class stream seated first, then an interactive one."""
    kw = dict(max_new_tokens=20, eos_id=None)
    return [(prompt(4, 1), dict(kw, priority="batch")),
            (prompt(4, 0), dict(kw, priority="interactive"))]


def run_tight(engine_cls, params, cfg, specs, **kw):
    """``specs`` on the tight on-demand pool: the streams, the preemptions
    (in all and per stream), prefills, TTFT observations and the swap
    counters."""
    with engine_cls(params, cfg, **TIGHT, **kw) as eng:
        hs = serve(eng, specs)
        streams = results(hs)
        m = eng.metrics
        return {
            "streams": streams,
            "preemptions": int(m.preemptions_total.value),
            "per_stream": [h._req.x.preemptions for h in hs],
            "prefills": int(m.prefills_total.value),
            "ttft": m.ttft_ms.count,
            "swapped_blocks": int(m.kv_swapped_blocks.value),
            "bytes": (int(m.kv_swap_bytes_out.value),
                      int(m.kv_swap_bytes_in.value)),
            "held": int(m.kv_swapped_blocks_held.value),
            "store": eng._swap_store,
        }


@pytest.fixture(scope="module")
def jax_params(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


@pytest.fixture(scope="module")
def jax_tight(jax_params):
    """The JAX engine's runs of the tight-pool scenarios (one engine
    config, so one set of compiles)."""
    out = {}
    for name, specs in (("greedy", preempt_specs()),
                        ("sampled", preempt_specs(SAMPLED)),
                        ("classes", class_specs())):
        out[name] = run_tight(JaxEngine, jax_params, JCFG, specs)
    return out


@pytest.fixture(scope="module")
def jax_oracle(jax_params):
    """Unpressured JAX streams: each spec served alone on a reserve pool
    large enough that nothing waits (one engine, one set of compiles)."""
    def solo(eng, specs):
        return [eng.generate(p, timeout=120, **kw) for p, kw in specs]

    sysp = prompt(17, seed=7)
    cache_prompts = [np.concatenate([sysp, prompt(3, s)]).astype(np.int32)
                     for s in (1, 2, 3)]
    with JaxEngine(jax_params, JCFG, slots=4, max_len=48,
                   block_size=8) as eng:
        out = {"greedy": solo(eng, preempt_specs()),
               "sampled": solo(eng, preempt_specs(SAMPLED)),
               "classes": solo(eng, class_specs()),
               "cache": [eng.generate(p, max_new_tokens=5, seed=s,
                                      timeout=120, **SAMPLED)
                         for s, p in enumerate(cache_prompts)],
               "cache_greedy": [eng.generate(p, max_new_tokens=5,
                                             timeout=120)
                                for p in cache_prompts]}
        prefix = {}
        for name, pre in (("mid", prompt(10, seed=40)),
                          ("aligned", prompt(8, seed=41))):
            sfx = [prompt(3, seed=60 + i) for i in range(4)]
            m = eng.metrics
            base = {k: getattr(m, k).value for k in (
                "prefix_prefills_total", "prefills_total",
                "prefix_hits_total", "kv_cow_copies_total")}
            ttft0 = m.ttft_ms.count
            pid = eng.register_prefix(pre)
            hs = [eng.submit(s, prefix_id=pid, max_new_tokens=5)
                  for s in sfx]
            streams = results(hs)
            assert eng.release_prefix(pid)
            counts = {k: getattr(m, k).value - v for k, v in base.items()}
            counts["ttft"] = m.ttft_ms.count - ttft0
            prefix[name] = (pre, sfx, streams, counts)
        out["prefix"] = prefix
    return out


def port(tparams, **kw):
    return GenerationEngine(tparams, TCFG, device="cpu", **kw)


# ---------------------------------------------------------------------------
# host bookkeeping, held step by step against the reference classes
# ---------------------------------------------------------------------------
def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:   # both sides must fail alike
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_free_batch_follows_the_reference(seed):
    rng = np.random.default_rng(seed)
    ref, got = JaxAllocator(17), BlockAllocator(17)
    held = []
    for _ in range(200):
        op = rng.integers(5)
        if op == 0:
            n = int(rng.integers(0, 6))
            a, b = _outcome(ref.alloc, n), _outcome(got.alloc, n)
            assert (a[0], a[1] if a[0] == "ok" else None) == \
                (b[0], b[1] if b[0] == "ok" else None)
            if a[0] == "ok":
                held.append(a[1])
            else:
                assert a[1] == "KVBlocksExhaustedError" == b[1]
        elif op == 1 and held:
            blk = held[int(rng.integers(len(held)))]
            assert _outcome(ref.incref, blk) == _outcome(got.incref, blk)
        elif op == 2 and held:
            lists = [held.pop(int(rng.integers(len(held))))
                     for _ in range(min(len(held), int(rng.integers(1, 4))))]
            if rng.random() < 0.2:
                lists.append(lists[0])     # a double free across the batch
            assert _outcome(ref.free_batch, lists) \
                == _outcome(got.free_batch, lists)
        elif op == 3 and held:
            blk = held.pop(int(rng.integers(len(held))))
            assert _outcome(ref.free, blk) == _outcome(got.free, blk)
        elif op == 4:
            bad = [int(rng.integers(1, 17))]
            assert _outcome(ref.incref, bad)[0] == _outcome(got.incref,
                                                            bad)[0]
        assert ref.free_count == got.free_count
        assert [ref.refcount(b) for b in range(17)] == \
            [got.refcount(b) for b in range(17)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_index_follows_the_reference(seed):
    rng = np.random.default_rng(seed)
    ref, got = JaxRadix(), RadixPrefixIndex()
    live = []
    for step in range(300):
        path = tuple(int(k) for k in rng.integers(0, 3, rng.integers(1, 6)))
        op = rng.integers(3)
        if op == 0:
            ref.insert(path, step)
            got.insert(path, step)
            live.append((path, step))
        elif op == 1 and live:
            p, v = live.pop(int(rng.integers(len(live))))
            ref.remove(p, v)
            got.remove(p, v)
        d0, v0 = ref.match(path)
        d1, v1 = got.match(path)
        assert (d0, sorted(v0)) == (d1, sorted(v1))
        assert ref.node_count() == got.node_count()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_follows_the_reference(seed):
    rng = np.random.default_rng(seed)
    B = 4
    ra, ga = JaxAllocator(33), BlockAllocator(33)
    ref = JaxPrefixCache(ra, B, capacity_blocks=8)
    got = PrefixCache(ga, B, capacity_blocks=8)

    def toks():
        # few distinct leading blocks, so prefixes are shared
        m = int(rng.integers(1, 5))
        return np.concatenate([rng.integers(0, 2, B) + 10 * k
                               for k in range(m)]).astype(np.int32)

    for _ in range(150):
        op = rng.integers(5)
        if op == 0:
            t = toks()
            m = len(t) // B
            if ra.free_count < m:
                continue
            assert ref.insert(t, ra.alloc(m)) == got.insert(t, ga.alloc(m))
        elif op in (1, 2):
            q = np.concatenate([toks(), [7]]).astype(np.int32)
            if op == 1:
                a, b = ref.match(q), got.match(q)
                assert (a is None) == (b is None)
                if a is not None:
                    assert a[1] == b[1]
                    assert a[0].blocks == b[0].blocks
                    np.testing.assert_array_equal(a[0].tokens, b[0].tokens)
            else:
                a, b = ref.match_and_ref(q), got.match_and_ref(q)
                assert (a is None) == (b is None)
                if a is not None:
                    assert a[1:] == b[1:]
                    ra.free(a[2])
                    ga.free(b[2])
        elif op == 3:
            n = int(rng.integers(1, 4))
            assert ref.evict(n) == got.evict(n)
        elif op == 4 and rng.random() < 0.2:
            ref.release_all()
            got.release_all()
        assert len(ref) == len(got)
        assert ref.total_blocks == got.total_blocks
        assert (ref.hits, ref.inserts, ref.evictions) == \
            (got.hits, got.inserts, got.evictions)
        assert ra.free_count == ga.free_count
        assert [ra.refcount(b) for b in range(33)] == \
            [ga.refcount(b) for b in range(33)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swap_store_follows_the_reference(seed):
    rng = np.random.default_rng(seed)
    ref, got = JaxSwapStore(10), BlockSwapStore(10)
    keys = []
    for _ in range(150):
        op = rng.integers(4)
        if op == 0:
            used, nbytes = int(rng.integers(1, 13)), int(rng.integers(1, 99))
            common = dict(payload=[], used_blocks=used, length=3,
                          n_generated=2, last_token=1, prefix_len=0,
                          nbytes=nbytes)
            k0 = ref.put(JaxSwapEntry(epoch=0, **common))
            k1 = got.put(SwapEntry(**common))
            assert k0 == k1
            if k0 is not None:
                keys.append(k0)
        elif op == 1:
            k = keys[int(rng.integers(len(keys)))] if keys \
                and rng.random() < 0.8 else None
            a, b = ref.take(k), got.take(k)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.used_blocks, a.nbytes) == (b.used_blocks, b.nbytes)
        elif op == 2 and keys:
            k = keys[int(rng.integers(len(keys)))]
            ref.discard(k)
            got.discard(k)
        elif op == 3 and rng.random() < 0.1:
            ref.invalidate()
            got.invalidate()
        assert (len(ref), ref.blocks_held, ref.bytes_held) == \
            (len(got), got.blocks_held, got.bytes_held)
        assert (ref.swap_outs, ref.swap_ins, ref.evictions) == \
            (got.swap_outs, got.swap_ins, got.evictions)
    with pytest.raises(ValueError, match="positive"):
        BlockSwapStore(0)


def test_preempted_reason_registered_exactly_once():
    assert REJECTION_REASONS.count("preempted") == 1
    assert PreemptedError("x", tokens_generated=3).reason == "preempted"


# ---------------------------------------------------------------------------
# shared prefixes: one prefill, copy-on-write on a mid-block tail
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["gather", "fused"])
@pytest.mark.parametrize("which", ["mid", "aligned"])
def test_shared_prefix_streams_match_jax(tparams, jax_oracle, which, route):
    """Four streams naming one prefix: exactly one prefix prefill, no
    stream prefill, four hits and — for the 10-token prefix that ends
    mid-block — four copy-on-write copies (none for the 8-token one),
    tokens equal to the JAX engine's prefix streams."""
    pre, sfx, want, want_counts = jax_oracle["prefix"][which]
    with port(tparams, slots=4, max_len=32, block_size=8,
              paged_attention=route) as eng:
        # the plain submit of prefix + suffix, then the prefix streams
        plain = [eng.generate(np.concatenate([pre, s]), max_new_tokens=5,
                              timeout=120) for s in sfx]
        m = eng.metrics
        base = {k: getattr(m, k).value for k in want_counts if k != "ttft"}
        ttft0 = m.ttft_ms.count
        pid = eng.register_prefix(pre)
        got = results([eng.submit(s, prefix_id=pid, max_new_tokens=5)
                       for s in sfx])
        assert eng.release_prefix(pid)
        counts = {k: getattr(m, k).value - v for k, v in base.items()}
        counts["ttft"] = m.ttft_ms.count - ttft0
        assert eng._allocator.in_use == 0
    assert got == want == plain
    assert counts == want_counts
    assert counts["prefix_prefills_total"] == 1
    assert counts["prefills_total"] == 0
    assert counts["prefix_hits_total"] == 4
    assert counts["kv_cow_copies_total"] == (4 if which == "mid" else 0)


def test_release_prefix_returns_pins_and_unknown_ids_raise(tparams):
    with port(tparams, slots=2, max_len=32, block_size=8) as eng:
        cap = eng._allocator.capacity
        pid = eng.register_prefix(prompt(10, seed=43))
        assert eng._allocator.free_count == cap - 2
        assert eng.metrics.kv_blocks_pinned.value == 2
        assert eng.release_prefix(pid)
        assert eng._allocator.free_count == cap
        assert not eng.release_prefix(pid)
        with pytest.raises(KeyError, match="not registered"):
            eng.submit(prompt(2), prefix_id=pid)


# ---------------------------------------------------------------------------
# on-demand allocation, preemption, recompute-on-resume
# ---------------------------------------------------------------------------
def test_on_demand_equals_reserve_and_seats_prompt_blocks_only(
        tparams, jax_oracle):
    with port(tparams, slots=2, max_len=32, block_size=8) as eng:
        want = eng.generate(prompt(4, 0), max_new_tokens=20, eos_id=None,
                            seed=0, timeout=120)
    with port(tparams, slots=2, max_len=32, block_size=8,
              allocate="on_demand", num_blocks=5) as eng:
        got = eng.generate(prompt(4, 0), max_new_tokens=20, eos_id=None,
                           seed=0, timeout=120)
        assert eng._fresh_blocks_needed(0, 4, 24) == 4
        assert eng._fresh_blocks_needed(0, 4, 24, admit=True) == 1
    assert got == want == jax_oracle["greedy"][0]
    # the worst case still gates structurally: 4 blocks > 2 usable
    with port(tparams, slots=2, max_len=32, block_size=8, num_blocks=3,
              allocate="on_demand") as eng:
        with pytest.raises(KVBlocksExhaustedError) as ei:
            eng.submit(prompt(4), max_new_tokens=24)
        assert ei.value.reason == "kv_blocks_exhausted"
    with pytest.raises(ValueError, match="allocate must be"):
        port(tparams, slots=2, max_len=32, allocate="lazy")


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("route", ["gather", "fused"])
def test_preempted_streams_match_jax(tparams, jax_tight, jax_oracle, mode,
                                     route):
    """The tight pool forces evictions mid-stream: every stream equals its
    unpressured JAX run, the preemptions (per stream too) equal the JAX
    engine's in the same scenario, and TTFT is counted once per stream."""
    specs = preempt_specs(SAMPLED if mode == "sampled" else None)
    got = run_tight(GenerationEngine, tparams, TCFG, specs, device="cpu",
                    paged_attention=route)
    want = jax_tight[mode]
    assert got["streams"] == jax_oracle[mode] == want["streams"]
    assert got["preemptions"] >= 1
    assert (got["preemptions"], got["per_stream"], got["prefills"]) == \
        (want["preemptions"], want["per_stream"], want["prefills"])
    assert got["ttft"] == want["ttft"] == 2


def test_resume_through_feed_path_when_prompt_outgrows_ladder(
        tparams, jax_oracle):
    """With one 8-token bucket the recompute prompt (4 + generated) does
    not fit the prefill ladder: the victim rebuilds its K/V through the
    decode-feed seat, token-equal all the same."""
    got = run_tight(GenerationEngine, tparams, TCFG, preempt_specs(),
                    device="cpu", buckets=(8,))
    assert got["preemptions"] >= 1
    assert got["streams"] == jax_oracle["greedy"]
    assert got["ttft"] == 2


def test_victims_by_class_batch_first(tparams, jax_tight, jax_oracle):
    """The batch stream is evicted for the interactive one's boundary
    crossing and never the other way round; both equal their unpressured
    runs, and the per-stream evictions equal the JAX engine's."""
    got = run_tight(GenerationEngine, tparams, TCFG, class_specs(),
                    device="cpu")
    want = jax_tight["classes"]
    assert got["streams"] == jax_oracle["classes"] == want["streams"]
    assert got["per_stream"] == want["per_stream"]
    batch, interactive = got["per_stream"]
    assert interactive == 0 and batch >= 1


def test_batch_never_evicts_interactive(tparams):
    """Interactive seated first: the batch stream's crossings preempt the
    batch stream itself."""
    specs = class_specs()[::-1]
    got = run_tight(GenerationEngine, tparams, TCFG, specs, device="cpu")
    interactive, batch = got["per_stream"]
    assert interactive == 0 and batch >= 1


def test_unresumable_victim_sheds_typed_preempted(tparams):
    """A prefix pinned under a running stream leaves the pool too small
    for the stream's worst case: its resume is impossible and its
    terminal is typed 'preempted'."""
    with port(tparams, slots=2, max_len=64, block_size=8, num_blocks=9,
              allocate="on_demand", queue_capacity=8) as eng:
        h = eng.submit(prompt(4), max_new_tokens=28, eos_id=None)
        deadline = time.time() + 60
        while len(h.tokens_so_far()) < 2:
            assert time.time() < deadline
            time.sleep(0.001)
        eng.register_prefix(prompt(40, seed=9), timeout=60.0)
        with pytest.raises(PreemptedError) as ei:
            h.result(timeout=120)
        assert ei.value.reason == "preempted"
        assert ei.value.tokens_generated >= 1
        assert eng.metrics.rejections_by_reason.get("preempted") == 1


# ---------------------------------------------------------------------------
# swap to host
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_swap_resume_needs_no_prefill(tparams, jax_oracle, mode):
    """Victims park their blocks in host memory and re-seat by copying
    them back: streams equal the unpressured JAX runs, one prefill per
    stream, every byte out comes back in, the store ends empty."""
    specs = preempt_specs(SAMPLED if mode == "sampled" else None)
    got = run_tight(GenerationEngine, tparams, TCFG, specs, device="cpu",
                    **SWAP)
    assert got["streams"] == jax_oracle[mode]
    assert got["preemptions"] >= 1 and got["swapped_blocks"] >= 1
    assert got["bytes"][0] > 0 and got["bytes"][0] == got["bytes"][1]
    assert got["prefills"] == 2
    assert got["held"] == 0


def test_threshold_none_builds_no_store(tparams, jax_oracle):
    got = run_tight(GenerationEngine, tparams, TCFG, preempt_specs(),
                    device="cpu")
    assert got["store"] is None
    assert got["streams"] == jax_oracle["greedy"]
    assert got["swapped_blocks"] == 0 and got["prefills"] >= 3
    above = run_tight(GenerationEngine, tparams, TCFG, preempt_specs(),
                      device="cpu", swap_threshold_blocks=16,
                      swap_capacity_blocks=64)
    assert above["streams"] == jax_oracle["greedy"]
    assert above["preemptions"] >= 1 and above["swapped_blocks"] == 0
    with pytest.raises(ValueError, match="requires swap_threshold"):
        port(tparams, slots=2, max_len=32, swap_capacity_blocks=8)


def test_shared_prefix_victim_never_swaps(tparams):
    """A victim holding shared prefix blocks resumes by recompute: its
    re-seat demand carries the shared-block discount."""
    sysp = prompt(8, seed=9)

    def run(**kw):
        with port(tparams, slots=2, max_len=48, block_size=8, num_blocks=7,
                  allocate="on_demand", queue_capacity=8, **kw) as eng:
            eng.register_prefix(sysp, prefix_id="sys", timeout=60.0)
            hv = eng.submit(prompt(4, 1), max_new_tokens=20, eos_id=None,
                            priority="batch", prefix_id="sys")
            ha = eng.submit(prompt(4, 0), max_new_tokens=20, eos_id=None)
            v = hv.result(timeout=120)
            ha.result(timeout=120)
            return v, (int(eng.metrics.preemptions_total.value),
                       int(eng.metrics.kv_swapped_blocks.value))

    v_swap, (npre, nswap) = run(**SWAP)
    v_plain, _ = run()
    assert v_swap == v_plain
    assert npre >= 1 and nswap == 0


# ---------------------------------------------------------------------------
# the automatic prefix cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["gather", "fused"])
def test_shared_system_prompt_hits_without_opt_in(tparams, jax_oracle,
                                                  route):
    sysp = prompt(17, seed=7)          # 2 full blocks and a partial tail
    ps = [np.concatenate([sysp, prompt(3, s)]).astype(np.int32)
          for s in (1, 2, 3)]
    with port(tparams, slots=2, max_len=48, block_size=8,
              prefix_cache_blocks=16, paged_attention=route) as eng:
        greedy = [eng.generate(p, max_new_tokens=5, timeout=120)
                  for p in ps]
        m = eng.metrics
        assert m.prefix_cache_hits_total.value == 2
        assert m.prefix_cache_inserts_total.value >= 1
        assert m.prefills_total.value == 1   # the hits skipped their prefill
        sampled = [eng.generate(p, max_new_tokens=5, seed=s, timeout=120,
                                **SAMPLED) for s, p in enumerate(ps)]
        assert m.prefix_cache_hits_total.value == 5
    assert greedy == jax_oracle["cache_greedy"]
    assert sampled == jax_oracle["cache"]


def test_lru_bound_eviction_and_drain_release(tparams):
    with port(tparams, slots=2, max_len=32, block_size=8,
              prefix_cache_blocks=3) as eng:
        for s in range(6):             # distinct prompts, no reuse
            eng.generate(prompt(9, seed=s + 20), max_new_tokens=4,
                         timeout=120)
        assert eng._prefix_cache.total_blocks <= 3
        assert eng.metrics.prefix_cache_evictions_total.value >= 1
        assert eng.metrics.prefix_cache_blocks.value <= 3
        assert eng._prefix_cache.total_blocks >= 1
        assert eng.drain(timeout=60.0)
        assert eng._allocator.free_count == eng._allocator.capacity
        assert eng.metrics.prefix_cache_blocks.value == 0
        with pytest.raises(Exception, match="draining"):
            eng.submit(prompt(3))


def test_cached_blocks_reclaimed_on_demand_not_gating(tparams):
    """A full cache never blocks admission: its entries evict when a seat
    needs the blocks."""
    with port(tparams, slots=1, max_len=32, block_size=8, num_blocks=5,
              prefix_cache_blocks=4, queue_capacity=8) as eng:
        eng.generate(prompt(9, seed=1), max_new_tokens=4, timeout=120)
        assert eng._prefix_cache.total_blocks >= 1
        assert eng.generate(prompt(4, seed=2), max_new_tokens=26,
                            eos_id=None, timeout=120)
        assert eng.metrics.prefix_cache_evictions_total.value >= 1


def test_timed_out_drain_releases_cache_keeps_pins(tparams):
    sysp = prompt(17, seed=7)
    p1 = np.concatenate([sysp, prompt(3, 1)]).astype(np.int32)
    with port(tparams, slots=2, max_len=64, block_size=8,
              prefix_cache_blocks=6, queue_capacity=8) as eng:
        eng.generate(p1, max_new_tokens=4, timeout=120)
        assert eng.metrics.prefix_cache_blocks.value > 0
        eng.register_prefix(prompt(8, seed=5), prefix_id="pin",
                            timeout=60.0)
        gate = threading.Event()
        h = eng.submit(prompt(4, 2), max_new_tokens=40, eos_id=None,
                       on_token=lambda _t: gate.wait(30))
        try:
            assert eng.drain(timeout=0.05) is False
            assert eng.metrics.prefix_cache_blocks.value == 0
            assert eng.metrics.prefix_cache_evictions_total.value >= 1
            assert "pin" in eng._prefixes
        finally:
            gate.set()
        h.result(timeout=120)
        assert eng.drain(timeout=60.0)
        assert "pin" not in eng._prefixes
        assert eng._allocator.free_count == eng._allocator.capacity


def test_unit_match_is_block_granular_and_lru():
    a = BlockAllocator(17)
    c = PrefixCache(a, 4, capacity_blocks=8)
    t1 = np.arange(8, dtype=np.int32)
    assert c.insert(t1, a.alloc(2))
    # a match keeps at least one token to feed: (len - 1) // B blocks
    assert c.match(np.arange(8, dtype=np.int32))[1] == 1
    assert c.match(np.arange(12, dtype=np.int32))[1] == 2
    assert c.match(np.arange(3, dtype=np.int32)) is None
    miss = np.concatenate([[9, 9, 9, 9], np.arange(4)]).astype(np.int32)
    assert c.match(miss) is None       # a prefix, not a substring
    free_before = a.free_count
    assert not c.insert(t1[:4], a.alloc(1))   # covered: refs come back
    assert a.free_count == free_before


def test_match_and_ref_survives_concurrent_release():
    """The match->seat handoff owns its references: a release_all between
    match and seat cannot free the matched blocks."""
    a = BlockAllocator(17)
    c = PrefixCache(a, 4, capacity_blocks=8)
    assert c.insert(np.arange(8, dtype=np.int32), a.alloc(2))
    _e, m, owned = c.match_and_ref(np.arange(12, dtype=np.int32))
    assert m == 2 and all(a.refcount(b) == 2 for b in owned)
    c.release_all()
    assert all(a.refcount(b) == 1 for b in owned)
    grabbed = a.alloc(a.free_count)
    assert not set(owned) & set(grabbed)
    a.free(grabbed)
    a.free(owned)
    assert a.free_count == a.capacity


def test_prefix_validation_and_pool_overcommit(tparams):
    with port(tparams, slots=2, max_len=32, block_size=8,
              num_blocks=7) as eng:
        with pytest.raises(ValueError, match="at least one token"):
            eng.register_prefix(np.zeros(0, np.int32))
        with pytest.raises(KeyError, match="not registered"):
            eng.submit(prompt(2), prefix_id="nope")
        eng.register_prefix(prompt(20, seed=47), prefix_id="big")
        with pytest.raises(ValueError, match="exceeds the cache capacity"):
            eng.submit(prompt(8), prefix_id="big", max_new_tokens=8)
        # 3 blocks pinned of 6: a second 4-block prefix can never be
        # pinned too, and fails typed at registration
        with pytest.raises(KVBlocksExhaustedError):
            eng.register_prefix(prompt(25, seed=52))
        assert eng.release_prefix("big")


def test_prefix_survives_cache_rebuild_via_lazy_reprefill(tparams,
                                                         tmp_path):
    """A failed decode step rebuilds the pool and drops the pinned K/V;
    the registration survives and the next stream naming it re-prefills
    it, token-equal to before. The failure's crash dump goes to
    ``tmp_path``."""
    from deeplearning4j_tpu_torch.util import crash_reporting as tc

    tc.crashDumpOutputDirectory(str(tmp_path))
    try:
        _lazy_reprefill(tparams)
    finally:
        tc.crashDumpOutputDirectory(None)


def _lazy_reprefill(tparams):
    pre, suf = prompt(10, seed=44), prompt(3, seed=45)
    with port(tparams, slots=2, max_len=32, block_size=8) as eng:
        ref = eng.generate(np.concatenate([pre, suf]), max_new_tokens=4,
                           timeout=120)
        pid = eng.register_prefix(pre)
        assert eng.generate(suf, prefix_id=pid, max_new_tokens=4,
                            timeout=120) == ref
        real_decode = eng._decode

        def boom(*a, **kw):
            raise RuntimeError("injected decode failure")

        gate = threading.Event()
        victim = eng.submit(prompt(4, seed=46), max_new_tokens=8,
                            on_token=lambda _t: gate.wait(30))
        eng._decode = boom
        gate.set()
        with pytest.raises(RuntimeError, match="injected"):
            victim.result(timeout=30)
        eng._decode = real_decode
        deadline = time.time() + 30
        while eng._prefixes[pid].ready:
            assert time.time() < deadline, "prefix never invalidated"
            time.sleep(0.001)
        assert eng.generate(suf, prefix_id=pid, max_new_tokens=4,
                            timeout=120) == ref
        assert eng.metrics.prefix_prefills_total.value == 2


@pytest.mark.parametrize("allocate,want", [("reserve", 2), ("on_demand", 0)])
def test_reservation_slack_gauge(tparams, allocate, want):
    """Right after seating a 4-token prompt of 20 new tokens, ``reserve``
    holds 2 unwritten blocks (3 mapped, 1 touched); ``on_demand`` none."""
    seen, release = threading.Event(), threading.Event()
    slack = []

    def hold(_tok, n=[0]):
        n[0] += 1
        if n[0] == 2:      # the post-prefill gauges have landed
            slack.append(eng.metrics.kv_reservation_slack.value)
            seen.set()
            release.wait(30)

    with port(tparams, slots=2, max_len=32, block_size=8,
              allocate=allocate) as eng:
        h = eng.submit(prompt(4), max_new_tokens=20, eos_id=None,
                       on_token=hold)
        assert seen.wait(60)
        release.set()
        h.result(timeout=120)
    assert slack == [want]


def test_cancelled_cache_hit_request_frees_match_refs(tparams):
    """A queued request whose prompt matched the cache and was cancelled
    before seating returns the planner's match references: afterwards
    dropping the cache's own references frees the whole pool."""
    sysp = prompt(17, seed=7)
    p1 = np.concatenate([sysp, prompt(3, 1)]).astype(np.int32)
    p2 = np.concatenate([sysp, prompt(3, 2)]).astype(np.int32)
    seen, release = threading.Event(), threading.Event()

    def hold(_tok):
        seen.set()
        release.wait(30)

    with port(tparams, slots=1, max_len=48, block_size=8,
              prefix_cache_blocks=16, queue_capacity=8) as eng:
        eng.generate(p1, max_new_tokens=4, timeout=120)   # seeds the cache
        blocker = eng.submit(prompt(5, 9), max_new_tokens=12, eos_id=None,
                             on_token=hold)
        assert seen.wait(60)
        victim = eng.submit(p2, max_new_tokens=4)
        assert victim.future.cancel()
        release.set()
        blocker.result(timeout=120)
        eng.generate(prompt(6, 11), max_new_tokens=4, timeout=120)
        deadline = time.time() + 30
        while eng.live_slots:
            assert time.time() < deadline
            time.sleep(0.01)
        eng._prefix_cache.release_all()
        assert eng._allocator.free_count == eng._allocator.capacity


def test_rebuild_voids_cache_and_swap_entries(tparams):
    """A pool rebuild drops cached and parked references without freeing
    them into the fresh allocator."""
    with port(tparams, slots=2, max_len=32, block_size=8,
              prefix_cache_blocks=8, swap_threshold_blocks=0) as eng:
        eng.generate(prompt(9, seed=1), max_new_tokens=4, timeout=120)
        assert eng._prefix_cache.total_blocks >= 1
        eng._swap_store.put(SwapEntry(payload=[], used_blocks=1, length=8,
                                      n_generated=1, last_token=0,
                                      prefix_len=0, nbytes=0))
        eng._reset_cache()
        assert eng._prefix_cache.total_blocks == 0
        assert len(eng._swap_store) == 0
        assert eng._allocator.free_count == eng._allocator.capacity
        assert eng.generate(prompt(5), max_new_tokens=4, timeout=120)
