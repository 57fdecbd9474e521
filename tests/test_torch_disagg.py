"""Disaggregated prefill/decode with KV page migration in the port
(deeplearning4j_tpu_torch/serving/disagg.py, the engine's page export and
import, the ``kv.migrate`` endpoint) against the JAX package, on the CPU,
at the reference tests' tiny fp32 config (``tests/test_disagg.py``:
vocab 50, hidden 32, 2 layers, 2 heads). JAX ``init_params`` makes the
weights; they reach the port through ``params_from_numpy``.

Each of the reference's tests has a counterpart here that runs the port
on the same inputs as the JAX package:

- a stream placed prefill host -> migrate -> decode host equals the JAX
  single-host stream token for token: fp32 and int8 pools, greedy and
  sampled, over the loopback hand-off and over the port's own RPC hosts;
  ``on_token`` sees the whole stream once; the captured pages equal the
  JAX engine's (fp32 within 1e-6, int8 values at most one quantization
  step apart);
- the three fault points degrade to recompute and never shed, a seeded
  plan fires on the JAX plan's schedule with the JAX front door's
  fallback count, a watchdog restart between ``import_pages`` and
  admission gives a recompute that reads no parked row, and the swap
  store ``import_pages`` creates leaves preemption to recompute;
- class routing (a prefill host never decodes, a recompute stays off it,
  ``host_class`` is validated, a mixed-only fleet keeps the policy
  inert), the heartbeat schema, the post-migration headroom bound, the
  fleet prefix index over a seeded heartbeat sequence and cache-aware
  routing, each equal to the JAX package's.

The tolerance is token-for-token equality and exact counters, except the
page values stated above.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.serving as J
from deeplearning4j_tpu.models import TransformerConfig as JaxConfig
from deeplearning4j_tpu.models import init_params as jax_init_params
from deeplearning4j_tpu.serving import faults as jax_faults
from deeplearning4j_tpu.serving.tracing import (
    TERMINAL_REASONS as JAX_REASONS)
from deeplearning4j_tpu.util import crash_reporting as jax_crash
import deeplearning4j_tpu_torch.serving as T
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)
from deeplearning4j_tpu_torch.serving import faults as t_faults
from deeplearning4j_tpu_torch.serving.tracing import TERMINAL_REASONS
from deeplearning4j_tpu_torch.util import crash_reporting as t_crash

WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")
TCFG = TransformerConfig(**WIDTHS, dtype=torch.float32,
                         attention_impl="full")
PROMPT = np.array([5, 9, 3, 7, 11, 2], np.int32)
SIDES = ("jax", "torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _dumps_to_tmp(tmp_path):
    jax_crash.crashDumpOutputDirectory(str(tmp_path))
    t_crash.crashDumpOutputDirectory(str(tmp_path))
    yield
    jax_crash.crashDumpOutputDirectory(None)
    t_crash.crashDumpOutputDirectory(None)
    for mod in (jax_faults, t_faults):
        if mod.active_plan() is not None:
            mod.active_plan().uninstall()


@pytest.fixture(scope="module")
def sides():
    """Each package's serving module and engine factory over the same
    weights (JAX ``init_params`` at key 0, as the reference tests)."""
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       p)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, device="cpu")
    return {
        "jax": (J, lambda name, kv="float32", **kw: J.GenerationEngine(
            jparams, JCFG, kv_dtype=kv, name=name,
            **{"slots": 2, "max_len": 64, **kw})),
        "torch": (T, lambda name, kv="float32", **kw: T.GenerationEngine(
            tparams, TCFG, kv_dtype=kv, name=name, device="cpu",
            **{"slots": 2, "max_len": 64, **kw})),
    }


_REFS = {}


@pytest.fixture(scope="module")
def reference(sides):
    """The JAX package's single-host stream of ``PROMPT`` (cached)."""
    def ref(max_new=10, kv="float32", temp=0.0, seed=0):
        key = (max_new, kv, temp, seed)
        if key not in _REFS:
            g = sides["jax"][1]("ref", kv)
            try:
                _REFS[key] = [int(t) for t in g.submit(
                    PROMPT, max_new_tokens=max_new, temperature=temp,
                    seed=seed).result(timeout=120)]
            finally:
                g.shutdown()
        return _REFS[key]
    return ref


class Fleet:
    """1 prefill-class + 1 decode-class loopback host of one package behind
    a front door with ``DisaggPolicy`` (``classes`` and ``disagg`` change
    that); heartbeats pumped once."""

    def __init__(self, sides, side, kv="float32",
                 classes=("prefill", "decode"), disagg=True, **engine_kw):
        pkg, make = sides[side]
        self.pkg = pkg
        self.g_p = make(f"{side}-a", kv, **engine_kw)
        self.g_d = make(f"{side}-b", kv, **engine_kw)
        self.hp = pkg.LoopbackHost(0, generation=self.g_p,
                                   host_class=classes[0])
        self.hd = pkg.LoopbackHost(1, generation=self.g_d,
                                   host_class=classes[1])
        # a liveness window no CPU-bound run outlasts: a stale prefill
        # host would turn the policy inert (its own test)
        self.d = pkg.ClusterDirectory(heartbeat_timeout_s=600.0)
        for h in (self.hp, self.hd):
            self.d.join(h)
            self.d.heartbeat(h.status())
        self.fd = pkg.ClusterFrontDoor(
            self.d, disagg=pkg.DisaggPolicy() if disagg else None)

    def run(self, max_new=10, **kw):
        h = self.fd.submit_generate(PROMPT, max_new_tokens=max_new, **kw)
        return [int(t) for t in h.result(timeout=120)]

    def counters(self):
        fm, pm, dm = self.fd.metrics, self.g_p.metrics, self.g_d.metrics
        return {"migrations": fm.kv_migrations_total.value,
                "fallbacks": fm.kv_migrate_fallbacks_total.value,
                "rejected": fm.rejected_total.value,
                "reasons": fm.rejections_by_reason.to_dict(),
                "prefix_hits": fm.prefix_route_hits_total.value,
                "bytes_out": pm.kv_migrate_bytes_out.value,
                "bytes_in": dm.kv_migrate_bytes_in.value,
                "swap_in": dm.kv_swap_bytes_in.value,
                "gen_p": pm.generated_tokens_total.value,
                "gen_d": dm.generated_tokens_total.value,
                "routed": self.fd.routed_by_host.to_dict()}

    def shutdown(self):
        self.g_p.shutdown()
        self.g_d.shutdown()


def on_both(sides, fn):
    """``fn(side)`` on each package, the fleets shut down after; returns
    ``{side: result}``."""
    return {side: fn(side) for side in SIDES}


# ---------------------------------------------------------------------------
# migrated streams against the JAX single-host stream
# ---------------------------------------------------------------------------
class TestMigratedParity:
    @pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
    @pytest.mark.parametrize("temp,seed", [(0.0, 0), (0.8, 7)])
    def test_loopback_migration_equals_jax(self, sides, reference,
                                           kv_dtype, temp, seed):
        ref = reference(10, kv_dtype, temp, seed)

        def run(side):
            f = Fleet(sides, side, kv_dtype)
            try:
                return f.run(10, temperature=temp, seed=seed), f.counters()
            finally:
                f.shutdown()
        got = on_both(sides, run)
        for side in SIDES:
            toks, c = got[side]
            assert toks == ref, side
            # a real migration: pages crossed and seated by swap-in
            assert c["migrations"] == 1 and c["fallbacks"] == 0
            assert c["bytes_out"] == c["bytes_in"] == c["swap_in"] > 0
        # the same pages, in the same bytes, in both packages
        assert got["torch"][1] == got["jax"][1]

    def test_rpc_migration_equals_jax(self, sides, reference):
        """The port's hosts behind its own ``HostRpcServer``s, the front
        door on ``RemoteHost``s: pages cross ``/rpc/v1/migrate``."""
        ref = reference(10)
        make = sides["torch"][1]
        g_p, g_d = make("rpf"), make("rdec")
        sp = T.HostRpcServer(T.LoopbackHost(0, generation=g_p,
                                            host_class="prefill"))
        sd = T.HostRpcServer(T.LoopbackHost(1, generation=g_d,
                                            host_class="decode"))
        try:
            d = T.ClusterDirectory()
            for i, s in enumerate((sp, sd)):
                rem = T.RemoteHost(i, s.url)
                d.join(rem)
                T.HeartbeatPump(rem, T.LoopbackTransport(d)).pump_once()
            fd = T.ClusterFrontDoor(d, disagg=T.DisaggPolicy())
            seen = []
            h = fd.submit_generate(PROMPT, max_new_tokens=10,
                                   on_token=seen.append)
            assert [int(t) for t in h.result(timeout=120)] == ref
            assert [int(t) for t in seen] == ref
            assert fd.metrics.kv_migrations_total.value == 1
            assert fd.metrics.kv_migrate_fallbacks_total.value == 0
            assert g_d.metrics.kv_migrate_bytes_in.value \
                == g_p.metrics.kv_migrate_bytes_out.value > 0
            assert g_p.metrics.generated_tokens_total.value == 1
            assert g_d.metrics.generated_tokens_total.value == 9
        finally:
            sp.stop()
            sd.stop()
            g_p.shutdown()
            g_d.shutdown()

    def test_on_token_sees_full_stream_once(self, sides, reference):
        ref = reference(8)

        def run(side):
            f = Fleet(sides, side)
            seen = []
            try:
                return f.run(8, on_token=seen.append), \
                    [int(t) for t in seen]
            finally:
                f.shutdown()
        got = on_both(sides, run)
        assert got["torch"] == got["jax"] == (ref, ref)

    @pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
    def test_captured_pages_match_jax(self, sides, kv_dtype):
        """``submit(capture_pages=True)`` then ``take_captured_pages``: the
        entry's metadata equal, each leaf's values equal within the stated
        tolerance (fp32 1e-6; int8 values one quantization step, their
        scales 1e-6 relative)."""
        entries = {}
        for side in SIDES:
            g = sides[side][1](f"cap-{side}", kv_dtype)
            try:
                h = g.submit(PROMPT, max_new_tokens=1, capture_pages=True)
                h.result(timeout=120)
                entries[side] = g.take_captured_pages(h)
                assert g.take_captured_pages(h) is None   # one shot
                assert g.metrics.kv_migrate_bytes_out.value \
                    == entries[side].nbytes
            finally:
                g.shutdown()
        je, te = entries["jax"], entries["torch"]
        for f in ("used_blocks", "length", "n_generated", "last_token",
                  "prefix_len", "nbytes"):
            assert getattr(te, f) == getattr(je, f), f
        assert te.used_blocks == 1 and te.length == PROMPT.size
        assert len(te.payload) == len(je.payload) == WIDTHS["layers"]
        for tl, jl in zip(te.payload, je.payload):
            assert sorted(tl) == sorted(jl)
            for k in jl:
                a = tl[k].numpy()
                b = np.asarray(jl[k])
                assert a.shape == b.shape and a.dtype == b.dtype, k
                if a.dtype == np.int8:
                    assert np.abs(a.astype(np.int32)
                                  - b.astype(np.int32)).max() <= 1, k
                elif k.endswith("_scale"):
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)

    def test_capture_pages_refuses_the_contiguous_cache(self, sides):
        for side in SIDES:
            g = sides[side][1](f"contig-{side}", paged=False)
            try:
                with pytest.raises(ValueError, match="capture_pages"):
                    g.submit(PROMPT, max_new_tokens=1, capture_pages=True)
                with pytest.raises(ValueError, match="import_pages"):
                    g.import_pages(None)
            finally:
                g.shutdown()


# ---------------------------------------------------------------------------
# migration faults: recompute on the decode host, never shed
# ---------------------------------------------------------------------------
class TestMigrateFaultsDegrade:
    @pytest.mark.parametrize("point", ["kv.migrate", "kv.migrate.export",
                                       "kv.migrate.import"])
    def test_fault_degrades_to_recompute_never_sheds(self, sides,
                                                     reference, point):
        ref = reference(8)

        def run(side):
            f = Fleet(sides, side)
            try:
                plan = f.pkg.FaultPlan(seed=11).fail(point, at=[0])
                with plan:
                    toks = f.run(8)
                return toks, [e["point"] for e in plan.fired()], \
                    f.counters()
            finally:
                f.shutdown()
        got = on_both(sides, run)
        assert got["torch"] == got["jax"]
        toks, fired, c = got["torch"]
        assert toks == ref and fired == [point]
        assert c["rejected"] == 0 and c["reasons"] == {}
        assert c["fallbacks"] >= 1 and c["migrations"] == 0

    def test_seeded_plan_schedule_and_fallbacks_match_jax(self, sides):
        """One seeded plan over all three points through eight streams
        (greedy and sampled, two prompts): the same fired schedule, the
        same streams and the same fallback count in both packages."""
        prompts = [PROMPT, np.array([3, 1, 4, 1, 5, 9, 2, 6, 5], np.int32)]

        def run(side):
            f = Fleet(sides, side)
            try:
                plan = (f.pkg.FaultPlan(seed=23)
                        .fail("kv.migrate", rate=0.3)
                        .fail("kv.migrate.export", rate=0.3)
                        .fail("kv.migrate.import", rate=0.3))
                out = []
                with plan:
                    for i in range(8):
                        h = f.fd.submit_generate(
                            prompts[i % 2], max_new_tokens=6, seed=i,
                            temperature=0.8 if i % 4 >= 2 else 0.0)
                        out.append([int(t) for t in h.result(timeout=120)])
                fired = [(e["point"], e["index"], e["kind"])
                         for e in plan.fired()]
                return out, fired, f.counters()
            finally:
                f.shutdown()
        got = on_both(sides, run)
        assert got["torch"][0] == got["jax"][0]
        assert got["torch"][1] == got["jax"][1]
        tc, jc = got["torch"][2], got["jax"][2]
        assert tc["fallbacks"] == jc["fallbacks"]
        assert tc["migrations"] == jc["migrations"]
        assert tc["migrations"] + tc["fallbacks"] == 8
        assert {p for p, _, _ in got["torch"][1]} == {
            "kv.migrate", "kv.migrate.export", "kv.migrate.import"}
        assert tc["rejected"] == 0

    def test_import_store_leaves_preemption_to_recompute(self, sides):
        """An engine without ``swap_threshold_blocks`` gets a swap store
        from ``import_pages``; its preemptions still recompute and swap
        nothing (the reference tests' tight on-demand pool: two 4-token
        prompts of 20 new tokens in 4 usable blocks of 8)."""
        tight = dict(slots=2, max_len=32, block_size=8, num_blocks=5,
                     allocate="on_demand", queue_capacity=8)
        prompts = [np.random.default_rng(s).integers(1, 50, 4).astype(
            np.int32) for s in (0, 1)]

        def run(side):
            with sides[side][1](f"tight-{side}", **tight) as g:
                h = g.submit(prompts[0], max_new_tokens=1,
                             capture_pages=True)
                h.result(timeout=120)
                key = g.import_pages(g.take_captured_pages(h))
                assert key is not None and g._swap_store is not None
                g.discard_imported(key)
                hs = [g.submit(p, max_new_tokens=20, eos_id=None, seed=s)
                      for s, p in enumerate(prompts)]
                streams = [[int(t) for t in x.result(timeout=120)]
                           for x in hs]
                m = g.metrics
                return (streams, m.preemptions_total.value,
                        m.kv_swapped_blocks.value,
                        m.kv_swapped_blocks_held.value)
        got = on_both(sides, run)
        assert got["torch"] == got["jax"]
        assert got["torch"][1] >= 1 and got["torch"][2:] == (0, 0)

    def test_migrate_failed_is_not_a_terminal_reason(self):
        assert "migrate_failed" not in TERMINAL_REASONS
        assert TERMINAL_REASONS == JAX_REASONS

    def test_restart_between_import_and_admission_recomputes(
            self, sides, reference):
        """Pages parked by ``import_pages`` (filled with garbage, so a read
        would show), then a watchdog restart, then the stream's submit
        with their key: it recomputes from its first token and equals
        the clean stream; no byte was swapped in."""
        ref = reference(10)

        def run(side):
            pkg, make = sides[side]
            with make(f"exp-{side}") as g:
                h = g.submit(PROMPT, max_new_tokens=1, capture_pages=True)
                first = int(h.result(timeout=120)[0])
                entry = g.take_captured_pages(h)
            for layer in entry.payload:
                for k in layer:
                    if side == "jax":
                        layer[k] = np.full_like(np.asarray(layer[k]), 7)
                    else:
                        layer[k] = torch.full_like(layer[k], 7)
            with make(f"imp-{side}") as g:
                g.generate(PROMPT, max_new_tokens=2, timeout=120)
                key = g.import_pages(entry)
                assert key is not None
                g.arm_watchdog(400)
                stale = g._thread
                plan = pkg.FaultPlan(seed=0).delay(
                    "generation.decode_step", ms=1500, at=(2,))
                with plan:
                    h0 = g.submit(PROMPT, max_new_tokens=8)
                    with pytest.raises(pkg.WatchdogTimeoutError):
                        h0.result(timeout=60)
                stale.join(timeout=10)
                h = g.submit(PROMPT, max_new_tokens=10, swap_key=key,
                             resume_tokens=np.asarray([first], np.int32),
                             resume_step=1)
                rest = [int(t) for t in h.result(timeout=120)]
                return [first] + rest, g.watchdog_restarts, \
                    g.metrics.kv_swap_bytes_in.value
        got = on_both(sides, run)
        assert got["torch"] == got["jax"]
        assert got["torch"] == (ref, 1, 0)


# ---------------------------------------------------------------------------
# class routing: a prefill host never holds a decode-phase stream
# ---------------------------------------------------------------------------
class TestClassRouting:
    def test_prefill_host_never_decodes(self, sides):
        def run(side):
            f = Fleet(sides, side)
            try:
                f.run(10)
                c = f.counters()
                return c["gen_p"], c["gen_d"], c["routed"]
            finally:
                f.shutdown()
        got = on_both(sides, run)
        assert got["torch"] == got["jax"]
        assert got["torch"][:2] == (1, 9)

    def test_fallback_recompute_stays_off_prefill_host(self, sides):
        def run(side):
            f = Fleet(sides, side)
            try:
                with f.pkg.FaultPlan(seed=5).fail("kv.migrate", at=[0]):
                    f.run(8)
                c = f.counters()
                return c["gen_p"], c["gen_d"]
            finally:
                f.shutdown()
        got = on_both(sides, run)
        assert got["torch"] == got["jax"] == (1, 8)

    def test_host_class_validation(self):
        for pkg in (J, T):
            with pytest.raises(ValueError, match="host_class"):
                pkg.LoopbackHost(0, host_class="gpu")

    def test_mixed_only_fleet_keeps_policy_inert(self, sides, reference):
        ref = reference(8)

        def run(side, disagg):
            f = Fleet(sides, side, classes=("mixed", "mixed"),
                      disagg=disagg)
            try:
                if disagg:
                    assert not f.fd.disagg.enabled(f.d)
                toks = [f.run(8), f.run(8, seed=3, temperature=0.8)]
                c = f.counters()
                return toks, c["routed"], c["migrations"], c["fallbacks"]
            finally:
                f.shutdown()
        got = {(side, dis): run(side, dis) for side in SIDES
               for dis in (True, False)}
        assert len(set(map(repr, got.values()))) == 1
        assert got[("torch", True)][0][0] == ref
        assert got[("torch", True)][2:] == (0, 0)


# ---------------------------------------------------------------------------
# heartbeats, the API snapshot, headroom, the fleet prefix index
# ---------------------------------------------------------------------------
class TestWireAndSnapshot:
    def test_v_old_heartbeat_payload_ingests_clean(self):
        old_payload = {
            "host_id": 3, "has_generate": True, "queue_depth": 0,
            "queue_capacity": 8, "gen_queue_depth": 1,
            "gen_queue_capacity": 64, "slots": 4, "free_slots": 2,
            "kv_blocks_total": 32, "kv_blocks_free": 16,
            "kv_blocks_usable": 30, "block_size": 16,
            "buckets": [8, 16], "breaker": "CLOSED", "seq": 7,
            "wire_version": 1,
        }
        got = {}
        for pkg in (J, T):
            st = pkg.HostStatus.from_dict(dict(old_payload))
            assert st.host_class == "mixed" and st.prefix_tokens == ()
            assert st.prefix_cache_entries == st.prefix_cache_hits == 0
            d = pkg.ClusterDirectory()
            d.heartbeat(st)
            assert d.status(3).host_class == "mixed"
            got[pkg] = st.to_dict()
        assert got[T] == got[J]

    def test_round_trip_preserves_class_and_prefixes(self):
        for pkg in (J, T):
            st = pkg.HostStatus(host_id=1, host_class="decode",
                                prefix_tokens=((1, 2, 3), (4, 5)),
                                prefix_cache_entries=2,
                                prefix_cache_hits=9)
            st2 = pkg.HostStatus.from_dict(st.to_dict())
            assert st2.host_class == "decode"
            assert st2.prefix_tokens == ((1, 2, 3), (4, 5))
            assert st2.prefix_cache_hits == 9

    def test_api_snapshot_rolls_up_host_classes(self, sides):
        def run(side):
            f = Fleet(sides, side)
            try:
                snap = f.d.api_snapshot()
                fleet = snap["fleet"]
                return (fleet["host_classes"],
                        fleet["prefix_cache_entries"],
                        fleet["prefix_cache_hits"],
                        snap["hosts"]["0"]["status"]["host_class"],
                        snap["hosts"]["1"]["status"]["host_class"])
            finally:
                f.shutdown()
        got = on_both(sides, run)
        assert got["torch"] == got["jax"]
        assert got["torch"][0] == {"prefill": 1, "decode": 1, "mixed": 0}
        assert got["torch"][3:] == ("prefill", "decode")


class TestMigrateFeasibility:
    def _st(self, pkg):
        return pkg.HostStatus(host_id=0, has_generate=True, slots=2,
                              free_slots=1, gen_queue_capacity=8,
                              kv_blocks_total=8, kv_blocks_free=8,
                              kv_blocks_usable=6, block_size=16)

    def test_headroom_uses_post_migration_bound(self):
        for pkg in (J, T):
            fd = pkg.ClusterFrontDoor(pkg.ClusterDirectory())
            st = self._st(pkg)
            assert not fd._headroom(st, "generate", 1, 7)
            assert fd._headroom(st, "generate", 1, 7, None, 6)
            assert fd._headroom(st, "generate", 1, 4, None, 9)
            # the post-migration bound judges the free blocks too
            st.kv_blocks_free = 5
            assert fd._headroom(st, "generate", 1, 7, None, 5)
            assert fd._headroom(st, "generate", 1, 7, None, 6) \
                == (st.gen_queue_depth + 1 <= st.gen_queue_capacity)

    def test_headroom_default_unchanged(self):
        grid = [(free, usable, need) for free in (0, 1)
                for usable in (5, 6) for need in (5, 6, 7)]
        got = {}
        for pkg in (J, T):
            fd = pkg.ClusterFrontDoor(pkg.ClusterDirectory())
            out = []
            for free, usable, need in grid:
                st = self._st(pkg)
                st.free_slots, st.kv_blocks_usable = free, usable
                out.append(fd._headroom(st, "generate", 1, need))
            got[pkg] = out
        assert got[T] == got[J]
        st = self._st(T)
        fd = T.ClusterFrontDoor(T.ClusterDirectory())
        assert fd._headroom(st, "generate", 1, 6)
        assert not fd._headroom(st, "generate", 1, 7)


class TestFleetPrefixIndex:
    def test_refresh_and_best_hosts_equal_jax(self):
        """The reference's scripted case, then a seeded heartbeat
        sequence (hosts joining, re-advertising and leaving): after each
        refresh, ``best_hosts`` and ``node_count`` equal the JAX index's
        for every probe."""
        class FakeDir:
            def __init__(self):
                self.st = {}

            def host_ids(self):
                return sorted(self.st)

            def status(self, hid):
                return self.st.get(hid)

        idx = {J: J.FleetPrefixIndex(), T: T.FleetPrefixIndex()}
        dirs = {J: FakeDir(), T: FakeDir()}

        def beat(hid, seq, prefixes):
            for pkg in (J, T):
                dirs[pkg].st[hid] = pkg.HostStatus(
                    host_id=hid, seq=seq, prefix_tokens=prefixes)

        def leave(hid):
            for pkg in (J, T):
                dirs[pkg].st.pop(hid, None)

        def probe(toks):
            got = []
            for pkg in (J, T):
                idx[pkg].refresh(dirs[pkg])
                got.append((idx[pkg].best_hosts(toks),
                            idx[pkg].node_count()))
            assert got[0] == got[1], toks
            return got[1][0]

        beat(0, 1, ((1, 2, 3),))
        beat(1, 1, ((1, 2), (9, 9)))
        assert probe((1, 2, 3, 4)) == (3, {0})
        assert probe((1, 2, 7)) == (2, {0, 1})
        assert probe((9, 9)) == (2, {1})
        beat(1, 2, ((9, 9),))
        assert probe((1, 2, 7)) == (2, {0})
        leave(0)
        assert probe((1, 2, 3)) == (0, set())
        assert probe((9, 9)) == (2, {1})

        rng = np.random.default_rng(5)
        seqs = {}
        for _ in range(60):
            hid = int(rng.integers(0, 4))
            if rng.random() < 0.15:
                leave(hid)
                seqs.pop(hid, None)
            else:
                seqs[hid] = seqs.get(hid, 0) + int(rng.integers(0, 2))
                beat(hid, seqs[hid], tuple(
                    tuple(int(t) for t in rng.integers(0, 4,
                                                       rng.integers(1, 6)))
                    for _ in range(int(rng.integers(0, 4)))))
            for _ in range(3):
                probe(tuple(int(t) for t in rng.integers(0, 4, 6)))

    def test_cache_aware_decode_routing_hits(self, sides):
        """A repeat prompt routes to the decode host advertising its
        prefix: the same ``prefix_route_hits_total`` and streams as the
        JAX fleet."""
        def run(side):
            f = Fleet(sides, side, prefix_cache_blocks=8)
            try:
                first = f.run(16)
                deadline = time.time() + 10
                while (f.g_d._prefix_cache is None
                       or len(f.g_d._prefix_cache) == 0):
                    assert time.time() < deadline, "prefix cache never filled"
                    time.sleep(0.02)
                f.d.heartbeat(f.hp.status())
                f.d.heartbeat(f.hd.status())
                entries = f.d.status(1).prefix_cache_entries
                second = f.run(10)
                return first, second, entries, f.counters()["prefix_hits"]
            finally:
                f.shutdown()
        got = on_both(sides, run)
        assert got["torch"] == got["jax"]
        assert got["torch"][2] >= 1 and got["torch"][3] >= 1
