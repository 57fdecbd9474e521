"""The port's load generator and time-series cost models
(deeplearning4j_tpu_torch/serving/loadgen.py and timeseries.py) against
the JAX package's, on the CPU.

- ``ArrivalProcess`` (Poisson, on/off, ramp) and ``TraceSpec.generate``:
  the same seed gives the same arrivals and the same trace, request for
  request, in both packages.
- ``LoadReport``: percentiles, windows, reasons and the stuck count over
  one hand-built record set, equal in both packages and to numpy's.
- A live replay of one seeded trace (``tests/test_loadgen.py:221``)
  through each package's generation engine at the reference tests' tiny
  fp32 config with the same weights: every stream equal to the JAX
  replay's, watermark-clean, none stuck; the same trace over the port's
  HTTP RPC plane (``run_over_rpc``, the ``main`` CLI) equal again.
- ``TimeSeriesStore``, ``fit_cost_models``, ``cheapest_cell``,
  ``config_key`` and ``ServingMetrics.timeseries_sample``'s schema equal
  to the JAX ones.

The tolerance is equality: arrival times bit for bit, tokens, reports.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.serving as J
from deeplearning4j_tpu.models import TransformerConfig as JaxConfig
from deeplearning4j_tpu.models import init_params as jax_init_params
from deeplearning4j_tpu.serving import loadgen as jax_loadgen
import deeplearning4j_tpu_torch.serving as T
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)
from deeplearning4j_tpu_torch.serving import loadgen as t_loadgen

PKGS = {"jax": J, "torch": T}
LOADGEN = {"jax": jax_loadgen, "torch": t_loadgen}
WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")
TCFG = TransformerConfig(**WIDTHS, dtype=torch.float32,
                         attention_impl="full")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both(fn):
    got = {side: fn(side) for side in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


# --------------------------------------------------------------------------
# Arrivals and traces
# --------------------------------------------------------------------------
ARRIVALS = [dict(kind="poisson", rate_rps=8.0),
            dict(kind="onoff", rate_rps=12.0, on_s=0.5, off_s=0.25,
                 off_rate_rps=0.0),
            dict(kind="onoff", rate_rps=6.0, off_rate_rps=1.5),
            dict(kind="ramp", rate_rps=10.0, start_rate_rps=1.0)]


class TestTrace:
    @pytest.mark.parametrize("kw", ARRIVALS,
                             ids=lambda kw: f"{kw['kind']}-{kw['rate_rps']}")
    def test_arrivals_equal(self, kw):
        def run(side):
            rng = np.random.default_rng(11)
            return LOADGEN[side].ArrivalProcess(**kw).arrivals(20.0, rng)

        times = both(run)
        assert times == sorted(times) and all(0 <= t < 20 for t in times)

    @pytest.mark.parametrize("seed", [0, 7])
    def test_trace_equal(self, seed):
        def run(side):
            lg = LOADGEN[side]
            spec = lg.TraceSpec(
                seed=seed, duration_s=8.0, vocab_size=50, max_len=48,
                mix={"chat": 0.5, "rag": 0.3, "batch": 0.2},
                arrival=lg.ArrivalProcess(kind="onoff", rate_rps=6.0))
            return (spec.system_prefix(),
                    [dataclasses.astuple(r) for r in spec.generate()])

        prefix, trace = both(run)
        assert trace and len(prefix) == 6
        assert [r[0] for r in trace] == list(range(len(trace)))
        assert {r[2] for r in trace} == {"chat", "rag", "batch"}
        assert all(len(r[3]) + r[4] <= 48 for r in trace)

    def test_refusals(self):
        def run(side):
            lg = LOADGEN[side]
            out = []
            for bad in (lambda: lg.ArrivalProcess(kind="bursty"),
                        lambda: lg.ArrivalProcess(rate_rps=0.0),
                        lambda: lg.TraceSpec(mix={"chat": 0.0}).generate(),
                        lambda: lg.LoadGenerator([], None, speed=0.0)):
                with pytest.raises(ValueError) as ei:
                    bad()
                out.append(str(ei.value))
            return out

        both(run)


# --------------------------------------------------------------------------
# The report
# --------------------------------------------------------------------------
def records(lg):
    rng = np.random.default_rng(2)
    out = []
    for i in range(40):
        t = float(i) * 0.1
        rec = lg.RequestRecord(index=i, kind="chat", tenant="t",
                               submit_t=t)
        if i % 13 != 12:                     # the rest are stuck
            rec.first_token_t = t + float(rng.uniform(0.01, 0.05))
            rec.done_t = t + float(rng.uniform(0.1, 0.9))
            rec.tokens = int(rng.integers(1, 20))
            rec.ok = i % 7 != 0
            rec.reason = "ok" if rec.ok else "deadline"
            rec.watermark_clean = True
        out.append(rec)
    return out


class TestReport:
    def test_report_equal_and_percentiles(self):
        windows = [(0.5, 1.5), (2.5, 3.0)]

        def run(side):
            lg = LOADGEN[side]
            rep = lg.LoadReport(records(lg), 0.0, 5.0)
            return (rep.to_dict(windows), rep.to_dict(),
                    rep.latency_percentile(90), rep.ttft_percentile(10))

        d, plain, p90, t10 = both(run)
        recs = records(t_loadgen)
        lat = [(r.done_t - r.submit_t) * 1e3 for r in recs if r.done_t]
        assert p90 == pytest.approx(float(np.percentile(lat, 90)))
        assert d["stuck_streams"] == 3 and d["requests"] == 40
        assert d["reasons"] == {"ok": 31, "deadline": 6, "pending": 3}
        assert d["latency_p99_during_episodes_ms"] is not None
        assert plain["latency_p99_between_episodes_ms"] is None


# --------------------------------------------------------------------------
# Live replays
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def np_params():
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def gen_engine(side, np_params, **kw):
    kw = {"slots": 4, "max_len": 48, "allocate": "on_demand",
          "swap_threshold_blocks": 1, **kw}
    if side == "jax":
        return J.GenerationEngine(
            jax.tree_util.tree_map(jnp.asarray, np_params), JCFG, **kw)
    return T.GenerationEngine(params_from_numpy(np_params, device="cpu"),
                              TCFG, device="cpu", **kw)


def spec(lg):
    return lg.TraceSpec(seed=6, duration_s=3.0,
                        arrival=lg.ArrivalProcess(rate_rps=6.0))


def replay(lg, submit, trace):
    handles = {}

    def tracked(tr, on_token):
        handles[tr.index] = h = submit(tr, on_token)
        return h
    rep = lg.LoadGenerator(trace, tracked, speed=4.0,
                           drain_timeout_s=60.0).run()
    streams = [handles[i].result(timeout=0) if i in handles else None
               for i in range(len(trace))]
    return rep, streams


class TestLiveReplay:
    def test_engine_replay_streams_equal_jax(self, np_params):
        def run(side):
            lg = LOADGEN[side]
            eng = gen_engine(side, np_params, name=f"lg-{side}")
            try:
                rep, streams = replay(lg, lg.engine_submitter(eng),
                                      spec(lg).generate())
            finally:
                eng.shutdown()
            assert rep.stuck_streams == 0 and rep.watermark_clean
            ok = [r for r in rep.records if r.ok]
            assert ok and all(r.latency_ms >= r.ttft_ms >= 0 for r in ok)
            return streams, rep.reasons(), rep.total_tokens

        streams, reasons, total = both(run)
        assert reasons == {"ok": len(streams)}
        assert total == sum(len(s) for s in streams) > 0

    def test_rpc_replay_and_cli_equal_the_engine_replay(self, np_params):
        """The same trace over the port's HTTP plane — two hosts behind
        ``HostRpcServer``, ``run_over_rpc`` and the ``main`` CLI — gives
        the JAX engine replay's streams and reasons."""
        ref_eng = gen_engine("jax", np_params, name="lg-ref")
        try:
            _rep, want = replay(jax_loadgen,
                                jax_loadgen.engine_submitter(ref_eng),
                                spec(jax_loadgen).generate())
        finally:
            ref_eng.shutdown()
        hosts = []
        for i in range(2):
            g = gen_engine("torch", np_params, name=f"lg-rpc{i}")
            hosts.append((g, T.HostRpcServer(T.LoopbackHost(i,
                                                            generation=g))))
        try:
            urls = [srv.url for _g, srv in hosts]
            rep = t_loadgen.run_over_rpc(urls, spec(t_loadgen), speed=4.0)
            assert rep.stuck_streams == 0 and rep.watermark_clean
            assert rep.reasons() == {"ok": len(want)}
            assert rep.total_tokens == sum(len(s) for s in want)
            assert sorted(r.tokens for r in rep.records) == sorted(
                len(s) for s in want)
            # the front door over these hosts, streams kept
            d = T.ClusterDirectory(heartbeat_timeout_s=30.0)
            for i, url in enumerate(urls):
                rem = T.RemoteHost(i, url)
                d.join(rem)
                T.HeartbeatPump(rem, T.LoopbackTransport(d)).pump_once()
            fd = T.ClusterFrontDoor(d)
            _rep2, got = replay(t_loadgen, T.front_door_submitter(fd),
                                spec(t_loadgen).generate())
            assert got == want
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = t_loadgen.main(["--url", urls[0], "--url", urls[1],
                                     "--seed", "6", "--duration-s", "3",
                                     "--rate-rps", "6", "--speed", "4"])
            cli = json.loads(out.getvalue().strip().splitlines()[-1])
            assert rc == 0 and cli["stuck_streams"] == 0
            assert cli["ok"] == cli["requests"] == len(want)
            assert cli["total_tokens"] == sum(len(s) for s in want)
        finally:
            for g, srv in hosts:
                srv.stop()
                g.shutdown()


# --------------------------------------------------------------------------
# Time series and cost models
# --------------------------------------------------------------------------
def ring(pkg):
    ts = pkg.TimeSeriesStore(capacity=8)   # 10 samples a host: wraps
    rng = np.random.default_rng(5)
    for i in range(30):
        occ = float(rng.uniform(0.1, 1.0))
        ts.record(i % 3, {
            "t": float(i), "slot_occupancy": occ,
            "tokens_per_sec": 100.0 + 900.0 * occ + float(rng.normal(0, 5)),
            "host_class": "decode" if i % 3 == 0 else "mixed",
            "config": {"kv_dtype": "int8" if i % 3 == 2 else "float32",
                       "allocate": "on_demand", "paged_attention": "fused"}})
    ts.record(7, {"t": 99.0, "tokens_per_sec": 5.0})   # no occupancy
    return ts


class TestTimeSeries:
    def test_store_and_cost_models_equal(self):
        def run(side):
            pkg = PKGS[side]
            ts = ring(pkg)
            models = pkg.fit_cost_models(ts, host_cost_per_s=3.0,
                                         min_samples=4)
            sparse = pkg.fit_cost_models(ts.series(1)[:3])
            return (len(ts), ts.host_ids(), ts.latest(2), ts.series(7),
                    ts.api_snapshot(limit=2), ts.recorded_total, models,
                    pkg.cheapest_cell(models), sparse,
                    pkg.cheapest_cell(sparse),
                    [pkg.config_key(h, c) for h, c in (
                        ("decode", {"kv_dtype": "int8"}), ("", None),
                        ("prefill", {"allocate": "on_demand",
                                     "paged_attention": "gather"}))])

        (n, ids, _latest, _s7, _api, recorded, models, cheapest, sparse,
         none, keys) = both(run)
        assert n == 8 * 3 + 1 and recorded == 31 and ids == [0, 1, 2, 7]
        assert cheapest in models and none is None
        assert all(m["cost_per_token"] is None for m in sparse.values())
        with pytest.raises(ValueError):
            T.TimeSeriesStore(capacity=0)
        with pytest.raises(ValueError):
            T.fit_cost_models([], host_cost_per_s=0.0)

    def test_timeseries_sample_schema_equal(self):
        keys = {}
        for side, pkg in PKGS.items():
            m = pkg.ServingMetrics()
            m.generated_tokens_total.inc(40)
            m.decode_wall_ms.inc(20.0)
            m.slot_occupancy.set(0.5)
            sample = m.timeseries_sample()
            keys[side] = (sorted(sample), sample["tokens_per_sec"],
                          sample["queue_by_class"])
        assert keys["torch"] == keys["jax"]
        assert keys["torch"][1] == 2000.0
