"""The port's HTTP RPC data plane (deeplearning4j_tpu_torch/serving/rpc.py)
against the JAX package's, on the CPU, over real sockets on 127.0.0.1.

- Wire schema: each dataclass's ``to_dict`` (``RpcRequest``,
  ``RpcResponse``, ``RpcStreamChunk``, ``HostStatus``) serialises to the
  same JSON bytes as the JAX package's, with the same fields, defaults
  and ``wire_version``; each package decodes the other's payload, and the
  rolling-upgrade rules hold (unknown fields dropped, missing defaulted);
  ``rejected_from_wire`` maps every terminal reason the same way.
- Across packages: the JAX ``RemoteHost`` client served by the port's
  ``HostRpcServer``, and the port's client served by the JAX server —
  status, batch inference and generation streams, each result equal to
  the serving engine's own (the same seeded weights in both packages).
- Deadline propagation (``tests/test_rpc.py:483-560``): a frozen clock's
  50 ms budget arrives as 50 ms, a spent budget sheds typed ``deadline``
  before the engine, re-dispatches ship only the remaining budget.
- A seeded ``FaultPlan`` on ``rpc.dispatch``, ``rpc.stream`` and
  ``rpc.response`` fires the same schedule with the same outcomes in
  both packages; typed failures for dropped and poisoned traffic.
- Graceful drain over the wire, the op registry's idempotent terminals
  and TTL, and the ledger's RPC dimensions at zero after stop.

The tolerance is equality: payload bytes, tokens, results, schedules.
"""
import dataclasses
import json
import threading
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
import deeplearning4j_tpu_torch.serving as T
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)
from deeplearning4j_tpu_torch.serving import faults as t_faults
from deeplearning4j_tpu_torch.serving.rpc import RPC_PREFIX
from deeplearning4j_tpu_torch.serving.tracing import TERMINAL_REASONS

PKGS = {"jax": J, "torch": T}
WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")
TCFG = TransformerConfig(**WIDTHS, dtype=torch.float32,
                         attention_impl="full")
WIRE_TYPES = ("RpcRequest", "RpcResponse", "RpcStreamChunk", "HostStatus",
              "KvMigrateRequest", "KvMigrateResponse")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_plan_left():
    yield
    for mod in (jax_faults, t_faults):
        if mod.active_plan() is not None:
            mod.active_plan().uninstall()


def both(fn):
    """``fn(pkg)`` on each package; asserts the results are equal and
    returns the port's."""
    got = {side: fn(pkg) for side, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def host(x) -> np.ndarray:
    return x.toNumpy() if hasattr(x, "toNumpy") else np.asarray(x)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def mlp(pkg, delay_s=0.0):
    class MlpAdapter(pkg.ModelAdapter):
        kind = "tiny-mlp"

        def __init__(self):
            super().__init__(model=None)
            self.w = np.linspace(-1.0, 1.0, 6,
                                 dtype=np.float32).reshape(6, 1)
            self.calls = 0

        def infer(self, x):
            self.calls += 1
            if delay_s:
                time.sleep(delay_s)
            return np.asarray(x) @ self.w

    return MlpAdapter()


def row(n=2):
    return np.arange(6 * n, dtype=np.float32).reshape(n, 6) / 7.0


def prompt(n=5, seed=3):
    return np.random.default_rng(seed).integers(1, 50, n).astype(np.int32)


@pytest.fixture(scope="module")
def np_params():
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def gen_engine(pkg, np_params, **kw):
    if pkg is J:
        return J.GenerationEngine(
            jax.tree_util.tree_map(jnp.asarray, np_params), JCFG,
            **{"slots": 2, "max_len": 48, **kw})
    return T.GenerationEngine(params_from_numpy(np_params, device="cpu"),
                              TCFG, **{"slots": 2, "max_len": 48,
                                       "device": "cpu", **kw})


def settled_host(pkg):
    """A ``LoopbackHost`` whose generation submit returns once the stream
    has finished: the host's admit answers with every token in place, so
    one poll takes the whole stream however fast the engine runs."""
    class Settled(pkg.LoopbackHost):
        def submit_generate(self, prompt, **kwargs):
            h = super().submit_generate(prompt, **kwargs)
            h.future.exception(timeout=120)
            return h
    return Settled


class Served:
    """One host of ``pkg`` (engines + LoopbackHost + HostRpcServer);
    ``settled`` serves each stream whole (:func:`settled_host`)."""

    def __init__(self, pkg, host_id=0, *, np_params=None, delay_s=0.0,
                 clock=None, settled=False, host_class="mixed"):
        self.eng = pkg.InferenceEngine(mlp(pkg, delay_s), max_batch_size=8,
                                       max_wait_ms=0.0,
                                       name=f"rpc-e{host_id}")
        self.gen = gen_engine(pkg, np_params, name=f"rpc-g{host_id}") \
            if np_params is not None else None
        local_cls = settled_host(pkg) if settled else pkg.LoopbackHost
        self.local = local_cls(host_id, engine=self.eng,
                               generation=self.gen, host_class=host_class)
        kw = {} if clock is None else {"clock": clock}
        self.srv = pkg.HostRpcServer(self.local, **kw)

    def stop(self):
        self.srv.stop()
        self.local.shutdown()


# --------------------------------------------------------------------------
# Wire schema
# --------------------------------------------------------------------------
def wire_cases(pkg):
    return [
        pkg.RpcRequest(request_id="r1", kind="generate", prompt=[1, 2, 3],
                       max_new_tokens=4, temperature=0.5, top_k=3, seed=9,
                       tenant="acme", priority="interactive",
                       timeout_ms=80.0, hedge_attempt=2,
                       resume_tokens=[7, 8], resume_step=2,
                       trace_id="cluster-000042", parent_span="attempt1"),
        pkg.RpcRequest(request_id="r2", kind="infer", x=[[1.0, 2.0]],
                       eos_default=False, eos_id=None),
        pkg.RpcResponse(request_id="r1", ok=True, done=True,
                        stream_id="op-7", result=[[1.0], [2.0]],
                        result_dtype="float32", resume_step=2),
        pkg.RpcResponse(ok=False, error_reason="queue_full",
                        error_message="full"),
        pkg.RpcStreamChunk(stream_id="op-7", cursor=3, tokens=[5, 6],
                           done=True, finish_reason="eos"),
        pkg.KvMigrateRequest(request_id="h1-m3", kind="import",
                             prompt=[4, 5, 6], max_new_tokens=9,
                             temperature=0.8, top_k=4, eos_default=False,
                             eos_id=2, seed=7, tenant="acme",
                             priority="batch", timeout_ms=120.5,
                             trace_id="cluster-000007",
                             parent_span="migrate:decode", first_token=11,
                             pages=[{"k": {"b64": "AAE=", "dtype": "int8",
                                           "shape": [1, 2]}}],
                             used_blocks=1, length=3, n_generated=1,
                             last_token=11, nbytes=2, block_size=16),
        pkg.KvMigrateResponse(request_id="h1-m3", ok=True, mode="migrated",
                              stream_id="op-9", first_token=11,
                              finish_reason="max_tokens", used_blocks=1,
                              length=3, n_generated=1, last_token=11,
                              nbytes=2, block_size=16),
        pkg.KvMigrateResponse(ok=False, error_reason="deadline",
                              error_message="spent"),
        pkg.HostStatus(host_id=4, has_infer=True, has_generate=True,
                       queue_depth=3, queue_capacity=64, slots=8,
                       free_slots=2, kv_blocks_total=64, kv_blocks_free=10,
                       kv_blocks_usable=60, block_size=16,
                       allocate="on_demand", buckets=(8, 16, 32),
                       prefix_tokens=((1, 2), (3,)), breaker="HALF_OPEN",
                       slo_burn_active=True, draining=True, seq=41,
                       wall_t=1234.5, sample={"t": 1.0, "x": [1, 2]}),
    ]


class TestWireSchema:
    def test_fields_and_versions_equal(self):
        for name in WIRE_TYPES:
            jf = [(f.name, f.default) for f in
                  dataclasses.fields(getattr(J, name))]
            tf = [(f.name, f.default) for f in
                  dataclasses.fields(getattr(T, name))]
            assert tf == jf, name

    def test_to_dict_bytes_equal_and_cross_decoded(self):
        for jm, tm in zip(wire_cases(J), wire_cases(T)):
            jb = json.dumps(jm.to_dict())
            tb = json.dumps(tm.to_dict())
            assert tb == jb, type(tm).__name__
            wire = json.loads(tb)
            # each package decodes the other's payload
            assert type(jm).from_dict(json.loads(tb)).to_dict() \
                == jm.to_dict()
            assert type(tm).from_dict(json.loads(jb)).to_dict() \
                == tm.to_dict()
            assert type(tm).from_dict(wire) == tm

    def test_rolling_upgrade_rules(self):
        for tm in wire_cases(T):
            wire = tm.to_dict()
            wire["a_newer_field"] = {"nested": [1]}
            assert type(tm).from_dict(wire).to_dict() == tm.to_dict()
        old = wire_cases(T)[0].to_dict()
        for drop in ("resume_tokens", "resume_step", "trace_id",
                     "parent_span", "hedge_attempt"):
            old.pop(drop)
        old["wire_version"] = 1
        back = T.RpcRequest.from_dict(old)
        assert back.resume_tokens is None and back.trace_id is None
        st = wire_cases(T)[-1].to_dict()
        for drop in ("draining", "wall_t", "sample", "prefix_tokens"):
            del st[drop]
        back = T.HostStatus.from_dict(st)
        assert back.draining is False and back.sample is None
        assert back.prefix_tokens == ()
        # a migrate request from a peer without the trace context
        mig = next(c for c in wire_cases(T)
                   if isinstance(c, T.KvMigrateRequest)).to_dict()
        for drop in ("trace_id", "parent_span"):
            del mig[drop]
        mig["wire_version"] = 1
        back = T.KvMigrateRequest.from_dict(mig)
        assert back.trace_id is None and back.parent_span is None
        assert back.first_token == 11 and back.block_size == 16

    def test_rejected_from_wire_maps_the_one_taxonomy(self):
        assert TERMINAL_REASONS == JAX_REASONS
        for reason in list(TERMINAL_REASONS) + ["not_a_reason", None]:
            got = []
            for pkg in (J, T):
                e = pkg.rejected_from_wire(reason, "msg", host=2)
                got.append((type(e).__name__, e.reason,
                            getattr(e, "host", None), str(e)))
            assert got[0] == got[1], reason
        assert isinstance(T.rejected_from_wire("host_draining", "x"),
                          T.HostDrainingError)


# --------------------------------------------------------------------------
# Across packages
# --------------------------------------------------------------------------
class TestCrossPackage:
    @pytest.mark.parametrize("server,client", [("torch", "jax"),
                                               ("jax", "torch")])
    def test_infer_status_and_streams_across_packages(self, np_params,
                                                      server, client):
        spkg, cpkg = PKGS[server], PKGS[client]
        served = Served(spkg, 3, np_params=np_params)
        try:
            remote = cpkg.RemoteHost(3, served.srv.url)
            st = remote.status()
            assert isinstance(st, cpkg.HostStatus)
            assert st.host_id == 3 and st.has_infer and st.has_generate
            assert st.slots == 2 and st.buckets == served.eng.buckets
            x = row(3)
            got = np.asarray(remote.submit_infer(
                x, timeout_ms=10_000).result(timeout=30))
            np.testing.assert_array_equal(got, host(served.eng.output(x)))
            seen = []
            h = remote.submit_generate(prompt(5), max_new_tokens=6, seed=7,
                                       on_token=seen.append)
            res = h.result(timeout=120)
            want = served.gen.generate(prompt(5), max_new_tokens=6, seed=7,
                                       timeout=120)
            assert res == want == seen and h.finish_reason == "max_tokens"
            sampled = remote.submit_generate(
                prompt(4, 1), max_new_tokens=5, seed=3, temperature=1.0,
                top_k=8).result(timeout=120)
            pid = remote.register_prefix(prompt(16, 2), prefix_id="sys")
            pref = remote.submit_generate(prompt(3, 4), max_new_tokens=4,
                                          prefix_id=pid).result(timeout=120)
            return_ = (res, sampled, pref)
        finally:
            served.stop()
        # the other package's engine, same weights: the same streams
        other = gen_engine(cpkg, np_params)
        try:
            assert other.generate(prompt(5), max_new_tokens=6, seed=7,
                                  timeout=120) == return_[0]
            assert other.generate(prompt(4, 1), max_new_tokens=5, seed=3,
                                  temperature=1.0, top_k=8,
                                  timeout=120) == return_[1]
        finally:
            other.shutdown()

    def test_jax_front_door_over_port_servers(self, np_params):
        """A JAX front door hedging over two port hosts: routing, the
        stream and the fleet accounting cross the package boundary."""
        hosts = [Served(T, i, np_params=np_params) for i in range(2)]
        try:
            d = J.ClusterDirectory(heartbeat_timeout_s=30.0)
            for i, s in enumerate(hosts):
                rem = J.RemoteHost(i, s.srv.url)
                d.join(rem)
                J.HeartbeatPump(rem, J.LoopbackTransport(d)).pump_once()
            fd = J.ClusterFrontDoor(d, hedge=J.HedgePolicy(
                hedge_after_ms=None, poll_wait_ms=20.0))
            # pinned alternately: every routed stream crosses the wire
            hs = [fd.submit_generate(prompt(5, i), max_new_tokens=5, seed=i,
                                     host=i % 2) for i in range(4)]
            hs.append(fd.submit_generate(prompt(6), max_new_tokens=5,
                                         seed=9))
            res = [h.result(timeout=120) for h in hs]
            want = [hosts[0].gen.generate(prompt(5, i), max_new_tokens=5,
                                          seed=i, timeout=120)
                    for i in range(4)]
            want.append(hosts[1].gen.generate(prompt(6), max_new_tokens=5,
                                              seed=9, timeout=120))
            assert res == want
            routed = fd.routed_by_host.to_dict()
            assert routed.get("h0", 0) >= 2 and routed.get("h1", 0) >= 2
            assert sum(routed.values()) == 5
        finally:
            for s in hosts:
                s.stop()


# --------------------------------------------------------------------------
# KV page migration across packages
# --------------------------------------------------------------------------
def page_payloads(dtype: str, seed: int = 0):
    """The same two-layer page payload as the JAX package holds it (numpy;
    bfloat16 through ``ml_dtypes``) and as the port does (CPU tensors)."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    j_layers, t_layers = [], []
    for _ in range(2):
        jl, tl = {}, {}
        if dtype == "int8":
            for k in ("k", "v"):
                a = rng.integers(-128, 128, (2, 4, 2, 8)).astype(np.int8)
                jl[k], tl[k] = a, torch.from_numpy(a.copy())
            for k in ("k_scale", "v_scale"):
                a = rng.random((2, 4, 2)).astype(np.float32)
                jl[k], tl[k] = a, torch.from_numpy(a.copy())
        else:
            for k in ("k", "v"):
                a = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
                if dtype == "bfloat16":
                    t = torch.from_numpy(a).to(torch.bfloat16)
                    # the same bits on both sides
                    jl[k] = t.view(torch.int16).numpy().view(
                        ml_dtypes.bfloat16)
                    tl[k] = t
                else:
                    jl[k], tl[k] = a, torch.from_numpy(a.copy())
        j_layers.append(jl)
        t_layers.append(tl)
    return j_layers, t_layers


def bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


class TestPageMigration:
    @pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
    def test_page_codec_equal_across_packages(self, dtype):
        """``_encode_pages`` gives the same dict from the JAX package's
        numpy leaves as from the port's tensors, and each package's
        ``_decode_pages`` reads the other's output bit for bit."""
        from deeplearning4j_tpu.serving import rpc as jrpc
        from deeplearning4j_tpu_torch.serving import rpc as trpc

        jp, tp = page_payloads(dtype)
        jw, tw = jrpc._encode_pages(jp), trpc._encode_pages(tp)
        assert tw == jw
        assert json.dumps(tw) == json.dumps(jw)
        names = {d["dtype"] for layer in tw for d in layer.values()}
        assert names == ({"int8", "float32"} if dtype == "int8"
                         else {dtype})
        t_back = trpc._decode_pages(json.loads(json.dumps(jw)))
        j_back = jrpc._decode_pages(json.loads(json.dumps(tw)))
        for tl, jl, t0, j0 in zip(t_back, j_back, tp, jp):
            assert sorted(tl) == sorted(jl) == sorted(t0)
            for k in t0:
                assert tl[k].dtype == t0[k].dtype
                assert tuple(tl[k].shape) == jl[k].shape == j0[k].shape
                assert str(jl[k].dtype) == str(j0[k].dtype)
                assert bits(tl[k]) == bits(t0[k]) == bits(jl[k]) \
                    == bits(j0[k])

    def test_undecodable_pages_degrade(self):
        from deeplearning4j_tpu_torch.serving import rpc as trpc

        _, tp = page_payloads("float32")
        wire = trpc._encode_pages(tp)
        bad_dtype = json.loads(json.dumps(wire))
        bad_dtype[0]["k"]["dtype"] = "complex64"
        short = json.loads(json.dumps(wire))
        short[1]["v"]["shape"] = [3, 4, 2, 8]
        for pages in (bad_dtype, short):
            with pytest.raises((KeyError, RuntimeError, ValueError)):
                trpc._decode_pages(pages)
        with pytest.raises(KeyError):
            trpc._encode_pages([{"k": torch.zeros(2, dtype=torch.int64)}])

    @pytest.mark.parametrize("sampling", [False, True])
    def test_jax_front_door_disagg_over_port_servers(self, np_params,
                                                     sampling):
        """A JAX ``ClusterFrontDoor(disagg=DisaggPolicy())`` over a port
        prefill host and a port decode host: the pages leave the port's
        ``/rpc/v1/migrate``, come back as the JAX package decodes them,
        and go out again to the port's decode host. The stream equals the
        JAX single-host stream."""
        kw = dict(temperature=0.8, seed=7) if sampling else dict(seed=0)
        ref_eng = gen_engine(J, np_params)
        try:
            want = [int(t) for t in ref_eng.generate(
                prompt(6), max_new_tokens=8, timeout=120, **kw)]
        finally:
            ref_eng.shutdown()
        hosts = [Served(T, i, np_params=np_params, host_class=c)
                 for i, c in enumerate(("prefill", "decode"))]
        try:
            d = J.ClusterDirectory(heartbeat_timeout_s=600.0)
            for i, s in enumerate(hosts):
                rem = J.RemoteHost(i, s.srv.url)
                d.join(rem)
                J.HeartbeatPump(rem, J.LoopbackTransport(d)).pump_once()
            fd = J.ClusterFrontDoor(d, disagg=J.DisaggPolicy())
            assert fd.disagg.enabled(d)
            got = [int(t) for t in fd.submit_generate(
                prompt(6), max_new_tokens=8, **kw).result(timeout=120)]
            assert got == want
            assert fd.metrics.kv_migrations_total.value == 1
            assert fd.metrics.kv_migrate_fallbacks_total.value == 0
            gp, gd = hosts[0].gen.metrics, hosts[1].gen.metrics
            assert gp.kv_migrate_bytes_out.value \
                == gd.kv_migrate_bytes_in.value == gd.kv_swap_bytes_in.value
            assert gp.generated_tokens_total.value == 1
            assert gd.generated_tokens_total.value == 7
        finally:
            for s in hosts:
                s.stop()

    @pytest.mark.parametrize("prefill,decode", [("jax", "torch"),
                                                ("torch", "jax")])
    def test_pages_cross_packages(self, np_params, prefill, decode):
        """A prefill host of one package ships its pages to a decode host
        of the other, each behind its own package's server; the front
        door is the decode side's package. The stream equals the JAX
        single-host stream and the decode host seats the pages."""
        ref_eng = gen_engine(J, np_params)
        try:
            want = [int(t) for t in ref_eng.generate(
                prompt(9, 4), max_new_tokens=8, timeout=120)]
        finally:
            ref_eng.shutdown()
        fpkg = PKGS[decode]
        hosts = [Served(PKGS[prefill], 0, np_params=np_params,
                        host_class="prefill"),
                 Served(PKGS[decode], 1, np_params=np_params,
                        host_class="decode")]
        try:
            d = fpkg.ClusterDirectory(heartbeat_timeout_s=600.0)
            for i, s in enumerate(hosts):
                rem = fpkg.RemoteHost(i, s.srv.url)
                d.join(rem)
                fpkg.HeartbeatPump(rem, fpkg.LoopbackTransport(d)
                                   ).pump_once()
            fd = fpkg.ClusterFrontDoor(d, disagg=fpkg.DisaggPolicy())
            got = [int(t) for t in fd.submit_generate(
                prompt(9, 4), max_new_tokens=8).result(timeout=120)]
            assert got == want
            assert fd.metrics.kv_migrations_total.value == 1
            assert fd.metrics.kv_migrate_fallbacks_total.value == 0
            gd = hosts[1].gen.metrics
            assert gd.kv_migrate_bytes_in.value \
                == hosts[0].gen.metrics.kv_migrate_bytes_out.value > 0
            assert gd.kv_swap_bytes_in.value > 0
        finally:
            for s in hosts:
                s.stop()


# --------------------------------------------------------------------------
# The server's contract
# --------------------------------------------------------------------------
class TestServer:
    def test_typed_and_malformed_requests(self, np_params):
        def run(pkg):
            served = Served(pkg, 0, np_params=np_params)
            remote = pkg.RemoteHost(0, served.srv.url, timeout_s=5.0)
            out = []
            try:
                for req in (pkg.RpcRequest(kind="teleport"),
                            pkg.RpcRequest(kind="generate", prompt=None),
                            pkg.RpcRequest(kind="infer", x=[[1.0]],
                                           x_dtype="bogus"),
                            pkg.RpcRequest(kind="generate", prompt=[1],
                                           prefix_id="nope"),
                            pkg.RpcRequest(kind="infer", x=row().tolist(),
                                           timeout_ms=0.0)):
                    resp = pkg.RpcResponse.from_dict(remote._rpc(
                        f"{RPC_PREFIX}/submit", req.to_dict(), point=None))
                    out.append((resp.ok, resp.error_reason))
                for path, body in ((f"{RPC_PREFIX}/result",
                                    {"stream_id": "op-999", "wait_ms": 1}),
                                   (f"{RPC_PREFIX}/stream",
                                    {"stream_id": "op-999"}),
                                   (f"{RPC_PREFIX}/cancel",
                                    {"stream_id": "op-999"})):
                    raw = remote._rpc(path, body, point=None)
                    out.append((raw.get("ok"), raw.get("done"),
                                raw.get("error_reason"), raw.get("found")))
                with pytest.raises(pkg.RpcError) as ei:
                    remote._rpc(f"{RPC_PREFIX}/nowhere", {}, point=None)
                out.append(ei.value.reason)
            finally:
                served.stop()
            with pytest.raises(pkg.HostUnavailableError) as ei:
                remote.submit_infer(row())
            out.append((ei.value.reason, ei.value.__cause__ is not None))
            return out

        out = both(run)
        assert out[:5] == [(False, "rpc_error"), (False, "client_error"),
                           (False, "client_error"), (False, "client_error"),
                           (False, "deadline")]

    def test_terminal_survives_a_lost_response_and_ttl(self):
        served = Served(T, 0)
        remote = T.RemoteHost(0, served.srv.url)
        try:
            resp = T.RpcResponse.from_dict(remote._rpc(
                f"{RPC_PREFIX}/submit",
                T.RpcRequest(kind="infer", x=row().tolist(),
                             x_dtype="float32").to_dict(), point=None))
            assert resp.ok
            polls = [T.RpcResponse.from_dict(remote._rpc(
                f"{RPC_PREFIX}/result",
                {"stream_id": resp.stream_id, "wait_ms": 5_000},
                point=None)) for _ in range(2)]
            for p in polls:
                assert p.ok and p.done and p.result == polls[0].result
            srv = served.srv
            state = srv._op(resp.stream_id)
            state.created_t -= 10 * srv.OP_TTL_S
            srv._gc()
            assert srv._op(resp.stream_id) is not None
            state.resolved_t -= 10 * srv.OP_TTL_S
            srv._gc()
            assert srv._op(resp.stream_id) is None
        finally:
            served.stop()

    def test_open_ops_ledger_and_shutdown_law(self, np_params):
        """A stream held in flight is one open op (and the engines'
        ``open_ops`` gauge says so); once it resolves and the server
        stops, the ledger's RPC dimension reads zero and the shutdown law
        holds."""
        gate, entered = threading.Event(), threading.Event()

        def hold(_tok):
            entered.set()
            gate.wait(30)

        served = Served(T, 5, np_params=np_params)
        watch = T.LeakWatch()
        ledger = T.ResourceLedger(engines=[served.gen, served.eng],
                                  rpc_servers=[served.srv])
        try:
            remote = T.RemoteHost(5, served.srv.url)
            served.gen.submit(prompt(3), max_new_tokens=2, on_token=hold)
            assert entered.wait(30)
            h = remote.submit_generate(prompt(4), max_new_tokens=3)
            deadline = time.time() + 10
            while served.srv.open_ops() == 0 and time.time() < deadline:
                time.sleep(0.01)
            assert served.srv.open_ops() == 1
            assert ledger.snapshot().get("rpc[h5].open_ops") == 1
            served.srv._gc()
            assert served.gen.metrics.open_ops.value == 1
            gate.set()
            h.result(timeout=120)
            deadline = time.time() + 10
            while served.srv.open_ops() and time.time() < deadline:
                time.sleep(0.01)
            assert ledger.snapshot().get("rpc[h5].open_ops") == 0
        finally:
            gate.set()
            served.stop()
        assert T.check_shutdown(served.srv) == []
        assert served.srv in T.tracked_rpc_servers()
        assert watch.finish(settle_s=5.0) == []


# --------------------------------------------------------------------------
# Deadline propagation
# --------------------------------------------------------------------------
class TestDeadlinePropagation:
    def test_frozen_clock_budget_and_spent_budget(self):
        def run(pkg):
            fc = FakeClock()
            served = Served(pkg, 0, clock=fc)
            remote = pkg.RemoteHost(0, served.srv.url, clock=fc)
            try:
                remote.submit_infer(row(), timeout_ms=50.0).result(
                    timeout=30)
                arrived = served.srv.last_arrival_budget_ms
                calls = served.eng.adapter.calls
                deadline_t = remote._deadline_t(50.0)
                fc.advance(0.060)
                with pytest.raises(pkg.RejectedError) as ei:
                    remote.submit_infer(row(), timeout_ms=remote._budget_ms(
                        deadline_t))
                return (round(arrived, 6), ei.value.reason,
                        served.eng.adapter.calls - calls)
            finally:
                served.stop()

        assert both(run) == (50.0, "deadline", 0)

    def test_redispatch_ships_only_the_remaining_budget(self, np_params):
        fc = FakeClock()
        served = Served(T, 0, np_params=np_params)
        remote = T.RemoteHost(0, served.srv.url, clock=fc)
        try:
            deadline_t = remote._deadline_t(50.0)
            remote.open_stream(prompt(4), max_new_tokens=1,
                               deadline_t=deadline_t)
            assert served.srv.last_arrival_budget_ms == pytest.approx(50.0)
            fc.advance(0.030)
            remote.open_stream(prompt(4), max_new_tokens=1,
                               deadline_t=deadline_t, hedge_attempt=1)
            assert served.srv.last_arrival_budget_ms == pytest.approx(20.0)
        finally:
            served.stop()

    def test_result_poller_backstops_a_wedged_remote(self):
        fc = FakeClock()
        served = Served(T, 0, delay_s=3.0)
        remote = T.RemoteHost(0, served.srv.url, clock=fc,
                              poll_wait_ms=20.0)
        try:
            fut = remote.submit_infer(row(), timeout_ms=50.0)
            fc.advance(60.0)
            with pytest.raises(T.RejectedError) as ei:
                fut.result(timeout=10)
            assert ei.value.reason == "deadline"
        finally:
            served.stop()


# --------------------------------------------------------------------------
# Chaos on the wire
# --------------------------------------------------------------------------
class TestRpcChaos:
    def test_seeded_plan_same_schedule_and_outcomes(self):
        def run(pkg):
            served = Served(pkg, 0)
            remote = pkg.RemoteHost(0, served.srv.url)
            plan = (pkg.FaultPlan(seed=42)
                    .fail("rpc.dispatch", rate=0.3)
                    .poison("rpc.response", lambda raw: {"wat": 1},
                            rate=0.2))
            outcomes = []
            try:
                with plan:
                    for _ in range(16):
                        try:
                            outcomes.append(host(remote.submit_infer(
                                row()).result(timeout=30)).tolist())
                        except pkg.RejectedError as e:
                            outcomes.append(e.reason)
                return ([(e["point"], e["index"], e["kind"])
                         for e in plan.fired()], outcomes)
            finally:
                served.stop()

        fired, outcomes = both(run)
        reasons = {o for o in outcomes if isinstance(o, str)}
        assert reasons == {"host_unavailable", "rpc_error"}
        assert any(isinstance(o, list) for o in outcomes)
        assert {k for _, _, k in fired} == {"fail", "poison"}

    def test_dropped_and_poisoned_streams_fail_typed(self, np_params):
        def run(pkg):
            served = Served(pkg, 0, np_params=np_params)
            remote = pkg.RemoteHost(0, served.srv.url, poll_wait_ms=25.0)
            out = []
            try:
                remote.submit_generate(prompt(4), max_new_tokens=1,
                                       seed=1).result(timeout=120)
                with pkg.FaultPlan(seed=0).fail("rpc.stream", at=(0,)):
                    h = remote.submit_generate(prompt(4), max_new_tokens=4,
                                               seed=2)
                    with pytest.raises(pkg.HostUnavailableError) as ei:
                        h.result(timeout=120)
                    out.append(ei.value.reason)
                # every stream chunk's tokens nulled (other payloads pass:
                # the lost stream's late cancel may still be in flight)
                with pkg.FaultPlan(seed=0).poison(
                        "rpc.response",
                        lambda raw: dict(raw, tokens=None)
                        if "tokens" in raw else raw, rate=1.0):
                    h = remote.submit_generate(prompt(4), max_new_tokens=4,
                                               seed=2)
                    with pytest.raises(pkg.RpcError) as ei:
                        h.result(timeout=120)
                    out.append(ei.value.reason)
                with pkg.FaultPlan(seed=0).fail("rpc.dispatch", at=(0,)):
                    with pytest.raises(pkg.HostUnavailableError) as ei:
                        remote.submit_infer(row())
                    out.append((ei.value.reason, served.srv.submits))
                with pkg.FaultPlan(seed=0).delay("rpc.dispatch", 60.0,
                                                 at=(0,)) as p:
                    t0 = time.perf_counter()
                    remote.submit_infer(row()).result(timeout=30)
                    out.append((time.perf_counter() - t0 >= 0.055,
                                [e["kind"] for e in p.fired()]))
                return out
            finally:
                served.stop()

        out = both(run)
        assert out[:2] == ["host_unavailable", "rpc_error"]
        assert out[3] == (True, ["delay"])


    def test_seeded_plan_through_a_two_host_front_door(self, np_params):
        """The same seeded plan on ``rpc.dispatch``, ``rpc.stream`` and
        ``rpc.response`` through each package's ``ClusterFrontDoor`` over
        two real hosts: the same calls fire and every request ends the
        same — its tokens, or its typed shed — by the same path over the
        hosts (routes and losses from its front-door trace). Requests go
        one at a time and each host answers its admit with the whole
        stream in place (one dispatch and one poll an attempt), so the
        order of the calls does not depend on the engines' speed."""
        def run(pkg):
            hosts = [Served(pkg, i, np_params=np_params, settled=True)
                     for i in range(2)]
            try:
                d = pkg.ClusterDirectory(heartbeat_timeout_s=300.0)
                for i, s in enumerate(hosts):
                    rem = pkg.RemoteHost(i, s.srv.url)
                    d.join(rem)
                    pkg.HeartbeatPump(rem, pkg.LoopbackTransport(d)
                                      ).pump_once()
                tracer = pkg.Tracer(sample_rate=1.0, capacity=64)
                fd = pkg.ClusterFrontDoor(d, tracer=tracer,
                                          hedge=pkg.HedgePolicy(
                                              hedge_after_ms=None,
                                              max_attempts=3,
                                              poll_wait_ms=20.0))
                reqs = [(prompt(4 + i % 3, i), i) for i in range(12)]
                clean = [fd.submit_generate(p, max_new_tokens=5, seed=sd,
                                            tenant=f"r{k}").result(
                                                timeout=120)
                         for k, (p, sd) in enumerate(reqs)]
                plan = (pkg.FaultPlan(seed=5)
                        .fail("rpc.dispatch", rate=0.3)
                        .fail("rpc.stream", rate=0.2)
                        .poison("rpc.response",
                                lambda raw: dict(raw, tokens=None)
                                if "tokens" in raw else raw, rate=0.2))
                out = []
                with plan:
                    for k, (p, sd) in enumerate(reqs):
                        h = fd.submit_generate(p, max_new_tokens=5, seed=sd,
                                               tenant=f"c{k}")
                        try:
                            out.append(h.result(timeout=120))
                        except pkg.RejectedError as e:
                            out.append(e.reason)
                paths = {}
                for t in tracer.traces():
                    if t.kind == "cluster.generate" \
                            and t.tenant.startswith("c"):
                        paths[int(t.tenant[1:])] = [
                            (n, a["host"], a.get("reason"))
                            for n, _, a in t.events
                            if a and "host" in a and n in (
                                "cluster.route", "cluster.bounce")]
                fired = [(e["point"], e["index"], e["kind"])
                         for e in plan.fired()]
                return (clean, out, [paths[k] for k in range(len(reqs))],
                        fired, fd.hedges.to_dict(),
                        fd.metrics.rejections_by_reason.to_dict())
            finally:
                for s in hosts:
                    s.stop()

        clean, out, paths, fired, hedges, sheds = both(run)
        ok = [k for k, o in enumerate(out) if isinstance(o, list)]
        shed = [k for k, o in enumerate(out) if not isinstance(o, list)]
        # every request that ends with tokens ends with its clean stream;
        # a shed is typed and follows a loss on each of the two hosts
        assert ok and shed and all(out[k] == clean[k] for k in ok)
        assert {out[k] for k in shed} == {"host_unavailable"}
        assert all(sorted({h for n, h, _ in paths[k]
                           if n == "cluster.bounce"}) == [0, 1]
                   for k in shed)
        assert {r for p in paths for n, _, r in p if n == "cluster.bounce"} \
            == {"host_unavailable", "rpc_error"}
        assert hedges.get("redispatch", 0) > 0
        assert sheds == {"host_unavailable": float(len(shed))}
        assert {p for p, _, _ in fired} == {"rpc.dispatch", "rpc.stream",
                                            "rpc.response"}


# --------------------------------------------------------------------------
# Resume from the delivery watermark over a real host
# --------------------------------------------------------------------------
def dying_host(pkg, die_after):
    """A ``RemoteHost`` whose streams deliver exactly ``die_after``
    tokens (counted from the stream's first token, a resumed attempt's
    included) and then lose the host, typed ``host_unavailable``."""
    class Dying:
        def __init__(self, stream):
            self.stream = stream
            self.host_id = stream.host_id
            self.stream_id = stream.stream_id
            self.resume_step = stream.resume_step

        def poll(self, cursor, wait_ms):
            at = self.resume_step + cursor
            if at >= die_after:
                raise pkg.HostUnavailableError("host lost",
                                               host=self.host_id)
            chunk = self.stream.poll(cursor, wait_ms)
            if at + len(chunk.tokens) >= die_after:
                chunk.tokens = chunk.tokens[:die_after - at]
                chunk.done, chunk.finish_reason = False, None
            return chunk

        def cancel(self):
            self.stream.cancel()

    class DyingHost(pkg.RemoteHost):
        def open_stream(self, prompt, **kwargs):
            return Dying(super().open_stream(prompt, **kwargs))
    return DyingHost


class TestResume:
    @pytest.mark.parametrize("sampling", [
        {}, {"temperature": 1.0, "top_k": 8}], ids=["greedy", "sampled"])
    def test_resumed_stream_over_rpc_equals_jax(self, np_params, sampling):
        """A stream seated at a resume point over the wire (the server's
        resume seat: one recompute prefill, next token at index r), and a
        stream the front door resumes on a second real host after the
        first lost it at token 3 (its attempt pre-seeded with the
        delivered prefix): both end in the uninterrupted stream, token
        for token, and equal the JAX package's."""
        def run(pkg):
            hosts = [Served(pkg, i, np_params=np_params) for i in range(2)]
            try:
                kw = dict(max_new_tokens=8, seed=7, **sampling)
                clean = hosts[1].gen.generate(prompt(5), timeout=120, **kw)
                rem = pkg.RemoteHost(1, hosts[1].srv.url)
                seated = [rem.submit_generate(
                    prompt(5), resume_tokens=clean[:r], resume_step=r,
                    **kw).result(timeout=120) for r in (1, 4, 7)]
                d = pkg.ClusterDirectory(heartbeat_timeout_s=300.0)
                for i, cls in ((0, dying_host(pkg, 3)),
                               (1, pkg.RemoteHost)):
                    h = cls(i, hosts[i].srv.url)
                    d.join(h)
                    pkg.HeartbeatPump(h, pkg.LoopbackTransport(d)
                                      ).pump_once()
                tracer = pkg.Tracer(sample_rate=1.0, capacity=8)
                fd = pkg.ClusterFrontDoor(d, tracer=tracer,
                                          hedge=pkg.HedgePolicy(
                                              hedge_after_ms=None,
                                              max_attempts=3,
                                              poll_wait_ms=20.0))
                seen = []
                res = fd.submit_generate(prompt(5), on_token=seen.append,
                                         **kw).result(timeout=120)
                events = [(n, a.get("host"), a.get("resume_step"))
                          for t in tracer.traces() for n, _, a in t.events
                          if a and n in ("cluster.route", "stream.resume")]
                return (clean, seated, res, seen, events,
                        fd.metrics.stream_resumes_total.value,
                        hosts[1].gen.metrics.stream_resumes_total.value)
            finally:
                for s in hosts:
                    s.stop()

        clean, seated, res, seen, events, fd_resumes, host_resumes = \
            both(run)
        assert seated == [clean[1:], clean[4:], clean[7:]]
        assert res == seen == clean
        assert events == [("cluster.route", 0, None),
                          ("cluster.route", 1, None),
                          ("stream.resume", 1, 3)]
        assert fd_resumes == 1 and host_resumes == 4


# --------------------------------------------------------------------------
# Graceful drain over the wire
# --------------------------------------------------------------------------
class TestDrain:
    def test_remote_drain_finishes_residents_then_sheds(self, np_params):
        def run(pkg):
            served = Served(pkg, 1, np_params=np_params)
            remote = pkg.RemoteHost(1, served.srv.url)
            try:
                h = remote.submit_generate(prompt(5), max_new_tokens=8,
                                           seed=4)
                drained = remote.drain(timeout=60.0)
                res = h.result(timeout=120)
                st = remote.status()
                with pytest.raises(pkg.HostDrainingError) as ei:
                    remote.submit_generate(prompt(3), max_new_tokens=2)
                return (drained, res, st.draining, ei.value.reason,
                        served.gen.drained)
            finally:
                served.stop()

        drained, res, flag, reason, gen_drained = both(run)
        assert drained is True and len(res) == 8 and flag is True
        assert reason == "host_draining" and gen_drained is True
