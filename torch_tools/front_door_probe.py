#!/usr/bin/env python3
"""Why ``chip_smoke.py``'s front door phase runs each host as a process.

Replays the engine phase's mix (BERT-base causal LM, bf16, flash, seeded
weights, the 32-request chat mix, 64 new tokens greedy, one arrival
every 20 ms) through a hedging ``ClusterFrontDoor`` over two generation
hosts (16 slots, max_len 512, 16-token blocks, fused paged decode, each
behind ``HostRpcServer`` and reached through ``RemoteHost``), laid out
two ways, and prints one JSON line per layout: wall seconds, tokens/s,
TTFT and latency p50/p99, streams routed per host, hedges, and each
host's decode steps, prefills and mean decode-step and prefill ms:

- ``in_process``: both hosts' engines and servers in this process, with
  the front door and the clients;
- ``processes``: each host a process of its own
  (``chip_smoke.HostProcess``, as the front door phase runs them).

Needs one card; from the repo root: ``python3 torch_tools/front_door_probe.py``
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

SPACING_S = 0.02


def replay(urls, prompts, max_new):
    from deeplearning4j_tpu_torch.serving import (
        ClusterDirectory, ClusterFrontDoor, HeartbeatPump, HedgePolicy,
        LoopbackTransport, RemoteHost)

    d = ClusterDirectory(heartbeat_timeout_s=30.0)
    pumps = []
    for i, url in enumerate(urls):
        rem = RemoteHost(i, url)
        d.join(rem)
        pump = HeartbeatPump(rem, LoopbackTransport(d), interval_s=0.2)
        pump.pump_once()
        pumps.append(pump.start())
    fd = ClusterFrontDoor(d, hedge=HedgePolicy(
        hedge_after_ms=5000.0, max_attempts=3, poll_wait_ms=50.0))
    first, done, handles = {}, {}, []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        time.sleep(max(0.0, t0 + i * SPACING_S - time.perf_counter()))
        t_sub = time.perf_counter()

        def on_tok(_t, i=i, t_sub=t_sub):
            first.setdefault(i, (time.perf_counter() - t_sub) * 1e3)
        h = fd.submit_generate(p, max_new_tokens=max_new, seed=0,
                               on_token=on_tok)
        h.future.add_done_callback(
            lambda _f, i=i, t_sub=t_sub: done.__setitem__(
                i, (time.perf_counter() - t_sub) * 1e3))
        handles.append(h)
    outs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    for pump in pumps:
        pump.stop()
    ttft, lat = list(first.values()), list(done.values())
    return {"wall_s": wall,
            "tokens_per_sec": sum(len(o) for o in outs) / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)),
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "routed_by_host": fd.routed_by_host.to_dict(),
            "hedges": fd.hedges.to_dict()}, outs


def in_process(cfg, prompts, max_new):
    from deeplearning4j_tpu_torch.models import init_params
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, HostRpcServer, LoopbackHost)

    params = init_params(cfg, seed=0, device="cuda")
    engines = [GenerationEngine(params, cfg, slots=16, max_len=cfg.max_seq,
                                block_size=16, kv_dtype="float32",
                                paged_attention="fused", queue_capacity=48,
                                name=f"probe-h{i}") for i in range(2)]
    servers = []
    try:
        for g in engines:
            g.warmup()
        base = [(g.metrics.decode_steps_total.value,
                 g.metrics.prefills_total.value) for g in engines]
        servers = [HostRpcServer(LoopbackHost(i, generation=g))
                   for i, g in enumerate(engines)]
        stats, outs = replay([s.url for s in servers], prompts, max_new)
        stats["hosts"] = [{
            "decode_steps": g.metrics.decode_steps_total.value - b[0],
            "prefills": g.metrics.prefills_total.value - b[1],
            "decode_step_ms_mean": g.metrics.decode_step_ms.mean,
            "prefill_ms_mean": g.metrics.prefill_ms.mean}
            for g, b in zip(engines, base)]
        return stats, outs
    finally:
        for s in servers:
            s.stop()
        for g in engines:
            g.shutdown()


def processes(cfg, prompts, max_new):
    import chip_smoke

    hosts = [chip_smoke.HostProcess(i, cfg, "cuda") for i in range(2)]
    try:
        urls = [h.start() for h in hosts]
        before = [h.ask("report") for h in hosts]
        stats, outs = replay(urls, prompts, max_new)
        after = [h.ask("report") for h in hosts]
        stats["hosts"] = [{
            "decode_steps": a["decode_steps"] - b["decode_steps"],
            "prefills": a["prefills"] - b["prefills"],
            "decode_step_ms_mean": a["decode_step_ms_mean"],
            "prefill_ms_mean": a["prefill_ms_mean"]}
            for a, b in zip(after, before)]
        for h in hosts:
            h.stop()
        return stats, outs
    finally:
        for h in hosts:
            h.kill()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("front_door_probe: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from deeplearning4j_tpu_torch.models import TransformerConfig
    from deeplearning4j_tpu_torch.ops import _build

    _build.build()
    chip_smoke.probe()
    cfg = TransformerConfig(causal=True, remat=False, attention_impl="flash")
    prompts = chip_smoke.chat_mix(cfg.vocab_size, max_len=cfg.max_seq)
    ref = None
    for name, layout in (("in_process", in_process),
                         ("processes", processes)):
        stats, outs = layout(cfg, prompts, 64)
        ref = outs if ref is None else ref
        stats.update(layout=name, streams_equal_first_layout=outs == ref,
                     threads=threading.active_count(), card=chip_smoke.CARD)
        print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
