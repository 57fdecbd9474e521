#!/usr/bin/env python3
"""Whether ``chip_smoke.py``'s disagg phase loses an HTTP call, and how
the loopback TCP stack behaved while it ran.

Builds the kernels, runs the engine phase (the reference streams) and the
front door phase once, then ``chip_smoke.disagg_phase`` ``--runs`` times,
each with fresh host processes. Each run prints one JSON line: pass or
the failed check, its wall seconds, part b's handshakes tried again on a
fresh socket (``RemoteHost.connect_retries``, per host), its slowest
call per HTTP path, and the change over the run of the kernel's TCP
counters in ``/proc/net/netstat`` and ``/proc/net/snmp`` (listen queue
overflows, SYN retransmits, TIME_WAIT handling; counters that did not
move are left out). The first line holds the TCP settings read from
``/proc/sys/net``; nothing is written there.

Needs one card; from the repo root:
``python3 torch_tools/disagg_probe.py [--runs N]``
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SETTINGS = ("core/somaxconn", "ipv4/tcp_syncookies", "ipv4/tcp_tw_reuse",
            "ipv4/tcp_max_tw_buckets", "ipv4/tcp_max_syn_backlog",
            "ipv4/tcp_syn_retries", "ipv4/tcp_timestamps",
            "ipv4/ip_local_port_range", "netfilter/nf_conntrack_max",
            "netfilter/nf_conntrack_count")


def tcp_settings() -> dict:
    out = {}
    for name in SETTINGS:
        try:
            with open(f"/proc/sys/net/{name}") as f:
                out[name] = f.read().split()
        except OSError:
            out[name] = None
    return out


def tcp_counters() -> dict:
    """Every ``TcpExt``/``Tcp`` counter as ``{"TcpExt.Name": int}``."""
    out = {}
    for path in ("/proc/net/netstat", "/proc/net/snmp"):
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for head, vals in zip(lines[::2], lines[1::2]):
            kind, names = head.split(":", 1)
            if kind not in ("TcpExt", "Tcp"):
                continue
            for k, v in zip(names.split(), vals.split(":", 1)[1].split()):
                try:
                    out[f"{kind}.{k}"] = int(v)
                except ValueError:
                    pass
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=8)
    args = ap.parse_args()

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models import TransformerConfig, init_params

    print(json.dumps({"tcp_settings": tcp_settings()}), flush=True)
    cs.build()
    cfg = TransformerConfig(causal=True, remat=False, attention_impl="flash")
    params = init_params(cfg, seed=0, device="cuda")
    prompts = cs.chat_mix(cfg.vocab_size, max_len=cfg.max_seq)
    engine = cs.engine_phase(cfg, params, prompts)
    front = cs.front_door_phase(cfg, params, prompts,
                                engine["float32"]["streams"],
                                engine["float32"]["decode_tokens_per_sec"])
    failed = 0
    for run in range(args.runs):
        c0, t0 = tcp_counters(), time.perf_counter()
        row = dict(run=run, ok=True, error=None)
        try:
            rpc = cs.disagg_phase(cfg, params, prompts, engine, front)["rpc"]
            row.update(connect_retries=rpc["connect_retries"],
                       http_ms_max=rpc["http_ms_max"])
        except AssertionError as e:
            row.update(ok=False, error=str(e)[:2000])
            failed += 1
        c1 = tcp_counters()
        row.update(s=time.perf_counter() - t0,
                   tcp_delta={k: c1[k] - c0.get(k, 0) for k in sorted(c1)
                              if c1[k] != c0.get(k, 0)})
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print(json.dumps({"runs": args.runs, "failed": failed}))
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
