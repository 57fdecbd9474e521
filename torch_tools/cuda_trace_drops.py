#!/usr/bin/env python3
"""Count how often ``torch.profiler``'s CUDA tracer misses a kernel record.

Why ``deeplearning4j_tpu_torch.profiler.cuda_launches`` reads a call's
CUDA launches (name, grid, block, shared memory) from a captured CUDA
graph and not from the profiler's kernel records: this script runs the
attention calls that ``chip_smoke.py``'s head dims phase reads (packed
forward and backward, streamed forward, dq and dk/dv, bf16, at head dims
8 and 160) many times, each call in a profiling session of its own, read
these ways, in turns:

- ``bare``: one session around one call (the read before the tracer was
  seen to drop records);
- ``warmup``: one session with ``schedule(wait=0, warmup=1, active=1)``:
  the call runs twice and only the second is recorded;
- ``acc_events``: a bare session with ``acc_events=True``;
- ``forced``: a bare session that asks CUPTI, before the session ends,
  to hand over every activity buffer, the unfinished ones too
  (``cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)`` on the
  libcupti the process loaded);
- ``padNN``: a bare session that idles NN ms on the host before the call
  and again after it has finished, so the session's window is wider than
  any skew between the host's and the device's clocks below NN ms.

It prints one JSON line per (call, way): the sessions run, the sessions
whose record is short of the call's launches, and the sessions whose
record is longer. Needs one card; from the repo root:

    python3 torch_tools/cuda_trace_drops.py [--sessions 100] [--ways bare,forced]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def kernels_of(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("cat") == "kernel"]


def flush_cupti():
    """cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED) on the
    libcupti this process loaded (the profiler's own)."""
    import ctypes
    with open("/proc/self/maps") as f:
        paths = [line.split()[-1] for line in f if "libcupti" in line]
    if not paths:
        raise RuntimeError("no libcupti in this process")
    ctypes.CDLL(paths[0]).cuptiActivityFlushAll(ctypes.c_uint32(1))


def read(fn, way: str) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    if way == "warmup":
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.append(
                         len(kernels_of(p)))) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        return got[0] if got else 0
    kw = {"acc_events": True} if way == "acc_events" else {}
    pad = int(way[3:]) / 1e3 if way.startswith("pad") else 0.0
    with profile(activities=[ProfilerActivity.CUDA], **kw) as prof:
        time.sleep(pad)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad)
        if way == "forced":
            flush_cupti()
    return len(kernels_of(prof))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=100)
    ap.add_argument("--ways", default="bare,warmup,acc_events,forced")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    rng = np.random.default_rng(0)
    for d in (8, 160):
        def rand(shape):
            return torch.as_tensor(rng.standard_normal(shape),
                                   dtype=torch.float32).to("cuda",
                                                           torch.bfloat16)

        q, k, v, do = (rand((2, 128, 4 * d)) for _ in range(4))
        qs, ks_, vs_, dos = (rand((4, 256, d)) for _ in range(4))
        _, lse = ak.mha_packed_forward(q, k, v, 4)
        o, slse = ak.flash_forward(qs, ks_, vs_)
        delta = (dos.float() * o.float()).sum(-1).reshape(4, 1, 256)
        calls = {
            "packed forward": (lambda: ak.mha_packed_forward(q, k, v, 4), 1),
            "packed backward": (
                lambda: ak.mha_packed_backward(q, k, v, do, lse, 4), 2),
            "streamed forward": (lambda: ak.flash_forward(qs, ks_, vs_), 1),
            "streamed dq": (lambda: ak.flash_bwd_dq(
                qs, ks_, vs_, dos, slse, delta), 1),
            "streamed dk/dv": (lambda: ak.flash_bwd_dkv(
                qs, ks_, vs_, dos, slse, delta), 1)}
        ways = args.ways.split(",")
        for name, (fn, want) in calls.items():
            fn()
            got = {way: [] for way in ways}
            for _ in range(args.sessions):
                for way in ways:
                    got[way].append(read(fn, way))
            for way, counts in got.items():
                print(json.dumps({
                    "d": d, "call": name, "way": way, "launches": want,
                    "sessions": len(counts),
                    "short": sum(c < want for c in counts),
                    "long": sum(c > want for c in counts)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
