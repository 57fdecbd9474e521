#!/usr/bin/env python3
"""Repeat the serving path's device calls and count results that differ
from the first call's, bit for bit.

The serving engine's streams are held token for token against each
other (``chip_smoke.py``'s fleet phases against its engine phase), which
rests on every call of the decode and prefill steps giving the same bits
for the same inputs. This script checks that assumption at the engine's
shapes (BERT-base widths: 12 heads of 64, 16 slots, 16-token blocks):

- ``packed T<n>``: the packed attention forward kernel (row 1) at the
  prefill buckets 16-128, causal, bf16;
- ``paged <pool>``: the paged decode kernel (row 6) over a 513-block
  bf16 or int8 pool, 16 slots at seeded positions;
- ``linear <m>x<k>x<n>``: ``F.linear`` in bf16 at the decode step's qkv
  and MLP shapes (m = 16) and a prefill's (m = 128).

Each case runs ``--calls`` times after a first call; the count of calls
whose result differs anywhere from the first, and the largest difference,
accumulate on the device. With ``--procs N`` it runs in N processes at
once, as a fleet's host processes share one card, and ``--burn`` adds a
process of large bf16 matmuls beside them. Prints one JSON line per case
and process, then how many processes saw a differing call; exits 1 when
any call differed. Needs one card; from the repo root:

    python3 torch_tools/determinism_stress.py [--calls 2000] [--procs 2] [--burn]
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

H, D, S, B, NB, NBMAX = 12, 64, 16, 16, 513, 32


def cases(torch, seed: int):
    """(label, fn) over seeded inputs on the card."""
    import numpy as np
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.models import quantize_kv
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    rng = np.random.default_rng(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to("cuda", dtype)

    out = []
    for t in (16, 32, 64, 128):
        q, k, v = (randn(1, t, H * D) for _ in range(3))
        out.append((f"packed T{t}",
                    lambda q=q, k=k, v=v: ak.mha_packed_forward(
                        q, k, v, H, True, None, torch.float32)[0]))
    pos = torch.as_tensor(rng.integers(0, NBMAX * B, S).astype(np.int32),
                          device="cuda")
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = torch.as_tensor(perm[:S * NBMAX].reshape(S, NBMAX),
                             device="cuda")
    for pool in ("bf16", "int8"):
        q = randn(S, H, D)
        kf, vf = (randn(NB, B, H, D, dtype=torch.float32) for _ in range(2))
        if pool == "int8":
            (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
        else:
            kp, vp, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
        out.append((f"paged {pool}", lambda q=q, kp=kp, vp=vp, ks=ks, vs=vs:
                    ak.paged_decode_attention(q, kp, vp, tables, pos,
                                              block_size=B, k_scale=ks,
                                              v_scale=vs)))
    for m, k, n in ((16, 768, 2304), (16, 768, 3072), (16, 3072, 768),
                    (16, 768, 30522), (128, 768, 3072)):
        x, w = randn(m, k), randn(n, k)
        out.append((f"linear {m}x{k}x{n}",
                    lambda x=x, w=w: F.linear(x, w)))
    return out


def stress(calls: int, seed: int) -> int:
    import torch

    differing = 0
    for label, fn in cases(torch, seed):
        ref = fn().clone()
        bad = torch.zeros((), dtype=torch.int64, device="cuda")
        worst = torch.zeros((), dtype=torch.float32, device="cuda")
        t0 = time.perf_counter()
        for _ in range(calls):
            got = fn()
            diff = (got.float() - ref.float()).abs()
            bad += (got != ref).any()
            worst = torch.maximum(worst, diff.max())
        torch.cuda.synchronize()
        n = int(bad.item())
        differing += n
        print(json.dumps({"pid": os.getpid(), "case": label, "calls": calls,
                          "differing_calls": n,
                          "max_abs_diff": float(worst.item()),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return differing


def burn(seconds: float):
    import torch

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--burn", action="store_true",
                    help="run large bf16 matmuls in another process")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--burn-only", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("determinism_stress: needs a CUDA card", file=sys.stderr)
        return 1
    if args.burn_only is not None:
        burn(args.burn_only)
        return 0
    if args.worker:
        return 1 if stress(args.calls, args.seed) else 0
    from deeplearning4j_tpu_torch.ops import _build

    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "toolchain": _build.toolchain().splitlines()[-1]}),
          flush=True)
    me = [sys.executable, os.path.abspath(__file__)]
    procs = [subprocess.Popen(me + ["--worker", "--calls", str(args.calls),
                                    "--seed", str(args.seed)])
             for _ in range(args.procs)]
    burner = subprocess.Popen(me + ["--burn-only", "600"]) \
        if args.burn else None
    rcs = [p.wait() for p in procs]
    if burner is not None:
        burner.kill()
        burner.wait()
    print(json.dumps({"workers_with_differences": sum(1 for rc in rcs
                                                      if rc),
                      "worker_exit_codes": rcs}))
    return 1 if any(rcs) else 0


if __name__ == "__main__":
    sys.exit(main())
