#!/usr/bin/env python3
"""The device mesh across cards: N processes, one card each, over NCCL.

``chip_smoke.py``'s ``mesh`` phase runs the mesh at world size 1 (the
collectives over one rank) and the ring's schedule in one process. This
script runs what exists only across cards, each part against what it
should equal:

- ``ring``: the kernel ring (plain and causal) and the zigzag over a
  context axis of N at the long-context attention shape (B=2, H=12,
  T=8192, D=64, bf16): forward and backward gathered on rank 0 and held
  bit for bit against ``ring_flash_loop`` / ``zigzag_ring_flash_loop``
  over N virtual ranks on that card; each rank's launches of rows 3-5
  (plain N, causal rank+1, zigzag 2N+1); the ms of one forward and
  backward;
- ``ulysses``: Ulysses over the same axis (its local attention through
  the streamed kernels), bidirectional, against ``flash_attention`` over
  the whole T on rank 0, by the attention checks of ``chip_smoke.py``
  (bidirectional: a causal first row's dq is ~0, so a floor in units of
  its rms holds nothing);
- ``long context``: the causal LM (B=2, T=8192, BERT-base widths, 12
  layers, seeded weights) under ``{context: N}`` (the ring in every
  layer) against the meshless step on each card: the losses of 1
  warm-up and 2 timed steps within 1e-3 relative, the launches, tokens/s
  a card;
- ``mlm``: bench.py's MLM step (B=96, T=512) under ``{data: N/2,
  model: 2}`` (the packed kernel on each rank's 6 heads) against the
  meshless step: losses of 2 warm-up and 3 timed steps within 1e-3
  relative, tokens/s a card;
- ``serving``: ``chip_smoke.py``'s engine phase (BERT-base widths as a
  causal LM, seeded weights, 16 slots, the 32-request chat mix, 64 new
  tokens, the fused route, an fp32 pool) through the sharded
  ``GenerationEngine`` under ``{model: N}`` and ``{data: N/2, model:
  2}`` — rank 0 schedules, every rank launches on its heads — against
  the meshless engine on rank 0's card: in fp32 every stream
  token-equal, in bf16 the share of streams token-equal; decode tokens/s
  and TTFT p50 a card, the plans' share of a decode step, the peak
  memory of each card.

Each rank joins through ``multihost.initialize`` on a ``file://`` store
under ``chiprun_out/`` and logs to ``chiprun_out/mesh_probe.rankR.log``;
the launcher waits for all of them (``--timeout`` seconds, then kills
them), prints rank 0's lines and each failure, then ``{"ok": ...,
"device": ...}``; exits 1 when a check failed. Needs N cards; from the
repo root:

    python3 torch_tools/mesh_probe.py [--ranks 4] [--timeout 600]
        [--parts ring,ulysses,long_context,mlm,serving]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAILED = []
PARTS = ("ring", "ulysses", "long_context", "mlm", "serving")


def check(ok: bool, msg: str):
    if not ok:
        FAILED.append(msg)
        print(f"FAILED {msg}", flush=True)


def log(label: str, obj):
    print(f"{label}: {json.dumps(obj)}", flush=True)


def blocks(x, n, me):
    """Rank ``me``'s block of the sequence (dim 2) of ``x``."""
    size = x.shape[2] // n
    return x[:, :, me * size:(me + 1) * size].contiguous()


def gather_seq(x, group):
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=2)


def ring_part(cs, n, me, group):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.parallel import sequence_parallel as sp

    B, H, T, D = 2, 12, 8192, 64
    rng = np.random.default_rng(8192)
    q, k, v, do = (torch.as_tensor(rng.standard_normal((B, H, T, D)),
                                   dtype=torch.float32)
                   .to("cuda", torch.bfloat16) for _ in range(4))
    zz = torch.as_tensor(sp.zigzag_indices(T, n), device="cuda")
    out = {}
    for name, causal, pairs in (("ring", False, n), ("ring causal", True,
                                                     me + 1),
                                ("zigzag", True, 2 * n + 1)):
        whole = [x[:, :, zz] for x in (q, k, v, do)] if name == "zigzag" \
            else [q, k, v, do]
        local = [blocks(x, n, me) for x in whole]

        def run():
            xs = [x.clone().requires_grad_() for x in local[:3]]
            if name == "zigzag":
                o = sp.zigzag_ring_flash_attention(*xs, group)
            else:
                o = sp.ring_flash_attention(*xs, group, causal)
            return o, torch.autograd.grad(o, xs, local[3])

        cs.reset_launches()
        o, g = run()
        torch.cuda.synchronize()
        la = cs.read_launches()
        got = {r: la[r] for r in ("flash_forward", "flash_bwd_dq",
                                  "flash_bwd_dkv")}
        check(all(c == pairs for c in got.values()),
              f"rank {me} {name}: launches {got}, expected {pairs} each")
        ms = cs.time_ms(run, iters=5, reps=3, graph=False)
        dist_all = [gather_seq(x.detach(), group) for x in (o, *g)]
        row = {"launches": got, "expected_launches": pairs, "ms": ms}
        if me == 0:
            if name == "zigzag":
                lo, lg = sp.zigzag_ring_flash_loop(*whole[:3], n, whole[3])
            else:
                lo, lg = sp.ring_flash_loop(*whole[:3], n, causal, whole[3])
            equal = [bool(torch.equal(a, b))
                     for a, b in zip(dist_all, (lo, *lg))]
            check(all(equal), f"{name}: the {n}-card ring against the "
                  f"one-process loop: out/dq/dk/dv equal {equal}")
            def unsharded():
                ws = [x.clone().requires_grad_() for x in (q, k, v)]
                o = ak.flash_attention(*ws, causal)
                return torch.autograd.grad(o, ws, do)

            row.update(bit_equal_to_loop=equal,
                       unsharded_ms=cs.time_ms(unsharded, iters=5, reps=3,
                                               graph=False))
        out[name] = row
        log(f"rank {me} ring {name}", row)
    return out


def ulysses_part(cs, n, me, group):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.parallel import sequence_parallel as sp

    B, H, T, D = 2, 12, 8192, 64
    rng = np.random.default_rng(8193)
    q, k, v, do = (torch.as_tensor(rng.standard_normal((B, H, T, D)),
                                   dtype=torch.float32)
                   .to("cuda", torch.bfloat16) for _ in range(4))
    local = [blocks(x, n, me) for x in (q, k, v, do)]
    xs = [x.clone().requires_grad_() for x in local[:3]]
    cs.reset_launches()
    o = sp.ulysses_attention(*xs, group, False)
    g = torch.autograd.grad(o, xs, local[3])
    torch.cuda.synchronize()
    la = cs.read_launches()
    check(la["flash_forward"] == la["flash_bwd_dq"] == la["flash_bwd_dkv"]
          == 1, f"rank {me} ulysses: launches {la}, expected 1 each")
    dist_all = [gather_seq(x.detach(), group) for x in (o, *g)]
    if me != 0:
        return {}
    ws = [x.clone().requires_grad_() for x in (q, k, v)]
    ro = ak.flash_attention(*ws, False)
    rg = torch.autograd.grad(ro, ws, do)
    row = {}
    for part, a, b, floor in zip(("out", "dq", "dk", "dv"), dist_all,
                                 (ro.detach(), *rg),
                                 (cs.FWD_FLOOR,) + (cs.BWD_FLOOR,) * 3):
        err, share, rule = cs.judge(a, b, D, False, floor)
        check(share <= 1, f"ulysses {part}: {err} ({share:.3f} of {rule})")
        row[part] = {"max_abs_err": err, "share_of_bound": share,
                     "bit_equal": bool(torch.equal(a, b))}
    log("ulysses", row)
    return row


def train_part(cs, n, me, label, cfg, B, T, warmup, timed, shape, used):
    """The meshless step on this card, then the same step under
    ``make_mesh(shape)``: losses within 1e-3 relative, ``used`` launches
    per rank as each rank's share of the work says."""
    from deeplearning4j_tpu_torch.parallel import make_mesh

    base = cs.train_run(cfg, B, T, warmup=warmup, timed=timed,
                        label=f"rank {me} meshless {label}")
    mesh = make_mesh(shape)
    st = cs.train_run(cfg, B, T, warmup=warmup, timed=timed,
                      label=f"rank {me} mesh {label}", mesh=mesh)
    rel = max(abs(a - b) / abs(b) for a, b in zip(st["losses"],
                                                  base["losses"]))
    check(rel <= 1e-3, f"rank {me} {label}: losses {st['losses']} against "
          f"{base['losses']} (largest relative difference {rel})")
    for name, count in used(mesh).items():
        check(st["launches"][name] == count,
              f"rank {me} {label}: {name} launched "
              f"{st['launches'][name]}, expected {count}")
    row = {"mesh": shape, "losses": st["losses"],
           "meshless_losses": base["losses"],
           "largest_relative_difference": rel, "step_ms": st["step_ms_mean"],
           "meshless_step_ms": base["step_ms_mean"],
           "tokens_per_sec": st["tokens_per_sec"],
           "tokens_per_sec_per_card": st["tokens_per_sec"] / n,
           "meshless_tokens_per_sec": base["tokens_per_sec"],
           "peak_memory_bytes": st["peak_memory_bytes"],
           "meshless_peak_memory_bytes": base["peak_memory_bytes"],
           "launches": {k: st["launches"][k] for k in used(mesh)}}
    log(f"rank {me} {label}", row)
    return row


def serving_part(cs, n, me):
    """The sharded generation engine on N cards against one card's."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models import (
        TransformerConfig, init_params)
    from deeplearning4j_tpu_torch.parallel import make_mesh

    base_cfg = TransformerConfig(causal=True, remat=False,
                                 attention_impl="flash")
    params = init_params(base_cfg, seed=0, device="cuda")
    prompts = cs.chat_mix(base_cfg.vocab_size, max_len=base_cfg.max_seq)
    rows = {}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = dataclasses.replace(base_cfg, dtype=dtype)
        one = cs.engine_phase(cfg, params, prompts, pools=("float32",),
                              label=f"rank {me} one card {dname}") \
            if me == 0 else None
        for shape in ({"model": n}, {"data": n // 2, "model": 2}):
            mesh = make_mesh(shape)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run = cs.engine_phase(cfg, params, prompts, mesh=mesh,
                                  pools=("float32",),
                                  label=f"rank {me} {dname} {shape}")
            peaks = [None] * n
            dist.all_gather_object(peaks, torch.cuda.max_memory_allocated())
            if me != 0:
                continue
            run, ref = run["float32"], one["float32"]
            same = sum(a == b for a, b in zip(run["streams"],
                                              ref["streams"]))
            if dname == "fp32":
                check(same == len(ref["streams"]),
                      f"serving {dname} {shape}: {same} of "
                      f"{len(ref['streams'])} streams equal one card's")
            row = {k: v for k, v in run.items() if k != "streams"}
            row.update(
                mesh=shape, streams_equal_one_card=same,
                streams=len(ref["streams"]),
                decode_tokens_per_sec_per_card=run["decode_tokens_per_sec"]
                / n,
                ttft_ms_p50=run["ttft_ms_p50"],
                one_card_decode_tokens_per_sec=ref["decode_tokens_per_sec"],
                one_card_ttft_ms_p50=ref["ttft_ms_p50"],
                one_card_decode_step_ms_mean=ref["decode_step_ms_mean"],
                peak_memory_bytes_per_card=peaks)
            rows[f"{dname} {shape}"] = row
            log(f"serving {dname} {shape}", row)
    return rows


def rank_main(rank: int, n: int, store: str, parts) -> int:
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models import TransformerConfig
    from deeplearning4j_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(f"file://{store}", n, rank)
    print(f"rank {rank}: {torch.cuda.get_device_name()} "
          f"(cuda:{torch.cuda.current_device()})", flush=True)
    mesh = make_mesh({"context": n})
    group, me = mesh.group("context"), mesh.axis_index("context")
    if "ring" in parts:
        ring_part(cs, n, me, group)
    if "ulysses" in parts:
        ulysses_part(cs, n, me, group)
    layers = 12
    lc = TransformerConfig(causal=True, max_seq=8192, remat=False,
                           attention_impl="flash")
    if "long_context" in parts:
        train_part(cs, n, rank, "long context", lc, 2, 8192, 1, 2,
                   {"context": n}, lambda m: {
                       k: layers * 3 * (m.axis_index("context") + 1)
                       for k in ("flash_forward", "flash_bwd_dq",
                                 "flash_bwd_dkv")})
    mlm = TransformerConfig(remat=False, attention_impl="flash")
    if "mlm" in parts:
        train_part(cs, n, rank, "mlm", mlm, 96, 512, 2, 3,
                   {"data": n // 2, "model": 2}, lambda m: {
                       k: layers * 5 for k in ("mha_attention_packed",
                                               "mha_packed_backward")})
    if "serving" in parts:
        try:
            serving_part(cs, n, rank)
        except AssertionError as e:   # chip_smoke's checks raise
            check(False, f"rank {rank} serving: {e}")
    multihost.barrier("done")
    torch.distributed.destroy_process_group()
    return 1 if FAILED else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated parts to run, of " + ", ".join(
                        PARTS))
    args = ap.parse_args()
    parts = args.parts.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}")
    if args.rank is not None:
        return rank_main(args.rank, args.ranks, args.store, parts)
    import torch

    if torch.cuda.device_count() < args.ranks:
        print(f"mesh_probe: needs {args.ranks} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    import chip_smoke as cs

    cs.build()          # once, before the ranks load the libraries
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "mesh_probe_store")
    if os.path.exists(store):
        os.remove(store)
    logs = [os.path.join(out, f"mesh_probe.rank{r}.log")
            for r in range(args.ranks)]
    procs = []
    for r in range(args.ranks):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 str(r), "--ranks", str(args.ranks), "--store", store,
                 "--parts", args.parts],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                env=dict(os.environ, LOCAL_RANK=str(r))))
    deadline = time.monotonic() + args.timeout
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    with open(logs[0]) as f:
        print(f.read(), end="")
    for r in range(1, args.ranks):
        with open(logs[r]) as f:
            for line in f:
                if line.startswith(("FAILED", "Traceback")) \
                        or "Error" in line:
                    print(f"rank {r}: {line}", end="")
    codes = [p.returncode for p in procs]
    ok = not timed_out and not any(codes)
    print(f"mesh_probe: ranks exited {codes}"
          + (" (timed out)" if timed_out else ""))
    print(json.dumps({"ok": ok, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
