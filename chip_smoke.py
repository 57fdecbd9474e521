#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

Phases, in order; any failure exits non-zero, and each prints its
seconds:

1. probe — torch/CUDA/nvcc versions and the card's name and power limit;
2. build — compile every kernel source in
   ``deeplearning4j_tpu_torch/ops/csrc`` (one nvcc per source, in
   parallel), print ptxas's registers and spills, and count the tensor-
   core instructions (HGMMA, HMMA) of the attention forward libraries
   (``mha_packed_fwd``, ``flash_fwd``) and of the backward
   (``attention_bwd``): each must have HGMMA;
3. kernels — the serving kernels (packed forward, paged decode) against
   their plain PyTorch versions on the card at the serving shapes, with
   the tolerance stated beside each check, timed beside the plain
   version, the one-call PyTorch yardstick where there is one, and the
   roofline bound;
4. train kernels — the same for the training kernels: packed forward and
   backward at the MLM step's shape (B=96, T=512, H=12, D=64, bf16), a
   causal and a bf16-p case; the streamed forward, dq and dk/dv at T=2048
   (causal and not) and at the long-context shape (B=2, T=8192, causal);
   each row's share of its bound and its time over the library call's
   (for the backward rows PyTorch's sdpa backward alone, one
   ``autograd.grad`` of a saved forward);
   kernel chain — what training runs: the backward kernels fed the
   forward kernel's lse, against the plain backward fed the same lse, at
   B=2 T=128 causal (packed, fp32 and bf16 p) and T=2048 causal
   (streamed); dq's first causal row is exactly 0 on both sides (packed)
   or equal bit for bit (streamed, whose delta the caller sums);
   loss and update kernels — the fused cross-entropy forward and backward
   at the MLM step's logits (49152 x 30522, bf16) and at edge cases
   (fp32, targets -1 and V, N not a multiple of 128), the fused AdamW over
   BERT-base's fp32 tree (2 applies) and over a bf16 tree;
5. engine — the BERT-base-width causal LM (12 layers, hidden 768, vocab
   30522, bf16, seeded random weights) served by ``GenerationEngine`` with
   the fused paged decode route, with a bf16 and an int8 KV pool, on the
   seeded chat mix (32 requests, prompts of 4..127 tokens, 64 new tokens
   each); the kernels' launch counts must equal layers x prefills and
   layers x decode steps;
6. routes — the two decode routes agree at the model level;
7. fp32 — a 2-layer fp32 engine gives token-equal greedy streams on both
   routes;
8. profile — torch.profiler over a short engine run: the device's busy
   share of the wall time and the kernels that take the most device time;
9. mlm train — the port's ``make_train_step`` on bench.py's MLM step
   (BERT-base, bidirectional, ``attention_impl="flash"``, bf16, B=96,
   T=512, batch from numpy seed 0): 2 warm-up, 5 timed and 3 more steps
   on one batch; tokens/s, step ms, MFU (989e12 bf16 peak, H100 SXM data
   sheet) and peak memory; the loss must fall, the packed forward and
   backward launch layers x steps each and the streamed kernels never;
10. long-context train — the causal LM at B=2, T=8192, 12 layers: 1
    warm-up and 2 timed steps; the streamed forward, dq and dk/dv launch
    layers x steps each and the packed kernels never;
11. train parity — a 2-layer fp32 copy at full widths: the kernel route
    and the einsum route give the same loss and gradients at T=512 (packed)
    and T=2048 (streamed);
12. train profile — one MLM step under torch.profiler, with the device
    time of make_train_step's eager AdamW tail; long-context profile —
    one T=8192 step under torch.profiler;
13. fused mlm train — bench.py's MLM step composed from the public entry
    points (``_forward_raw``, ``softmax_cross_entropy`` over the (B*T, V)
    logits, the weighted mean, ``fused_adamw(1e-4, weight_decay=0.01)
    .apply``) for the MLM phase's 10 steps from the same params and batch:
    the loss falls and stays within 1e-3 relative of the MLM phase's at
    every step; the cross-entropy kernels and the AdamW kernel launch once
    per step, the packed kernels layers x steps;
14. fused parity — on a 2-layer fp32 copy at full widths (T=512), the
    composed loss and its gradients equal ``lm_loss``'s;
15. fused profile — one composed step under torch.profiler: the share of
    the cross-entropy and AdamW kernels in the device time.

The next-to-last line of standard output is ``{"kernels": [...]}``, the
last ``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W): HBM bytes/s, the
# tensor-core bf16 rate and the fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# the device of the training phases
DEVICE = "cuda"
# the card's name and power limit as nvidia-smi reports them (``probe``)
CARD = "?"



def log(msg: str):
    print(msg, flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """Least time (ms) for the work, and which of the two bounds it;
    ``peak`` is the rate of the operations' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 20, reps: int = 5, graph: bool = True) -> float:
    """Median device time of one ``fn()`` call over ``reps`` windows of
    ``iters`` calls between CUDA events. With ``graph`` the calls are
    captured in a CUDA graph and replayed, so host launch overhead is out
    of the number (inputs stay L2-resident); without it they are launched
    eagerly (for calls of a millisecond or more, and for autograd)."""
    import torch

    if not graph:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
        return float(np.median(times))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph_ = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph_):
        for _ in range(iters):
            fn()
    graph_.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph_.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def counted():
    """Every kernel wrapper that counts its launches, by name."""
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.ops import xent_kernels as xk

    return {"mha_attention_packed": ak.mha_attention_packed,
            "mha_packed_backward": ak.mha_packed_backward,
            "flash_forward": ak.flash_forward,
            "flash_bwd_dq": ak.flash_bwd_dq,
            "flash_bwd_dkv": ak.flash_bwd_dkv,
            "paged_decode_attention": ak.paged_decode_attention,
            "softmax_cross_entropy": xk.softmax_cross_entropy,
            "softmax_cross_entropy_backward":
                xk.softmax_cross_entropy_backward,
            "fused_adamw": updaters.fused_adamw}


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    for fn in counted().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in counted().items()}


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_bound(ref, rel: float) -> float:
    """``rel`` of the largest |ref| (at least ``rel``)."""
    return rel * max(ref.float().abs().max().item(), 1.0)


# A bf16 kernel result against its plain version is held per element:
# |a - b| <= 2^-7 |b| + floor * rms(b's row), the row being one head's D
# values. 2^-7 |b| is one bf16 ulp of the output (each side rounds once).
# The floor covers what the arithmetic lets differ before that rounding,
# in units of the row's own size, never of the tensor's largest |b|: late
# causal rows, whose outputs shrink as ~1/sqrt(keys seen), are held as
# tightly as the first.
# - forward, fp32 p: p is rounded to bf16 for P.V under the running max
#   there and the row max here; the two roundings are independent and
#   move o by about 2^-8.7 of the row's rms (one standard deviation):
#   a floor of 2^-5;
# - backward: ds is rounded to bf16 on both sides, and an element whose
#   dp or delta (fp32 sums in another order) sits at a rounding boundary
#   lands one ulp away; that is rare and moves a gradient row by ~2^-8
#   of one of its terms: a floor of 2^-6.
# With bf16 p (s - m and exp(s - m) rounded under different maxima) the
# JAX package's own bound for that mode holds: 5e-2 of the largest |b|.
BF16_ULP = 2 ** -7
FWD_FLOOR, BWD_FLOOR = 2 ** -5, 2 ** -6


def judge(a, b, d: int, p_bf16: bool, floor: float):
    """(largest |a - b|, the largest share of its bound that an element
    takes, the bound's rule); the check passes when the share is <= 1."""
    import torch

    err = max_err(a, b)
    if p_bf16:
        return err, err / rel_bound(b, 5e-2), "5e-2 of max|ref|"
    a = a.float().unflatten(-1, (-1, d))
    b = b.float().unflatten(-1, (-1, d))
    diff = (a - b).abs()
    allowed = BF16_ULP * b.abs() \
        + floor * b.square().mean(-1, keepdim=True).sqrt()
    share = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / allowed).max().item()   # 0/0 counts as 0
    return err, share, f"2^-7|ref| + 2^{int(np.log2(floor))} rms(row)"


# ------------------------------------------------------------------ phases


def probe():
    import torch

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from deeplearning4j_tpu_torch.ops import _build

    out = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {out[-1] if out else '?'}")
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(CARD)


def build():
    from deeplearning4j_tpu_torch.ops import _build

    t0 = time.perf_counter()
    took = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{n} {s:.1f} s" for n, s in took.items()))
    for name in took:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    # the bf16 attention forward and backward run on the tensor cores: the
    # wgmma (HGMMA) and mma (HMMA) instructions in each built library
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    for name in ("mha_packed_fwd", "flash_fwd", "attention_bwd"):
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {op: sum(1 for line in sass.splitlines()
                          if f" {op}." in line or f" {op} " in line)
                  for op in ("HGMMA", "HMMA")}
        log(f"{name} SASS: {counts['HGMMA']} HGMMA, {counts['HMMA']} HMMA "
            f"instructions")
        check(counts["HGMMA"] > 0, f"{name} has no HGMMA instruction: its "
              "bf16 kernels do not reach the tensor cores")


def packed_cases(torch):
    """(label, B, T, causal, p_dtype) at the prefill shapes: the engine's
    buckets the chat mix reaches (8..128) and the top rung (512)."""
    bf16 = torch.bfloat16
    return [("T8 causal", 1, 8, True, torch.float32),
            ("T64 causal", 1, 64, True, torch.float32),
            ("T128 causal", 1, 128, True, torch.float32),
            ("T512 causal", 1, 512, True, torch.float32),
            ("B2 T128 non-causal", 2, 128, False, torch.float32),
            ("T128 causal p=bf16", 1, 128, True, bf16)]


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    H, D = 12, 64
    rng = np.random.default_rng(0)
    packed_rows = []
    for label, B, T, causal, p_dtype in packed_cases(torch):
        q, k, v = (torch.as_tensor(rng.standard_normal((B, T, H * D)),
                                   dtype=torch.float32).to("cuda",
                                                           torch.bfloat16)
                   for _ in range(3))
        o, lse = ak.mha_packed_forward(q, k, v, H, causal, None, p_dtype)
        ro, rlse = ak.mha_packed_forward_reference(q, k, v, H, causal, None,
                                                   p_dtype)
        torch.cuda.synchronize()
        lse_err = (lse - rlse).abs().max().item()
        # o: the per-element forward bound (``judge``)
        err, share, rule = judge(o, ro, D, p_dtype == torch.bfloat16,
                                 FWD_FLOOR)
        # lse: fp32 sums of the same p, only the order differs (1e-3); with
        # bf16 p the sums take p rounded under different maxima (5e-2)
        lse_tol = 1e-3 if p_dtype == torch.float32 else 5e-2
        check(share <= 1.0, f"packed {label}: max |o - plain| {err} takes "
              f"{share} of its bound {rule}")
        check(lse_err <= lse_tol,
              f"packed {label}: lse err {lse_err} > {lse_tol}")
        ms = time_ms(lambda: ak.mha_packed_forward(q, k, v, H, causal, None,
                                                   p_dtype))
        plain_ms = time_ms(lambda: ak.mha_packed_forward_reference(
            q, k, v, H, causal, None, p_dtype))

        def sdpa():
            def hs(x):
                return x.view(B, T, H, D).transpose(1, 2)
            return F.scaled_dot_product_attention(hs(q), hs(k), hs(v),
                                                  is_causal=causal)
        lib_ms = time_ms(sdpa)
        nbytes = 4 * B * T * H * D * 2 + B * H * T * 4
        flops = (2 if causal else 4) * B * H * T * T * D
        b_ms, b_by = bound(nbytes, flops)
        log(f"packed {label}: max_abs_err {err:.3e} ({share:.3f} of its "
            f"bound {rule}) lse_err {lse_err:.3e} kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms bound {b_ms:.5f} ms "
            f"({b_by})")
        packed_rows.append(dict(case=label, max_abs_err=err,
                                bound_share=share, tol=rule,
                                lse_err=lse_err, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=b_ms,
                                bound_by=b_by))

    S, B, nbmax, NB = 16, 16, 32, 513
    paged_rows = []
    for kv in ("bf16", "int8"):
        q = torch.as_tensor(rng.standard_normal((S, H, D)),
                            dtype=torch.float32).to("cuda", torch.bfloat16)
        kf = torch.as_tensor(rng.standard_normal((NB, B, H, D)),
                             dtype=torch.float32, device="cuda")
        vf = torch.as_tensor(rng.standard_normal((NB, B, H, D)),
                             dtype=torch.float32, device="cuda")
        if kv == "int8":
            from deeplearning4j_tpu_torch.models import quantize_kv
            kp, ks = quantize_kv(kf)
            vp, vs = quantize_kv(vf)
        else:
            kp, vp = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
            ks = vs = None
        pos_np = rng.integers(0, nbmax * B, S).astype(np.int32)
        pos_np[[3, 11]] = 0                       # two dead slots
        tables_np = np.zeros((S, nbmax), np.int32)
        perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
        for s in range(S):
            if s in (3, 11):
                continue                          # dead: all scratch block 0
            n = pos_np[s] // B + 1
            tables_np[s, :n] = perm[s * nbmax:s * nbmax + n]
        tables = torch.as_tensor(tables_np, device="cuda")
        pos = torch.as_tensor(pos_np, device="cuda")
        o = ak.paged_decode_attention(q, kp, vp, tables, pos, block_size=B,
                                      k_scale=ks, v_scale=vs)
        ro = ak.paged_decode_attention_reference(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o.float()).all()),
              f"paged {kv}: non-finite output")
        err = (o.float() - ro.float()).abs().max().item()
        # fp32 softmax on both sides (online here, whole-row there); the
        # bf16 output rounding can differ by 1 ulp: 2^-7 of the largest |o|
        tol = 2 ** -7 * max(ro.float().abs().max().item(), 1.0)
        check(err <= tol, f"paged {kv}: max |o - plain| {err} > {tol}")
        ms = time_ms(lambda: ak.paged_decode_attention(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs))
        plain_ms = time_ms(lambda: ak.paged_decode_attention_reference(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs))
        n_pos = int((pos_np.astype(np.int64) + 1).sum())
        item = kp.element_size()
        nbytes = 2 * n_pos * H * D * item + 2 * S * H * D * 2 \
            + (2 * n_pos * H * 4 if kv == "int8" else 0) \
            + tables_np.nbytes + pos_np.nbytes
        flops = 4 * n_pos * H * D
        b_ms, b_by = bound(nbytes, flops)
        log(f"paged {kv}: max_abs_err {err:.3e} (tol {tol:.3e}) kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.5f} ms "
            f"({b_by}) positions {n_pos}")
        paged_rows.append(dict(case=f"{kv} pool", max_abs_err=err, tol=tol,
                               ms=ms, plain_ms=plain_ms, library_ms=None,
                               bound_ms=b_ms, bound_by=b_by))
    return packed_rows, paged_rows


def packed_train_cases(torch):
    """(label, B, T, causal, p_dtype) of rows 1 and 2: the MLM step's
    shape (B=96, T=512, non-causal) first, then a causal and a bf16-p
    case."""
    return [("B96 T512 non-causal", 96, 512, False, torch.float32),
            ("B2 T128 causal", 2, 128, True, torch.float32),
            ("B2 T128 causal p=bf16", 2, 128, True, torch.bfloat16)]


def sdpa_backward_ms(q4, k4, v4, do4, causal, it: int = 20,
                     reps: int = 5):
    """The library yardstick of the backward rows: PyTorch's fused
    attention backward alone, timed as ``torch.autograd.grad`` of one saved
    ``scaled_dot_product_attention`` forward (``retain_graph``, so every
    call runs the same backward); one call gives dq, dk and dv."""
    import torch
    import torch.nn.functional as F

    xs = [x.detach().clone().requires_grad_() for x in (q4, k4, v4)]
    o = F.scaled_dot_product_attention(*xs, is_causal=causal)
    return time_ms(lambda: torch.autograd.grad(o, xs, do4,
                                               retain_graph=True),
                   it, reps, graph=False)


def flash_train_cases():
    """(label, B, T, causal) of rows 3-5: parity at T=2048, and the
    long-context shape (B=2, H=12, T=8192, causal) timed and checked."""
    return [("T2048 causal", 2, 2048, True),
            ("T2048 non-causal", 2, 2048, False),
            ("T8192 causal", 2, 8192, True)]


def train_kernel_phase():
    """Rows 1-5 at the training shapes, each against its plain version on
    the card (per-element bounds, ``judge``), timed beside the plain
    version, a PyTorch yardstick and the roofline bound."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    H, D = 12, 64
    rng = np.random.default_rng(1)
    rows = {n: [] for n in ("mha_attention_packed", "mha_packed_backward",
                            "flash_forward", "flash_bwd_dq",
                            "flash_bwd_dkv")}

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(DEVICE,
                                                       torch.bfloat16)

    def judged(what, label, pairs, p_bf16, floor):
        """Check each (name, kernel, plain) pair; the worst error and
        share of its bound."""
        err, share, rule = 0.0, 0.0, ""
        for name, a, b in pairs:
            e, sh, rule = judge(a, b, D, p_bf16, floor)
            check(sh <= 1.0, f"{what} {label}: {name} max err {e} takes "
                  f"{sh} of its bound {rule}")
            err, share = max(err, e), max(share, sh)
        return err, share, rule

    def add(name, label, judged_, ms, plain_ms, lib_ms, nbytes, flops):
        err, share, rule = judged_
        b_ms, b_by = bound(nbytes, flops)
        # the kernel's share of its roofline bound, and its time over the
        # library call's
        roof = b_ms / ms
        factor = None if lib_ms is None else ms / lib_ms
        log(f"{name} {label}: max_abs_err {err:.3e} ({share:.3f} of its "
            f"bound {rule}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms bound "
            f"{b_ms:.5f} ms ({b_by}); {100 * roof:.2f}% of the bound, "
            f"{'-' if factor is None else f'{factor:.2f}'}x the library")
        rows[name].append(dict(case=label, max_abs_err=err,
                               bound_share=share, tol=rule, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               roofline_share=roof, library_factor=factor))

    for label, B, T, causal, p_dtype in packed_train_cases(torch):
        q, k, v, do = (rand((B, T, H * D)) for _ in range(4))
        o, lse = ak.mha_packed_forward(q, k, v, H, causal, None, p_dtype)
        ro, rlse = ak.mha_packed_forward_reference(q, k, v, H, causal, None,
                                                   p_dtype)
        got = ak.mha_packed_backward(q, k, v, do, rlse, H, causal, None,
                                     p_dtype)
        ref = ak.mha_packed_backward_reference(q, k, v, do, rlse, H, causal,
                                               None, p_dtype)
        torch.cuda.synchronize()
        # o, dq, dk, dv: the per-element bounds (``judge``); lse as in the
        # serving phase (1e-3, or 5e-2 with bf16 p)
        bf16_p = p_dtype == torch.bfloat16
        fwd = judged("packed fwd", label, [("o", o, ro)], bf16_p, FWD_FLOOR)
        lse_err = max_err(lse, rlse)
        check(lse_err <= (5e-2 if bf16_p else 1e-3),
              f"packed fwd {label}: lse err {lse_err}")
        bwd = judged("packed bwd", label,
                     [(f"d{n}", a, b) for n, a, b in zip("qkv", got, ref)],
                     bf16_p, BWD_FLOOR)

        def hs(x):
            return x.view(B, T, H, D).transpose(1, 2)
        n_elt = B * T * H * D
        fwd_flops = (2 if causal else 4) * B * H * T * T * D
        big = B * T >= 8192
        it, reps = (3, 3) if big else (20, 5)
        # the forward kernel and its library call: 20 calls a window,
        # median of 5; the plain version (milliseconds) 3 x 3 when big
        add("mha_attention_packed", label, fwd,
            time_ms(lambda: ak.mha_packed_forward(q, k, v, H, causal, None,
                                                  p_dtype), 20, 5,
                    graph=not big),
            time_ms(lambda: ak.mha_packed_forward_reference(
                q, k, v, H, causal, None, p_dtype), it, reps,
                graph=not big),
            time_ms(lambda: F.scaled_dot_product_attention(
                hs(q), hs(k), hs(v), is_causal=causal), 20, 5,
                graph=not big),
            4 * n_elt * 2 + B * H * T * 4, fwd_flops)
        # the backward kernel and its library call take milliseconds:
        # 20 calls a window, median of 5
        add("mha_packed_backward", label, bwd,
            time_ms(lambda: ak.mha_packed_backward(
                q, k, v, do, rlse, H, causal, None, p_dtype), 20, 5,
                graph=not big),
            time_ms(lambda: ak.mha_packed_backward_reference(
                q, k, v, do, rlse, H, causal, None, p_dtype), it, reps,
                graph=not big),
            sdpa_backward_ms(hs(q), hs(k), hs(v), hs(do), causal),
            7 * n_elt * 2 + B * H * T * 4, 2.5 * fwd_flops)
        del q, k, v, do, o, lse, ro, rlse, got, ref
        torch.cuda.empty_cache()

    for label, B, T, causal in flash_train_cases():
        BH = B * H
        q, k, v, do = (rand((BH, T, D)) for _ in range(4))
        o, lse = ak.flash_forward(q, k, v, causal)
        ro, rlse = ak.flash_forward_reference(q, k, v, causal)
        delta = (do.float() * ro.float()).sum(-1).reshape(BH, 1, T)
        dq = ak.flash_bwd_dq(q, k, v, do, rlse, delta, causal)
        dk, dv = ak.flash_bwd_dkv(q, k, v, do, rlse, delta, causal)
        rdq = ak.flash_bwd_dq_reference(q, k, v, do, rlse, delta, causal)
        rdk, rdv = ak.flash_bwd_dkv_reference(q, k, v, do, rlse, delta,
                                              causal)
        torch.cuda.synchronize()
        # o, dq, dk, dv: the per-element bounds (``judge``, fp32 p); lse
        # 1e-3 (fp32 sums in another order)
        fwd = judged("flash fwd", label, [("o", o, ro)], False, FWD_FLOOR)
        lse_err = max_err(lse, rlse)
        check(lse_err <= 1e-3, f"flash fwd {label}: lse err {lse_err}")
        bwd_dq = judged("flash bwd", label, [("dq", dq, rdq)], False,
                        BWD_FLOOR)
        bwd_dkv = judged("flash bwd", label, [("dk", dk, rdk),
                                              ("dv", dv, rdv)], False,
                         BWD_FLOOR)
        n_elt = BH * T * D
        prod = (1 if causal else 2) * BH * T * T * D   # one product, flops
        vec = BH * T * 4
        it, reps = (2, 3) if T >= 8192 else (3, 3)

        def q4(x):
            return x.view(B, H, T, D)
        # the forward kernel and its library call: 20 calls a window,
        # median of 5
        add("flash_forward", label, fwd,
            time_ms(lambda: ak.flash_forward(q, k, v, causal), 20, 5,
                    graph=False),
            time_ms(lambda: ak.flash_forward_reference(q, k, v, causal), it,
                    reps, graph=False),
            time_ms(lambda: F.scaled_dot_product_attention(
                q4(q), q4(k), q4(v), is_causal=causal), 20, 5,
                graph=False),
            4 * n_elt * 2 + vec, 2 * prod)
        lib_bwd = sdpa_backward_ms(q4(q), q4(k), q4(v), q4(do), causal)
        # the backward kernels: 20 calls a window, median of 5
        add("flash_bwd_dq", label, bwd_dq,
            time_ms(lambda: ak.flash_bwd_dq(q, k, v, do, rlse, delta,
                                            causal), 20, 5, graph=False),
            time_ms(lambda: ak.flash_bwd_dq_reference(
                q, k, v, do, rlse, delta, causal), it, reps, graph=False),
            lib_bwd, 5 * n_elt * 2 + 2 * vec, 3 * prod)
        add("flash_bwd_dkv", label, bwd_dkv,
            time_ms(lambda: ak.flash_bwd_dkv(q, k, v, do, rlse, delta,
                                             causal), 20, 5, graph=False),
            time_ms(lambda: ak.flash_bwd_dkv_reference(
                q, k, v, do, rlse, delta, causal), it, reps, graph=False),
            lib_bwd, 6 * n_elt * 2 + 2 * vec, 4 * prod)
        del q, k, v, do, o, lse, ro, rlse, delta, dq, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return rows


def chain_cases(torch):
    """(label, B, T, p_dtype, streamed) of the chain check: the packed
    kernels at a causal T=128 with fp32 and bf16 p, the streamed ones at
    T=2048 causal."""
    return [("B2 T128 causal", 2, 128, torch.float32, False),
            ("B2 T128 causal p=bf16", 2, 128, torch.bfloat16, False),
            ("T2048 causal", 2, 2048, torch.float32, True)]


def chain_phase():
    """The chain that training runs: the backward kernels fed the forward
    kernel's lse (the streamed ones also delta = rowsum(dO * o) of the
    forward kernel's o, as ``_FlashAttention.backward`` takes it), against
    the plain backward fed the same lse and delta, per element (``judge``).
    The first query of a causal head sees one key: the forward kernel's lse
    is exactly its score, so dq's first row is exactly 0 on both sides where
    delta is taken inside the kernel from p (packed), and equal bit for bit
    on both sides where the caller's fp32 rowsum gives it (streamed: its
    order of summation is not the product's, so dp - delta may keep an
    ulp)."""
    import torch

    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    H, D = 12, 64
    rng = np.random.default_rng(3)

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(DEVICE,
                                                       torch.bfloat16)

    for label, B, T, p_dtype, streamed in chain_cases(torch):
        bf16_p = p_dtype == torch.bfloat16
        if streamed:
            BH = B * H
            q, k, v, do = (rand((BH, T, D)) for _ in range(4))
            o, lse = ak.flash_forward(q, k, v, True)
            delta = (do.float() * o.float()).sum(-1).reshape(BH, 1, T)
            got = (ak.flash_bwd_dq(q, k, v, do, lse, delta, True),
                   *ak.flash_bwd_dkv(q, k, v, do, lse, delta, True))
            ref = (ak.flash_bwd_dq_reference(q, k, v, do, lse, delta, True),
                   *ak.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               True))
        else:
            q, k, v, do = (rand((B, T, H * D)) for _ in range(4))
            _, lse = ak.mha_packed_forward(q, k, v, H, True, None, p_dtype)
            got = ak.mha_packed_backward(q, k, v, do, lse, H, True, None,
                                         p_dtype)
            ref = ak.mha_packed_backward_reference(q, k, v, do, lse, H, True,
                                                   None, p_dtype)
        torch.cuda.synchronize()
        first = (got[0][:, 0], ref[0][:, 0])   # every head's first row
        worst = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            err, share, rule = judge(a, b, D, bf16_p, BWD_FLOOR)
            check(share <= 1.0, f"chain {label}: {name} max err {err} takes "
                  f"{share} of its bound {rule}")
            worst = max(worst, share)
        row0 = [x.float().abs().max().item() for x in first]
        check(torch.equal(*first), f"chain {label}: dq's first causal row "
              f"differs between kernel and plain (max |.| {row0})")
        if not streamed:
            check(row0 == [0.0, 0.0], f"chain {label}: dq's first causal row "
                  f"is not exactly 0 (max |.| kernel, plain: {row0})")
        zero_heads = int((first[0].float().abs().amax(-1) == 0).sum().item()) \
            if streamed else None
        log(f"chain {label}: worst share of the bound {worst:.3f} ({rule}); "
            f"dq's first causal row max |.| {row0[0]:.3e} kernel, "
            f"{row0[1]:.3e} plain, equal bit for bit"
            + (f"; exactly 0 in {zero_heads} of {first[0].shape[0]} heads"
               if streamed else ""))
        del q, k, v, do, lse, got, ref, first
        torch.cuda.empty_cache()


def chat_mix(vocab: int, n_requests: int = 32, max_len: int = 512):
    """The seeded chat-shaped mix of the JAX package's decode benchmark:
    prompt lengths drawn from [4, max_len // 4), token ids uniform."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_requests):
        n = int(rng.integers(4, max(5, max_len // 4)))
        out.append(rng.integers(0, vocab, n).astype(np.int32))
    return out


def engine_phase(cfg, params, prompts, device="cuda", max_new=64):
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, ServingMetrics)

    results = {}
    for kv in ("float32", "int8"):
        with GenerationEngine(params, cfg, slots=16, max_len=cfg.max_seq,
                              paged_attention="fused", kv_dtype=kv,
                              queue_capacity=len(prompts) + 16,
                              device=device) as eng:
            eng.warmup()
            eng.metrics = ServingMetrics()   # the engine is idle here
            ak.mha_attention_packed.launches = 0
            ak.paged_decode_attention.launches = 0
            first = {}
            t0 = time.perf_counter()
            handles = []
            for i, p in enumerate(prompts):
                t_sub = time.perf_counter()
                first[i] = None

                def on_tok(_tok, i=i, t_sub=t_sub):
                    if first[i] is None:
                        first[i] = (time.perf_counter() - t_sub) * 1e3
                handles.append(eng.submit(p, max_new_tokens=max_new,
                                          on_token=on_tok))
            outs = [h.result(timeout=600) for h in handles]
            wall = time.perf_counter() - t0
            packed_n = ak.mha_attention_packed.launches
            paged_n = ak.paged_decode_attention.launches
            m = eng.metrics
        check(all(len(o) == max_new for o in outs),
              f"engine {kv}: a stream returned fewer than {max_new} tokens")
        check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
              f"engine {kv}: token id out of range")
        prefills = int(m.prefills_total.value)
        steps = int(m.decode_steps_total.value)
        check(prefills == len(prompts),
              f"engine {kv}: {prefills} prefills for {len(prompts)} prompts")
        check(packed_n == cfg.layers * prefills,
              f"engine {kv}: packed kernel launched {packed_n} times, "
              f"expected layers x prefills = {cfg.layers * prefills}")
        check(paged_n == cfg.layers * steps,
              f"engine {kv}: paged kernel launched {paged_n} times, "
              f"expected layers x decode steps = {cfg.layers * steps}")
        ttft = float(np.median([first[i] for i in first]))
        stats = dict(decode_tokens_per_sec=m.decode_tokens_per_sec(),
                     end_to_end_tokens_per_sec=len(prompts) * max_new / wall,
                     ttft_ms_p50=ttft,
                     ttft_ms_p50_histogram=m.ttft_ms.quantile(0.5),
                     decode_step_ms_mean=m.decode_step_ms.mean,
                     decode_step_ms_p50_histogram=m.decode_step_ms.quantile(
                         0.5),
                     kv_pool_bytes=eng.num_blocks * eng.kv_block_bytes,
                     prefills=prefills, decode_steps=steps,
                     packed_launches=packed_n, paged_launches=paged_n)
        log(f"engine kv_dtype={kv}: " + json.dumps(stats))
        results[kv] = stats
    return results


def route_phase(cfg, params, prompts, device="cuda"):
    """One decode step through each route on its own clone of a pool that
    holds four prefilled prompts: the logits must agree."""
    import torch

    from deeplearning4j_tpu_torch.models import (
        compute_params, init_kv_cache, make_paged_decode_logits,
        make_paged_prefill)
    from deeplearning4j_tpu_torch.models.random import prng_key

    B, S, max_len = 16, 4, cfg.max_seq
    nbmax = max_len // B
    cparams = compute_params(params, cfg, device)
    cache = init_kv_cache(cfg, S, max_len, block_size=B, device=device)
    prefill = make_paged_prefill(cfg, B)
    tables = np.zeros((S, nbmax), np.int32)
    lengths = np.zeros(S, np.int64)
    tokens = np.zeros(S, np.int64)
    for i, p in enumerate(prompts[:S]):
        n = len(p)
        bucket = 8
        while bucket < n:
            bucket *= 2
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = p
        nb = -(-(n + 1) // B)
        tables[i, :nb] = np.arange(1 + i * nbmax, 1 + i * nbmax + nb)
        row = np.zeros(-(-bucket // B), np.int32)
        k = min(nb, row.size)
        row[:k] = tables[i, :k]
        _, tok = prefill(cparams, cache, padded, row, n, prng_key(0), 0.0,
                         0, 0)
        lengths[i], tokens[i] = n, int(tok)
    zero = np.zeros(S, np.int64)
    logits = {}
    for route in ("gather", "fused"):
        clone = {"layers": [{k: t.clone() for k, t in lc.items()}
                            for lc in cache["layers"]]}
        fn = make_paged_decode_logits(cfg, B, paged_attention=route)
        logits[route] = fn(cparams, clone, tables, lengths, tokens, zero,
                           zero)
    g, f = logits["gather"], logits["fused"]
    diff = (g - f).abs().max().item()
    scale = g.abs().max().item()
    # the gather route keeps bf16 scores and probabilities (the reference's
    # einsum path), the fused kernel fp32: ~2^-8 relative per layer, a few
    # percent of the logits' range after 12 layers
    tol = 0.05 * scale
    check(bool(torch.isfinite(f).all()), "fused route: non-finite logits")
    check(diff <= tol, f"routes disagree: max |logits diff| {diff} > {tol}")
    agree = (g.argmax(-1) == f.argmax(-1)).float().mean().item()
    log(f"routes: max |gather - fused| logits {diff:.4e} (tol {tol:.4e}, "
        f"max |logits| {scale:.4e}), argmax agreement {agree:.2f}")


def fp32_phase(cfg, prompts, device="cuda"):
    """A 2-layer fp32 copy of ``cfg`` (same widths): greedy streams
    token-equal between the fused and gather routes."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.models import init_params
    from deeplearning4j_tpu_torch.serving import GenerationEngine

    cfg = dataclasses.replace(cfg, layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device=device)
    streams = {}
    for route in ("fused", "gather"):
        with GenerationEngine(params, cfg, slots=8, max_len=cfg.max_seq,
                              paged_attention=route, device=device) as eng:
            hs = [eng.submit(p, max_new_tokens=16) for p in prompts[:8]]
            streams[route] = [h.result(timeout=600) for h in hs]
    check(streams["fused"] == streams["gather"],
          "fp32 engine: fused and gather greedy streams differ")
    log(f"fp32 2-layer engine: {len(streams['fused'])} greedy streams "
        "token-equal on fused and gather")


def profile_phase(cfg, params, prompts, device="cuda"):
    """Where the serving time goes: 16 streams of 16 tokens through the
    fused bf16-pool engine under torch.profiler (after a warm run of the
    same shape). Prints the device-busy share of the wall time and the
    kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.serving import GenerationEngine

    with GenerationEngine(params, cfg, slots=16, max_len=cfg.max_seq,
                          paged_attention="fused", device=device) as eng:
        eng.warmup()
        for h in [eng.submit(p, max_new_tokens=16) for p in prompts[:16]]:
            h.result(timeout=600)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hs = [eng.submit(p, max_new_tokens=16) for p in prompts[16:32]]
            for h in hs:
                h.result(timeout=600)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, "profile")


def train_batch(cfg, B, T, seed=0):
    """A batch drawn as bench.py draws it: uniform tokens and targets from
    numpy seed 0, all weights 1."""
    import torch

    rng = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                                      device=DEVICE),
            "targets": torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (B, T)), device=DEVICE),
            "weights": torch.ones((B, T), dtype=torch.float32,
                                  device=DEVICE)}


def train_run(cfg, B, T, warmup, timed, extra=0, label="train",
              make_step=None):
    """The port's make_train_step on ``cfg`` (seeded weights), or the
    ``(init_state, step)`` that ``make_step(cfg)`` builds, over one fixed
    batch: ``warmup`` steps, ``timed`` steps between synchronizes, then
    ``extra`` steps; the loss of every step is kept. Every launch count is
    set to 0 before the first step and read after the last. Returns the
    step's metrics."""
    import torch

    from deeplearning4j_tpu_torch import profiler as tprof
    from deeplearning4j_tpu_torch.models import init_params, make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=DEVICE)
    init_state, step = make_step(cfg) if make_step else make_train_step(
        cfg, learning_rate=1e-4)
    opt_state = init_state(params)
    batch = train_batch(cfg, B, T)
    losses = []
    reset_launches()
    for _ in range(warmup):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    for _ in range(extra):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    losses = [float(x) for x in losses]
    launches = read_launches()
    steps = warmup + timed + extra
    tok_s = B * T / (step_ms / 1e3)
    fpt = tprof.transformer_flops_per_token(
        tprof.non_embedding_params(params, cfg), cfg.layers, cfg.hidden, T)
    stats = dict(B=B, T=T, layers=cfg.layers, steps=steps,
                 step_ms_mean=step_ms, tokens_per_sec=tok_s,
                 mfu=tprof.mfu(tok_s, fpt, BF16_FLOPS),
                 mfu_basis=tprof.MFU_BASIS, mfu_peak_flops=BF16_FLOPS,
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 losses=losses, launches=launches)
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    log(f"{label}: " + json.dumps(stats))
    del params, opt_state
    torch.cuda.empty_cache()
    return stats


def mlm_phase():
    """bench.py's MLM step on the port: BERT-base widths, bidirectional,
    attention_impl='flash' (the packed kernels), bf16 compute, B=96,
    T=512: 2 warm-up steps, 5 timed, 3 more; the loss must fall on the
    fixed batch and the packed kernels launch layers x steps each (remat
    is off, as in bench.py: with it the checkpoint recomputes each block
    and the packed forward launches twice per layer per step)."""
    from deeplearning4j_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(remat=False, attention_impl="flash")
    st = train_run(cfg, 96, 512, warmup=2, timed=5, extra=3,
                   label="mlm train")
    n = cfg.layers * st["steps"]
    la = st["launches"]
    check(st["losses"][-1] < st["losses"][0],
          f"mlm train: loss did not fall: {st['losses']}")
    check(la["mha_attention_packed"] == n and la["mha_packed_backward"] == n,
          f"mlm train: packed launches {la}, expected layers x steps = {n}")
    check(la["flash_forward"] == la["flash_bwd_dq"] == la["flash_bwd_dkv"]
          == la["softmax_cross_entropy"] == la["fused_adamw"] == 0,
          f"mlm train: streamed, xent or adamw kernels launched: {la}")
    return st


def long_context_phase():
    """The causal LM at T=8192 (the JAX package's long-context shape: B=2,
    12 heads, D=64, bf16), all 12 layers: 1 warm-up and 2 timed steps;
    the streamed kernels launch layers x steps each, the packed ones 0."""
    from deeplearning4j_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(causal=True, max_seq=8192, remat=False,
                            attention_impl="flash")
    st = train_run(cfg, 2, 8192, warmup=1, timed=2, label="long-context train")
    n = cfg.layers * st["steps"]
    la = st["launches"]
    check(la["flash_forward"] == la["flash_bwd_dq"] == la["flash_bwd_dkv"]
          == n, f"long-context: streamed launches {la}, expected {n}")
    check(la["mha_attention_packed"] == la["mha_packed_backward"] == 0,
          f"long-context: packed kernels launched: {la}")
    return st


def train_parity_phase():
    """A 2-layer fp32 copy of BERT-base (full widths, seeded weights): the
    'flash' route (kernels) and the 'full' route (einsum) give the same
    loss and gradients, at T=512 (packed kernels, causal and not) and at
    T=2048 (streamed kernels, causal)."""
    import torch

    from deeplearning4j_tpu_torch.models import (
        TransformerConfig, init_params, lm_loss)
    from deeplearning4j_tpu_torch.models.bert import grad_aliases

    for T, causal in ((512, False), (512, True), (2048, True)):
        base = TransformerConfig(layers=2, dtype=torch.float32, causal=causal,
                                 max_seq=T, remat=False)
        params = init_params(base, seed=2, device=DEVICE)
        batch = train_batch(base, 2, T, seed=T)
        out = {}
        for impl in ("flash", "full"):
            cfg = dataclasses.replace(base, attention_impl=impl)
            tree, xs = grad_aliases(params)
            reset_launches()
            loss = lm_loss(tree, batch, cfg)
            grads = torch.autograd.grad(loss, xs)
            out[impl] = (float(loss.detach()), grads, read_launches())
        (lf, gf, la), (lr, gr, _) = out["flash"], out["full"]
        key = "mha_packed_backward" if T <= 1024 else "flash_bwd_dkv"
        check(la[key] == 2, f"train parity T={T}: {key} launched {la[key]}")
        # fp32 on both routes; the kernels' online softmax and the einsum's
        # whole-row one sum in other orders: 1e-5 relative on the loss,
        # 1e-4 of each leaf's largest |gradient|
        check(abs(lf - lr) <= 1e-5 * abs(lr),
              f"train parity T={T}: loss {lf} vs {lr}")
        worst = 0.0
        for a, b in zip(gf, gr):
            e = max_err(a, b) / max(b.abs().max().item(), 1e-12)
            worst = max(worst, e)
        check(worst <= 1e-4, f"train parity T={T}: grad rel err {worst}")
        log(f"train parity T={T} causal={causal}: loss flash {lf:.7f} full "
            f"{lr:.7f}; worst grad err {worst:.3e} of the leaf's max (tol "
            "1e-4)")
        del params, out, gf, gr
        torch.cuda.empty_cache()


def profile_train_step(cfg, B, T, label):
    """One make_train_step step on ``cfg`` (after a warm-up step) under
    torch.profiler: the device's busy share and the top kernels. Returns
    the profile and its device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models import init_params, make_train_step

    params = init_params(cfg, seed=0, device=DEVICE)
    init_state, step = make_train_step(cfg)
    opt_state = init_state(params)
    batch = train_batch(cfg, B, T)
    params, opt_state, _ = step(params, opt_state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _ = step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = report_profile(prof, wall_ms, label)
    del params, opt_state
    torch.cuda.empty_cache()
    return prof, kernels


def train_profile_phase():
    """One MLM step (B=96, T=512) under torch.profiler, with the device
    time of make_train_step's eager AdamW tail."""
    from torch.autograd import DeviceType

    from deeplearning4j_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(remat=False, attention_impl="flash")
    prof, kernels = profile_train_step(cfg, 96, 512, "train profile")
    # the eager AdamW tail: the device time of every kernel launched inside
    # make_train_step's "make_train_step.adamw" range
    tail = [e for e in prof.key_averages()
            if e.key == "make_train_step.adamw"
            and e.device_type == DeviceType.CPU]
    check(len(tail) == 1, "train profile: no make_train_step.adamw range")
    tail_ms = tail[0].device_time_total / 1e3
    busy = sum(ms for _, ms, _ in kernels)
    log(f"train profile: eager AdamW tail {tail_ms:.3f} ms of device time "
        f"({100 * tail_ms / busy:.2f}% of device time)")


def long_context_profile_phase():
    """One step of the causal LM at B=2, T=8192 under torch.profiler."""
    from deeplearning4j_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(causal=True, max_seq=8192, remat=False,
                            attention_impl="flash")
    profile_train_step(cfg, 2, 8192, "long-context profile")


def make_fused_mlm_step(cfg, learning_rate=1e-4, weight_decay=0.01):
    """bench.py's MLM step composed from the port's public entry points,
    as the JAX package's fused-op experiment composed it outside
    ``make_train_step``: the logits of ``_forward_raw`` (compute dtype) as
    (B*T, V), ``softmax_cross_entropy`` per row, ``loss_from_logits``'s
    weighted mean, ``torch.autograd.grad`` through ``grad_aliases``, then
    ``fused_adamw(...).apply`` in place. Returns ``(init_state, step,
    loss_of)``."""
    import torch

    from deeplearning4j_tpu_torch.models.bert import (
        _forward_raw, grad_aliases)
    from deeplearning4j_tpu_torch.ops import (
        fused_adamw, softmax_cross_entropy)

    opt = fused_adamw(learning_rate, weight_decay=weight_decay)

    def loss_of(tree, batch):
        logits = _forward_raw(tree, batch["tokens"], cfg)
        per_row = softmax_cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                        batch["targets"].reshape(-1))
        w = batch["weights"].reshape(-1)
        return (per_row * w).sum() / w.sum().clamp_min(1.0)

    def step(params, opt_state, batch):
        tree, xs = grad_aliases(params)
        loss = loss_of(tree, batch)
        grads = torch.autograd.grad(loss, xs)
        params, opt_state = opt.apply(params, opt_state, grads)
        return params, opt_state, loss.detach()

    return opt.init, step, loss_of


def fused_mlm_phase(mlm):
    """The composed MLM step (``make_fused_mlm_step``) at the MLM phase's
    configuration, batch and seeded weights, for the same 2 + 5 + 3 steps:
    the loss falls, the cross-entropy kernels launch once per step each,
    the AdamW kernel once per step (one launch for all 149 leaves), the
    packed kernels layers x steps, and every step's loss stays within
    1e-3 relative of the MLM phase's (``make_train_step``) loss."""
    from deeplearning4j_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(remat=False, attention_impl="flash")
    st = train_run(cfg, 96, 512, warmup=2, timed=5, extra=3,
                   label="fused mlm train",
                   make_step=lambda c: make_fused_mlm_step(c)[:2])
    steps, la = st["steps"], st["launches"]
    n = cfg.layers * steps
    check(st["losses"][-1] < st["losses"][0],
          f"fused mlm train: loss did not fall: {st['losses']}")
    check(la["softmax_cross_entropy"] == la["softmax_cross_entropy_backward"]
          == la["fused_adamw"] == steps,
          f"fused mlm train: xent/adamw launches {la}, expected {steps}")
    check(la["mha_attention_packed"] == la["mha_packed_backward"] == n,
          f"fused mlm train: packed launches {la}, expected {n}")
    check(la["flash_forward"] == la["flash_bwd_dq"] == la["flash_bwd_dkv"]
          == 0, f"fused mlm train: streamed kernels launched: {la}")
    # the same training as make_train_step: both start from the same
    # params and batch; the logits' gradient rounds to bf16 at other places
    # (one rounding here, two at the target column there) and the bias
    # corrections are fp32 here and float64 there, so near-zero gradients
    # may flip AdamW's sign step (up to 2 lr per element per step). 1e-3 of
    # the loss is ~1% of its fall over the 10 steps.
    rel = [abs(a - b) / abs(b) for a, b in zip(st["losses"], mlm["losses"])]
    check(len(rel) == steps and max(rel) <= 1e-3,
          f"fused mlm train: losses {st['losses']} vs make_train_step's "
          f"{mlm['losses']} (relative {rel}, tol 1e-3)")
    st["loss_rel_diff_vs_mlm"] = rel
    log(f"fused vs make_train_step on {CARD}: step "
        f"{st['step_ms_mean']:.3f} / {mlm['step_ms_mean']:.3f} ms, tokens/s "
        f"{st['tokens_per_sec']:.1f} / {mlm['tokens_per_sec']:.1f}, mfu "
        f"{st['mfu']:.5f} / {mlm['mfu']:.5f}, peak memory "
        f"{st['peak_memory_bytes']} / {mlm['peak_memory_bytes']} bytes; "
        f"worst loss difference {max(rel):.3e} relative (tol 1e-3)")
    return st


def fused_parity_phase():
    """A 2-layer fp32 copy of BERT-base (full widths, MLM, T=512): the
    composed loss (fused cross-entropy) and ``lm_loss`` give the same loss
    and gradients."""
    import torch

    from deeplearning4j_tpu_torch.models import (
        TransformerConfig, init_params, lm_loss)
    from deeplearning4j_tpu_torch.models.bert import grad_aliases

    cfg = TransformerConfig(layers=2, dtype=torch.float32, remat=False,
                            attention_impl="flash")
    params = init_params(cfg, seed=2, device=DEVICE)
    batch = train_batch(cfg, 2, 512, seed=512)
    loss_of = make_fused_mlm_step(cfg)[2]
    out = {}
    for name, fn in (("fused", loss_of), ("lm_loss", lambda tr, b:
                                           lm_loss(tr, b, cfg))):
        tree, xs = grad_aliases(params)
        reset_launches()
        loss = fn(tree, batch)
        grads = torch.autograd.grad(loss, xs)
        out[name] = (float(loss.detach()), grads, read_launches())
    (lf, gf, la), (lr, gr, _) = out["fused"], out["lm_loss"]
    check(la["softmax_cross_entropy"] == la["softmax_cross_entropy_backward"]
          == 1, f"fused parity: xent launches {la}")
    # fp32 on both sides; the kernel's online exp-sum and logsumexp sum in
    # other orders: 1e-5 relative on the loss, 1e-4 of each leaf's largest
    # |gradient| (train_parity_phase's tolerances)
    check(abs(lf - lr) <= 1e-5 * abs(lr),
          f"fused parity: loss {lf} vs lm_loss {lr}")
    worst = max(max_err(a, b) / max(b.abs().max().item(), 1e-12)
                for a, b in zip(gf, gr))
    check(worst <= 1e-4, f"fused parity: grad rel err {worst}")
    log(f"fused parity (2 layers, fp32, T=512): loss fused {lf:.7f} lm_loss "
        f"{lr:.7f}; worst grad err {worst:.3e} of the leaf's max (tol 1e-4)")
    del params, out, gf, gr
    torch.cuda.empty_cache()


def fused_profile_phase():
    """One composed MLM step (after a warm-up step) under torch.profiler:
    the device's busy share, the top kernels, and the cross-entropy and
    AdamW kernels' share of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(remat=False, attention_impl="flash")
    params = init_params(cfg, seed=0, device=DEVICE)
    init_state, step, _ = make_fused_mlm_step(cfg)
    opt_state = init_state(params)
    batch = train_batch(cfg, 96, 512)
    params, opt_state, _ = step(params, opt_state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _ = step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = report_profile(prof, wall_ms, "fused profile")
    busy = sum(ms for _, ms, _ in kernels)
    for part in ("xent_fwd_kernel", "xent_bwd_kernel", "adamw_kernel"):
        ms = sum(m for name, m, _ in kernels if part in name)
        n = sum(c for name, _, c in kernels if part in name)
        log(f"fused profile: {part} {ms:.3f} ms x{n} "
            f"({100 * ms / busy:.2f}% of device time)")
    del params, opt_state
    torch.cuda.empty_cache()


def xent_cases(torch):
    """(label, N, V, dtype, edge) of rows 7 and 8: the MLM step's logits
    (N = 96 x 512 rows of BERT's 30522-token vocabulary, bf16) first; then
    fp32 at the JAX tests' (16, 1000) and an N that is no multiple of 128,
    whose first four targets are -1 and V (outside the vocabulary)."""
    return [("N49152 V30522 bf16", 49152, 30522, torch.bfloat16, False),
            ("N16 V1000 fp32", 16, 1000, torch.float32, True),
            ("N200 V30522 bf16", 200, 30522, torch.bfloat16, True)]


def elementwise(a, b, rel, floor, rows=4096):
    """(largest |a - b|, largest share of the per-element bound rel |b| +
    floor that |a - b| takes); equal elements take 0. The check passes at a
    share <= 1. Taken ``rows`` rows at a time, so a (49152, 30522) pair
    needs no fp32 copy of itself."""
    import torch

    err, share = 0.0, 0.0
    for i in range(0, a.shape[0], rows):
        x, y = a[i:i + rows].float(), b[i:i + rows].float()
        diff = (x - y).abs()
        allowed = rel * y.abs() + floor
        err = max(err, diff.max().item())
        share = max(share, torch.where(diff == 0, torch.zeros_like(diff),
                                       diff / allowed).max().item())
    return err, share


def ce_backward_ms(x, t, g, it, reps):
    """The library yardstick of row 8: the autograd backward of
    ``F.cross_entropy(reduction="none")`` (forward + backward, minus the
    forward alone)."""
    import torch
    import torch.nn.functional as F

    xr = x.detach().clone().requires_grad_()
    gx = g.to(x.dtype)

    def both():
        torch.autograd.grad(F.cross_entropy(xr, t, reduction="none"), xr, gx)

    def fwd():
        with torch.no_grad():
            F.cross_entropy(xr, t, reduction="none")

    return max(time_ms(both, it, reps, graph=False)
               - time_ms(fwd, it, reps, graph=False), 0.0)


def loss_update_kernel_phase():
    """Rows 7-9 against their plain versions on the card, per element,
    timed beside the plain version, a PyTorch yardstick and the byte
    bound: the fused cross-entropy forward and backward at the MLM step's
    logits and at edge cases, and the fused AdamW over BERT-base's fp32
    tree (2 applies) and over a bf16 tree."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.models import BERT_BASE, init_params
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.ops import xent_kernels as xk

    rows = {n: [] for n in ("softmax_cross_entropy",
                            "softmax_cross_entropy_backward", "fused_adamw")}

    def add(name, label, judged, rule, ms, plain_ms, lib_ms, nbytes, flops):
        err, share = judged
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        log(f"{name} {label}: max_abs_err {err:.3e} ({share:.3f} of its "
            f"bound {rule}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
        rows[name].append(dict(case=label, max_abs_err=err,
                               bound_share=share, tol=rule, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by))

    for label, n, v, dtype, edge in xent_cases(torch):
        rng = np.random.default_rng(0)
        t = torch.as_tensor(rng.integers(0, v, n), device=DEVICE)
        w = torch.as_tensor(rng.random(n) if edge else np.ones(n),
                            dtype=torch.float32, device=DEVICE)
        if edge:
            t[:4] = torch.tensor([-1, v, -1, v])
        g = w / n
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        x = torch.randn((n, v), generator=gen, device=DEVICE, dtype=dtype)
        loss, lse = xk.softmax_cross_entropy_forward(x, t)
        rloss, rlse = xk.xent_forward_reference(x, t)
        grad = xk.softmax_cross_entropy_backward(x, t, rlse, g)
        rgrad = xk.xent_backward_reference(x, t, rlse, g)
        torch.cuda.synchronize()
        check(loss.dtype == lse.dtype == torch.float32 and grad.dtype == dtype,
              f"xent {label}: dtypes {loss.dtype} {lse.dtype} {grad.dtype}")
        # loss and lse: fp32 exp-sums of the same V terms in another order
        # (online with per-vector rescaling there, whole-row max here):
        # 1e-6 relative + 1e-5 absolute, ten fp32 ulps of an lse near 10
        fl, fs = elementwise(loss, rloss, 1e-6, 1e-5)
        ll, ls = elementwise(lse, rlse, 1e-6, 1e-5)
        fwd = (max(fl, ll), max(fs, ls))
        check(fwd[1] <= 1.0, f"xent fwd {label}: loss/lse err {fwd}")
        if edge:
            check(bool(torch.equal(loss[:4], lse[:4])),
                  f"xent fwd {label}: targets -1 and V must give loss = lse")
        # the gradient: the same fp32 (exp(x - lse) - onehot) g on both
        # sides but for exp's last ulps, rounded once to the output dtype:
        # one bf16 ulp (2^-7 |plain|), or 1e-5 relative in fp32; 1e-30 only
        # lets exact zeros pass
        bf16 = dtype == torch.bfloat16
        rule = "2^-7|ref|" if bf16 else "1e-5|ref|"
        bwd = elementwise(grad, rgrad, 2 ** -7 if bf16 else 1e-5, 1e-30)
        check(bwd[1] <= 1.0, f"xent bwd {label}: grad err {bwd}")
        big = n * v > 10 ** 8
        it, reps = (3, 3) if big else (20, 5)
        t_lib = t.clamp(0, v - 1)   # F.cross_entropy refuses -1 and V
        item = x.element_size()
        add("softmax_cross_entropy", label, fwd, "1e-6|ref| + 1e-5",
            time_ms(lambda: xk.softmax_cross_entropy_forward(x, t), it, reps,
                    graph=False),
            time_ms(lambda: xk.xent_forward_reference(x, t), it, reps,
                    graph=False),
            time_ms(lambda: F.cross_entropy(x, t_lib, reduction="none"), it,
                    reps, graph=False),
            n * v * item + 12 * n, 5 * n * v)
        add("softmax_cross_entropy_backward", label, bwd, rule,
            time_ms(lambda: xk.softmax_cross_entropy_backward(x, t, rlse, g),
                    it, reps, graph=False),
            time_ms(lambda: xk.xent_backward_reference(x, t, rlse, g), it,
                    reps, graph=False),
            ce_backward_ms(x, t_lib, g, it, reps),
            2 * n * v * item + 12 * n, 4 * n * v)
        del x, t, g, loss, lse, rloss, rlse, grad, rgrad
        torch.cuda.empty_cache()

    hyper = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    bf16 = torch.bfloat16
    for label in ("BERT-base fp32", "bf16 tree"):
        rng = np.random.default_rng(0)
        if label == "BERT-base fp32":
            params = init_params(BERT_BASE, seed=0, device=DEVICE)
        else:
            params = {k: torch.as_tensor(rng.standard_normal(s),
                                         dtype=torch.float32).to(DEVICE, bf16)
                      for k, s in (("b", (7,)), ("e", (3000, 128)),
                                   ("w", (1024, 128)))}
        leaves = updaters.tree_leaves(params)
        steps = [[torch.as_tensor(rng.standard_normal(p.shape,
                                                      dtype=np.float32),
                                  device=DEVICE).to(p.dtype) for p in leaves]
                 for _ in range(2)]
        ref_p = [p.clone() for p in leaves]
        ref_m = [torch.zeros_like(p) for p in leaves]
        ref_v = [torch.zeros_like(p) for p in leaves]
        opt = updaters.fused_adamw(hyper["lr"], weight_decay=hyper["wd"])
        state = opt.init(params)
        for count, gs in enumerate(steps, 1):
            opt.apply(params, state, gs)
            bc1, bc2 = updaters.bias_corrections(count, 0.9, 0.999)
            for i, g in enumerate(gs):
                new = updaters.adamw_reference(ref_p[i], g, ref_m[i],
                                               ref_v[i], bc1, bc2, **hyper)
                for dst, src in zip((ref_p[i], ref_m[i], ref_v[i]), new):
                    dst.copy_(src)
        torch.cuda.synchronize()
        check(state["count"] == 2, f"adamw {label}: count {state['count']}")
        got = leaves + state["mu"] + state["nu"]
        want = ref_p + ref_m + ref_v
        check(all(a.dtype == b.dtype for a, b in zip(got, want)),
              f"adamw {label}: a dtype changed")
        # every operation rounded once in fp32 on both sides, in the same
        # order (the kernel contracts nothing into an FMA): two fp32 ulps
        # (2^-22 relative), or one bf16 ulp (2^-7) where the leaves are bf16
        rel = 2 ** -7 if leaves[0].dtype == bf16 else 2 ** -22
        judged = [elementwise(a.reshape(-1, 1), b.reshape(-1, 1), rel, 1e-30,
                              rows=1 << 24) for a, b in zip(got, want)]
        judged = (max(e for e, _ in judged), max(s for _, s in judged))
        check(judged[1] <= 1.0, f"adamw {label}: p/m/v err {judged}")
        gs = steps[0]
        bc1, bc2 = updaters.bias_corrections(3, 0.9, 0.999)
        lib_p = [p.detach().clone() for p in leaves]
        for p, g in zip(lib_p, gs):
            p.grad = g.clone()
        lib = torch.optim.AdamW(lib_p, lr=hyper["lr"],
                                weight_decay=hyper["wd"], fused=True)
        numel = sum(p.numel() for p in leaves)
        add("fused_adamw", label, judged, f"{rel:.3g}|ref|",
            time_ms(lambda: opt.apply(params, state, gs), 3, 3, graph=False),
            time_ms(lambda: [updaters.adamw_reference(
                p, g, m, v, bc1, bc2, **hyper) for p, g, m, v in zip(
                    leaves, gs, state["mu"], state["nu"])], 3, 3,
                graph=False),
            time_ms(lib.step, 3, 3, graph=False),
            sum(p.numel() * (2 * p.element_size() + g.element_size()
                             + 2 * m.element_size() + 2 * v.element_size())
                for p, g, m, v in zip(leaves, gs, state["mu"],
                                      state["nu"])),
            15 * numel)
        log(f"fused_adamw {label}: {len(leaves)} leaves, {numel} params, "
            f"one launch per apply")
        del params, leaves, steps, ref_p, ref_m, ref_v, state, lib, lib_p
        torch.cuda.empty_cache()
    return rows


def report_profile(prof, wall_ms, label):
    """Device busy time over the wall time, and the top device events;
    returns the device events as (name, ms, count). Only events that ran
    on the device count: the CPU ops that launched them (aten ops,
    autograd nodes) carry the same time as their kernels and would count
    it twice, and a ``record_function`` range's device-side span covers
    kernels already counted."""
    from torch.autograd import DeviceType

    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and e.key != "make_train_step.adamw"]
    busy_ms = sum(ms for _, ms, _ in kernels)
    log(f"{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}% of wall)")
    ranked = sorted(kernels, key=lambda r: -r[1])
    # the top ten, then the package's own kernels below them
    for rank, (name, ms, n) in enumerate(ranked):
        if rank < 10 or name.startswith(("dl4jt", "void dl4jt")):
            log(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f}%  x{n:<6d} "
                f"{name[:90]}")
    return kernels


def timed_phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


SOURCES = "deeplearning4j_tpu_torch/ops/csrc/"
KERNELS = (
    # name, source, replaces (file:line of the TPU kernel's function)
    ("mha_attention_packed", "mha_packed_fwd.cu",
     "deeplearning4j_tpu/ops/pallas_kernels.py:648"),
    ("mha_packed_backward", "attention_bwd.cu",
     "deeplearning4j_tpu/ops/pallas_kernels.py:717"),
    ("flash_forward", "flash_fwd.cu",
     "deeplearning4j_tpu/ops/pallas_kernels.py:176"),
    ("flash_bwd_dq", "attention_bwd.cu",
     "deeplearning4j_tpu/ops/pallas_kernels.py:391"),
    ("flash_bwd_dkv", "attention_bwd.cu",
     "deeplearning4j_tpu/ops/pallas_kernels.py:412"),
    ("paged_decode_attention", "paged_decode.cu",
     "deeplearning4j_tpu/ops/pallas_kernels.py:838"),
    ("softmax_cross_entropy", "xent.cu",
     "deeplearning4j_tpu/ops/pallas_kernels.py:957"),
    ("softmax_cross_entropy_backward", "xent.cu",
     "deeplearning4j_tpu/ops/pallas_kernels.py:988"),
    ("fused_adamw", "adamw.cu",
     "deeplearning4j_tpu/ops/pallas_updaters.py:79"),
)


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU", file=sys.stderr)
        return 1
    import deeplearning4j_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    timed_phase("probe", probe)
    timed_phase("build", build)
    packed_rows, paged_rows = timed_phase("kernels", kernel_phase)
    train_rows = timed_phase("train kernels", train_kernel_phase)
    timed_phase("kernel chain", chain_phase)
    update_rows = timed_phase("loss and update kernels",
                              loss_update_kernel_phase)
    from deeplearning4j_tpu_torch.models import (
        TransformerConfig, init_params)

    # BERT-base widths as a causal LM, bf16 compute, seeded random weights
    cfg = TransformerConfig(causal=True, remat=False, attention_impl="flash")
    params = init_params(cfg, seed=0, device="cuda")
    prompts = chat_mix(cfg.vocab_size, max_len=cfg.max_seq)
    engine = timed_phase("engine", engine_phase, cfg, params, prompts)
    timed_phase("routes", route_phase, cfg, params, prompts)
    timed_phase("fp32", fp32_phase, cfg, prompts)
    timed_phase("profile", profile_phase, cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    mlm = timed_phase("mlm train", mlm_phase)
    longctx = timed_phase("long-context train", long_context_phase)
    timed_phase("train parity", train_parity_phase)
    timed_phase("train profile", train_profile_phase)
    timed_phase("long-context profile", long_context_profile_phase)
    fused = timed_phase("fused mlm train", fused_mlm_phase, mlm)
    timed_phase("fused parity", fused_parity_phase)
    timed_phase("fused profile", fused_profile_phase)
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    # each kernel's launches on the path that carries it: the serving
    # engine (fp32-pool run) for the paged kernel, the MLM step for the
    # packed kernels, the T=8192 step for the streamed ones, the composed
    # MLM step for the cross-entropy and AdamW kernels
    launches = {"mha_attention_packed": ("mlm_train", mlm),
                "mha_packed_backward": ("mlm_train", mlm),
                "flash_forward": ("long_context_train", longctx),
                "flash_bwd_dq": ("long_context_train", longctx),
                "flash_bwd_dkv": ("long_context_train", longctx),
                "softmax_cross_entropy": ("fused_mlm_train", fused),
                "softmax_cross_entropy_backward": ("fused_mlm_train", fused),
                "fused_adamw": ("fused_mlm_train", fused)}
    rows = dict(train_rows, paged_decode_attention=paged_rows, **update_rows)
    rows["mha_attention_packed"] = train_rows["mha_attention_packed"] \
        + packed_rows
    main_case = {"paged_decode_attention": "bf16 pool",
                 "flash_forward": "T8192 causal",
                 "flash_bwd_dq": "T8192 causal",
                 "flash_bwd_dkv": "T8192 causal",
                 "softmax_cross_entropy": "N49152 V30522 bf16",
                 "softmax_cross_entropy_backward": "N49152 V30522 bf16",
                 "fused_adamw": "BERT-base fp32"}
    kernels = []
    for name, source, replaces in KERNELS:
        case = main_case.get(name, "B96 T512 non-causal")
        main = next(r for r in rows[name] if r["case"] == case)
        if name == "paged_decode_attention":
            path, n = "engine", engine["float32"]["paged_launches"]
        else:
            path, st = launches[name]
            n = st["launches"][name]
        check(n > 0, f"{name}: no launch on its main path {path}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES + source,
            "replaces": replaces, "launches": n, "launches_path": path,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": case,
            "cases": rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
