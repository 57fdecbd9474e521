#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

Phases, in order; any failure exits non-zero, and each prints its
seconds:

1. probe — torch/CUDA/nvcc versions and the card's name and power limit;
2. build — compile every kernel source in
   ``deeplearning4j_tpu_torch/ops/csrc`` (one nvcc per source, in
   parallel);
3. kernels — the serving kernels (packed forward, paged decode) against
   their plain PyTorch versions on the card at the serving shapes, with
   the tolerance stated beside each check, timed beside the plain
   version, the one-call PyTorch yardstick where there is one, and the
   roofline bound;
4. train kernels — the same for the training kernels: packed forward and
   backward at the MLM step's shape (B=96, T=512, H=12, D=64, bf16), a
   causal and a bf16-p case; the streamed forward, dq and dk/dv at T=2048
   (causal and not) and at the long-context shape (B=2, T=8192, causal);
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
12. train profile — one MLM step under torch.profiler.

The next-to-last line of standard output is ``{"kernels": [...]}``, the
last ``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W): HBM bytes/s and the
# tensor-core bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# the device of the training phases
DEVICE = "cuda"



def log(msg: str):
    print(msg, flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def bound(nbytes: float, flops: float):
    """Least time (ms) for the work, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    for fn in (ak.mha_attention_packed, ak.mha_packed_backward,
               ak.flash_forward, ak.flash_bwd_dq, ak.flash_bwd_dkv,
               ak.paged_decode_attention):
        fn.launches = 0


def read_launches():
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    return {"mha_attention_packed": ak.mha_attention_packed.launches,
            "mha_packed_backward": ak.mha_packed_backward.launches,
            "flash_forward": ak.flash_forward.launches,
            "flash_bwd_dq": ak.flash_bwd_dq.launches,
            "flash_bwd_dkv": ak.flash_bwd_dkv.launches,
            "paged_decode_attention": ak.paged_decode_attention.launches}


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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)


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


def sdpa_backward_ms(q4, k4, v4, do4, causal):
    """The library yardstick of the backward rows: PyTorch's fused
    attention backward, timed as the autograd backward of
    ``scaled_dot_product_attention`` (forward + backward, minus the
    forward alone); one call gives dq, dk and dv."""
    import torch
    import torch.nn.functional as F

    xs = [x.detach().clone().requires_grad_() for x in (q4, k4, v4)]

    def both():
        o = F.scaled_dot_product_attention(*xs, is_causal=causal)
        torch.autograd.grad(o, xs, do4)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(*xs, is_causal=causal)

    return max(time_ms(both, 3, 3, graph=False)
               - time_ms(fwd, 3, 3, graph=False), 0.0)


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
        log(f"{name} {label}: max_abs_err {err:.3e} ({share:.3f} of its "
            f"bound {rule}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms bound "
            f"{b_ms:.5f} ms ({b_by})")
        rows[name].append(dict(case=label, max_abs_err=err,
                               bound_share=share, tol=rule, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by))

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
        add("mha_attention_packed", label, fwd,
            time_ms(lambda: ak.mha_packed_forward(q, k, v, H, causal, None,
                                                  p_dtype), it, reps,
                    graph=not big),
            time_ms(lambda: ak.mha_packed_forward_reference(
                q, k, v, H, causal, None, p_dtype), it, reps,
                graph=not big),
            time_ms(lambda: F.scaled_dot_product_attention(
                hs(q), hs(k), hs(v), is_causal=causal), it, reps,
                graph=not big),
            4 * n_elt * 2 + B * H * T * 4, fwd_flops)
        add("mha_packed_backward", label, bwd,
            time_ms(lambda: ak.mha_packed_backward(
                q, k, v, do, rlse, H, causal, None, p_dtype), it, reps,
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
        add("flash_forward", label, fwd,
            time_ms(lambda: ak.flash_forward(q, k, v, causal), it, reps,
                    graph=False),
            time_ms(lambda: ak.flash_forward_reference(q, k, v, causal), it,
                    reps, graph=False),
            time_ms(lambda: F.scaled_dot_product_attention(
                q4(q), q4(k), q4(v), is_causal=causal), it, reps,
                graph=False),
            4 * n_elt * 2 + vec, 2 * prod)
        lib_bwd = sdpa_backward_ms(q4(q), q4(k), q4(v), q4(do), causal)
        add("flash_bwd_dq", label, bwd_dq,
            time_ms(lambda: ak.flash_bwd_dq(q, k, v, do, rlse, delta,
                                            causal), it, reps, graph=False),
            time_ms(lambda: ak.flash_bwd_dq_reference(
                q, k, v, do, rlse, delta, causal), it, reps, graph=False),
            lib_bwd, 5 * n_elt * 2 + 2 * vec, 3 * prod)
        add("flash_bwd_dkv", label, bwd_dkv,
            time_ms(lambda: ak.flash_bwd_dkv(q, k, v, do, rlse, delta,
                                             causal), it, reps, graph=False),
            time_ms(lambda: ak.flash_bwd_dkv_reference(
                q, k, v, do, rlse, delta, causal), it, reps, graph=False),
            lib_bwd, 6 * n_elt * 2 + 2 * vec, 4 * prod)
        del q, k, v, do, o, lse, ro, rlse, delta, dq, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return rows


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


def train_run(cfg, B, T, warmup, timed, extra=0, label="train"):
    """The port's make_train_step on ``cfg`` (seeded weights) over one
    fixed batch: ``warmup`` steps, ``timed`` steps between synchronizes,
    then ``extra`` steps. Every launch count is set to 0 before the first
    step and read after the last. Returns the step's metrics."""
    import torch

    from deeplearning4j_tpu_torch import profiler as tprof
    from deeplearning4j_tpu_torch.models import init_params, make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=DEVICE)
    init_state, step = make_train_step(cfg, learning_rate=1e-4)
    opt_state = init_state(params)
    batch = train_batch(cfg, B, T)
    losses = []
    reset_launches()
    for _ in range(warmup):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        params, opt_state, loss = step(params, opt_state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    losses.append(float(loss))
    for _ in range(extra):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
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
          == 0, f"mlm train: streamed kernels launched: {la}")
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


def train_profile_phase():
    """One MLM step (B=96, T=512, after a warm-up step) under
    torch.profiler: the device's busy share and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models import (
        TransformerConfig, init_params, make_train_step)

    cfg = TransformerConfig(remat=False, attention_impl="flash")
    params = init_params(cfg, seed=0, device=DEVICE)
    init_state, step = make_train_step(cfg)
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
    report_profile(prof, wall_ms, "train profile")
    del params, opt_state
    torch.cuda.empty_cache()


def report_profile(prof, wall_ms, label):
    """Device busy time over the wall time, and the top device events.
    Only events that ran on the device count: the CPU ops that launched
    them (aten ops, autograd nodes) carry the same time as their kernels
    and would count it twice."""
    from torch.autograd import DeviceType

    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    log(f"{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}% of wall)")
    for name, ms, n in sorted(kernels, key=lambda r: -r[1])[:10]:
        log(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f}%  x{n:<6d} "
            f"{name[:90]}")


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
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    # each kernel's launches on the path that carries it: the serving
    # engine (fp32-pool run) for the paged kernel, the MLM step for the
    # packed kernels, the T=8192 step for the streamed ones
    launches = {"mha_attention_packed": ("mlm_train", mlm),
                "mha_packed_backward": ("mlm_train", mlm),
                "flash_forward": ("long_context_train", longctx),
                "flash_bwd_dq": ("long_context_train", longctx),
                "flash_bwd_dkv": ("long_context_train", longctx)}
    rows = dict(train_rows, paged_decode_attention=paged_rows)
    rows["mha_attention_packed"] = train_rows["mha_attention_packed"] \
        + packed_rows
    main_case = {"paged_decode_attention": "bf16 pool",
                 "flash_forward": "T8192 causal",
                 "flash_bwd_dq": "T8192 causal",
                 "flash_bwd_dkv": "T8192 causal"}
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
