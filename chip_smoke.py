#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

Phases, in order; any failure exits non-zero:

1. probe — torch/CUDA/nvcc versions and the card's name and power limit;
2. build — compile every kernel of the serving path from
   ``deeplearning4j_tpu_torch/ops/csrc`` (one nvcc per source, in
   parallel);
3. kernels — each kernel against its plain PyTorch version on the card at
   the serving shapes, with the tolerance stated beside each check, timed
   beside its plain version, the one-call PyTorch yardstick where there is
   one, and its roofline bound;
4. engine — the BERT-base-width causal LM (12 layers, hidden 768, vocab
   30522, bf16, seeded random weights) served by ``GenerationEngine`` with
   the fused paged decode route, with a bf16 and an int8 KV pool, on the
   seeded chat mix (32 requests, prompts of 4..127 tokens, 64 new tokens
   each); the kernels' launch counts must equal layers x prefills and
   layers x decode steps; the two decode routes must agree at the model
   level; a 2-layer fp32 engine must give token-equal greedy streams on
   both routes;
5. profile — torch.profiler over a short engine run: the device's busy
   share of the wall time and the kernels that take the most device time.

The next-to-last line of standard output is ``{"kernels": [...]}``, the
last ``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W): HBM bytes/s and the
# tensor-core bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

PACKED_REPLACES = "deeplearning4j_tpu/ops/pallas_kernels.py:648"
PAGED_REPLACES = "deeplearning4j_tpu/ops/pallas_kernels.py:838"


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


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median device time of one ``fn()`` call: ``iters`` calls captured
    in a CUDA graph, replayed ``reps`` times between CUDA events, so host
    launch overhead is out of the number. Inputs stay L2-resident."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


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
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        scale = ro.float().abs().max().item()
        # bf16 output: each side rounds once (1 ulp = 2^-8 relative), and
        # p is rounded to bf16 for P.V under a running max here and the
        # row max there (another ~2^-9 relative): 2^-6 of the largest |o|.
        # p_dtype=bf16 also rounds s-m and exp(s-m): the JAX package's own
        # bound for that mode, 5e-2 of |o|.
        tol = (2 ** -6 if p_dtype == torch.float32 else 5e-2) * max(scale, 1.0)
        # lse: fp32 sums of the same p, only the order differs (1e-3); with
        # bf16 p the sums take p rounded under different maxima (5e-2)
        lse_tol = 1e-3 if p_dtype == torch.float32 else 5e-2
        check(err <= tol, f"packed {label}: max |o - plain| {err} > {tol}")
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
        log(f"packed {label}: max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"lse_err {lse_err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} "
            f"ms sdpa {lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
        packed_rows.append(dict(case=label, max_abs_err=err, tol=tol,
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
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    log(f"profile: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}% of wall)")
    for name, ms, n in sorted(kernels, key=lambda r: -r[1])[:10]:
        log(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f}%  x{n:<6d} "
            f"{name[:90]}")


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

    probe()
    build()
    packed_rows, paged_rows = kernel_phase()
    from deeplearning4j_tpu_torch.models import (
        TransformerConfig, init_params)

    # BERT-base widths as a causal LM, bf16 compute, seeded random weights
    cfg = TransformerConfig(causal=True, remat=False, attention_impl="flash")
    params = init_params(cfg, seed=0, device="cuda")
    prompts = chat_mix(cfg.vocab_size, max_len=cfg.max_seq)
    engine = engine_phase(cfg, params, prompts)
    route_phase(cfg, params, prompts)
    fp32_phase(cfg, prompts)
    profile_phase(cfg, params, prompts)

    def row(name, source, replaces, rows, main_case, launches):
        main = next(r for r in rows if r["case"] == main_case)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["ms"], "kernel_ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], "shape": main_case,
                "cases": rows}

    kernels = [
        row("mha_attention_packed",
            "deeplearning4j_tpu_torch/ops/csrc/mha_packed_fwd.cu",
            PACKED_REPLACES, packed_rows, "T128 causal",
            engine["float32"]["packed_launches"]),
        row("paged_decode_attention",
            "deeplearning4j_tpu_torch/ops/csrc/paged_decode.cu",
            PAGED_REPLACES, paged_rows, "bf16 pool",
            engine["float32"]["paged_launches"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
