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
   version, the one-call PyTorch yardstick where there is one (for paged
   decode, sdpa on K/V already gathered, the gather not timed), and the
   roofline bound; paged decode is also called twice for the same bits,
   and run off the serving shape: a block-64 pool at head dim 128, and
   fp32 and int8 pools with pos on the split edges, past the table, at -1
   and in a dead slot;
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
   head dims — the packed and streamed kernels, forward and backward, at
   head dims 8, 48, 96, 160, 256, 320 and 512 (padded to the built
   widths; 160 and 256 on the 256-wide instances, in opted-in dynamic
   shared memory; 320 and 512 on the chunked kernels, 256 dims a CTA),
   fp32 and bf16, causal and not, with their CUDA launches per call and
   shared memory per block (read from a captured CUDA graph's kernel
   nodes)
   and, in bf16, their times at 256, 320 and 512; paged decode at head
   dim 1280 (the wide kernel) on a bf16 and an int8 pool; head dim 0
   must refuse at the default scale;
   loss and update kernels — the fused cross-entropy forward and backward
   at the MLM step's logits (49152 x 30522, bf16) and at edge cases
   (fp32, targets -1 and V, N not a multiple of 128), the fused AdamW over
   BERT-base's fp32 tree (2 applies) and over a bf16 tree, its whole call
   split into the kernel alone (profiler) and the host's work;
5. engine — the BERT-base-width causal LM (12 layers, hidden 768, vocab
   30522, bf16, seeded random weights) served by ``GenerationEngine`` with
   the fused paged decode route, with a bf16 and an int8 KV pool, on the
   seeded chat mix (32 requests, prompts of 4..127 tokens, 64 new tokens
   each); the kernels' launch counts must equal layers x prefills and
   layers x decode steps;
6. routes — the two decode routes agree at the model level;
7. fp32 — a 2-layer fp32 engine gives token-equal greedy streams on both
   routes and on the contiguous cache (``paged=False``);
8. profile — torch.profiler over a short engine run: the device's busy
   share of the wall time, the kernels that take the most device time,
   and the paged decode kernels' (split and merge) share;
   kv lifecycle fp32 — the paged engine's block lifecycle on a 2-layer
   fp32 copy, fused and gather routes: shared prefixes of 250 tokens
   (copy-on-write) and 256 (block-aligned), on-demand allocation with
   preemption, the same pool swapping to host, the automatic prefix
   cache; every stream token-equal to its reference, the counters exact;
   shared prefix — the JAX package's shared-prefix scenario at full width
   (bf16, 48 streams on one 256-token prefix, 8-token suffixes, 32 new
   tokens, fused): one prefix prefill, no stream prefill, 48 hits;
   occupancy — its occupancy leg (int8 pool of 256 blocks, 48 requests of
   a 64-token system prompt and short suffixes, 192 new tokens):
   ``reserve`` and ``on_demand`` with a 64-block prefix cache (preemptions
   and cache hits required), then ``on_demand`` swapping to host against
   an unpressured run (streams resumed by swap-in token-equal);
   contiguous — the engine phase's mix through ``paged=False`` beside the
   paged gather route in the same run: greedy streams token-equal, decode
   tokens/s and KV bytes per stream of each;
   speculative fp32 — a 2-layer fp32 copy with the grid's draft (1 layer,
   hidden 384, 12 heads, mlp 1536): k 2 and 4, gather and fused, float32
   and int8 pools, greedy and sampled streams token-equal to the plain
   engine's; a self-draft accepts >= 0.9; an on-demand pool preempts and
   stays token-equal;
   speculative — the JAX package's ``speculative_grid`` at its TPU
   settings (bf16 BERT-base target and draft, ``lm_head`` zeroed,
   acceptance 1.0, 16 slots, 32 requests, 64 new tokens), k 0, 2, 4, 8 x
   float32, int8 pools, fused: tokens/s, decode steps (fewer than k 0's
   in every k > 0 cell), acceptance, best speedup, row 6's launches
   (layers x (k + 1) per verify turn); then a self-draft with real logits
   at k 4, token-equal to the engine phase;
   resilience and qos — the engine phase's model, pool and mix under the
   serving resilience layer: the tracer off, an empty fault plan and the
   tracer on (decode tokens/s of each, every request's events);
   transient prefill and decode faults absorbed by retries (token-equal,
   retries == faults fired, success rate, p99 latency); a poisoned
   decode step failing typed; the engine breaker's open, typed shed and
   half-open probe; a watchdog restart whose stale step leaves the
   replacement's streams untouched; the QoS ratios (weights 3:1 over a
   preloaded queue, an interactive request overtaking a batch flood, a
   quota shed, a ``preemptible=False`` tenant never preempted on a tight
   on-demand pool); every engine's ledger and shutdown law, the thread
   count and ``torch.cuda.memory_allocated()`` back to their values
   before the phase; a merged Chrome trace to ``chiprun_out/``;
   front door — a ``ModelRegistry`` deployment of the same model behind
   the batching ``InferenceEngine`` (64 client threads of 1-4 128-token
   rows; every bucket batch bit-equal to a direct call, each request's
   rows its batch's rows, unpadded rows within 2^-5 of the row's largest
   logit; rows/s and latency), then two generation hosts on the card,
   each a process of its own (``--serve-host``) behind a
   ``HostRpcServer``, a directory fed by ``RemoteHost`` heartbeats and a
   hedging ``ClusterFrontDoor``: the mix replayed by ``LoadGenerator``
   token-equal to the engine phase on both hosts, again under seeded RPC
   faults (typed sheds only, none stuck; a stream resumed from its
   watermark equal to host 0's engine seated at its resume points) and
   with one host drained
   mid-replay (nothing shed); the shutdown law and the ledger at zero;
   disagg — disaggregated prefill/decode with KV page migration
   (:func:`disagg_phase`);
   mesh serving — the sharded serving engines (:func:`mesh_serving_phase`):
   (a) the engine phase's model, mix and both pools through
   ``GenerationEngine(mesh=)`` at world size 1 on NCCL, every stream
   token-equal to the engine phase's, rows 1 and 6 layers x prefills and
   layers x steps, one plan a prefill and a step, decode tokens/s, TTFT
   p50 and the plans' broadcast ms beside the engine phase's; (b) one
   prefill of four prompts and one decode step through the per-rank step
   bodies over 2 and 4 virtual 'model' ranks in one process (6 and 3
   heads of 64 a rank), rows 1 and 6 on the rank's heads, bf16 and int8
   pools, logits against the unsharded step within twice its own
   distance from fp32, fp32 tokens equal; (c) the front door's part a
   through ``InferenceEngine(mesh=)`` and ``CausalLMAdapter(mesh=)``,
   every bucket batch bit-equal to a direct call;
   ops — the op registry (``deeplearning4j_tpu_torch.ops``) on the card
   (:func:`ops_phase`): the two attention ops through the eager
   namespaces at BERT-base width, fp32 and bf16, forward and backward,
   on rows 1-2 (``multiHeadDotProductAttention``, and
   ``scaledDotProductAttentionFused`` at T = 1024) and rows 3-5 (at
   T = 4096), the einsum at T = 512 and under a mask with no launch,
   the refusals, both routes' ms at T = 512 and 1024; then every one of
   the 451 keys on CUDA NDArrays against the CPU
   (``tests/torch_op_cases.py``'s recipes); gradient sharing
   (``parallel/gradient_sharing.py``: three threshold-compression and
   int8 steps, ``thresholdEncode``/``Decode`` on the word embeddings) and
   the ten ``ops.updaters`` keys over the BERT-base tree against the CPU,
   ``adamUpdater`` leaf by leaf against ``fused_adamw``;
   networks — ``MultiLayerNetwork`` on the card (:func:`networks_phase`):
   (a) LeNet-MNIST (``tools/bench_configs.py``'s config #1, B=256, the
   ``MnistDataSetIterator`` surrogate, one epoch of 30 steps): images/s,
   accuracy > 0.9 on 1000 test images, its first 3 steps against the
   same seed's on the CPU; (b) the GravesLSTM char-RNN (config #3: two
   GravesLSTM(512), vocab 80, B=64, T=128): tokens/s, step ms, the loss
   falls, ``rnnTimeStep`` one step at a time against ``output()``; (c)
   two SelfAttentionLayer(768, 12 heads) at x (32, 512, 768), fp32 and
   bf16: rows 1 and 2 exactly 2 x steps (and two row-1 launches an
   ``output()``), none with ``attentionKernel=False`` or a features
   mask, the two routes' loss and gradients within the ops phase's
   attention tolerances, both routes' step ms; (d) ``ModelSerializer``:
   (c)'s fp32 net written and restored on the card (output bit-equal)
   and on the CPU, one more step on each on the same trajectory;
   graphs — ``ComputationGraph`` and the rest of the networks on the card
   (:func:`graphs_phase`): (e) ResNet-50 as a graph at full width (the
   port's ``zoo.ResNet50``, BASELINE config #2: B=32, 3x224x224, 1000
   classes, Adam 1e-3), FLOAT and HALF,
   2 warm-up and 8 timed steps: images/s, step ms, peak memory; the
   restored graph's output bit-equal; 2 steps at B=2 against the CPU;
   (f) the attention graph at x (32, 512, 768), 12 heads (two residual
   SelfAttentionLayers, merged, pooled), FLOAT and HALF: rows 1 and 2
   exactly 2 x 7 launches over 7 fit steps, none on the einsum route,
   the routes' loss and gradients within networks (c)'s rule; the
   attention-vertex graph launching no row; (g) transfer learning
   (frozen LeNet layers bit-unchanged) and early stopping with a file
   saver under ``chiprun_out/`` (the restored best model's score); (h)
   ``ParallelWrapper`` at world size 1 over NCCL on (e)'s graph, bit-equal
   to ``fit``; (i) the 27 new layer types and 12 vertex types on the
   card against the CPU, forward and gradients;
   samediff — SameDiff on the card (:func:`samediff_phase`): (a)
   BASELINE config #4, the BERT-base encoder built through the graph API
   as the TF importer emits it (``tests/torch_samediff_cases.py``: L=12,
   H=768, A=12, V=30522, T=128, intermediate 3072), its constants made
   trainable, ``fuseAttention`` (12 sites), an XAVIER MLM head,
   ``loss.sparseMcxent`` and Adam(1e-4) at B=32, FLOAT and HALF: 2
   warm-up and 8 timed steps, tokens/s, step ms, peak memory and rows
   1-5's launches (none: the fused op takes the einsum below T = 768),
   the loss falling; (b) the same 12-layer graph at T=1024, B=4, fp32
   and bf16: rows 1 and 2 exactly 12 times a fit step and row 1 12 times
   an ``output``, the fused graph against the unfused (layer 0's
   attention output by ``judge``, the encoder output, the loss and four
   gradients by networks (c)'s rule); (c) a 2-layer copy at T=2048, B=2
   on rows 3-5 (2 each a step), the same comparisons; (d) (a)'s graph
   saved with its Adam state and loaded: the output and one more step
   bit-equal; (e) ``ModelRegistry``/``InferenceEngine`` serving (a)'s
   encoder (``SameDiffAdapter``), LeNet (``MultiLayerNetworkAdapter``),
   the graphs phase's attention graph (``ComputationGraphAdapter``) and
   ``ParallelInference.engine()``: rows equal to the model's own call,
   rows/s; (f) ``check_gradients`` in float64 on a dense and a conv net;
   (g) ``train_with_checkpointing`` over a 2-layer fp32 BERT
   ``make_train_step(cfg, mesh)`` at world size 1 on NCCL, stopped by
   SIGTERM and resumed: bit-equal to the unbroken run;
   importers — the ONNX importer, ``OnnxRunner`` and the zoo on the card
   (:func:`importers_phase`): (a) config #4 written as ONNX bytes by the
   port's pure-Python writer (``tests/torch_onnx_cases.py``: the encoder
   node for node as an opset-13 exporter writes it) and imported with
   ``OnnxFrameworkImporter.runImport(bytes, device="cuda")``: the
   import's seconds, ``fuseAttention`` (12 sites), ``output`` at B=32,
   T=128 (tokens/s over 5 calls, peak memory, rows 1-5 none: the einsum
   below T = 768), the output against the unfused graph, the API-built
   encoder and the CPU import; (b) the same graph written at T=1024,
   B=4, constants made trainable, an MLM head: row 1 exactly 12 launches
   an ``output`` and rows 1 and 2 12 a fit step, fp32 and bf16, fused
   against unfused by (b)'s rule of the samediff phase; (c)
   ``OnnxRunner`` over (a)'s bytes bit-equal to (a)'s output; (d) the 16
   zoo architectures at their default input shapes, one ``output`` at
   B=2 each, against the CPU with the card's parameters (1e-4 of the
   largest |value|). The card has no ``h5py``: the Keras importer is
   tested on the CPU only;
   embeddings and rl — ``text/``, ``graph/``, ``rl/`` and ``arbiter/`` on
   the card (:func:`embeddings_rl_phase`; recipes in
   ``tests/torch_embedding_cases.py``; each cut printed on a ``reduced``
   line): (a) Word2Vec at 71,290 x 300 (text8's vocabulary at min-count
   5, GoogleNews' width, word2vec.c's window 5, 5 negatives, sample 1e-3,
   batch 512) on a seeded 1M-token corpus with 16 planted topic groups:
   skip-gram and CBOW, pairs/s, step ms, table bytes and peak memory, the
   groups nearest each other; skip-gram and CBOW on the full vocabulary
   in ~72k tokens, twice on the card (bit-equal, and equal to the same
   fit launched eagerly, without its CUDA graph) and once on the CPU
   (tables within 1e-5 of max|CPU|, the same nearest words up to ties),
   the device's busy share of a short fit (torch.profiler); (b) DeepWalk
   (d 128, window 10, walk length 40, 1 walk a vertex) on a
   BlogCatalog-sized power-law graph, twice (bit-equal), and on a
   1,000-vertex copy against the CPU; (c) GloVe (d 300, x_max 100, alpha
   0.75, window 10) on 40k tokens, FastText (fastText's dim 100, bucket
   2M, n-grams 3-6) on the full vocabulary in ~72k tokens with an OOV
   word, ParagraphVectors (fit, inferVector), each against the CPU on a
   cut copy; (a)'s vectors through the binary format read on the CPU and
   the card (bit-equal, rewrites byte-equal) and the doc vectors through
   npz; (d) DQN on CartPole at rl4j-examples' configuration for
   5000 steps (the last 10 episodes above the first 10), 20 updates on
   the card against the CPU from the same parameters, n-step Q and A2C
   over 16 lockstep CartPoles and 5 updates of each against the CPU; (e)
   a random search (4 candidates, lr and width of a dense net on the
   MNIST surrogate) on the card against the same search on the CPU;
9. mlm train — the port's ``make_train_step`` on bench.py's MLM step
   (BERT-base, bidirectional, ``attention_impl="flash"``, bf16, B=96,
   T=512, batch from numpy seed 0): 2 warm-up, 5 timed and 3 more steps
   on one batch; tokens/s, step ms, MFU (989e12 bf16 peak, H100 SXM data
   sheet) and peak memory; the loss must fall, the packed forward and
   backward launch layers x steps each and the streamed kernels never;
10. long-context train — the causal LM at B=2, T=8192, 12 layers: 1
    warm-up and 2 timed steps; the streamed forward, dq and dk/dv launch
    layers x steps each and the packed kernels never;
    mesh — the device mesh at world size 1 with torch.distributed on
    NCCL (a file store under ``chiprun_out/``), so the mesh route's
    collectives run on the card: (a) the MLM step through
    ``make_train_step(cfg, mesh)`` from the MLM phase's params and batch,
    its losses within 1e-3 of that phase's (bit-equal or not reported),
    the packed kernels layers x steps; (b) the T=8192 step under the mesh
    against the long-context phase, rows 3-5 layers x steps; (c) the
    ring's schedule in one process (``ring_flash_loop``,
    ``zigzag_ring_flash_loop``) over 4 virtual ranks at B=2, H=12,
    T=8192, D=64, bf16: the plain ring, the causal ring and the zigzag
    against the streamed kernels over the whole T, forward and dq/dk/dv
    (the backward passes fed the ring output's delta), rows 3-5 launching
    16, 10 and 36 times, each schedule's ms beside the unsharded
    kernels';
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

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import threading
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


# the failed checks of the running kernel phase (``kernel_checks``), else
# None: then a failed check raises at once
_FAILED = None


def check(ok: bool, msg: str):
    if ok:
        return
    if _FAILED is None:
        raise AssertionError(msg)
    _FAILED.append(msg)


def kernel_checks(phase):
    """``phase`` with its failed checks recorded instead of raised: the
    phase runs every case, prints the first failing check of each case
    (its label, before the colon) with its error, then fails."""
    def run(*args):
        global _FAILED
        failed = _FAILED = []
        try:
            out = phase(*args)
        finally:
            _FAILED = None
            first = {}
            for msg in failed:
                first.setdefault(msg.split(":")[0], msg)
            for case, msg in first.items():
                log(f"FAILED {case}: first failing check: {msg}")
        check(not failed, f"{len(failed)} kernel check(s) failed in "
              f"{len(first)} case(s); the first: "
              f"{failed[0] if failed else ''}")
        return out
    return run


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
    from deeplearning4j_tpu_torch.ops import pallas_updaters as updaters
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


def judge(a, b, d: int, p_bf16: bool, floor: float, terms=None):
    """(largest |a - b|, the largest share of its bound that an element
    takes, the bound's rule); the check passes when the share is <= 1.
    ``terms``: per element the sum of |the bf16-rounded terms| that were
    added in fp32 to make ``a``, each off by at most half an ulp, 2^-8 of
    itself — that much more is allowed."""
    import torch

    err = max_err(a, b)
    if p_bf16:
        return err, err / rel_bound(b, 5e-2), "5e-2 of max|ref|"
    a = a.float().unflatten(-1, (-1, d))
    b = b.float().unflatten(-1, (-1, d))
    diff = (a - b).abs()
    allowed = BF16_ULP * b.abs() \
        + floor * b.square().mean(-1, keepdim=True).sqrt()
    rule = f"2^-7|ref| + 2^{int(np.log2(floor))} rms(row)"
    if terms is not None:
        allowed = allowed + 2 ** -8 * terms.float().unflatten(-1, (-1, d))
        rule += " + 2^-8 sum|terms|"
    share = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / allowed).max().item()   # 0/0 counts as 0
    return err, share, rule


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
    log("build toolchain: " + _build.toolchain().replace("\n", " | "))
    # each library as loaded: a wrong result traces to a build or a launch
    for name in took:
        lib = _build.library(name)
        data = lib.read_bytes()
        log(f"  library {name}: {lib} {len(data)} bytes sha256 "
            f"{hashlib.sha256(data).hexdigest()}")
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
        again = ak.paged_decode_attention(q, kp, vp, tables, pos,
                                          block_size=B, k_scale=ks,
                                          v_scale=vs)
        ro = ak.paged_decode_attention_reference(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o.float()).all()),
              f"paged {kv}: non-finite output")
        # the splits merge in split-index order: the same bits every call
        check(torch.equal(o, again), f"paged {kv}: two calls differ")
        err = (o.float() - ro.float()).abs().max().item()
        # fp32 softmax on both sides (online here, whole-row there); the
        # bf16 output rounding can differ by 1 ulp: 2^-7 of the largest |o|
        tol = 2 ** -7 * max(ro.float().abs().max().item(), 1.0)
        check(err <= tol, f"paged {kv}: max |o - plain| {err} > {tol}")
        # and per element: one bf16 ulp of the element, 2^-7 |plain|, plus
        # 2^-12 of its head row's rms for fp32 sums in another order
        _, share, rule = judge(o, ro, D, False, PAGED_FLOOR)
        check(share <= 1.0, f"paged {kv}: an element takes {share} of its "
              f"bound {rule}")
        ms = time_ms(lambda: ak.paged_decode_attention(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs))
        plain_ms = time_ms(lambda: ak.paged_decode_attention_reference(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs))
        lib_ms = paged_sdpa_ms(q, kp, vp, tables, pos, B, ks, vs)
        n_pos = int((pos_np.astype(np.int64) + 1).sum())
        item = kp.element_size()
        nbytes = 2 * n_pos * H * D * item + 2 * S * H * D * 2 \
            + (2 * n_pos * H * 4 if kv == "int8" else 0) \
            + tables_np.nbytes + pos_np.nbytes
        flops = 4 * n_pos * H * D
        b_ms, b_by = bound(nbytes, flops)
        log(f"paged {kv}: max_abs_err {err:.3e} (tol {tol:.3e}; "
            f"{share:.3f} of the per-element bound {rule}), two calls "
            f"bit-equal; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"{PAGED_LIBRARY} {lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by}) "
            f"positions {n_pos} splits {ak.paged_decode_plan(nbmax, B)}")
        paged_rows.append(dict(case=f"{kv} pool", max_abs_err=err, tol=tol,
                               bound_share=share, ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=b_ms,
                               bound_by=b_by))
    paged_rows += paged_edge_cases(rng)
    return packed_rows, paged_rows


# the library yardstick of row 6 (timed only, never called by the port)
PAGED_LIBRARY = "sdpa on pre-gathered K/V, gather not timed"
# per-element floor of the paged check, in units of the head row's rms
PAGED_FLOOR = 2 ** -12


def paged_sdpa_ms(q, kp, vp, tables, pos, B, ks, vs):
    """``F.scaled_dot_product_attention`` on K/V already gathered into
    (S, H, L, D) in q's dtype (int8 pools dequantized first) with a boolean
    mask for pos: the one-call library form of paged decode, the gather
    left out of the time."""
    import torch
    import torch.nn.functional as F

    S, H, D = q.shape
    nbmax = tables.shape[1]
    L = nbmax * B
    tl = tables.long()

    def gathered(pool, scale):
        g = pool[tl].float()
        if scale is not None:
            g = g * scale[tl][..., None]
        return g.reshape(S, L, H, D).transpose(1, 2).to(q.dtype).contiguous()
    k4, v4 = gathered(kp, ks), gathered(vp, vs)
    mask = (torch.arange(L, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask))


def paged_edge_cases(rng):
    """Row 6 off the serving shape, each against its plain version per
    element and called twice for the same bits: a block-64 pool at head dim
    128 (over the previous kernel's 48 KB stage), fp32 and int8 pools with
    pos on the split edges, past the table, -1 and a dead slot."""
    import torch

    from deeplearning4j_tpu_torch.models import quantize_kv
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    rows = []
    for label, B, nbmax, D, pool, q_dtype in (
            ("block 64 D128 bf16 pool", 64, 8, 128, "bf16", torch.bfloat16),
            ("split edges fp32 pool", 16, 32, 64, "fp32", torch.float32),
            ("split edges int8 pool", 16, 32, 64, "int8", torch.bfloat16)):
        H = 12
        per, _ = ak.paged_decode_plan(nbmax, B)
        span, L = per * B, nbmax * B
        pos_np = np.array([0, span - 1, span, 2 * span, L - 1, L + 5, -1, 0],
                          np.int32)
        S, NB = len(pos_np), nbmax * len(pos_np) + 1
        perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
        tables_np = np.zeros((S, nbmax), np.int32)
        for s in range(S - 1):                    # the last slot is dead
            tables_np[s] = perm[s * nbmax:(s + 1) * nbmax]
        q = torch.as_tensor(rng.standard_normal((S, H, D)),
                            dtype=torch.float32).to("cuda", q_dtype)
        kf, vf = (torch.as_tensor(rng.standard_normal((NB, B, H, D)),
                                  dtype=torch.float32, device="cuda")
                  for _ in range(2))
        ks = vs = None
        if pool == "int8":
            (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
        elif pool == "bf16":
            kp, vp = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        else:
            kp, vp = kf, vf
        tables = torch.as_tensor(tables_np, device="cuda")
        pos = torch.as_tensor(pos_np, device="cuda")

        def call():
            return ak.paged_decode_attention(q, kp, vp, tables, pos,
                                             block_size=B, k_scale=ks,
                                             v_scale=vs)
        o, again = call(), call()
        ro = ak.paged_decode_attention_reference(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        check(torch.equal(o, again), f"paged {label}: two calls differ")
        # pos < 0 gives zeros, as the JAX package's Pallas kernel does (its
        # gather reference, like the plain version, softmaxes a row of
        # masked scores instead): held apart from the plain comparison
        check(bool((o[6] == 0).all()), f"paged {label}: pos -1 is not 0")
        live = [s for s in range(S) if s != 6]
        o, ro = o[live], ro[live]
        err = max_err(o, ro)
        if q_dtype == torch.float32:
            # fp32 both sides, summation order aside
            share = err / rel_bound(ro, 1e-5)
            rule = "1e-5 max|ref|"
        else:
            _, share, rule = judge(o, ro, D, False, PAGED_FLOOR)
        check(share <= 1.0, f"paged {label}: max err {err} takes {share} of "
              f"its bound {rule}")
        log(f"paged {label}: max_abs_err {err:.3e} ({share:.3f} of its "
            f"bound {rule}), two calls bit-equal, splits "
            f"{ak.paged_decode_plan(nbmax, B)}")
        rows.append(dict(case=label, max_abs_err=err, bound_share=share,
                         tol=rule))
    return rows


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


def head_dim_phase():
    """Head dims off BERT-base's 64, which the kernels run padded to the
    next built width or, past 256, in 256-wide chunks: the packed forward
    and backward (B=2, T=128, 4 heads) and the streamed forward, dq and
    dk/dv (BH=4, T=256) at D = 8, 48, 96, 160, 256, 320 and 512 (160 and
    256 on the 256-wide instances, their tiles in opted-in dynamic shared
    memory; 320 and 512 on the chunked kernels at those tiles), fp32 and
    bf16, causal and not, against the plain versions: fp32 to 1e-5
    (forward) or 1e-4 (backward) of the largest |plain|, bf16 per element
    (``judge``). Each call must launch its kernel. Then paged decode at
    D = 1280 (the wide kernel, two 1024-dim chunks) on a bf16 and an int8
    pool, held as the kernels phase holds row 6. D = 0 must refuse at the
    default scale. Each wrapper's CUDA launches per call and the shared
    memory of each launch's block are read from the profiler's kernel
    records (``head_dim_launches``); at D = 320 and 512 they must equal
    D = 256's."""
    import torch

    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    rng = np.random.default_rng(4)
    worst, smem = {}, {}
    calls = (ak.mha_attention_packed, ak.mha_packed_backward,
             ak.flash_forward, ak.flash_bwd_dq, ak.flash_bwd_dkv)
    for d in (8, 48, 96, 160, 256, 320, 512):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                def rand(shape):
                    return torch.as_tensor(
                        rng.standard_normal(shape),
                        dtype=torch.float32).to(DEVICE, dtype)
                q, k, v, do = (rand((2, 128, 4 * d)) for _ in range(4))
                before = [c.launches for c in calls]
                o, lse = ak.mha_packed_forward(q, k, v, 4, causal)
                ro, rlse = ak.mha_packed_forward_reference(q, k, v, 4,
                                                           causal)
                got = ak.mha_packed_backward(q, k, v, do, rlse, 4, causal)
                ref = ak.mha_packed_backward_reference(q, k, v, do, rlse, 4,
                                                       causal)
                pairs = [("packed o", o, ro, FWD_FLOOR)] + [
                    (f"packed d{n}", a, b, BWD_FLOOR)
                    for n, a, b in zip("qkv", got, ref)]
                lse_errs = [max_err(lse, rlse)]
                qs, ks_, vs_, dos = (rand((4, 256, d)) for _ in range(4))
                o, lse = ak.flash_forward(qs, ks_, vs_, causal)
                ro, rlse = ak.flash_forward_reference(qs, ks_, vs_, causal)
                delta = (dos.float() * ro.float()).sum(-1).reshape(4, 1, 256)
                got = (ak.flash_bwd_dq(qs, ks_, vs_, dos, rlse, delta,
                                       causal),
                       *ak.flash_bwd_dkv(qs, ks_, vs_, dos, rlse, delta,
                                         causal))
                ref = (ak.flash_bwd_dq_reference(qs, ks_, vs_, dos, rlse,
                                                 delta, causal),
                       *ak.flash_bwd_dkv_reference(qs, ks_, vs_, dos, rlse,
                                                   delta, causal))
                pairs += [("streamed o", o, ro, FWD_FLOOR)] + [
                    (f"streamed d{n}", a, b, BWD_FLOOR)
                    for n, a, b in zip("qkv", got, ref)]
                lse_errs.append(max_err(lse, rlse))
                torch.cuda.synchronize()
                label = (f"D{d} {str(dtype).split('.')[-1]} "
                         f"{'causal' if causal else 'non-causal'}")
                check([c.launches - n for c, n in zip(calls, before)]
                      == [1] * len(calls),
                      f"head dims {label}: a kernel did not launch once")
                share = 0.0
                for name, a, b, floor in pairs:
                    if dtype == torch.float32:
                        rel = 1e-5 if floor == FWD_FLOOR else 1e-4
                        sh = max_err(a, b) / rel_bound(b, rel)
                        rule = f"{rel:g} max|ref|"
                    else:
                        _, sh, rule = judge(a, b, d, False, floor)
                    check(sh <= 1.0, f"head dims {label}: {name} takes {sh} "
                          f"of its bound {rule}")
                    share = max(share, sh)
                lse_tol = 1e-5 if dtype == torch.float32 else 1e-3
                check(max(lse_errs) <= lse_tol, f"head dims {label}: lse "
                      f"err {max(lse_errs)} > {lse_tol}")
                worst[label] = share
        smem[d] = head_dim_launches(rng, d)
        log(f"head dims: D{d} bf16: CUDA launches per call and shared "
            f"memory per block (bytes), from the captured graph's kernel "
            f"nodes: {json.dumps(smem[d])}; "
            f"{-(-d // ak.ATTENTION_CHUNK)} CTA(s) per (row tile, head), "
            f"one per {ak.ATTENTION_CHUNK}-dim chunk")
    for d in (320, 512):
        check(smem[d] == smem[256], f"head dims: D{d}'s launches and shared "
              f"memory {smem[d]} differ from D256's {smem[256]}: the "
              "chunked kernels should hold the 256-wide tiles")
    log("head dims: worst share of the bound per case: "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    # the chunked kernels' cost against the 256-wide instance's, bf16,
    # non-causal, at the shapes above
    for d in (256, 320, 512):
        q, k, v, do = (torch.as_tensor(rng.standard_normal((2, 128, 4 * d)),
                                       dtype=torch.float32).to(
            DEVICE, torch.bfloat16) for _ in range(4))
        qs, ks_, vs_, dos = (x.reshape(2, 128, 4, d).transpose(1, 2)
                             .reshape(8, 128, d).contiguous()
                             for x in (q, k, v, do))
        _, lse = ak.mha_packed_forward(q, k, v, 4)
        o, slse = ak.flash_forward(qs, ks_, vs_)
        delta = (dos.float() * o.float()).sum(-1).reshape(8, 1, 128)
        ms = {"packed forward": time_ms(
                  lambda: ak.mha_packed_forward(q, k, v, 4)),
              "packed backward": time_ms(
                  lambda: ak.mha_packed_backward(q, k, v, do, lse, 4)),
              "streamed forward": time_ms(
                  lambda: ak.flash_forward(qs, ks_, vs_)),
              "streamed dq": time_ms(
                  lambda: ak.flash_bwd_dq(qs, ks_, vs_, dos, slse, delta)),
              "streamed dk/dv": time_ms(
                  lambda: ak.flash_bwd_dkv(qs, ks_, vs_, dos, slse, delta))}
        log(f"head dims: D{d} bf16 (B=2 T=128 H=4 packed, BH=8 T=128 "
            "streamed) ms: " + json.dumps(ms))
    wide_paged_cases(rng)
    q = torch.zeros(1, 8, 0, device=DEVICE)
    try:
        ak.mha_packed_forward(q, q, q, 2)
    except ValueError as e:
        check("head_dim >= 1" in str(e), f"head dim 0 refused without "
              f"naming the bound: {e}")
        log(f"head dims: D = 0 refuses: {e}")
    else:
        raise AssertionError("head dim 0 ran: the kernels take D >= 1")


def head_dim_launches(rng, d):
    """Each attention wrapper called once at head dim ``d`` (bf16,
    non-causal, the phase's shapes), captured in a CUDA graph: per call,
    the shared memory per block of each kernel launch, in launch order,
    as the driver holds it. Fails unless the forward and each
    streamed pass launch once, the packed backward twice (dq, then
    dk/dv), and every block fits the card's shared memory."""
    import torch

    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.profiler import cuda_launches

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(DEVICE, torch.bfloat16)

    q, k, v, do = (rand((2, 128, 4 * d)) for _ in range(4))
    qs, ks_, vs_, dos = (rand((4, 256, d)) for _ in range(4))
    _, lse = ak.mha_packed_forward(q, k, v, 4)
    o, slse = ak.flash_forward(qs, ks_, vs_)
    delta = (dos.float() * o.float()).sum(-1).reshape(4, 1, 256)
    calls = {"packed forward": (lambda: ak.mha_packed_forward(q, k, v, 4), 1),
             "packed backward": (
                 lambda: ak.mha_packed_backward(q, k, v, do, lse, 4), 2),
             "streamed forward": (lambda: ak.flash_forward(qs, ks_, vs_), 1),
             "streamed dq": (lambda: ak.flash_bwd_dq(
                 qs, ks_, vs_, dos, slse, delta), 1),
             "streamed dk/dv": (lambda: ak.flash_bwd_dkv(
                 qs, ks_, vs_, dos, slse, delta), 1)}
    out = {}
    for name, (fn, want) in calls.items():
        got = cuda_launches(fn)
        check(len(got) == want, f"head dims D{d}: {name} made {len(got)} "
              f"CUDA launches ({[g['name'] for g in got]}), expected {want}")
        out[name] = [g["shared_memory"] for g in got]
        check(max(out[name]) <= ak.MAX_BLOCK_SMEM_BYTES, f"head dims D{d}: "
              f"{name} takes {out[name]} bytes a block")
    return out


def wide_paged_cases(rng):
    """Row 6 at head dim 1280 (the wide kernel: two 1024-dim chunks a
    (split, head), the scores summed over the whole row in each), 16
    slots of 4 heads over a 32-entry table of 16-token blocks (8 splits
    and the merge), bf16 and int8 pools, against the plain version: two
    calls bit-equal, 2^-7 of the largest |o|, and per element as the
    kernels phase holds row 6."""
    import torch

    from deeplearning4j_tpu_torch.models import quantize_kv
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.profiler import cuda_launches

    S, H, D, B, nbmax = 16, 4, 1280, 16, 32
    NB = S * nbmax + 1
    per, n_splits = ak.paged_decode_plan(nbmax, B)
    for kv in ("bf16", "int8"):
        q = torch.as_tensor(rng.standard_normal((S, H, D)),
                            dtype=torch.float32).to(DEVICE, torch.bfloat16)
        kf = torch.as_tensor(rng.standard_normal((NB, B, H, D)),
                             dtype=torch.float32, device=DEVICE)
        vf = torch.as_tensor(rng.standard_normal((NB, B, H, D)),
                             dtype=torch.float32, device=DEVICE)
        if kv == "int8":
            kp, ks = quantize_kv(kf)
            vp, vs = quantize_kv(vf)
        else:
            kp, vp = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
            ks = vs = None
        del kf, vf
        pos_np = rng.integers(0, nbmax * B, S).astype(np.int32)
        pos_np[3] = 0                           # a dead slot
        tables_np = np.zeros((S, nbmax), np.int32)
        perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
        for s in range(S):
            if s != 3:
                n = pos_np[s] // B + 1
                tables_np[s, :n] = perm[s * nbmax:s * nbmax + n]
        tables = torch.as_tensor(tables_np, device=DEVICE)
        pos = torch.as_tensor(pos_np, device=DEVICE)
        before = ak.paged_decode_attention.launches
        o = ak.paged_decode_attention(q, kp, vp, tables, pos, block_size=B,
                                      k_scale=ks, v_scale=vs)
        again = ak.paged_decode_attention(q, kp, vp, tables, pos,
                                          block_size=B, k_scale=ks,
                                          v_scale=vs)
        ro = ak.paged_decode_attention_reference(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        check(ak.paged_decode_attention.launches == before + 2,
              f"head dims paged D{D} {kv}: the kernel did not launch")
        check(torch.equal(o, again), f"head dims paged D{D} {kv}: two "
              "calls differ")
        err = (o.float() - ro.float()).abs().max().item()
        tol = 2 ** -7 * max(ro.float().abs().max().item(), 1.0)
        check(err <= tol, f"head dims paged D{D} {kv}: max |o - plain| "
              f"{err} > {tol}")
        _, share, rule = judge(o, ro, D, False, PAGED_FLOOR)
        check(share <= 1.0, f"head dims paged D{D} {kv}: an element takes "
              f"{share} of its bound {rule}")
        got = cuda_launches(lambda: ak.paged_decode_attention(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs))
        check(len(got) == 1 + (n_splits > 1), f"head dims paged D{D} {kv}: "
              f"{len(got)} CUDA launches, expected the split pass"
              f"{' and the merge' if n_splits > 1 else ''}")
        launched = [(g["name"].split("<")[0].split()[-1], g["shared_memory"])
                    for g in got]
        ms = time_ms(lambda: ak.paged_decode_attention(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs))
        plain_ms = time_ms(lambda: ak.paged_decode_attention_reference(
            q, kp, vp, tables, pos, block_size=B, k_scale=ks, v_scale=vs),
            iters=3, reps=3, graph=False)
        n_pos = int((pos_np.astype(np.int64) + 1).sum())
        nbytes = 2 * n_pos * H * D * kp.element_size() + 2 * S * H * D * 2 \
            + (2 * n_pos * H * 4 if kv == "int8" else 0) \
            + tables_np.nbytes + pos_np.nbytes
        b_ms, b_by = bound(nbytes, 4 * n_pos * H * D)
        log(f"head dims: paged D{D} {kv} pool: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}; {share:.3f} of {rule}), two calls bit-equal; "
            f"splits {n_splits} of {per} blocks, CUDA launches per call "
            f"and shared memory per block (bytes), from the captured "
            f"graph's kernel nodes: {launched}; "
            f"{-(-D // ak.PAGED_CHUNK)} CTA(s) per (split, head); kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.5f} ms "
            f"({b_by})")
        del q, kp, vp, o, again, ro
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


def engine_phase(cfg, params, prompts, device="cuda", max_new=64,
                 mesh=None, label="engine", pools=("float32", "int8")):
    """The mix through the fused route on each of ``pools`` (under
    ``mesh`` the sharded engine, whose plans' broadcast time is reported
    too; a follower rank of the mesh only follows, and returns no run)."""
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, ServingMetrics)

    results = {}
    for kv in pools:
        with GenerationEngine(params, cfg, mesh=mesh, slots=16,
                              max_len=cfg.max_seq,
                              paged_attention="fused", kv_dtype=kv,
                              queue_capacity=len(prompts) + 16,
                              device=device) as eng:
            if not eng.is_driver:
                continue   # leaving the block waits for the driver's end
            eng.warmup()
            eng.metrics = ServingMetrics()   # the engine is idle here
            plans0 = eng.plan_stats()
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
            plans1 = eng.plan_stats()
        check(all(len(o) == max_new for o in outs),
              f"{label} {kv}: a stream returned fewer than {max_new} tokens")
        check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
              f"{label} {kv}: token id out of range")
        prefills = int(m.prefills_total.value)
        steps = int(m.decode_steps_total.value)
        check(prefills == len(prompts),
              f"{label} {kv}: {prefills} prefills for {len(prompts)} "
              "prompts")
        check(packed_n == cfg.layers * prefills,
              f"{label} {kv}: packed kernel launched {packed_n} times, "
              f"expected layers x prefills = {cfg.layers * prefills}")
        check(paged_n == cfg.layers * steps,
              f"{label} {kv}: paged kernel launched {paged_n} times, "
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
        if plans1 is not None:
            # the run's plans: one a prefill and a decode step (and none
            # else: no swap, draft or restart on this path)
            n = plans1["plans"] - plans0["plans"]
            ms = plans1["plan_ms"] - plans0["plan_ms"]
            check(n == prefills + steps,
                  f"{label} {kv}: {n} plans for {prefills} prefills and "
                  f"{steps} decode steps")
            stats.update(plans=n, plan_ms_total=ms,
                         plan_ms_per_step=ms / n,
                         plan_share_of_decode_step=ms / n
                         / m.decode_step_ms.mean)
        log(f"{label} kv_dtype={kv}: " + json.dumps(stats))
        results[kv] = dict(stats, streams=outs)
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
    token-equal between the fused and gather routes and the contiguous
    cache (``paged=False``)."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.models import init_params
    from deeplearning4j_tpu_torch.serving import GenerationEngine

    cfg = dataclasses.replace(cfg, layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device=device)
    streams = {}
    for route, paged in (("fused", True), ("gather", True),
                         ("gather", False)):
        with GenerationEngine(params, cfg, slots=8, max_len=cfg.max_seq,
                              paged=paged, paged_attention=route,
                              device=device) as eng:
            hs = [eng.submit(p, max_new_tokens=16) for p in prompts[:8]]
            streams[route if paged else "contiguous"] = [
                h.result(timeout=600) for h in hs]
    check(streams["fused"] == streams["gather"],
          "fp32 engine: fused and gather greedy streams differ")
    check(streams["contiguous"] == streams["gather"],
          "fp32 engine: paged=False and paged greedy streams differ")
    log(f"fp32 2-layer engine: {len(streams['fused'])} greedy streams "
        "token-equal on fused, gather and paged=False")


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
    kernels = report_profile(prof, wall_ms, "profile")
    busy = sum(ms for _, ms, _ in kernels)
    for part in ("paged_decode_split_kernel", "paged_decode_combine_kernel"):
        ms = sum(m for name, m, _ in kernels if part in name)
        n = sum(c for name, _, c in kernels if part in name)
        log(f"profile: {part} {ms:.3f} ms x{n} "
            f"({100 * ms / busy:.2f}% of device time)")


PREFIX_COUNTERS = ("prefix_prefills_total", "prefills_total",
                   "prefix_hits_total", "kv_cow_copies_total")


def kv_lifecycle_phase(cfg, device="cuda"):
    """The paged engine's block lifecycle on a 2-layer fp32 copy of ``cfg``
    (BERT-base widths, as ``fp32_phase`` builds it), on the fused and the
    gather route. Every stream below must be token-equal to its reference:

    - shared prefix: prefixes of 250 tokens (its tail block copied on
      write) and 256 (block-aligned), 8 streams of 8-token suffixes each
      against plain submits of prefix + suffix: one prefix prefill, no
      stream prefill, 8 hits, 8 (250) or 0 (256) copy-on-write copies;
    - on-demand allocation: 4 streams (2 greedy, 2 sampled) of 40-token
      prompts and 64 new tokens in a pool of 16 usable blocks (their worst
      case is 28): at least one preemption, streams equal to their solo
      runs on an unpressured pool;
    - the same pool with ``swap_threshold_blocks=0``: at least one block
      swapped out and back, streams equal to the solo runs;
    - the prefix cache: 6 prompts sharing a 64-token system prompt hit it
      with no opt-in, streams equal to a cache-less engine's.

    Prints the paged kernel's launches per route."""
    import torch

    from deeplearning4j_tpu_torch.models import init_params
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.serving import GenerationEngine

    cfg = dataclasses.replace(cfg, layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device=device)
    V = cfg.vocab_size

    def engine(route, **kw):
        kw = {**dict(slots=8, max_len=cfg.max_seq, queue_capacity=64), **kw}
        return GenerationEngine(params, cfg, paged_attention=route,
                                device=device, **kw)

    def serve(eng, reqs):
        hs = [eng.submit(p, **kw) for p, kw in reqs]
        return [h.result(timeout=600) for h in hs], hs

    rng = np.random.default_rng(11)
    prefixes = {n: rng.integers(0, V, n).astype(np.int32) for n in (250, 256)}
    suffixes = [rng.integers(0, V, 8).astype(np.int32) for _ in range(8)]
    tight = [(rng.integers(0, V, 40).astype(np.int32),
              dict(max_new_tokens=64, eos_id=None, seed=i,
                   **({} if i % 2 == 0 else dict(temperature=1.0,
                                                 top_k=40))))
             for i in range(4)]
    sysp = rng.integers(0, V, 64).astype(np.int32)
    chat = [(np.concatenate([sysp, rng.integers(0, V, 8)]).astype(np.int32),
             dict(max_new_tokens=16, eos_id=None)) for _ in range(6)]
    summary = {}
    for route in ("fused", "gather"):
        ak.paged_decode_attention.launches = 0
        for plen, want_cow in ((250, 8), (256, 0)):
            pre = prefixes[plen]
            with engine(route) as eng:
                plain, _ = serve(eng, [(np.concatenate([pre, sfx]),
                                        dict(max_new_tokens=16))
                                       for sfx in suffixes])
                base = {k: getattr(eng.metrics, k).value
                        for k in PREFIX_COUNTERS}
                pid = eng.register_prefix(pre)
                got, _ = serve(eng, [(sfx, dict(prefix_id=pid,
                                                max_new_tokens=16))
                                     for sfx in suffixes])
                d = {k: int(getattr(eng.metrics, k).value - v)
                     for k, v in base.items()}
                check(eng.release_prefix(pid), "prefix was not registered")
            check(got == plain, f"kv lifecycle {route}: prefix {plen} "
                  "streams differ from prefix + suffix submits")
            want = {"prefix_prefills_total": 1, "prefills_total": 0,
                    "prefix_hits_total": 8, "kv_cow_copies_total": want_cow}
            check(d == want, f"kv lifecycle {route}: prefix {plen} counts "
                  f"{d}, expected {want}")
            summary[f"{route} prefix {plen}"] = d
        with engine(route) as eng:
            solo = [eng.generate(p, timeout=600, **kw) for p, kw in tight]
        for label, extra in (("on_demand", {}),
                             ("swap", dict(swap_threshold_blocks=0))):
            with engine(route, slots=4, num_blocks=17,
                        allocate="on_demand", **extra) as eng:
                got, hs = serve(eng, tight)
                m = eng.metrics
                stats = dict(preemptions=int(m.preemptions_total.value),
                             swapped_blocks=int(m.kv_swapped_blocks.value),
                             swap_bytes_out=int(m.kv_swap_bytes_out.value),
                             swap_bytes_in=int(m.kv_swap_bytes_in.value),
                             prefills=int(m.prefills_total.value))
            check(got == solo, f"kv lifecycle {route} {label}: streams "
                  "differ from their solo runs")
            check(stats["preemptions"] >= 1,
                  f"kv lifecycle {route} {label}: no preemption")
            if label == "swap":
                check(stats["swapped_blocks"] >= 1
                      and stats["swap_bytes_in"] == stats["swap_bytes_out"],
                      f"kv lifecycle {route} swap: {stats}")
            summary[f"{route} {label}"] = stats
        with engine(route) as eng:
            want = [eng.generate(p, timeout=600, **kw) for p, kw in chat]
        with engine(route, prefix_cache_blocks=32) as eng:
            got = [eng.generate(chat[0][0], timeout=600, **chat[0][1])]
            more, _ = serve(eng, chat[1:])
            got += more
            hits = int(eng.metrics.prefix_cache_hits_total.value)
        check(got == want, f"kv lifecycle {route}: prefix-cache streams "
              "differ from a cache-less engine's")
        check(hits >= 1, f"kv lifecycle {route}: no prefix-cache hit")
        summary[f"{route} prefix cache hits"] = hits
        summary[f"{route} paged launches"] = \
            ak.paged_decode_attention.launches
        check(route != "fused" or ak.paged_decode_attention.launches > 0,
              "kv lifecycle fused: the paged kernel never launched")
    log("kv lifecycle fp32: every stream token-equal on both routes; "
        + json.dumps(summary))


def shared_prefix_phase(cfg, params, device="cuda"):
    """The JAX package's shared-prefix scenario at its TPU settings
    (``bench.py`` ``shared_prefix_scenario``): 16 slots, max_len 512, 48
    streams of 8-token suffixes on one 256-token prefix, 32 new tokens
    each, fused route, bf16. One prefix prefill, no stream prefill, 48
    hits; TTFT on the ``on_token`` clock and from the histogram."""
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, ServingMetrics)

    n_streams, prefix_len, suffix_len, max_new = 48, 256, 8, 32
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len).astype(np.int32)
    with GenerationEngine(params, cfg, slots=16, max_len=512,
                          paged_attention="fused",
                          queue_capacity=n_streams + 16,
                          device=device) as eng:
        eng.warmup()
        eng.metrics = ServingMetrics()   # the engine is idle here
        ak.paged_decode_attention.launches = 0
        ak.mha_attention_packed.launches = 0
        t0 = time.perf_counter()
        pid = eng.register_prefix(prefix)
        first, handles = {}, []
        for i in range(n_streams):
            t_sub = time.perf_counter()
            first[i] = None

            def on_tok(_tok, i=i, t_sub=t_sub):
                if first[i] is None:
                    first[i] = (time.perf_counter() - t_sub) * 1e3
            handles.append(eng.submit(
                rng.integers(0, cfg.vocab_size, suffix_len).astype(np.int32),
                prefix_id=pid, max_new_tokens=max_new, on_token=on_tok))
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        m = eng.metrics
        stats = dict(
            streams=n_streams, prefix_tokens=prefix_len,
            suffix_tokens=suffix_len, max_new_tokens=max_new,
            prefix_prefills=int(m.prefix_prefills_total.value),
            stream_prefills=int(m.prefills_total.value),
            prefix_hits=int(m.prefix_hits_total.value),
            cow_copies=int(m.kv_cow_copies_total.value),
            ttft_ms_p50=float(np.median(list(first.values()))),
            ttft_ms_p50_histogram=m.ttft_ms.quantile(0.5),
            end_to_end_tokens_per_sec=n_streams * max_new / wall,
            decode_steps=int(m.decode_steps_total.value),
            paged_launches=ak.paged_decode_attention.launches,
            packed_launches=ak.mha_attention_packed.launches)
    check(all(len(o) == max_new for o in outs)
          and all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "shared prefix: a stream is short or holds an out-of-range id")
    check((stats["prefix_prefills"], stats["stream_prefills"],
           stats["prefix_hits"]) == (1, 0, n_streams),
          f"shared prefix: {stats}")
    check(stats["paged_launches"] == cfg.layers * stats["decode_steps"],
          "shared prefix: paged kernel launches != layers x decode steps")
    log(f"shared prefix ({CARD}): " + json.dumps(stats))
    return stats


def occupancy_phase(cfg, params, device="cuda"):
    """The JAX package's occupancy leg at its TPU settings (``bench.py``
    ``occupancy_leg``): 16 slots, max_len 512, 16-token blocks, an int8
    pool of 15 x 17 + 1 = 256 blocks (the worst case seats 15 streams),
    48 requests of a 64-token system prompt and 2..15-token suffixes, 192
    new tokens each, fused route, bf16. Cells ``reserve`` and
    ``on_demand`` (with a 64-block prefix cache): the on-demand cell must
    preempt and hit the cache. Then ``on_demand`` with
    ``swap_threshold_blocks=0``, ``swap_capacity_blocks=64`` and no cache,
    against ``reserve`` on an unpressured pool (513 blocks: no stream
    waits for blocks or is preempted): every stream never preempted or
    resumed only by swap-in must be token-equal to its unpressured run,
    and at least one must have swapped in."""
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, ServingMetrics, kv_bytes_per_token)

    slots, max_len, block, n_requests = 16, 512, 16, 48
    sys_len, sfx_hi, max_new, cache_blocks = 64, 16, 192, 64
    num_blocks = (slots - 1) * (-(-(sys_len + sfx_hi + max_new) // block)) \
        + 1
    itemsize = 2 if "bfloat16" in str(cfg.dtype) else 4
    contig_stream_bytes = max_len * kv_bytes_per_token(
        cfg.layers, cfg.heads, cfg.head_dim, "float32", itemsize)

    def mix():
        rng = np.random.default_rng(0)   # the same mix in every run
        sysp = rng.integers(0, cfg.vocab_size, sys_len)
        return [np.concatenate([sysp, rng.integers(
            0, cfg.vocab_size, int(rng.integers(2, sfx_hi)))]).astype(
                np.int32) for _ in range(n_requests)]

    def cell(allocate, prefix_cache_blocks=0, **kw):
        with GenerationEngine(params, cfg, slots=slots, max_len=max_len,
                              block_size=block,
                              num_blocks=kw.pop("num_blocks", num_blocks),
                              kv_dtype="int8", allocate=allocate,
                              prefix_cache_blocks=prefix_cache_blocks,
                              paged_attention="fused",
                              queue_capacity=n_requests + slots,
                              device=device, **kw) as eng:
            eng.warmup()
            eng.metrics = ServingMetrics()
            eng.metrics.kv_blocks_total.set(eng._allocator.capacity)
            ak.paged_decode_attention.launches = 0
            t0 = time.perf_counter()
            handles = [eng.submit(p, max_new_tokens=max_new, eos_id=None)
                       for p in mix()]
            occ, blk, slack, socc, cblk, steady = [], [], [], [], [], []
            while True:
                sample = (eng.metrics.kv_block_occupancy.value,
                          eng.metrics.kv_blocks_in_use.value,
                          eng.metrics.kv_reservation_slack.value,
                          eng.metrics.slot_occupancy.value,
                          eng.metrics.prefix_cache_blocks.value)
                for xs, v in zip((occ, blk, slack, socc, cblk), sample):
                    xs.append(v)
                if eng.queue_depth > 0 and sample[3] > 0:
                    steady.append(sample)   # every seat contested
                if handles[-1].future.done():
                    break
                # every wake takes the GIL from the scheduler thread, whose
                # eager decode loop is host-bound: sample at 50 ms
                time.sleep(0.05)
            if len(steady) >= 3:
                occ, blk, slack, socc, cblk = (list(x) for x in zip(*steady))
            outs = [h.result(timeout=900) for h in handles]
            wall_s = time.perf_counter() - t0
            m = eng.metrics
            greqs = [h._req.x for h in handles]
        blocks_in_use = float(np.median(blk))
        resident = float(np.median(socc)) * slots
        tokens_out = m.generated_tokens_total.value
        stream_blocks = max(0.0, blocks_in_use - float(np.median(cblk)))
        stream_bytes = stream_blocks * eng.kv_block_bytes / resident \
            if stream_blocks > 0 and resident > 0 else None
        stats = {
            "allocate": allocate,
            "prefix_cache_blocks": prefix_cache_blocks,
            "steady_state_pool_occupancy": float(np.median(occ)),
            "steady_state_blocks_in_use": blocks_in_use,
            "kv_reservation_slack_blocks": float(np.median(slack)),
            "preemptions": int(m.preemptions_total.value),
            "preemptions_per_1k_tokens":
                1e3 * m.preemptions_total.value / tokens_out
                if tokens_out else None,
            "prefix_cache_hits": int(m.prefix_cache_hits_total.value),
            "prefix_cache_hit_rate":
                m.prefix_cache_hits_total.value / n_requests,
            "decode_tokens_per_sec": m.decode_tokens_per_sec(),
            "end_to_end_tokens_per_sec": n_requests * max_new / wall_s,
            "kv_hbm_bytes_per_resident_stream": stream_bytes,
            "resident_streams_at_contiguous_budget":
                int(slots * contig_stream_bytes // stream_bytes)
                if stream_bytes else None,
            "swapped_blocks": int(m.kv_swapped_blocks.value),
            "swap_bytes_out": int(m.kv_swap_bytes_out.value),
            "swap_bytes_in": int(m.kv_swap_bytes_in.value),
            "paged_launches": ak.paged_decode_attention.launches,
        }
        check(all(len(o) == max_new for o in outs),
              f"occupancy {allocate}: a stream returned fewer tokens")
        return stats, outs, greqs

    reserve, _, _ = cell("reserve")
    log(f"occupancy reserve ({CARD}): " + json.dumps(reserve))
    on_demand, _, _ = cell("on_demand", cache_blocks)
    log(f"occupancy on_demand ({CARD}): " + json.dumps(on_demand))
    check(on_demand["preemptions"] >= 1,
          "occupancy on_demand: no preemption in a pool below the worst case")
    check(on_demand["prefix_cache_hits"] >= 1,
          "occupancy on_demand: no prefix-cache hit on a shared system prompt")
    swap, swap_outs, greqs = cell("on_demand", swap_threshold_blocks=0,
                                  swap_capacity_blocks=64)
    _, free_outs, _ = cell("reserve", num_blocks=slots * max_len // block + 1)
    by_swap = [i for i, g in enumerate(greqs)
               if g.preemptions and g.swap_ins == g.preemptions]
    never = [i for i, g in enumerate(greqs) if not g.preemptions]
    recompute = [i for i, g in enumerate(greqs)
                 if g.swap_ins < g.preemptions]
    differ = [i for i in by_swap + never if swap_outs[i] != free_outs[i]]
    swap.update(resumed_by_swap_only=len(by_swap),
                resumed_by_recompute=len(recompute),
                never_preempted=len(never),
                swap_ins=sum(g.swap_ins for g in greqs))
    log(f"occupancy on_demand + swap ({CARD}): " + json.dumps(swap))
    check(swap["swap_ins"] >= 1, "occupancy swap: no stream swapped in")
    check(not differ, f"occupancy swap: streams {differ} (never preempted "
          "or resumed by swap-in only) differ from the unpressured run")
    return {"reserve": reserve, "on_demand": on_demand, "swap": swap}


def draft_config(cfg, dtype):
    """The JAX package's grid draft (``bench.py`` ``speculative_grid``): one
    layer at half the target's hidden (384) and mlp (1536), its 12 heads
    (head dim 32), vocab and positions."""
    return dataclasses.replace(cfg, hidden=cfg.hidden // 2, layers=1,
                               mlp_dim=cfg.mlp_dim // 2, dtype=dtype)


def serve_mix(eng, prompts, max_new, **kw):
    """Submit every prompt, wait for every stream; (streams, wall s)."""
    t0 = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    outs = [h.result(timeout=600) for h in hs]
    return outs, time.perf_counter() - t0


def contiguous_phase(cfg, params, prompts, device="cuda", max_new=64):
    """The engine phase's chat mix (32 requests, 64 new tokens, 16 slots,
    max_len 512, bf16) through the contiguous cache (``paged=False``) and,
    in the same run, the paged engine on the gather route (both read the
    decode attention through the same (slots, 512) einsum): greedy streams
    token-equal; decode tokens/s and KV bytes per stream beside each
    other. Both runs sample the engine's gauges every 50 ms: the paged
    figure is the median over samples of blocks in use times the block's
    bytes over the live slots, the contiguous one the cache's allocated
    bytes over the slots."""
    from deeplearning4j_tpu_torch.serving import (GenerationEngine,
                                                  ServingMetrics)

    out = {}
    streams = {}
    for label, paged in (("contiguous", False), ("paged gather", True)):
        with GenerationEngine(params, cfg, slots=16, max_len=cfg.max_seq,
                              paged=paged, queue_capacity=len(prompts) + 16,
                              device=device) as eng:
            eng.warmup()
            m = eng.metrics = ServingMetrics()
            reset_launches()
            t0 = time.perf_counter()
            hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
            samples = []
            while not all(h.future.done() for h in hs):
                live = m.slot_occupancy.value * eng.slots
                if paged and live > 0:
                    samples.append(m.kv_blocks_in_use.value
                                   * eng.kv_block_bytes / live)
                time.sleep(0.05)
            streams[label] = [h.result(timeout=600) for h in hs]
            wall = time.perf_counter() - t0
            n = read_launches()
            if paged:
                check(bool(samples), "contiguous paged gather: no gauge "
                      "sample with a live slot")
                per_stream = float(np.median(samples))
            else:
                per_stream = sum(t.numel() * t.element_size()
                                 for layer in eng._cache["layers"]
                                 for t in layer.values()) / eng.slots
        check(n["mha_attention_packed"] == cfg.layers * len(prompts),
              f"contiguous {label}: the packed kernel launched "
              f"{n['mha_attention_packed']} times, expected layers x "
              "prefills")
        check(n["paged_decode_attention"] == 0,
              f"contiguous {label}: the paged kernel launched")
        out[label] = dict(
            decode_tokens_per_sec=m.decode_tokens_per_sec(),
            end_to_end_tokens_per_sec=len(prompts) * max_new / wall,
            decode_steps=int(m.decode_steps_total.value),
            decode_step_ms_mean=m.decode_step_ms.mean,
            kv_bytes_per_stream=per_stream,
            gauge_samples=len(samples))
        log(f"contiguous: {label}: " + json.dumps(out[label]))
    check(streams["contiguous"] == streams["paged gather"],
          "contiguous: paged=False greedy streams differ from the paged "
          "gather route's")
    log(f"contiguous: {len(prompts)} greedy streams token-equal to the "
        "paged gather route's")
    return out


def speculative_fp32_phase(cfg, prompts, device="cuda", max_new=32):
    """Speculative decoding against the plain engine on a 2-layer fp32 copy
    of ``cfg`` (BERT-base widths) with the grid's draft shape in fp32: 8
    chat-mix prompts, greedy and sampled (temperature 0.8, top_k 40), 32
    new tokens, 8 slots. Every speculative stream (k 2 and 4, gather and
    fused, float32 and int8 pools) is token-equal to the plain engine's on
    the same route and pool; a self-draft (draft = target, k 4) accepts
    at least 0.9 and is token-equal; an on-demand pool of 32 usable blocks
    preempts at least once and is token-equal."""
    import torch

    from deeplearning4j_tpu_torch.models import init_params
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.serving import GenerationEngine, SpecConfig

    cfg32 = dataclasses.replace(cfg, layers=2, dtype=torch.float32)
    params = init_params(cfg32, seed=1, device=device)
    dcfg = draft_config(cfg, torch.float32)
    dparams = init_params(dcfg, seed=2, device=device)
    reqs = [(p, dict(max_new_tokens=max_new, eos_id=None, seed=i))
            for i, p in enumerate(prompts[:8])]
    reqs += [(p, dict(max_new_tokens=max_new, eos_id=None, seed=100 + i,
                      temperature=0.8, top_k=40))
             for i, p in enumerate(prompts[:8])]

    def run(route, kv, spec=None, **kw):
        with GenerationEngine(params, cfg32, slots=8, max_len=cfg.max_seq,
                              paged_attention=route, kv_dtype=kv,
                              speculative=spec, queue_capacity=64,
                              device=device, **kw) as eng:
            hs = [eng.submit(p, **k) for p, k in reqs]
            return [h.result(timeout=600) for h in hs], eng.metrics

    summary = {}
    plain = {}
    for route in ("gather", "fused"):
        for kv in ("float32", "int8"):
            plain[route, kv], _ = run(route, kv)
            for k in (2, 4):
                ak.paged_decode_attention.launches = 0
                got, m = run(route, kv, SpecConfig(dparams, dcfg, k=k))
                label = f"{route} {kv} k{k}"
                check(got == plain[route, kv], f"speculative fp32 {label}: "
                      "streams differ from the plain engine's")
                launched = ak.paged_decode_attention.launches
                check((launched > 0) == (route == "fused"),
                      f"speculative fp32 {label}: paged kernel launches "
                      f"{launched}")
                summary[label] = dict(
                    decode_steps=int(m.decode_steps_total.value),
                    acceptance=m.spec_acceptance_rate.value,
                    fallbacks=int(m.spec_fallbacks_total.value),
                    paged_launches=launched)
    base = plain["fused", "float32"]
    got, m = run("fused", "float32", SpecConfig(params, cfg32, k=4))
    acc = m.spec_acceptance_rate.value
    check(got == base, "speculative fp32 self-draft: streams differ")
    check(acc >= 0.9, f"speculative fp32 self-draft: acceptance {acc} < 0.9")
    summary["self-draft fused float32 k4"] = dict(
        decode_steps=int(m.decode_steps_total.value), acceptance=acc)
    got, m = run("fused", "float32", SpecConfig(dparams, dcfg, k=4),
                 allocate="on_demand", num_blocks=33)
    pre = int(m.preemptions_total.value)
    check(got == base, "speculative fp32 on_demand: streams differ from "
          "their unpressured runs")
    check(pre >= 1, "speculative fp32 on_demand: no preemption")
    summary["on_demand fused float32 k4"] = dict(
        preemptions=pre, decode_steps=int(m.decode_steps_total.value))
    log("speculative fp32: every stream token-equal to the plain engine's; "
        + json.dumps(summary))


def speculative_phase(cfg, params, prompts, plain_streams, device="cuda",
                      max_new=64):
    """The JAX package's ``speculative_grid`` at its TPU settings
    (``bench.py:326-395``): the BERT-base causal LM (bf16, flash) and the
    grid's draft (bf16), ``lm_head`` zeroed in both (acceptance 1.0), 16
    slots, max_len 512, the 32-request chat mix, 64 new tokens; k in
    {0, 2, 4, 8} x {float32, int8} pools on the fused route (the gather
    route is cut for time; the fp32 phase holds its parity). Each k > 0
    cell must accept 1.0 and take fewer decode steps than its pool's
    k = 0 cell; row 6 launches layers x (k + 1) per verify turn and
    layers per plain turn, row 1 target layers + draft layers per prompt
    (the draft prefill at head dim 32). Then a self-draft with real
    logits at k 4 on the bf16 pool: token-equal to the engine phase's
    streams, its acceptance printed."""
    import torch

    from deeplearning4j_tpu_torch.models import init_params
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, ServingMetrics, SpecConfig)

    dcfg = draft_config(cfg, torch.bfloat16)
    dparams = init_params(dcfg, seed=2, device=device)
    zp = dict(params, lm_head=torch.zeros_like(params["lm_head"]))
    zd = dict(dparams, lm_head=torch.zeros_like(dparams["lm_head"]))
    cells = []
    for kv in ("float32", "int8"):
        for k in (0, 2, 4, 8):
            spec = SpecConfig(zd, dcfg, k=k) if k else None
            with GenerationEngine(zp, cfg, slots=16, max_len=cfg.max_seq,
                                  kv_dtype=kv, paged_attention="fused",
                                  queue_capacity=len(prompts) + 16,
                                  speculative=spec, device=device) as eng:
                eng.warmup()
                eng.metrics = ServingMetrics()
                reset_launches()
                outs, wall = serve_mix(eng, prompts, max_new, eos_id=None)
                n = read_launches()
                m = eng.metrics
            steps = int(m.decode_steps_total.value)
            prefills = int(m.prefills_total.value)
            check(all(len(o) == max_new for o in outs),
                  f"speculative k{k} {kv}: a stream came back short")
            paged = n["paged_decode_attention"]
            # layers x (k+1) per verify turn, layers per plain turn
            verify, rest = divmod(paged // cfg.layers - steps, max(k, 1))
            check(paged % cfg.layers == 0 and rest == 0
                  and (k == 0) == (verify == 0),
                  f"speculative k{k} {kv}: {paged} paged launches over "
                  f"{steps} steps")
            packed_want = (cfg.layers + (dcfg.layers if k else 0)) * prefills
            check(n["mha_attention_packed"] == packed_want,
                  f"speculative k{k} {kv}: {n['mha_attention_packed']} "
                  f"packed launches, expected {packed_want}")
            cell = dict(k=k, kv_dtype=kv, paged_attention="fused",
                        tokens_per_sec=len(prompts) * max_new / wall,
                        decode_tokens_per_sec=m.decode_tokens_per_sec(),
                        decode_steps_total=steps, verify_turns=verify,
                        acceptance_rate=m.spec_acceptance_rate.value
                        if k else None,
                        paged_launches=paged,
                        paged_launches_per_verify=cfg.layers * (k + 1)
                        if k else None,
                        packed_launches=n["mha_attention_packed"])
            if k:
                check(cell["acceptance_rate"] == 1.0,
                      f"speculative k{k} {kv}: acceptance "
                      f"{cell['acceptance_rate']}, expected 1.0")
                base = next(c for c in cells
                            if c["kv_dtype"] == kv and c["k"] == 0)
                check(steps < base["decode_steps_total"],
                      f"speculative k{k} {kv}: {steps} decode steps, not "
                      f"fewer than k=0's {base['decode_steps_total']}")
                cell["speedup_vs_k0"] = cell["tokens_per_sec"] \
                    / base["tokens_per_sec"]
            log("speculative: " + json.dumps(cell))
            cells.append(cell)
    best = max(c["speedup_vs_k0"] for c in cells if c["k"])
    log(f"speculative: best_speedup_vs_k0 {best:.4f}")
    with GenerationEngine(params, cfg, slots=16, max_len=cfg.max_seq,
                          paged_attention="fused",
                          queue_capacity=len(prompts) + 16,
                          speculative=SpecConfig(params, cfg, k=4),
                          device=device) as eng:
        reset_launches()
        outs, wall = serve_mix(eng, prompts, max_new)
        n = read_launches()
        m = eng.metrics
    check(outs == plain_streams, "speculative self-draft bf16: streams "
          "differ from the plain engine's")
    self_draft = dict(acceptance_rate=m.spec_acceptance_rate.value,
                      decode_steps_total=int(m.decode_steps_total.value),
                      tokens_per_sec=len(prompts) * max_new / wall,
                      paged_launches=n["paged_decode_attention"])
    log("speculative: self-draft k4 bf16 pool, real logits, token-equal "
        "to the engine phase: " + json.dumps(self_draft))
    return dict(cells=cells, best_speedup_vs_k0=best, self_draft=self_draft)


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
              make_step=None, mesh=None):
    """The port's make_train_step on ``cfg`` (seeded weights), or the
    ``(init_state, step)`` that ``make_step(cfg)`` builds, over one fixed
    batch: ``warmup`` steps, ``timed`` steps between synchronizes, then
    ``extra`` steps; the loss of every step is kept. With ``mesh`` the
    weights go through ``place_params`` and the step is
    ``make_train_step(cfg, mesh)``. Every launch count is set to 0 before
    the first step and read after the last. Returns the step's metrics."""
    import torch

    from deeplearning4j_tpu_torch import profiler as tprof
    from deeplearning4j_tpu_torch.models import (
        init_params, make_train_step, place_params)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=DEVICE)
    if mesh is not None:
        params = place_params(params, cfg, mesh)
    init_state, step = make_step(cfg) if make_step else make_train_step(
        cfg, mesh, learning_rate=1e-4)
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


# the ring schedules of the mesh phase's part (c): (name, causal, the
# pairs a schedule launches of each of rows 3-5 over n virtual ranks)
RING_SCHEDULES = (
    ("ring", False, lambda n: n * n),
    ("ring causal", True, lambda n: n * (n + 1) // 2),
    ("zigzag", True, lambda n: n * (2 * n + 1)),
)


def mesh_phase(mlm, longctx):
    """The device mesh on the card, at world size 1: torch.distributed
    initialized with NCCL (a file store under ``chiprun_out/``), so every
    collective of the mesh route (the Megatron all-reduces, the logits'
    all-gather, the loss's and the gradients' sums) runs through NCCL on
    one rank. (a) bench.py's MLM step through ``make_train_step(cfg,
    mesh=make_mesh({"data": 1, "model": 1, "context": 1}))`` from the MLM
    phase's seeded params and batch: its 10 losses within 1e-3 relative of
    the MLM phase's (and whether they are bit-equal), the packed kernels
    layers x steps, the streamed ones never. (b) The long-context causal
    LM (B=2, T=8192) under the same mesh: 1 warm-up and 2 steps, losses
    within 1e-3 of the long-context phase's, rows 3-5 layers x steps.
    (c) One attention layer at the long-context shape (B=2, H=12, T=8192,
    D=64, bf16) through the ring's schedule in one process over n=4
    virtual ranks (``ring_flash_loop``, ``zigzag_ring_flash_loop``): the
    plain ring, the causal ring and the zigzag, forward and dq/dk/dv held
    against the streamed kernels over the whole T (``ring_loop_part``),
    each row's launches against n^2, n(n+1)/2 and n(2n+1), each
    schedule's forward+backward ms beside the unsharded kernels'."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models import TransformerConfig
    from deeplearning4j_tpu_torch.parallel import make_mesh

    with nccl_world():
        mesh = make_mesh({"data": 1, "model": 1, "context": 1})
        check(mesh.device_mesh is not None
              and dist.get_backend(mesh.group("model")) == "nccl",
              f"mesh: no NCCL groups on {mesh}")
        out = {"mesh": dict(mesh.shape), "backend": dist.get_backend()}
        # (a) bench.py's MLM step under the mesh
        cfg = TransformerConfig(remat=False, attention_impl="flash")
        st = train_run(cfg, 96, 512, warmup=2, timed=5, extra=3,
                       label="mesh mlm train", mesh=mesh)
        out["mlm"] = mesh_compare(st, mlm, "mesh mlm", cfg.layers,
                                  ("mha_attention_packed",
                                   "mha_packed_backward"),
                                  ("flash_forward", "flash_bwd_dq",
                                   "flash_bwd_dkv"))
        # (b) the long-context causal LM under the mesh
        cfg = TransformerConfig(causal=True, max_seq=8192, remat=False,
                                attention_impl="flash")
        st = train_run(cfg, 2, 8192, warmup=1, timed=2,
                       label="mesh long-context train", mesh=mesh)
        out["long_context"] = mesh_compare(
            st, longctx, "mesh long-context", cfg.layers,
            ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"),
            ("mha_attention_packed", "mha_packed_backward"))
    # (c) the ring's schedule in one process at full width
    out["ring"] = kernel_checks(ring_loop_part)()
    log("mesh: " + json.dumps(out))
    return out


_WORLDS = iter(range(1 << 30))


@contextlib.contextmanager
def nccl_world():
    """torch.distributed at world size 1 on NCCL, with a file store under
    ``chiprun_out/``: NCCL seats one rank on a card, so a mesh's
    collectives run through it on this one. The group is destroyed on
    exit. Each world has a store file of its own (a file store made
    again at a path an earlier world of the process used leaves a gloo
    group's rendezvous waiting)."""
    import torch.distributed as dist

    os.makedirs("chiprun_out", exist_ok=True)
    store = os.path.abspath(f"chiprun_out/mesh_store.{next(_WORLDS)}")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_compare(st, base, label, layers, used, unused):
    """The mesh run ``st`` against the meshless run ``base``: every loss
    within 1e-3 relative (and whether all are bit-equal), the ``used``
    kernels launched layers x steps each and the ``unused`` ones never;
    returns the figures for the phase's line."""
    n = layers * st["steps"]
    la = st["launches"]
    check(len(st["losses"]) == len(base["losses"]),
          f"{label}: {len(st['losses'])} steps against {len(base['losses'])}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(st["losses"],
                                                  base["losses"]))
    check(rel <= 1e-3, f"{label}: losses {st['losses']} against the meshless "
          f"run's {base['losses']} (largest relative difference {rel})")
    check(all(la[k] == n for k in used),
          f"{label}: launches {la}, expected {used} x {n}")
    check(all(la[k] == 0 for k in unused),
          f"{label}: {unused} launched: {la}")
    return {"losses": st["losses"], "meshless_losses": base["losses"],
            "largest_relative_difference": rel,
            "bit_equal": st["losses"] == base["losses"],
            "step_ms": st["step_ms_mean"],
            "meshless_step_ms": base["step_ms_mean"],
            "tokens_per_sec": st["tokens_per_sec"],
            "meshless_tokens_per_sec": base["tokens_per_sec"],
            "peak_memory_bytes": st["peak_memory_bytes"],
            "launches": {k: la[k] for k in used}}


def ring_loop_part():
    """Part (c) of the mesh phase: the three ring schedules at the
    long-context shape, n=4 virtual ranks, held stage by stage against
    the whole-T kernels: the output against ``flash_forward`` over the
    whole T; dq, dk, dv against ``flash_bwd_dq`` / ``flash_bwd_dkv`` over
    the whole T fed that forward's lse and the delta of the ring's own
    output (the ring takes its delta from it, and each bf16 rounding of
    the output moves delta and with it every gradient of the row — the
    same delta keeps the comparison to the backward passes), allowing
    half an ulp of each bf16 pair term the ring sums. For the record,
    each share of the attention check against ``flash_attention``'s own
    backward too."""
    import torch

    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.parallel import sequence_parallel as sp

    n, B, H, T, D = 4, 2, 12, 8192, 64
    rng = np.random.default_rng(8192)
    q, k, v, do = (torch.as_tensor(rng.standard_normal((B, H, T, D)),
                                   dtype=torch.float32)
                   .to(DEVICE, torch.bfloat16) for _ in range(4))
    q3, k3, v3, do3 = (x.reshape(B * H, T, D) for x in (q, k, v, do))
    rows = {}
    whole = {}
    for causal in (False, True):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]

        def unsharded(xs=xs, causal=causal):
            o = ak.flash_attention(*xs, causal)
            return o, torch.autograd.grad(o, xs, do)

        o, g = unsharded()
        whole[causal] = (o.detach(), g, ak.flash_forward(q3, k3, v3,
                                                         causal)[1])
        rows[f"unsharded{' causal' if causal else ''}"] = {
            "ms": time_ms(unsharded, iters=5, reps=3, graph=False)}
    zz = torch.as_tensor(sp.zigzag_indices(T, n), device=DEVICE)
    inv = torch.argsort(zz)
    for name, causal, pairs in RING_SCHEDULES:
        if name == "zigzag":
            def run(magnitudes=False):
                o, g = sp.zigzag_ring_flash_loop(
                    *(x[:, :, zz] for x in (q, k, v)), n, do[:, :, zz],
                    magnitudes)
                return o[:, :, inv], tuple(x[:, :, inv] for x in g)
        else:
            def run(magnitudes=False, causal=causal):
                return sp.ring_flash_loop(q, k, v, n, causal, do,
                                          magnitudes)
        reset_launches()
        o, g = run()
        torch.cuda.synchronize()
        la = read_launches()
        want = pairs(n)
        got = {r: la[r] for r in ("flash_forward", "flash_bwd_dq",
                                  "flash_bwd_dkv")}
        check(all(c == want for c in got.values()),
              f"ring {name}: launches {got}, expected {want} each")
        ro, rg, lse = whole[causal]
        delta = (do3.float() * o.reshape(B * H, T, D).float()).sum(-1)[
            :, None, :]
        ref = (ak.flash_bwd_dq(q3, k3, v3, do3, lse, delta, causal),
               *ak.flash_bwd_dkv(q3, k3, v3, do3, lse, delta, causal))
        terms = run(magnitudes=True)[1]
        errs = {}
        for i, (part, a, b, floor, t) in enumerate((
                ("out", o, ro, FWD_FLOOR, None),
                ("dq", g[0], ref[0], BWD_FLOOR, terms[0]),
                ("dk", g[1], ref[1], BWD_FLOOR, terms[1]),
                ("dv", g[2], ref[2], BWD_FLOOR, terms[2]))):
            err, share, rule = judge(a, b.reshape(a.shape), D, False, floor,
                                     t)
            check(share <= 1, f"ring {name}: {part} off the whole-T kernel "
                  f"by {err} ({share:.3f} of {rule})")
            errs[part] = {"max_abs_err": err, "share_of_bound": share,
                          "bound": rule}
            if t is not None:
                # for the record: the attention check alone, against
                # flash_attention's own backward (its delta)
                errs[part]["share_of_attention_check_own_delta"] = judge(
                    a, rg[i - 1], D, False, floor)[1]
        rows[name] = {"launches": got, "expected_launches": want,
                      "checks": errs,
                      "ms": time_ms(run, iters=5, reps=3, graph=False),
                      "unsharded_ms": rows["unsharded causal" if causal
                                           else "unsharded"]["ms"]}
        log(f"mesh ring {name}: " + json.dumps(rows[name]))
    return rows


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
    from deeplearning4j_tpu_torch.ops import pallas_updaters as updaters
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
        kernel_ms, host_ms = adamw_split_ms(opt, params, state, gs)
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
        rows["fused_adamw"][-1].update(kernel_ms=kernel_ms, host_ms=host_ms)
        log(f"fused_adamw {label}: {len(leaves)} leaves, {numel} params, "
            f"one launch per apply; the kernel alone {kernel_ms:.4f} ms "
            f"(profiler), host work {host_ms:.4f} ms a call")
        del params, leaves, steps, ref_p, ref_m, ref_v, state, lib, lib_p
        torch.cuda.empty_cache()
    return rows


def adamw_split_ms(opt, params, state, gs, calls: int = 5):
    """What one ``fused_adamw`` apply is made of: the kernel's device time
    (torch.profiler, mean over ``calls`` applies) and the host's time to
    enqueue one apply (host clock over ``calls`` applies issued back to
    back, no sync inside; the kernels queue behind each other)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt.apply(params, state, gs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            opt.apply(params, state, gs)
        torch.cuda.synchronize()
    kernel = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "adamw_kernel" in e.key]
    check(bool(kernel), "adamw: the profiler saw no adamw_kernel")
    kernel_ms = sum(e.self_device_time_total for e in kernel) / 1e3 / calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        opt.apply(params, state, gs)
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return kernel_ms, host_ms


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


def timed_mix(eng, prompts, max_new, **kw):
    """Submit every prompt; (streams or exceptions, per-request submit to
    terminal ms, wall s). A failed request's entry is its exception."""
    t0 = time.perf_counter()
    subs, done = [], {}
    hs = []
    for i, p in enumerate(prompts):
        subs.append(time.perf_counter())
        h = eng.submit(p, max_new_tokens=max_new, **kw)
        h.future.add_done_callback(
            lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
        hs.append(h)
    outs = []
    for h in hs:
        try:
            outs.append(h.result(timeout=600))
        except Exception as e:
            outs.append(e)
    wall = time.perf_counter() - t0
    lat = [(done[i] - subs[i]) * 1e3 for i in range(len(hs))]
    return outs, lat, wall


def held_order(eng, holder, specs):
    """Hold the scheduler in ``holder``'s first token, queue every
    ``(prompt, kwargs)`` of ``specs`` behind it, release it, and return
    the specs' indices in the order they were seated (their first tokens,
    which come from the prefills in the queue's pop order) with the
    streams."""
    gate, entered = threading.Event(), threading.Event()
    order = []
    lock = threading.Lock()

    def hold(_tok):
        if not entered.is_set():
            entered.set()
            gate.wait(120)

    p, kw = holder
    hs = [eng.submit(p, on_token=hold, **kw)]
    try:
        check(entered.wait(120), "qos: the holder never started")
        for i, (p, kw) in enumerate(specs):
            seen = []

            def first(_tok, i=i, seen=seen):
                if not seen:
                    seen.append(1)
                    with lock:
                        order.append(i)
            hs.append(eng.submit(p, on_token=first, **kw))
    finally:
        gate.set()
    outs = [h.result(timeout=600) for h in hs]
    return order, outs


def resilience_qos_phase(cfg, params, prompts, plain_streams,
                         engine_tok_s, device="cuda", max_new=64):
    """The serving engine's resilience, QoS, tracing and ledger at full
    width: the engine phase's BERT-base causal LM (bf16, 16 slots, max_len
    512, 16-token blocks, fused route) on the seeded 32-request chat mix,
    64 new tokens. Every check fails the run.

    1-2. The mix in turns, two rounds: the tracer off, an installed empty
       plan, ``Tracer(sample_rate=1.0)`` on (every request's events run
       ``submit`` ... ``stream.finish``, ``retire``), and transient faults
       (``FaultPlan(seed=0)``: ``generation.decode_step`` at rate 0.05
       and at 1, 3, 7; ``generation.prefill`` at 0, 2) under
       ``RetryPolicy(max_attempts=4, seed=0)`` (retries == faults fired,
       no request fails). Every stream token-equal to the engine phase's;
       each run's decode tokens/s, ms a decode step and tokens a step
       beside the engine phase's; the faulted runs' p50 and p99 latency.
    3. Poison: an out-of-vocab id at one decode step fails that iteration's
       streams with ``PoisonedResultError``; the engine serves on.
    4. Breaker: a persistent prefill fault opens the engine breaker after 3
       failures; ``submit`` sheds typed ``circuit_open``; after the 0.5 s
       cooldown one half-open probe closes it; later streams token-equal.
    5. Watchdog: ``arm_watchdog(500)``, a 2000 ms delay at one decode step:
       the live streams fail typed ``watchdog``, exactly one restart, and
       the mix submitted after the restart (pass after pass, until one was
       in flight when the stale thread woke and wrote its late step into
       the abandoned pool) is token-equal.
    6. QoS (the JAX package's ``fairness_leg``, ``bench.py:864-1000``,
       through the generation engine): two batch tenants at weights 3:1
       draining a preloaded queue (the first-40 split of seats), an
       interactive request overtaking a batch flood, a quota shed typed
       ``quota_exceeded``; under ``allocate="on_demand"`` on a tight pool
       that swaps its victims to host memory, a ``preemptible=False``
       tenant is never preempted while others are, and every stream
       resumed by swap-in or never preempted is token-equal.
    7. Ledger: ``ResourceLedger`` per engine after its scenarios,
       ``check_shutdown`` after each ``shutdown()``, the thread count back
       to its value before the phase, and ``torch.cuda.memory_allocated()``
       back to its value before the phase once the engines are collected.
    The Chrome trace of step 1's traced run, merged with the engine's
    ``OpProfiler`` spans, goes to ``chiprun_out/resilience_trace.json``.
    """
    import gc

    import torch

    from deeplearning4j_tpu_torch.serving.ledger import (
        process_thread_counts)
    from deeplearning4j_tpu_torch.util import crash_reporting

    def allocated():
        """Bytes of live tensors on the card, without cuBLAS's per-handle
        workspaces: a restart's new scheduler thread may take a new
        handle, and its workspace is cached for the process's life."""
        gc.collect()
        torch.cuda.synchronize()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        return torch.cuda.memory_allocated()

    os.makedirs("chiprun_out", exist_ok=True)
    crash_reporting.crashDumpOutputDirectory("chiprun_out")
    mem_before = allocated()
    threads_before = process_thread_counts()[0]
    reset_launches()
    base = dict(slots=16, max_len=cfg.max_seq, paged_attention="fused",
                device=device)

    def same(outs, label, idx=None):
        want = plain_streams if idx is None else [plain_streams[i]
                                                  for i in idx]
        bad = [i for i, (a, b) in enumerate(zip(outs, want)) if a != b]
        failed = sorted({type(outs[i]).__name__ for i in bad
                         if isinstance(outs[i], Exception)})
        check(not bad, f"resilience: {label}: streams {bad} differ from "
              f"the engine phase's (failed typed: {failed})")

    # each part returns numbers only: its engines, handles and exceptions
    # (whose tracebacks hold the engine's frames) die with its frame
    stats = resilience_scenarios(cfg, params, prompts, engine_tok_s,
                                 max_new, base, same)
    stats.update(qos_scenarios(cfg, params, prompts, max_new, base, same))

    # ---- 7: the process after the phase ---------------------------------
    n = read_launches()
    stats.update(packed_launches=n["mha_attention_packed"],
                 paged_launches=n["paged_decode_attention"])
    check(n["mha_attention_packed"] > 0 and n["paged_decode_attention"] > 0,
          "resilience: the phase launched no packed or paged kernel")
    deadline = time.monotonic() + 10.0
    while process_thread_counts()[0] > threads_before \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    threads_after = process_thread_counts()[0]
    check(threads_after <= threads_before,
          f"ledger: {threads_after} threads after the phase, "
          f"{threads_before} before")
    mem_after = allocated()
    # the caching allocator rounds each block to 512 bytes; allow 1 MiB
    check(abs(mem_after - mem_before) <= 1 << 20,
          f"ledger: {mem_after - mem_before} bytes still allocated after "
          "the phase's engines were collected")
    crash_reporting.crashDumpOutputDirectory(None)
    stats.update(threads_before=threads_before, threads_after=threads_after,
                 memory_allocated_before=mem_before,
                 memory_allocated_after=mem_after)
    log(f"resilience and qos ({CARD}): " + json.dumps(stats, default=str))
    return stats


def resilience_scenarios(cfg, params, prompts, engine_tok_s, max_new, base,
                         same):
    """Parts 1-5 of :func:`resilience_qos_phase` on one engine."""
    from deeplearning4j_tpu_torch.profiler import OpProfiler
    from deeplearning4j_tpu_torch.serving import (
        CircuitBreaker, CircuitOpenError, FaultPlan, GenerationEngine,
        PoisonedResultError, ResourceLedger, RetryPolicy, Tracer,
        WatchdogTimeoutError, check_shutdown)

    stats = {}
    V = cfg.vocab_size
    tracer = Tracer(sample_rate=1.0, capacity=512, enabled=False)
    prof = OpProfiler()
    eng = GenerationEngine(
        params, cfg, queue_capacity=2 * len(prompts) + 16,
        retry_policy=RetryPolicy(max_attempts=4, seed=0),
        breaker=CircuitBreaker(failure_threshold=3, cooldown_s=0.5),
        tracer=tracer, profiler=prof, name="resilience", **base)
    eng.warmup()
    ledger = ResourceLedger(engines=[eng])
    ledger.baseline()
    m = eng.metrics

    def mix(label, **kw):
        """The mix once; its streams and latencies, and its decode
        tokens/s split into ms a decode step and tokens a step."""
        w0, t0, n0 = m.decode_wall_ms.value, m.generated_tokens_total.value \
            - m.prefills_total.value, m.decode_steps_total.value
        outs, lat, _wall = timed_mix(eng, prompts, max_new, **kw)
        same(outs, label)
        wall = (m.decode_wall_ms.value - w0) / 1e3
        toks = m.generated_tokens_total.value - m.prefills_total.value - t0
        steps = m.decode_steps_total.value - n0
        runs.setdefault(label, []).append(
            {"decode_tokens_per_sec": toks / wall,
             "decode_step_ms": wall * 1e3 / steps,
             "tokens_per_step": toks / steps})
        return outs, lat

    def transient_plan():
        return (FaultPlan(seed=0)
                .fail("generation.decode_step", rate=0.05, at=(1, 3, 7))
                .fail("generation.prefill", at=(0, 2)))

    # 1-2. the mix in turns, two rounds: tracer off, an installed empty
    # plan, the tracer on, the 5% transient plan (retried)
    runs, lats, fired, retries = {}, [], [], []
    for _round in range(2):
        mix("tracer_off")
        with FaultPlan(seed=0):
            mix("empty_plan")
        tracer.clear()
        tracer.enabled = True
        mix("tracer_on")
        tracer.enabled = False
        traces = [t for t in tracer.traces() if t.reason == "ok"]
        check(len(traces) == len(prompts), f"tracing: {len(traces)} "
              f"traces retained for {len(prompts)} requests")
        for t in traces:
            n = t.event_names()
            check(n[:5] == ["submit", "queue.admit", "queue.wait",
                            "slot.assign", "prefill"]
                  and n[-2:] == ["stream.finish", "retire"]
                  and n.count("decode.step") == max_new - 1,
                  f"tracing: event names {n[:6]} ... {n[-3:]}")
        r0 = m.retries_total.value
        with transient_plan() as plan:
            outs, lat = mix("transient_plan")
        failed = [o for o in outs if isinstance(o, Exception)]
        check(not failed, f"transient: {len(failed)} requests failed: "
              f"{failed[:1]}")
        fired.append(len(plan.fired()))
        retries.append(m.retries_total.value - r0)
        check(fired[-1] > 0 and retries[-1] == fired[-1],
              f"transient: {retries[-1]} retries for {fired[-1]} faults")
        lats += lat
    path = prof.export_chrome_trace("chiprun_out/resilience_trace.json",
                                    tracer=tracer)
    spans = prof.summary()
    check({"serving.prefill", "serving.decode_step"} <= set(spans),
          f"tracing: spans {sorted(spans)}")
    stats["chrome_trace"] = path
    stats["chrome_trace_events"] = len(
        json.load(open(path))["traceEvents"])
    stats["decode_tokens_per_sec_engine_phase"] = engine_tok_s
    for label, rs in runs.items():
        stats[f"decode_tokens_per_sec_{label}"] = [
            r["decode_tokens_per_sec"] for r in rs]
        stats[f"decode_step_ms_{label}"] = [r["decode_step_ms"] for r in rs]
        stats[f"tokens_per_step_{label}"] = [r["tokens_per_step"]
                                             for r in rs]
    stats.update(transient_faults_fired=fired, transient_retries=retries,
                 transient_success_rate=1.0,
                 transient_latency_ms_p99=float(np.percentile(lats, 99)),
                 transient_latency_ms_p50=float(np.percentile(lats, 50)))

    # 3. poison: an out-of-vocab id at the 4th decode step under the plan
    p0 = m.poisoned_results_total.value
    poison = FaultPlan(seed=0).poison(
        "generation.decode_step",
        lambda out: (out[0], np.full(16, V + 7, np.int64)), at=(3,))
    with poison:
        outs, _lat, _w = timed_mix(eng, prompts[:4], 8)
    failed = [o for o in outs if isinstance(o, Exception)]
    check(failed and all(isinstance(o, PoisonedResultError)
                         and o.reason == "poisoned" for o in failed)
          and all(len(o) == 8 for o in outs if not isinstance(o, Exception)),
          f"poison: terminals {[type(o).__name__ for o in outs]}")
    check(m.poisoned_results_total.value - p0 == 1,
          "poison: one poisoned iteration expected")
    stats["poison_failed_streams"] = len(failed)
    outs, _lat, _w = timed_mix(eng, prompts[:8], max_new)
    same(outs, "after poison", idx=range(8))

    # 4. breaker
    opened0 = m.breaker_opened_total.value
    # a prefill fault: a request that fails at its prefill records no
    # success between the failures, so they are consecutive
    persistent = FaultPlan(seed=0).fail("generation.prefill", rate=1.0)
    with persistent:
        for _ in range(3):
            outs, _lat, _w = timed_mix(eng, prompts[:1], 4)
            check(type(outs[0]).__name__ == "FaultInjectedError",
                  f"breaker: {outs[0]!r}")
        check(eng.breaker.state == "OPEN",
              f"breaker: {eng.breaker.state} after 3 failures")
        try:
            eng.submit(prompts[0], max_new_tokens=4)
            check(False, "breaker: submit was not shed while OPEN")
        except CircuitOpenError as e:
            check(e.reason == "circuit_open", f"breaker: {e.reason}")
    time.sleep(0.6)
    outs, _lat, _w = timed_mix(eng, prompts[:1], max_new)   # the probe
    check(eng.breaker.state == "CLOSED", "breaker: the probe did not close")
    outs2, _lat, _w = timed_mix(eng, prompts[:8], max_new)
    same(outs + outs2[1:], "after breaker", idx=[0] + list(range(1, 8)))
    check((m.breaker_opened_total.value - opened0,
           m.rejections_by_reason.get("circuit_open")) == (1, 1),
          "breaker: one open and one circuit_open shed expected")
    stats["breaker_cycle"] = [m.breaker_opened_total.value,
                              m.breaker_half_open_total.value,
                              m.breaker_closed_total.value]

    # 5. watchdog: a 2000 ms stall at a decode step, 500 ms watchdog
    eng.arm_watchdog(500)
    stale = eng._thread
    stall = FaultPlan(seed=0).delay("generation.decode_step", ms=2000,
                                    at=(5,))
    t_stall = time.perf_counter()
    with stall:
        outs, _lat, _w = timed_mix(eng, prompts[:4], max_new)
        check(all(isinstance(o, WatchdogTimeoutError)
                  and o.reason == "watchdog" for o in outs),
              f"watchdog: terminals {[type(o).__name__ for o in outs]}")
        t_restart = time.perf_counter() - t_stall
        # the mix again and again while the stale thread sleeps, until one
        # pass was in flight when it woke, ran its late step against the
        # abandoned pool and ended
        passes, overlap = 0, False
        while not overlap and passes < 20:
            alive = stale.is_alive()
            outs, _lat, wall = timed_mix(eng, prompts, max_new)
            same(outs, f"after watchdog (pass {passes})")
            overlap = alive and not stale.is_alive()
            passes += 1
    stale.join(timeout=30)
    check(not stale.is_alive(), "watchdog: the stale thread never ended")
    check(overlap, "watchdog: no post-restart pass was in flight when the "
          "stale step woke")
    check(eng.watchdog_restarts == 1 and m.watchdog_restarts.value == 1,
          f"watchdog: {eng.watchdog_restarts} restarts")
    stats.update(watchdog_restart_s=t_restart,
                 watchdog_post_restart_passes=passes)
    bad = ledger.check(timeout_s=10.0)
    check(not bad, f"resilience: ledger {bad}")
    eng.shutdown()
    bad = check_shutdown(eng)
    check(not bad, f"resilience: shutdown law {bad}")
    stats["resilience_rejections"] = m.rejections_by_reason.to_dict()
    return stats


def qos_scenarios(cfg, params, prompts, max_new, base, same):
    """Part 6 of :func:`resilience_qos_phase`: the policy engine, then a
    ``preemptible=False`` tenant on a tight on-demand pool."""
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, QosPolicy, QuotaExceededError, ResourceLedger,
        Tracer, check_shutdown)

    stats = {}
    V = cfg.vocab_size
    # ---- 6: QoS ---------------------------------------------------------
    clock = [0.0]
    pol = QosPolicy({
        "heavy": {"weight": 3.0, "priority": "batch"},
        "light": {"weight": 1.0, "priority": "batch"},
        "batcher": {"priority": "batch"},
        "user": {"priority": "interactive"},
        "q": {"quota": 1.0, "quota_burst": 1.0}}, clock=lambda: clock[0])
    rng = np.random.default_rng(1)
    short = [rng.integers(0, V, 8).astype(np.int32) for _ in range(120)]
    with GenerationEngine(params, cfg, qos=pol, queue_capacity=256,
                          name="qos", **base) as qeng:
        qeng.warmup()
        qledger = ResourceLedger(engines=[qeng])
        qledger.baseline()
        holder = (short[0], dict(max_new_tokens=4, tenant="light"))
        specs = [(short[k], dict(max_new_tokens=8, tenant=t))
                 for k in range(60) for t in ("heavy", "light")]
        order, outs = held_order(qeng, holder, specs)
        head = [specs[i][1]["tenant"] for i in order[:40]]
        n_h, n_l = head.count("heavy"), head.count("light")
        check(all(len(o) == 8 for o in outs[1:]), "qos: short streams")
        check(n_h == 30 and n_l == 10,
              f"qos: first-40 seats {n_h} heavy : {n_l} light, want 30:10")
        specs = [(short[k], dict(max_new_tokens=8, tenant="batcher"))
                 for k in range(40)]
        specs.append((short[40], dict(max_new_tokens=8, tenant="user")))
        order, _outs = held_order(qeng, (short[1], dict(
            max_new_tokens=4, tenant="batcher")), specs)
        check(order[0] == 40, f"qos: the interactive request was seated "
              f"{order.index(40) + 1}th")
        qeng.submit(short[2], max_new_tokens=2, tenant="q").result(
            timeout=600)
        try:
            qeng.submit(short[3], max_new_tokens=2, tenant="q")
            check(False, "qos: the quota did not shed")
        except QuotaExceededError as e:
            check(e.reason == "quota_exceeded", f"qos: {e.reason}")
        qm = qeng.metrics
        check(qm.rejections_by_reason.get("quota_exceeded") == 1,
              "qos: one quota shed expected")
        stats.update(
            qos_first40_heavy_light=[n_h, n_l],
            qos_goodput_ratio=n_h / max(n_l, 1),
            qos_interactive_seat=order.index(40) + 1,
            qos_interactive_queue_wait_ms_mean=qm.queue_wait_by_class[
                "interactive"].mean,
            qos_batch_queue_wait_ms_mean=qm.queue_wait_by_class[
                "batch"].mean,
            qos_served=qm.qos_snapshot()["tenants"])
        bad = qledger.check(timeout_s=10.0)
        check(not bad, f"qos: ledger {bad}")
    check(not check_shutdown(qeng), f"qos: {check_shutdown(qeng)}")

    # a preemptible=False tenant on a tight on-demand pool. Every victim
    # parks its blocks in host memory and resumes by swap-in, token-equal
    # to the engine phase's streams (a recompute prefill would round the
    # bf16 K/V unlike the decode steps that first wrote them)
    ppol = QosPolicy({"pinned": {"priority": "batch", "preemptible": False},
                      "bulk": {"priority": "batch"}})
    ptracer = Tracer(sample_rate=1.0, capacity=256)
    with GenerationEngine(params, cfg, qos=ppol, allocate="on_demand",
                          num_blocks=96, swap_threshold_blocks=0,
                          swap_capacity_blocks=512, tracer=ptracer,
                          queue_capacity=len(prompts) + 16, name="pinned",
                          **base) as peng:
        # 4 pinned streams fit the pool together (4 x 12 blocks at most),
        # so a pinned stream always finds a bulk victim or room
        tenants = ["pinned" if i % 8 == 0 else "bulk"
                   for i in range(len(prompts))]
        hs = [peng.submit(p, max_new_tokens=max_new, tenant=t)
              for p, t in zip(prompts, tenants)]
        outs = [h.result(timeout=600) for h in hs]
        evictions = [[a for name, _t, a in h._req.trace.events
                      if name == "preempt"] for h in hs]
        held = [i for i, ev in enumerate(evictions)
                if all(a["swapped"] for a in ev)]
        check(len(held) == len(prompts), f"qos: {len(prompts) - len(held)} "
              "preempted stream(s) resumed by recompute, not by swap-in")
        same(outs, "preemptible=False")
        pre = peng.metrics.preemptions_total.value
        pinned_pre = sum(len(ev) for ev, t in zip(evictions, tenants)
                         if t == "pinned")
        check(pre > 0 and pinned_pre == 0,
              f"qos: {pre} preemptions, {pinned_pre} of the pinned tenant")
        stats.update(qos_preemptions=pre, qos_pinned_preemptions=pinned_pre,
                     qos_preempted_streams=sum(1 for ev in evictions if ev),
                     qos_streams_token_equal=len(held),
                     qos_swapped_blocks=peng.metrics.kv_swapped_blocks.value)
    check(not check_shutdown(peng), f"pinned: {check_shutdown(peng)}")
    return stats


def front_door_phase(cfg, params, prompts, plain_streams, engine_tok_s,
                     device="cuda", max_new=64):
    """The serving front door at full width, on the engine phase's model
    (BERT-base causal LM, bf16, ``attention_impl="flash"``, seeded
    weights) and chat mix. Every check fails the run.

    a. Registry and ``InferenceEngine``: ``ModelRegistry().deploy("bert",
       CausalLMAdapter(params, cfg), buckets=(1, 2, 4, 8, 16, 32),
       warmup_example=<one 128-token row>)``, then ``registry.engine``;
       64 client threads submit 1-4 seeded 128-token rows each. Every
       dispatched bucket batch's logits are bit-equal to a direct
       ``make_infer_last_logits`` call on the same padded batch, and each
       request's output is its rows of that batch; against a direct call
       on the request's own unpadded rows (other GEMM shapes, so possibly
       another summation order in bf16) each logit is within 2^-5 of its
       row's largest |logit| (4 to 8 bf16 ulps at that magnitude). Row 1
       launches layers x dispatches; ``compiled_signatures() <=
       len(buckets)``; rows/s and p50/p99 latency.
    b. The fleet over HTTP: two hosts on the card, each a process of its
       own (:func:`serve_host`: ``registry.generation_engine`` with 16
       slots, max_len 512, 16-token blocks, the engine phase's pool and
       fused route, behind ``LoopbackHost`` + ``HostRpcServer`` on
       127.0.0.1); here a ``ClusterDirectory`` fed by ``RemoteHost``
       heartbeat pumps and a hedging ``ClusterFrontDoor``;
       ``LoadGenerator`` replays the 32 prompts (64 new tokens, greedy,
       one arrival every 20 ms, so each dispatch has landed and counts
       in the front door's routing before the next arrives) through
       ``front_door_submitter``. Every stream equals the engine phase's;
       both hosts serve; on each host rows 1 and 6 launch layers x
       prefills and layers x decode steps.
    c. Chaos and drain: the replay under a seeded ``FaultPlan`` on
       ``rpc.dispatch``, ``rpc.stream`` and ``rpc.response``: every
       request ends in a typed shed or in its reference stream, none
       stuck. The reference is (b)'s stream, except for a stream the
       front door resumed from its delivery watermark (the resume
       points read from its front-door trace): up to its first resume
       point r (b)'s stream, then what host 0's engine generates seated
       at r on that prefix through the same recompute prefill, and so
       on at each later resume point. The fired schedule, the resume
       points and each request's path over the hosts go to
       ``chiprun_out/``. Then the replay with ``drain_host`` of host 1
       started at 0.3 s (nothing shed, host 1 leaves). After shutdown,
       ``check_shutdown`` of the ``InferenceEngine`` here and of each
       host's engine and server there reads clean, and
       ``ResourceLedger`` over them and the front door reads zero open
       ops, outstanding dispatches, live slots, queued and in-flight
       rows."""
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry, ResourceLedger, check_shutdown)

    reg = ModelRegistry()
    try:
        stats, eng = inference_engine_part(reg, cfg, params, device)
    finally:
        reg.shutdown()
    hosts = [HostProcess(i, cfg, device) for i in range(2)]
    try:
        stats.update(fleet_part(hosts, cfg, prompts, plain_streams,
                                max_new))
        reports = [h.stop() for h in hosts]
    finally:
        for h in hosts:
            h.kill()
    bad = check_shutdown(eng) + [v for r in reports for v in r["shutdown"]]
    check(not bad, f"front door: shutdown law: {bad}")
    dims = ResourceLedger(engines=[eng], rpc_servers=[],
                          front_doors=[stats.pop("_fd")]).snapshot().dims
    for r in reports:
        dims.update(r["ledger"])
    held = {k: v for k, v in dims.items() if v and k.endswith(
        (".open_ops", ".outstanding", ".live_slots", ".queue_depth",
         ".inflight_rows"))}
    check(not held, f"front door: ledger after shutdown: {held}")
    stats["ledger_after_shutdown"] = {
        k: v for k, v in dims.items() if not k.startswith("process.")}
    stats["engine_phase_decode_tokens_per_sec"] = engine_tok_s
    log(f"front door ({CARD}): " + json.dumps(stats, default=str))
    return stats


def inference_engine_part(reg, cfg, params, device, mesh=None,
                          label="inference engine"):
    """Part a of :func:`front_door_phase` (and, with ``mesh``, part c of
    :func:`mesh_serving_phase`); returns (stats, engine)."""
    import torch

    from deeplearning4j_tpu_torch.models.bert import (
        make_infer_last_logits, place_params)
    from deeplearning4j_tpu_torch.serving import CausalLMAdapter

    class Recording(CausalLMAdapter):
        """Keeps each batch the engine dispatches and its logits."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []
            self.on = False
            self._rec = threading.Lock()

        def infer(self, x):
            y = super().infer(x)
            if self.on:
                with self._rec:
                    self.calls.append((np.array(x), y))
            return y

    T, buckets, n_clients = 128, (1, 2, 4, 8, 16, 32), 64
    rng = np.random.default_rng(1)
    example = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    adapter = Recording(params, cfg, mesh, device=device)
    t0 = time.perf_counter()
    reg.deploy("bert", adapter, buckets=buckets, warmup_example=example)
    eng = reg.engine("bert", name="bert-infer", mesh=mesh)
    warm_s = time.perf_counter() - t0
    reqs = [rng.integers(0, cfg.vocab_size,
                         (int(rng.integers(1, 5)), T)).astype(np.int32)
            for _ in range(n_clients)]
    outs, lat = [None] * n_clients, [None] * n_clients
    gate = threading.Barrier(n_clients)

    def client(i):
        gate.wait()
        t = time.perf_counter()
        outs[i] = eng.output(reqs[i])
        lat[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    adapter.on = True
    reset_launches()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    n = read_launches()
    adapter.on = False
    check(all(o is not None for o in outs),
          f"{label}: a client got no output")
    check(all(o.shape == (r.shape[0], cfg.vocab_size) and np.isfinite(o).all()
              for o, r in zip(outs, reqs)),
          f"{label}: output of the wrong shape or not finite")
    calls = adapter.calls
    check(n["mha_attention_packed"] == cfg.layers * len(calls),
          f"{label}: packed kernel launched "
          f"{n['mha_attention_packed']} times for {len(calls)} dispatches "
          f"of {cfg.layers} layers")
    check(n["paged_decode_attention"] == 0,
          f"{label}: the paged kernel launched")
    check(eng.compiled_signatures() <= len(buckets),
          f"{label}: {eng.compiled_signatures()} batch shapes "
          f"for {len(buckets)} buckets")
    # each dispatched batch against a direct call on the same padded batch
    fwd = make_infer_last_logits(cfg, mesh)
    mine = params if mesh is None else place_params(params, cfg, mesh)
    row_out = {}
    for x, y in calls:
        check(x.shape[0] in buckets, f"{label}: batch of "
              f"{x.shape[0]} rows is no bucket")
        direct = fwd(mine, torch.from_numpy(x).to(device)).cpu().numpy()
        check(np.array_equal(direct, y),
              f"{label}: bucket batch of {x.shape[0]} differs from "
              f"the direct call (max {np.abs(direct - y).max()})")
        for j in range(x.shape[0]):
            row_out.setdefault(x[j].tobytes(), y[j])
    rel = 0.0
    for r, o in zip(reqs, outs):
        want = np.stack([row_out[row.tobytes()] for row in r])
        check(np.array_equal(o, want),
              f"{label}: a request's rows are not its batch's rows")
        own = fwd(mine, torch.from_numpy(r).to(device)).cpu().numpy()
        scale = np.abs(own).max(axis=1, keepdims=True)
        err = np.abs(o - own) / scale
        rel = max(rel, float(err.max()))
        check(err.max() <= 2.0 ** -5,
              f"{label}: unpadded rows differ by {err.max()} of "
              "the row's largest logit (limit 2^-5)")
    rows = sum(r.shape[0] for r in reqs)
    stats = {"ie_warmup_s": warm_s, "ie_requests": n_clients,
             "ie_rows": rows, "ie_wall_s": wall,
             "ie_rows_per_sec": rows / wall,
             "ie_latency_p50_ms": float(np.percentile(lat, 50)),
             "ie_latency_p99_ms": float(np.percentile(lat, 99)),
             "ie_dispatches": len(calls),
             "ie_batch_sizes": sorted(x.shape[0] for x, _ in calls),
             "ie_compiled_signatures": eng.compiled_signatures(),
             "ie_unpadded_max_rel_err": rel,
             "ie_packed_launches": n["mha_attention_packed"]}
    log(f"{label}: " + json.dumps(stats))
    return stats, eng


# ---- the front door phase's hosts: one process each ----------------------
def mesh_serving_phase(cfg, params, prompts, engine):
    """The sharded serving engines at full width. (a) and (c) run at
    world size 1 on NCCL (:func:`nccl_world`): every device operation's
    plan goes through the plans' channel; the steps' sums and gathers
    over a 'model' group of one rank are x itself, so they run no
    collective (``models/bert.py`` ``_drive``):

    a. The engine phase's model, mix and both pools through
       ``GenerationEngine(mesh=make_mesh({"data": 1, "model": 1}))`` on
       the fused route: every stream token-equal to the engine phase's,
       rows 1 and 6 layers x prefills and layers x decode steps, one plan
       a prefill and a decode step; decode tokens/s and TTFT p50 beside
       the engine phase's, and the plans' broadcast ms a step.
    b. :func:`virtual_ranks_part`: the sharded step bodies over 2 and 4
       virtual 'model' ranks in one process.
    c. ``InferenceEngine(mesh=)`` through a registry deployment of
       ``CausalLMAdapter(params, cfg, mesh)`` (the front door phase's
       part a on the mesh): every bucket batch bit-equal to a direct
       ``make_infer_last_logits(cfg, mesh)`` call."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry, check_shutdown)

    out = {}
    with nccl_world():
        mesh = make_mesh({"data": 1, "model": 1})
        check(mesh.device_mesh is not None
              and dist.get_backend(mesh.group("model")) == "nccl",
              f"mesh serving: no NCCL groups on {mesh}")
        runs = engine_phase(cfg, params, prompts, mesh=mesh,
                            label="mesh serving")
        out["engine"] = {}
        for kv, run in runs.items():
            base = engine[kv]
            off = sum(a != b for a, b in zip(run["streams"],
                                             base["streams"]))
            check(off == 0, f"mesh serving {kv}: {off} of "
                  f"{len(base['streams'])} streams differ from the engine "
                  "phase's")
            out["engine"][kv] = {
                k: v for k, v in run.items() if k != "streams"}
            out["engine"][kv].update(
                meshless_decode_tokens_per_sec=base["decode_tokens_per_sec"],
                meshless_ttft_ms_p50=base["ttft_ms_p50"],
                meshless_decode_step_ms_mean=base["decode_step_ms_mean"])
        reg = ModelRegistry()
        try:
            ie, eng = inference_engine_part(reg, cfg, params, "cuda",
                                            mesh=mesh,
                                            label="mesh inference engine")
        finally:
            reg.shutdown()
        bad = check_shutdown(eng)
        check(not bad, f"mesh inference engine: shutdown law: {bad}")
        out["inference_engine"] = ie
    out["virtual"] = kernel_checks(virtual_ranks_part)(cfg, params, prompts)
    log(f"mesh serving ({CARD}): " + json.dumps(out))
    return out


# ------------------------------------------------------------------ ops

# the attention rows of the ops phase, by row number
ATTENTION_ROWS = {1: "mha_attention_packed", 2: "mha_packed_backward",
                  3: "flash_forward", 4: "flash_bwd_dq", 5: "flash_bwd_dkv"}


def _launched(rows):
    """Check that exactly the attention ``rows`` launched, once each, in
    the run since the last ``reset_launches``; the counts."""
    got = read_launches()
    return {ATTENTION_ROWS[r]: got[ATTENTION_ROWS[r]] for r in ATTENTION_ROWS
            }, all(got[n] == (r in rows) for r, n in ATTENTION_ROWS.items())


def _attention_grads_check(label, got, ref, plain=None):
    """``got`` (the output, then each gradient) against ``ref``, the
    einsum route's in fp32. fp32: the output within 1e-5 and each
    gradient within 1e-4 of its largest |value| (train parity's rule).
    bf16: PERF.md §6's attention rule per 64-wide row (``judge``: 2^-7
    |ref| + 2^-5 rms(row) forward, 2^-6 backward), or, where the einsum
    route in bf16 (``plain``) is itself farther from fp32 than that, no
    more than twice its share: the rule was made for a kernel against its
    plain version at one precision, and here the four projections round
    in bf16 on both routes. Returns the worst share and the bf16 einsum
    route's."""
    worst = worst_plain = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        name = "out" if i == 0 else f"grad {i - 1}"
        if plain is None:
            rel = 1e-5 if i == 0 else 1e-4
            err = max_err(a, b)
            share, rule = err / rel_bound(b, rel), f"{rel} of max|ref|"
            allowed = 1.0
        else:
            floor = FWD_FLOOR if i == 0 else BWD_FLOOR
            a, b, own_a, zero_share = _zero_rows(a, b, plain[i])
            err, share, rule = judge(a, b, 64, False, floor)
            _, own, _ = judge(own_a, b, 64, False, floor)
            share = max(share, zero_share)
            worst_plain = max(worst_plain, own)
            allowed = max(1.0, 2 * own)
            rule += f"; the bf16 einsum route's share {own:.3f}"
        check(share <= allowed, f"{label} {name}: |err| {err:.3e}, "
              f"{share:.3f} of its bound ({rule}), allowed {allowed:.3f}")
        worst = max(worst, share)
    return worst, worst_plain


def _zero_rows(a, b, plain):
    """The 64-wide rows where the fp32 reference is exactly 0 (a causal
    dq's first query row: it attends to one key, so ds is 0) have no
    size of their own for ``judge`` to scale by: there |a| is held to one
    bf16 ulp (2^-7) of the whole tensor's rms, and the rows are zeroed
    for ``judge``. The streamed kernels' first row is not exactly 0
    (ROADMAP, known differences: delta sums in another order than dp).
    Returns (a, b, plain) without those rows and their share."""
    import torch

    rows = b.float().unflatten(-1, (-1, 64))
    zero = (rows == 0).all(-1, keepdim=True)
    if not bool(zero.any()):
        return a, b, plain, 0.0
    cap = BF16_ULP * b.float().square().mean().sqrt().item()
    got = a.float().unflatten(-1, (-1, 64)).masked_fill(~zero, 0.0)
    share = got.abs().max().item() / cap if cap > 0 else 0.0

    def drop(x):
        x = x.float().unflatten(-1, (-1, 64))
        return x.masked_fill(zero, 0.0).flatten(-2)

    return drop(a), b.float(), drop(plain), share


def _routes(fn, leaves, go, dtype):
    """fn's output and gradients on the kernel route (auto; launches
    counted from the caller's reset), the einsum route in fp32 and, for
    bf16, the einsum route in bf16."""
    import torch

    out = fn(leaves, None)
    got = [out] + list(torch.autograd.grad(out, leaves, go.to(out)))
    torch.cuda.synchronize()

    def einsum(ts):
        ts = [t.detach().requires_grad_() for t in ts]
        o = fn(ts, False)
        return [o] + list(torch.autograd.grad(o, ts, go.to(o)))

    ref = einsum([t.float() for t in leaves])
    plain = einsum(leaves) if dtype == torch.bfloat16 else None
    return got, ref, plain


def _mha_part(dtype):
    """(a) ``ops.nn.multiHeadDotProductAttention`` on CUDA NDArrays at
    BERT-base width: rows 1 and 2 once each, the output and the five
    gradients against the einsum route in fp32."""
    import torch

    from deeplearning4j_tpu_torch import NDArray, ops

    g = torch.Generator().manual_seed(15)
    x = torch.randn(8, 512, 768, generator=g)
    ws = [torch.randn(768, 768, generator=g) * 768 ** -0.5
          for _ in range(4)]
    go = torch.randn(8, 512, 768, generator=g)
    leaves = [t.to(DEVICE, dtype).requires_grad_() for t in [x] + ws]
    where = []

    def fn(ts, use_kernel):
        out = ops.nn.multiHeadDotProductAttention(
            *[NDArray(t) for t in ts[:1] * 2 + ts[1:]], 12,
            use_kernel=use_kernel)
        where.append(out.device.type)
        return out.torch

    reset_launches()
    got, ref, plain = _routes(fn, leaves, go.to(DEVICE), dtype)
    counts, ok = _launched((1, 2))
    check(ok and where[0] == torch.device(DEVICE).type,
          f"ops (a) {dtype}: launches {counts} on {where[0]}")
    worst, own = _attention_grads_check(f"ops (a) {dtype}", got, ref, plain)
    res = {"launches": counts, "worst_share": worst,
           "bf16_einsum_share": own}
    if dtype == torch.bfloat16:
        # (e) the registry call's ms against the direct composition:
        # the same projections, mha_attention_packed, the output product
        from deeplearning4j_tpu_torch.ops import mha_attention_packed

        xs = [t.detach() for t in leaves]
        nds = [NDArray(t) for t in xs[:1] * 2 + xs[1:]]

        def registry():
            return ops.nn.multiHeadDotProductAttention(*nds, 12)

        def direct():
            qp, kp, vp = (xs[0] @ w for w in xs[1:4])
            return mha_attention_packed(qp, kp, vp, 12) @ xs[4]

        with torch.no_grad():
            ms = {"registry_ms": time_ms(registry, graph=False),
                  "direct_ms": time_ms(direct, graph=False),
                  "direct_ms_again": time_ms(direct, graph=False),
                  "registry_ms_again": time_ms(registry, graph=False)}
            for name, fn in (("registry", registry), ("direct", direct)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                ms[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 20
        res.update(ms)
    return res


def _sdpa_case(label, B, T, causal, dtype, rows):
    """(b) ``ops.nn.scaledDotProductAttentionFused`` auto on (B, 12, T,
    64) CUDA NDArrays: forward and backward launch exactly ``rows``, and
    match the einsum route in fp32."""
    import torch

    from deeplearning4j_tpu_torch import NDArray, ops

    g = torch.Generator().manual_seed(T)
    qkv = [torch.randn(B, 12, T, 64, generator=g) for _ in range(3)]
    go = torch.randn(B, 12, T, 64, generator=g)
    leaves = [t.to(DEVICE, dtype).requires_grad_() for t in qkv]

    def fn(ts, use_kernel):
        return ops.nn.scaledDotProductAttentionFused(
            *[NDArray(t) for t in ts], causal=causal,
            use_kernel=use_kernel).torch

    reset_launches()
    got, ref, plain = _routes(fn, leaves, go.to(DEVICE), dtype)
    counts, ok = _launched(rows)
    check(ok, f"ops (b) {label}: launches {counts}, want rows {rows}")
    worst, own = _attention_grads_check(f"ops (b) {label}", got, ref, plain)
    return {"launches": counts, "worst_share": worst,
            "bf16_einsum_share": own}


def _sdpa_route_ms(T, B=32):
    """fwd+bwd ms of both routes of the fused op at (B, 12, T, 64) bf16
    (the reference's gate shape): the kernels (use_kernel=True) and the
    einsum (use_kernel=False), in turns einsum, kernel, kernel, einsum."""
    import torch

    from deeplearning4j_tpu_torch import ops

    fn = ops.REGISTRY["nn.scaledDotProductAttentionFused"].fn
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(B, 12, T, 64, generator=g).to(DEVICE,
                                                          torch.bfloat16)
               .requires_grad_() for _ in range(3))

    def step(use_kernel):
        out = fn(q, k, v, use_kernel=use_kernel)
        torch.autograd.grad(out, (q, k, v), out)

    times = {}
    for name, uk in (("einsum", False), ("kernel", True), ("kernel", True),
                     ("einsum", False)):
        times.setdefault(name, []).append(
            time_ms(lambda: step(uk), iters=5, reps=3, graph=False))
    return {name: min(ts) for name, ts in times.items()}


def _device_compare(case, got, want, label, compare=None):
    """One op's CUDA outputs against its CPU outputs: on the card, the
    CPU's dtype; integers and bools exact; floats within the case's
    tolerance of the output's largest |value| (the devices' kernels sum
    in other orders), linalg by its invariants, the rejection-loop draws
    by their moments (``compare``). Returns the worst share of the
    bound."""
    import torch

    from deeplearning4j_tpu_torch import NDArray
    from torch_op_cases import ATOL, RTOL, flat_outputs

    got, want = flat_outputs(got), flat_outputs(want)
    check(len(got) == len(want), f"{label}: {len(got)} outputs != "
          f"{len(want)}")
    worst = 0.0
    outs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if not isinstance(w, torch.Tensor):
            check(g == w, f"{label} output {i}: {g} != {w}")
            outs.append(None)
            continue
        check(isinstance(g, NDArray) and g.device.type == DEVICE
              and g.dtype == w.dtype, f"{label} output {i}: "
              f"{getattr(g, 'device', None)} {getattr(g, 'dtype', None)}, "
              f"want {DEVICE} {w.dtype}")
        outs.append((g.torch.cpu(), w))
    rtol, atol = case.tol or (RTOL, ATOL)
    compare = compare or case.compare

    def share(a, b, rel, floor):
        a, b = a.double(), b.double()
        bound = rel * max(b.abs().max().item(), 1.0) + floor
        return (a - b).abs().max().item() / bound if a.numel() else 0.0

    if compare in ("svd", "qr", "eig"):
        (a0, b0), (a1, b1) = outs[0], outs[1]
        if compare == "svd":
            u, s, vh = (o[0].double() for o in outs)
            ru, rs, rvh = (o[1].double() for o in outs)
            k = s.shape[-1]
            worst = max(share(s, rs, rtol, atol), share(
                (u[:, :k] * s) @ vh[:k], (ru[:, :k] * rs) @ rvh[:k], 1e-5,
                1e-6))
        elif compare == "qr":
            worst = max(share(a0.double() @ a1.double(),
                              b0.double() @ b1.double(), 1e-5, 1e-6),
                        share(a1.abs(), b1.abs(), 1e-5, 1e-6))
        else:
            worst = max(share(a0, b0, rtol, atol), share(
                (a1.double().T @ b1.double()).abs(),
                torch.eye(len(a0), dtype=torch.float64), 1e-4, 0.0))
    elif compare == "moments":
        a, b = outs[0]
        off = ((a - b).abs() > rtol * b.abs() + atol).double().mean().item()
        check(off <= 0.01, f"{label}: {off:.3%} of samples differ")
        worst = max(abs(a.double().mean() - b.double().mean()).item()
                    / (2e-2 * abs(b.double().mean().item())), off / 0.01)
    else:
        for a, b in (o for o in outs if o is not None):
            if not b.dtype.is_floating_point:
                check(torch.equal(a, b), f"{label}: integer outputs differ")
                continue
            worst = max(worst, share(a, b, max(rtol, 1e-5), atol))
    check(worst <= 1.0, f"{label}: {worst:.3f} of its bound")
    return worst


def _ops_on_card_part():
    """(d) every key of the registry on CUDA NDArrays against the same op
    on CPU tensors, by the CPU tests' recipes (``tests/
    torch_op_cases.py``)."""
    import torch

    from deeplearning4j_tpu_torch import NDArray, nd, ops
    from torch_op_cases import CASES, REJECTION_DRAWS, to_torch

    counts, worst = {}, (0.0, "")
    for key in sorted(CASES):
        case = CASES[key]
        ns, name = key.split(".", 1)
        for variant, make in enumerate(case.variants):
            args, kwargs = make(np.random.default_rng(variant))
            # the creation keys make their arrays on the default device
            nd.setDefaultDevice("cpu")
            want = ops.REGISTRY[key].fn(*to_torch(args, "cpu"),
                                        **to_torch(kwargs, "cpu"))
            nd.setDefaultDevice(DEVICE)
            cuda_args = [NDArray(a) if isinstance(a, torch.Tensor) else a
                         for a in to_torch(args, DEVICE)]
            got = getattr(getattr(ops, ns), name)(
                *cuda_args, **to_torch(kwargs, DEVICE))
            nd.setDefaultDevice(None)
            w = _device_compare(
                case, got, want, f"ops (d) {key} v{variant}",
                "moments" if key in REJECTION_DRAWS else None)
            worst = max(worst, (w, f"{key} v{variant}"))
        counts[ns] = counts.get(ns, 0) + 1
    torch.cuda.synchronize()
    return {"keys_by_namespace": counts, "keys": sum(counts.values()),
            "worst_share": worst[0], "worst_op": worst[1]}


def _bert_tree():
    """The BERT-base parameter tree as the mlm train phase builds it
    (``init_params``, seed 0, fp32 on the card)."""
    from deeplearning4j_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(remat=False, attention_impl="flash")
    return init_params(cfg, seed=0, device=DEVICE)


def _tree_cpu(tree):
    from deeplearning4j_tpu_torch.parallel import gradient_sharing as gsh

    return gsh.tree_map(lambda t: t.cpu(), tree)


def _events_ms(fn):
    """``fn()``'s result and its device ms between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _gradient_sharing_part(params):
    """(f) gradient sharing at full width: three steps of
    ``gradient_compression(AdaptiveThresholdAlgorithm())`` and of
    ``int8_compression()`` over the BERT-base tree with seeded gradients
    (N(0, 1e-3)) on the card against the same steps on the CPU — the
    updates and residuals bit-equal, the threshold (which reads the count
    of sent entries) within 1e-6 relative; ms a step on the card; then
    ``math.thresholdEncode``/``Decode`` on the (30522, 768) word
    embeddings' gradient, bit-equal, with their ms."""
    import torch

    from deeplearning4j_tpu_torch import NDArray, ops
    from deeplearning4j_tpu_torch.parallel import gradient_sharing as gsh

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    steps = [gsh.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=DEVICE, dtype=p.dtype) * 1e-3, params)
        for _ in range(3)]
    out = {}
    for label, make in (
            ("threshold", lambda: gsh.gradient_compression(
                gsh.AdaptiveThresholdAlgorithm())),
            ("int8", gsh.int8_compression)):
        tx_d, tx_h = make(), make()
        # a throwaway step first: the caching allocator's first
        # allocations are not a step's cost
        warm = make()
        warm.update(steps[0], warm.init(params))
        st_d, st_h = tx_d.init(params), tx_h.init(_tree_cpu(params))
        ms, thresholds, exact = [], [], True
        for k, g in enumerate(steps):
            (u_d, st_d), t = _events_ms(lambda: tx_d.update(g, st_d))
            ms.append(t)
            u_h, st_h = tx_h.update(_tree_cpu(g), st_h)
            pairs = list(zip(gsh.tree_leaves(u_d), gsh.tree_leaves(u_h)))
            if label == "threshold":
                pairs += list(zip(gsh.tree_leaves(st_d.residual),
                                  gsh.tree_leaves(st_h.residual)))
                td, th = float(st_d.threshold), float(st_h.threshold)
                check(abs(td - th) <= 1e-6 * abs(th), f"ops (f) {label} "
                      f"step {k}: threshold {td} against the CPU's {th}")
                exact = exact and td == th
                thresholds.append(td)
            for a, b in pairs:
                check(torch.equal(a.cpu(), b), f"ops (f) {label} step {k}: "
                      f"an update or residual leaf differs from the CPU's")
        out[label] = {"ms_a_step": ms, "median_ms": float(np.median(ms)),
                      "thresholds": thresholds, "threshold_exact": exact}
        log(f"ops (f) {label} ({CARD}): {np.median(ms):.3f} ms a step "
            f"(median of 3) over {len(gsh.tree_leaves(params))} leaves; steps "
            f"{ms}")
    word = next(i for i, p in enumerate(gsh.tree_leaves(params))
                if tuple(p.shape) == (30522, 768))
    g = gsh.tree_leaves(steps[0])[word]
    enc = ops.math.thresholdEncode(NDArray(g), 1e-3)
    dec = ops.math.thresholdDecode(enc)
    want = ops.REGISTRY["math.thresholdEncode"].fn(g.cpu(), 1e-3)
    check(torch.equal(enc.torch.cpu(), want)
          and torch.equal(dec.torch.cpu(), want),
          "ops (f) thresholdEncode/Decode: the word embeddings differ")
    out["encode_ms"] = time_ms(lambda: ops.math.thresholdEncode(
        NDArray(g), 1e-3), 10, 3, graph=False)
    out["decode_ms"] = time_ms(lambda: ops.math.thresholdDecode(enc), 10, 3,
                               graph=False)
    out["encode_sent"] = int((want != 0).sum())
    log(f"ops (f) thresholdEncode/Decode (30522, 768) ({CARD}): "
        f"{out['encode_ms']:.4f} / {out['decode_ms']:.4f} ms")
    return out


# each updater key's state arrays after the gradient, and whether a step
# count follows (the reference's wide_defs.py signatures)
UPDATER_STATE = {"sgdUpdater": (0, False), "nesterovsUpdater": (1, False),
                 "adaGradUpdater": (1, False), "rmsPropUpdater": (1, False),
                 "adaDeltaUpdater": (2, False), "adamUpdater": (2, True),
                 "adaMaxUpdater": (2, True), "nadamUpdater": (2, True),
                 "amsGradUpdater": (3, True), "adaBeliefUpdater": (2, True)}


def _updaters_part(params):
    """(g) the registry's ten updaters at full width: one step of each
    over every leaf of the BERT-base tree (seeded N(0, 1e-2) gradients,
    zero state, t = 0) on the card against the CPU, every output within
    1e-6 of the leaf's largest |value| (elementwise ops, each rounded
    once on either device); then ``adamUpdater`` leaf by leaf over the
    tree against ``fused_adamw`` (row 9) over the same tree, device ms
    between CUDA events (a finding: the registry op is Adam's update
    alone, the kernel AdamW's whole in-place step)."""
    import torch

    from deeplearning4j_tpu_torch import NDArray, ops
    from deeplearning4j_tpu_torch.ops import pallas_updaters as pu
    from torch_op_cases import flat_outputs

    leaves = pu.tree_leaves(params)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    grads = [torch.randn(p.shape, generator=gen, device=DEVICE,
                         dtype=p.dtype) * 1e-2 for p in leaves]
    out = {"leaves": len(leaves), "params": sum(p.numel() for p in leaves)}
    worst = (0.0, "")
    for name, (n_state, counted_) in UPDATER_STATE.items():
        fn_d = getattr(ops.updaters, name)
        fn_h = ops.REGISTRY[f"updaters.{name}"].fn
        exact = True
        for i, g in enumerate(grads):
            zeros = torch.zeros_like(g)
            tail = (0,) if counted_ else ()
            got = flat_outputs(fn_d(NDArray(g), *[NDArray(zeros)] * n_state,
                                    *tail))
            want = flat_outputs(fn_h(g.cpu(), *[zeros.cpu()] * n_state,
                                     *tail))
            check(len(got) == len(want), f"ops (g) {name}: outputs")
            for a, b in zip(got, want):
                if not isinstance(b, torch.Tensor):
                    check(a == b, f"ops (g) {name}: step count {a} != {b}")
                    continue
                # float32: the difference of two close float32 values is
                # exact, and a double copy of the tree costs the CPU
                # seconds
                a = a.torch.cpu()
                err = (a - b).abs().max().item()
                share = err / (1e-6 * max(b.abs().max().item(), 1e-30))
                exact = exact and err == 0.0
                worst = max(worst, (share, name))
                check(share <= 1.0, f"ops (g) {name} leaf {i}: "
                      f"{share:.3f} of its bound")
        out.setdefault("bit_equal", {})[name] = exact
    out["worst_share"], out["worst_op"] = worst
    nd_g = [NDArray(g) for g in grads]
    nd_m = [NDArray(torch.zeros_like(g)) for g in grads]

    def registry_adam():
        return [ops.updaters.adamUpdater(g, m, m, 0)
                for g, m in zip(nd_g, nd_m)]

    opt = pu.fused_adamw(1e-3)
    tree = {i: p.clone() for i, p in enumerate(leaves)}
    state = opt.init(tree)
    ms = {}
    for label, fn in (("fused_adamw", lambda: opt.apply(tree, state, grads)),
                      ("adamUpdater", registry_adam),
                      ("adamUpdater", registry_adam),
                      ("fused_adamw", lambda: opt.apply(tree, state, grads))):
        ms.setdefault(label, []).append(time_ms(fn, 3, 3, graph=False))
    out["adam_ms"] = {k: min(v) for k, v in ms.items()}
    log(f"ops (g) updaters ({CARD}): {out['leaves']} leaves, "
        f"{out['params']} params, worst {worst[1]} {worst[0]:.3f} of its "
        f"bound; adamUpdater leaf by leaf {out['adam_ms']['adamUpdater']:.3f}"
        f" ms against fused_adamw {out['adam_ms']['fused_adamw']:.3f} ms; "
        f"bit-equal to the CPU: {out['bit_equal']}")
    return out


def ops_phase():
    """The op registry on the card (``deeplearning4j_tpu_torch.ops``):

    a. ``ops.nn.multiHeadDotProductAttention`` through the eager namespace
       on CUDA NDArrays at BERT-base width (x (8, 512, 768), four (768,
       768) projections, 12 heads), fp32 and bf16: forward and
       ``autograd.grad`` to x and the four weights; rows 1 and 2 launch
       once each; the output and every gradient against the einsum route
       (``use_kernel=False``) in fp32;
    b. ``ops.nn.scaledDotProductAttentionFused`` auto on (B, 12, T, 64):
       T = 1024, B = 4 takes rows 1-2; T = 4096, B = 2, causal, rows 3-5;
       T = 512 the einsum, no kernel; each in fp32 and bf16, checked as
       in (a); then both routes' fwd+bwd ms at T = 512 and 1024, B = 32,
       bf16 (the reference's gate was measured on a TPU);
    c. a masked call takes the einsum and launches nothing, and so do
       float64 and float16 inputs on auto; ``use_kernel=True`` with a
       mask, off the envelope or off the kernels' dtypes raises the
       reference's ValueError; numpy float64 data become float32 arrays
       and take row 1;
    d. every one of the 451 keys on CUDA NDArrays against the CPU;
    e. (a)'s registry call against the direct composition (projections,
       ``mha_attention_packed``, the output product): device ms and
       wall ms a call;
    f. gradient sharing over the BERT-base tree
       (:func:`_gradient_sharing_part`);
    g. the ten updater keys over the same tree (:func:`_updaters_part`)."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from deeplearning4j_tpu_torch import NDArray, nd, ops

    out = {"mha": {}, "sdpa": {}}
    for dtype in (torch.float32, torch.bfloat16):
        out["mha"][str(dtype)] = _mha_part(dtype)
        torch.cuda.empty_cache()
        for label, B, T, causal, rows in (
                ("T1024", 4, 1024, False, (1, 2)),
                ("T4096 causal", 2, 4096, True, (3, 4, 5)),
                ("T512", 4, 512, False, ())):
            out["sdpa"][f"{label} {dtype}"] = _sdpa_case(
                f"{label} {dtype}", B, T, causal, dtype, rows)
            torch.cuda.empty_cache()
    out["route_ms_bf16_B32"] = {T: _sdpa_route_ms(T) for T in (512, 1024)}
    torch.cuda.empty_cache()
    # (c) the einsum route and the refusals
    g = torch.Generator().manual_seed(3)
    q = NDArray(torch.randn(2, 12, 1024, 64, generator=g).to(DEVICE))
    mask = NDArray(torch.zeros(2, 1, 1, 1024).to(DEVICE))
    reset_launches()
    masked = ops.nn.scaledDotProductAttentionFused(q, q, q, mask=mask)
    plain = ops.nn.scaledDotProductAttentionFused(q, q, q, use_kernel=False)
    counts, ok = _launched(())
    check(ok, f"ops (c): a masked call launched {counts}")
    check(max_err(masked.torch, plain.torch) <= 1e-6,
          "ops (c): an all-zero mask changed the output")
    for kw, label in (({"mask": mask}, "masked"), ({}, "T=100")):
        qq = q if kw else NDArray(torch.randn(1, 2, 100, 64).to(DEVICE))
        try:
            ops.nn.scaledDotProductAttentionFused(qq, qq, qq,
                                                  use_kernel=True, **kw)
            check(False, f"ops (c): use_kernel=True {label} did not raise")
        except ValueError as e:
            check("use_kernel=True" in str(e), f"ops (c): {e}")
    # off the kernels' dtypes: float64 (arrays hold it with the 64-bit
    # switch on) and float16 on auto take the einsum and launch nothing,
    # within 1e-5 (float64) or 1e-2 (float16) of the float32 einsum;
    # use_kernel=True raises
    with nd.enableX64(True):
        for dt, tol in ((torch.float64, 1e-5), (torch.float16, 1e-2)):
            qd = NDArray(q.torch.to(dt))
            reset_launches()
            got = ops.nn.scaledDotProductAttentionFused(qd, qd, qd)
            counts, ok = _launched(())
            check(ok and got.dtype == dt,
                  f"ops (c): {dt} on auto launched {counts} ({got.dtype})")
            check(max_err(got.torch.float(), plain.torch) <= tol,
                  f"ops (c): {dt} einsum off the float32 one")
            try:
                ops.nn.scaledDotProductAttentionFused(qd, qd, qd,
                                                      use_kernel=True)
                check(False, f"ops (c): use_kernel=True {dt} did not raise")
            except ValueError as e:
                check("use_kernel=True" in str(e), f"ops (c): {e}")
    # numpy float64 data, as a caller passes it: float32 arrays in the
    # default mode, so the forward takes row 1
    rng = np.random.default_rng(5)
    xh = rng.standard_normal((2, 128, 768))
    wh = [rng.standard_normal((768, 768)) * 768 ** -0.5 for _ in range(4)]
    reset_launches()
    got = ops.nn.multiHeadDotProductAttention(xh, xh, *wh, 12)
    counts, ok = _launched((1,))
    check(ok and got.dtype == torch.float32 and got.device.type == "cuda",
          f"ops (c): numpy float64 data launched {counts} ({got.dtype} on "
          f"{got.device})")
    out["refusals"] = "raised"
    out["off_dtypes"] = "einsum, no launch"
    t0 = time.perf_counter()
    out["on_card"] = _ops_on_card_part()
    torch.cuda.empty_cache()
    tree = _bert_tree()
    t1 = time.perf_counter()
    out["gradient_sharing"] = _gradient_sharing_part(tree)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    out["updaters"] = _updaters_part(tree)
    out["part_s"] = {"d": t1 - t0, "f": t2 - t1,
                     "g": time.perf_counter() - t2}
    log(f"ops (d) {out['part_s']['d']:.1f} s, (f) {out['part_s']['f']:.1f} "
        f"s, (g) {out['part_s']['g']:.1f} s")
    del tree
    torch.cuda.empty_cache()
    log(f"ops ({CARD}): " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------- networks

# (b)'s widths: config #3 (tools/bench_configs.py:144-163)
RNN_B, RNN_T, RNN_V, RNN_H = 64, 128, 80, 512
# (c)'s widths: BERT-base attention, a batch of 32 sequences of 512
SA_B, SA_T, SA_D, SA_HEADS = 32, 512, 768, 12


def _lenet_conf():
    """``tools/bench_configs.py:103-125``'s LeNet (config #1)."""
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.train import Adam

    return (NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-3))
            .dataType("FLOAT").list()
            .layer(L.ConvolutionLayer(nOut=20, kernelSize=(5, 5), activation="RELU"))
            .layer(L.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(nOut=50, kernelSize=(5, 5), activation="RELU"))
            .layer(L.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(nOut=500, activation="RELU"))
            .layer(L.OutputLayer(nOut=10, lossFunction="MCXENT"))
            .setInputType(InputType.convolutionalFlat(28, 28, 1)).build())


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed_fit(net, batches, warmup):
    """Fit each batch once; (mean ms of the steps after ``warmup``, every
    step's loss). Each step ends in a synchronize (the loss is read)."""
    times, losses = [], []
    for i, ds in enumerate(batches):
        t0 = time.perf_counter()
        net.fit(ds)
        losses.append(net.score())
        _sync()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times)), losses


def _rel_norm(a, b) -> float:
    """||a - b|| / ||b|| over two flat parameter vectors."""
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _lenet_part():
    """(a) one epoch of LeNet-MNIST on the card, evaluated; the first 3
    steps against the CPU's from the same seed: losses within 1e-5
    relative, the parameters within 1e-5 of their norm (Adam's first
    steps move every weight by ~lr whatever its gradient's size, so a
    gradient at rounding level may flip: no element is held alone)."""
    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

    train = MnistDataSetIterator(256, train=True, num_examples=7680)
    test = MnistDataSetIterator(250, train=False, num_examples=1000)
    check(train.synthetic, "networks (a): expected the MNIST surrogate "
          "(no cache), got the IDX files")
    batches = list(train)
    check(len(batches) == 30, f"networks (a): {len(batches)} batches")
    net = MultiLayerNetwork(_lenet_conf(), device=DEVICE).init()
    step_ms, losses = _timed_fit(net, batches, warmup=2)
    ev = net.evaluate(test)
    acc = ev.accuracy()
    check(acc > 0.9, f"networks (a): LeNet accuracy {acc:.4f} <= 0.9")
    card = MultiLayerNetwork(_lenet_conf(), device=DEVICE).init()
    host = MultiLayerNetwork(_lenet_conf(), device="cpu").init()
    loss_err = 0.0
    for ds in batches[:3]:
        card.fit(ds)
        host.fit(ds)
        loss_err = max(loss_err, abs(card.score() - host.score())
                       / abs(host.score()))
    param_err = _rel_norm(card.params().torch, host.params().torch)
    check(loss_err <= 1e-5 and param_err <= 1e-5,
          f"networks (a): card vs CPU over 3 steps: loss {loss_err:.3e}, "
          f"params {param_err:.3e} (allowed 1e-5 each)")
    out = {"step_ms": step_ms, "images_per_sec": 256 / step_ms * 1e3,
           "accuracy": acc, "first_loss": losses[0], "last_loss": losses[-1],
           "cpu_loss_rel_err": loss_err, "cpu_param_rel_norm_err": param_err}
    log(f"networks (a) LeNet ({CARD}): {step_ms:.3f} ms a step, "
        f"{out['images_per_sec']:.1f} images/s, accuracy {acc:.4f}")
    return out


def _char_rnn_part():
    """(b) the GravesLSTM char-RNN: 2 warm-up and 5 timed steps on one
    one-hot batch; the loss falls; ``rnnTimeStep`` one step at a time
    gives ``output()`` of the whole sequence within 1e-5 of its largest
    |value| (both fp32; the stream's input projections are one step's
    matmuls, the whole sequence's one)."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import (
        InputType, MultiLayerNetwork, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.train import Adam

    B, T, V, H = RNN_B, RNN_T, RNN_V, RNN_H
    conf = (NeuralNetConfiguration.Builder().seed(2).updater(Adam(1e-3))
            .dataType("FLOAT").list()
            .layer(L.GravesLSTM(nOut=H, activation="TANH"))
            .layer(L.GravesLSTM(nOut=H, activation="TANH"))
            .layer(L.RnnOutputLayer(nOut=V, lossFunction="MCXENT"))
            .setInputType(InputType.recurrent(V, T)).build())
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    rng = np.random.default_rng(0)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    ds = DataSet(x, y)
    step_ms, losses = _timed_fit(net, [ds] * 7, warmup=2)
    check(losses[-1] < losses[0], f"networks (b): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} did not fall")
    whole = net.output(x).torch
    net.rnnClearPreviousState()
    t0 = time.perf_counter()
    steps = torch.stack([net.rnnTimeStep(x[:, t]).torch for t in range(T)], 1)
    _sync()
    stream_s = time.perf_counter() - t0
    err = max_err(steps, whole)
    check(err <= rel_bound(whole, 1e-5), f"networks (b): rnnTimeStep vs "
          f"output |err| {err:.3e} > 1e-5 of max|output|")
    out = {"step_ms": step_ms, "tokens_per_sec": B * T / step_ms * 1e3,
           "losses": losses, "stream_max_abs_err": err,
           "stream_ms_a_step": stream_s / T * 1e3}
    log(f"networks (b) char-RNN ({CARD}): {step_ms:.3f} ms a step, "
        f"{out['tokens_per_sec']:.1f} tokens/s, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    return out


def _attention_conf(dtype_name, kernel=None):
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.train import Adam

    return (NeuralNetConfiguration.Builder().seed(4).updater(Adam(1e-4))
            .dataType(dtype_name).list()
            .layer(L.SelfAttentionLayer(nOut=SA_D, nHeads=SA_HEADS,
                                        attentionKernel=kernel))
            .layer(L.SelfAttentionLayer(nOut=SA_D, nHeads=SA_HEADS,
                                        attentionKernel=kernel))
            .layer(L.GlobalPoolingLayer(poolingType="AVG"))
            .layer(L.OutputLayer(nOut=10, lossFunction="MCXENT"))
            .setInputType(InputType.recurrent(SA_D, SA_T)).build())


def _attention_batch(b, seed):
    from deeplearning4j_tpu_torch.data import DataSet

    rng = np.random.default_rng(seed)
    return DataSet(rng.standard_normal((b, SA_T, SA_D)).astype(np.float32),
                   np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)])


def _net_loss_and_grads(net, ds):
    """A network's training loss on ``ds`` (no dropout here) and its
    gradients with respect to every parameter, without an update."""
    import torch

    from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

    params = tree_map(lambda p: p.detach().requires_grad_(), net._params)
    loss, _, _ = net._loss_for(params, net._state, net._tensor(ds.features),
                               net._tensor(ds.labels), None, None, None)
    return [loss] + list(torch.autograd.grad(loss, tree_leaves(params)))


def _attention_part():
    """(c) two SelfAttentionLayers at BERT-base attention widths, fp32 and
    bf16, on the kernel route (auto): rows 1 and 2 launch exactly 2 x
    steps over 2 warm-up and 5 timed steps, and each ``output()`` adds two
    row-1 launches; ``attentionKernel=False`` (its own 2 + 5 steps) and a
    features-masked step launch neither row; on one batch of 8 and the
    fp32 net's weights, the kernel route's first attention output, loss
    and gradients against the fp32 einsum route's within the ops phase's
    attention tolerances (``_attention_grads_check``: fp32 1e-5 / 1e-4 of
    the largest |value|; bf16 the per-row rule, or twice the bf16 einsum
    route's own share). Returns the step ms of both routes and the
    launches."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

    out = {}
    batches = [_attention_batch(SA_B, s) for s in range(7)]
    for dtype_name in ("FLOAT", "HALF"):
        res = {}
        net = MultiLayerNetwork(_attention_conf(dtype_name), device=DEVICE).init()
        reset_launches()
        res["kernel_step_ms"], losses = _timed_fit(net, batches, warmup=2)
        got = read_launches()
        res["launches"] = {k: got[k] for k in ("mha_attention_packed",
                                                "mha_packed_backward")}
        check(got["mha_attention_packed"] == 2 * 7
              and got["mha_packed_backward"] == 2 * 7,
              f"networks (c) {dtype_name}: 7 fit steps launched {got}, "
              f"expected rows 1 and 2 14 times each")
        reset_launches()
        net.output(batches[0].features)
        _sync()
        got = read_launches()
        check(got["mha_attention_packed"] == 2 and got["mha_packed_backward"] == 0,
              f"networks (c) {dtype_name}: output() launched {got}")
        res["losses"] = losses
        einsum = MultiLayerNetwork(_attention_conf(dtype_name, kernel=False),
                                   device=DEVICE).init()
        reset_launches()
        res["einsum_step_ms"], _ = _timed_fit(einsum, batches, warmup=2)
        mask = np.ones((SA_B, SA_T), np.float32)
        mask[:, SA_T - 37:] = 0
        net.fit(DataSet(batches[0].features, batches[0].labels, mask, None))
        _sync()
        counts, ok = _launched(())
        check(ok, f"networks (c) {dtype_name}: attentionKernel=False and a "
              f"masked batch launched {counts}")
        res["einsum_over_kernel"] = res["einsum_step_ms"] / res["kernel_step_ms"]
        # one step's loss and gradients on both routes, the same weights
        ds = _attention_batch(8, 11)
        nets = [MultiLayerNetwork(_attention_conf(*c), device=DEVICE).init()
                for c in ((dtype_name, None), ("FLOAT", False), (dtype_name, False))]
        for n in (nets[0], nets[2]):  # the fp32 weights (bf16-rounded in HALF)
            n.setParams(nets[1].params().torch)
        got, ref, plain = [[n.feedForward(ds.features)[1].torch]
                           + _net_loss_and_grads(n, ds) for n in nets]
        if dtype_name == "FLOAT":
            plain = None
        # the first attention layer's output and its layers' projection
        # gradients (64-wide head rows) through _attention_grads_check; the
        # loss and the head's gradients to 1e-5 / 1e-4 of the largest |value|
        # in fp32, in bf16 to 2^-6 of it or twice the bf16 einsum route's
        # own distance from fp32
        rows = [0] + [i for i, g in enumerate(got) if g.dim() == 2
                      and tuple(g.shape) == (SA_D, SA_D)]
        for i in range(1, len(got)):
            if i in rows:
                continue
            err = max_err(got[i], ref[i])
            if plain is None:
                allowed = rel_bound(ref[i], 1e-5 if i == 1 else 1e-4)
            else:
                allowed = max(rel_bound(ref[i], 2 ** -6), 2 * max_err(plain[i], ref[i]))
            check(err <= allowed, f"networks (c) {dtype_name} "
                  f"{'loss' if i == 1 else f'gradient {i - 2}'}: |err| "
                  f"{err:.3e} > {allowed:.3e}")
        res["route_share"] = _attention_grads_check(
            f"networks (c) {dtype_name}", [got[i] for i in rows],
            [ref[i] for i in rows],
            None if plain is None else [plain[i] for i in rows])
        res["attention_ms"] = _attention_call_ms(dtype_name)
        out[dtype_name] = res
        del net, einsum, nets
        torch.cuda.empty_cache()
        log(f"networks (c) {dtype_name} ({CARD}): kernel {res['kernel_step_ms']:.3f}"
            f" ms a step, einsum {res['einsum_step_ms']:.3f} ms "
            f"({res['einsum_over_kernel']:.3f}x), launches {res['launches']}; "
            f"one layer's attention op ms {res['attention_ms']}")
    return out


def _attention_call_ms(dtype_name):
    """Where (c)'s step time goes: one SelfAttentionLayer's attention op
    (``multi_head_attention``: the four projections and the attention) at
    (c)'s shape, forward and forward + backward, on the kernel route and
    the einsum route; CUDA events over 5 eager calls, median of 3."""
    import torch

    from deeplearning4j_tpu_torch.ops.nn_defs import multi_head_attention

    dt = torch.float32 if dtype_name == "FLOAT" else torch.bfloat16
    g = torch.Generator().manual_seed(7)
    x = torch.randn(SA_B, SA_T, SA_D, generator=g).to(DEVICE, dt).requires_grad_()
    ws = [(torch.randn(SA_D, SA_D, generator=g) * SA_D ** -0.5).to(DEVICE, dt)
          .requires_grad_() for _ in range(4)]
    go = torch.randn(SA_B, SA_T, SA_D, generator=g).to(DEVICE, dt)
    out = {}
    for route, kernel in (("kernel", None), ("einsum", False)):
        def fwd():
            with torch.no_grad():
                multi_head_attention(x, x, *ws, SA_HEADS, use_kernel=kernel)

        def fwd_bwd():
            o = multi_head_attention(x, x, *ws, SA_HEADS, use_kernel=kernel)
            torch.autograd.grad(o, [x] + ws, go)

        out[route] = {"fwd": time_ms(fwd, iters=5, reps=3, graph=False),
                      "fwd_bwd": time_ms(fwd_bwd, iters=5, reps=3, graph=False)}
    return out


def _serializer_part(tmp_dir):
    """(d) (c)'s fp32 net after 3 steps written with ModelSerializer and
    restored on the card (``output()`` bit-equal) and on the CPU (within
    1e-5 of the largest |output|: the einsum on the host, the kernel on
    the card); one more step on each, the same small batch: losses
    within 1e-5 relative, parameters within 1e-5 of their norm."""
    import torch

    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

    net = MultiLayerNetwork(_attention_conf("FLOAT"), device=DEVICE).init()
    for s in range(3):
        net.fit(_attention_batch(8, 20 + s))
    path = os.path.join(tmp_dir, "networks_d.zip")
    ModelSerializer.writeModel(net, path, saveUpdater=True)
    x = _attention_batch(4, 30).features
    want = net.output(x).torch
    card = ModelSerializer.restoreMultiLayerNetwork(path, device=DEVICE)
    got = card.output(x).torch
    check(torch.equal(got, want), f"networks (d): the restored net's output "
          f"differs on the card by {max_err(got, want):.3e}")
    host = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    err = max_err(host.output(x).torch, want.cpu())
    check(err <= rel_bound(want, 1e-5), f"networks (d): CPU restore output "
          f"|err| {err:.3e} > 1e-5 of max|output|")
    step = _attention_batch(4, 31)
    card.fit(step)
    host.fit(step)
    loss_err = abs(card.score() - host.score()) / abs(host.score())
    param_err = _rel_norm(card.params().torch, host.params().torch)
    check(card.getIterationCount() == host.getIterationCount() == 4
          and loss_err <= 1e-5 and param_err <= 1e-5,
          f"networks (d): one more step: iterations {card.getIterationCount()}"
          f"/{host.getIterationCount()}, loss {loss_err:.3e}, params "
          f"{param_err:.3e} (allowed 1e-5)")
    return {"bytes": os.path.getsize(path), "cpu_output_max_abs_err": err,
            "next_step_loss_rel_err": loss_err,
            "next_step_param_rel_norm_err": param_err}


def networks_phase():
    """``MultiLayerNetwork`` on the card: (a) LeNet-MNIST, (b) the
    GravesLSTM char-RNN, (c) SelfAttentionLayer on rows 1-2, (d)
    ModelSerializer (see the module docstring). Every part's failure
    fails the phase."""
    import tempfile

    out = {"card": CARD}
    t0 = time.perf_counter()
    out["lenet"] = _lenet_part()
    t1 = time.perf_counter()
    out["char_rnn"] = _char_rnn_part()
    t2 = time.perf_counter()
    out["self_attention"] = _attention_part()
    t3 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out["serializer"] = _serializer_part(d)
    out["part_s"] = {"a": t1 - t0, "b": t2 - t1, "c": t3 - t2,
                     "d": time.perf_counter() - t3}
    log(f"networks ({CARD}): " + json.dumps(out, default=str))
    return out


# ------------------------------------------------------------------ graphs
# ComputationGraph, its layers and vertices, transfer learning, early
# stopping and ParallelWrapper on the card (:func:`graphs_phase`)

RESNET_B, RESNET_HW, RESNET_CLASSES = 32, 224, 1000


def _graph_recipes():
    """``tests/torch_graph_cases.py`` (jax-free recipes)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_graph_cases

    return torch_graph_cases


def _resnet(dtype_name="FLOAT", device=None):
    """Config #2: the port's ``zoo.ResNet50`` at 224x224 and 1000 classes,
    its data type set to ``dtype_name``."""
    from deeplearning4j_tpu_torch import nn as pnn
    from deeplearning4j_tpu_torch.zoo import ResNet50

    conf = ResNet50(numClasses=RESNET_CLASSES, inputShape=(3, RESNET_HW, RESNET_HW)).conf()
    conf.dataType = dtype_name
    return pnn.ComputationGraph(conf, device=device or DEVICE)


def _resnet_batch(b, seed):
    from deeplearning4j_tpu_torch.data import DataSet

    rng = np.random.default_rng(seed)
    return DataSet(rng.random((b, 3, RESNET_HW, RESNET_HW), np.float32),
                   np.eye(RESNET_CLASSES, dtype=np.float32)[
                       rng.integers(0, RESNET_CLASSES, b)])


def _resnet_split_ms(net, ds):
    """Where an (e) step goes: the forward alone (no grad), the forward and
    backward (loss and ``autograd.grad``), and the updater over every leaf
    (``update`` + ``apply_updates`` on those gradients, not kept); each
    the mean of 3 after one warm-up, as the host's enqueue time and the
    time to a synchronize."""
    import torch

    from deeplearning4j_tpu_torch.train.updaters import apply_updates

    x = net._input_dict([ds.features])

    def fwd():
        with torch.no_grad():
            net._forward(net._params, net._state, x, training=False, rng=None)

    def fwd_bwd():
        return _graph_loss_and_grads(net, ds)[1:]

    grads = None

    def update():
        with torch.no_grad():
            from deeplearning4j_tpu_torch.train.updaters import tree_unflatten
            g = tree_unflatten(net._params, grads)
            updates, _ = net._tx.update(g, net._opt_state, net._params)
            apply_updates(net._params, updates)

    out = {}
    for name, fn in (("forward", fwd), ("forward_backward", fwd_bwd), ("update", update)):
        enq, done = [], []
        for i in range(4):
            _sync()
            t0 = time.perf_counter()
            r = fn()
            t1 = time.perf_counter()
            _sync()
            t2 = time.perf_counter()
            if name == "forward_backward":
                grads = r
            if i:
                enq.append((t1 - t0) * 1e3)
                done.append((t2 - t0) * 1e3)
        out[name] = {"enqueue_ms": float(np.mean(enq)), "ms": float(np.mean(done))}
    return out


def _cpu_spread(card, batches):
    """(e)'s card-vs-CPU comparison at B=2 from the card's seeded weights:
    the card (fp32), the CPU in fp32 and the CPU in float64 (the port's
    64-bit switch on), each from the same weights: the loss and the
    gradient at init, then 2 Adam steps' losses and the parameters after
    them. Returns each fp32 run's distance from the float64 run, and the
    card's distance from the CPU's fp32 loss at init."""
    import torch

    from deeplearning4j_tpu_torch import nd
    from deeplearning4j_tpu_torch.train.updaters import tree_map

    def host(dtype_name):
        h = _resnet(dtype_name, device="cpu")
        return h.setParamTrees(tree_map(lambda t: t.cpu().numpy(), card._params),
                               tree_map(lambda t: t.cpu().numpy(), card._state))

    def run(net):
        lg = _graph_loss_and_grads(net, batches[0])
        grad = torch.cat([g.detach().reshape(-1).double().cpu() for g in lg[1:]])
        losses = []
        for ds in batches:
            net.fit(ds)
            losses.append(net.score())
        return float(lg[0].detach()), grad, losses, net.params().torch.double().cpu()

    host32 = host("FLOAT")
    with nd.enableX64(True):
        host64 = host("DOUBLE")
    res = [run(card), run(host32)]
    with nd.enableX64(True):
        res.append(run(host64))

    def diff(a, b):
        return {"loss_at_init": abs(a[0] - b[0]) / abs(b[0]),
                "grad_at_init_rel_norm": ((a[1] - b[1]).norm() / b[1].norm()).item(),
                "step_losses": max(abs(x - y) / abs(y) for x, y in zip(a[2], b[2])),
                "params_rel_norm": ((a[3] - b[3]).norm() / b[3].norm()).item()}

    return diff(res[0], res[2]), diff(res[1], res[2]), diff(res[0], res[1])["loss_at_init"]


def _resnet_part(tmp_dir):
    """(e) ResNet-50 as a ComputationGraph at full width (the reference
    zoo's graph, BASELINE config #2: B=32, 3x224x224, 1000 classes, Adam
    1e-3), FLOAT and HALF: 2 warm-up and 8 timed steps on one batch, each
    ending in a read of its loss; images/s, step ms, peak memory, the
    step split (:func:`_resnet_split_ms`); no attention row launches. The
    FLOAT net written with ModelSerializer and restored on the card:
    ``output()`` bit-equal. Then the card's first 2 FLOAT steps at B=2
    against the CPU's from the same seeded weights (:func:`_cpu_spread`):
    the loss at init within 1e-5 relative of the CPU's fp32 loss; the
    loss and gradient at init, the 2 steps' losses and the parameters
    after them each as close to a float64 CPU run as 4 x the fp32 CPU
    run is (or 1e-5). Both fp32 runs are far from it: at init with two
    images the early convolutions' gradients are large sums that nearly
    cancel through the BatchNormalizations (the stem's ~1700 for a loss
    of ~9), so fp32 rounding moves them by ~1%; and Adam's first steps
    move every weight by about lr whatever its gradient's size."""
    import torch

    from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

    ds = _resnet_batch(RESNET_B, 0)
    out = {}
    for dtype_name in ("FLOAT", "HALF"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net = _resnet(dtype_name).init()
        _sync()
        init_s = time.perf_counter() - t0
        reset_launches()
        step_ms, losses = _timed_fit(net, [ds] * 10, warmup=2)
        got = read_launches()
        check(not any(got.values()), f"graphs (e) {dtype_name}: ResNet-50 launched "
              f"kernel rows {got}")
        check(all(np.isfinite(losses)), f"graphs (e) {dtype_name}: losses {losses}")
        res = {"step_ms": step_ms, "images_per_sec": RESNET_B / step_ms * 1e3,
               "losses": losses, "n_params": net.numParams(), "init_s": init_s,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "split": _resnet_split_ms(net, ds)}
        if dtype_name == "FLOAT":
            path = os.path.join(tmp_dir, "resnet50.zip")
            t0 = time.perf_counter()
            ModelSerializer.writeModel(net, path, saveUpdater=False)
            back = ModelSerializer.restoreComputationGraph(path, device=DEVICE)
            x = _resnet_batch(4, 1).features
            want, got_out = net.outputSingle(x).torch, back.outputSingle(x).torch
            check(torch.equal(want, got_out), f"graphs (e): the restored ResNet-50's "
                  f"output differs on the card by {max_err(got_out, want):.3e}")
            res["serializer_s"] = time.perf_counter() - t0
            res["zip_bytes"] = os.path.getsize(path)
            del back
        out[dtype_name] = res
        log(f"graphs (e) ResNet-50 {dtype_name} ({CARD}): {step_ms:.3f} ms a step, "
            f"{res['images_per_sec']:.1f} images/s, peak {res['peak_memory_gib']:.2f} GiB, "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; split {json.dumps(res['split'])}")
        del net
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    card = _resnet().init()
    card64, cpu64, init_loss = _cpu_spread(card, [_resnet_batch(2, 10 + s) for s in range(2)])
    check(init_loss <= 1e-5, f"graphs (e): the loss at init on the card is "
          f"{init_loss:.3e} from the CPU's (allowed 1e-5)")
    for k in card64:
        allowed = max(4 * cpu64[k], 1e-5)
        check(card64[k] <= allowed, f"graphs (e): the card's {k} is {card64[k]:.3e} from "
              f"the float64 CPU run's, more than 4 x the fp32 CPU run's {cpu64[k]:.3e}")
    out["card_vs_cpu64"], out["cpu32_vs_cpu64"] = card64, cpu64
    out["card_vs_cpu32_loss_at_init"] = init_loss
    out["cpu_compare_s"] = time.perf_counter() - t0
    log(f"graphs (e) at B=2 against the CPU in float64 ({CARD}): the card "
        f"{json.dumps(card64)}; the CPU in fp32 {json.dumps(cpu64)}; the loss at init "
        f"card vs CPU fp32 {init_loss:.3e}; {out['cpu_compare_s']:.1f} s")
    del card
    torch.cuda.empty_cache()
    return out


def _graph_loss_and_grads(net, ds):
    """A graph's training loss on ``ds`` and its gradients with respect to
    every parameter (sorted-name order), without an update."""
    import torch

    from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

    params = tree_map(lambda p: p.detach().requires_grad_(), net._params)
    loss, _ = net._loss_for(params, net._state, net._input_dict([ds.features]),
                            [net._tensor(ds.labels)], None, None, None)
    return [loss] + list(torch.autograd.grad(loss, tree_leaves(params)))


def _graph_attention_part():
    """(f) the attention graph at BERT-base attention widths (x (32, 512,
    768), 12 heads of 64: two SelfAttentionLayers, each in a residual
    ElementWiseVertex(Add), a MergeVertex of the two block outputs, global
    pooling, a 10-way output), FLOAT and HALF: 7 fit steps on the kernel
    route launch rows 1 and 2 exactly 2 x 7 times; 7 on the einsum route
    (``attentionKernel=False``) launch neither; on a batch of 8 and the
    fp32 einsum net's weights, the kernel route's loss and gradients
    against the fp32 einsum route's (fp32: 1e-5 of the loss, 1e-4 of each
    gradient's largest |value|; bf16: 2^-6 of it or twice the bf16 einsum
    route's own distance from fp32, networks (c)'s rule). The graph of a
    DotProductAttentionVertex and an AttentionVertex: one fit step and an
    ``output()``, no kernel row."""
    import torch

    from deeplearning4j_tpu_torch import nn as pnn
    from deeplearning4j_tpu_torch import train as ptrain
    from deeplearning4j_tpu_torch.nn.conf import graph as pgraph

    GC = _graph_recipes()
    batches = [_attention_batch(SA_B, s) for s in range(7)]
    out = {}

    def graph(dtype_name, kernel=None):
        return pnn.ComputationGraph(GC.attention_graph(
            pnn, ptrain, d=SA_D, heads=SA_HEADS, T=SA_T, dtype=dtype_name,
            attention_kernel=kernel), device=DEVICE).init()

    for dtype_name in ("FLOAT", "HALF"):
        res = {}
        net = graph(dtype_name)
        reset_launches()
        res["kernel_step_ms"], res["losses"] = _timed_fit(net, batches, warmup=2)
        got = read_launches()
        res["launches"] = {k: got[k] for k in ("mha_attention_packed",
                                                "mha_packed_backward")}
        check(got["mha_attention_packed"] == 2 * 7 and got["mha_packed_backward"] == 2 * 7,
              f"graphs (f) {dtype_name}: 7 fit steps launched {got}, expected rows "
              f"1 and 2 14 times each")
        check(all(np.isfinite(res["losses"])), f"graphs (f) {dtype_name}: losses "
              f"{res['losses']}")
        einsum = graph(dtype_name, kernel=False)
        reset_launches()
        res["einsum_step_ms"], _ = _timed_fit(einsum, batches, warmup=2)
        counts, ok = _launched(())
        check(ok, f"graphs (f) {dtype_name}: attentionKernel=False launched {counts}")
        ds = _attention_batch(8, 11)
        nets = [graph(*c) for c in ((dtype_name, None), ("FLOAT", False),
                                    (dtype_name, False))]
        for n in (nets[0], nets[2]):
            n.setParams(nets[1].params().torch)
        got, ref, plain = [_graph_loss_and_grads(n, ds) for n in nets]
        worst = 0.0
        for i in range(len(got)):
            err = max_err(got[i], ref[i])
            if dtype_name == "FLOAT":
                allowed = rel_bound(ref[i], 1e-5 if i == 0 else 1e-4)
            else:
                allowed = max(rel_bound(ref[i], 2 ** -6), 2 * max_err(plain[i], ref[i]))
            worst = max(worst, err / allowed)
            check(err <= allowed, f"graphs (f) {dtype_name} "
                  f"{'loss' if i == 0 else f'gradient {i - 1}'}: |err| {err:.3e} > "
                  f"{allowed:.3e}")
        res["route_worst_share"] = worst
        vnet = pnn.ComputationGraph(GC.attention_vertex_graph(
            pnn, ptrain, pgraph, d=SA_D, heads=SA_HEADS, T=SA_T, dtype=dtype_name),
            device=DEVICE).init()
        reset_launches()
        t0 = time.perf_counter()
        vnet.fit(batches[0])
        vout = vnet.outputSingle(batches[1].features).torch
        _sync()
        res["vertex_graph_s"] = time.perf_counter() - t0
        counts, ok = _launched(())
        check(ok and bool(torch.isfinite(vout).all()) and np.isfinite(vnet.score()),
              f"graphs (f) {dtype_name}: the attention-vertex graph launched {counts} "
              f"or gave non-finite values")
        out[dtype_name] = res
        del net, einsum, nets, vnet
        torch.cuda.empty_cache()
        log(f"graphs (f) {dtype_name} ({CARD}): kernel {res['kernel_step_ms']:.3f} ms a "
            f"step, einsum {res['einsum_step_ms']:.3f} ms, launches {res['launches']}, "
            f"route share {worst:.3f}")
    return out


def _transfer_earlystop_part():
    """(g) on LeNet (networks (a)'s net and MNIST surrogate): 5 steps on
    10 classes, then ``TransferLearning`` with ``setFeatureExtractor(3)``
    and ``nOutReplace`` of the output to 5 classes fine-tuned 10 steps:
    the frozen layers' parameters bit-unchanged on the card, the loss
    finite and falling; then ``EarlyStoppingTrainer`` over 4 batches an
    epoch with ``ScoreImprovementEpochTerminationCondition(2)``,
    ``MaxEpochsTerminationCondition(5)``, a holdout of 1000 test images
    and a ``LocalFileModelSaver`` under ``chiprun_out/``: the best model
    restored from its zip gives that epoch's score (1e-5 relative)."""
    import torch

    from deeplearning4j_tpu_torch.data import (
        DataSet, ListDataSetIterator, MnistDataSetIterator)
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves

    def five(ds):
        return DataSet(ds.features, np.eye(5, dtype=np.float32)[
            np.argmax(ds.labels, -1) % 5])

    batches = list(MnistDataSetIterator(256, train=True, num_examples=3840))
    hold = [five(ds) for ds in MnistDataSetIterator(250, train=False, num_examples=1000)]
    base = MultiLayerNetwork(_lenet_conf(), device=DEVICE).init()
    for ds in batches[:5]:
        base.fit(ds)
    ftc = FineTuneConfiguration.Builder().updater(Adam(1e-3)).seed(7).build()
    net = (TransferLearning.Builder(base).fineTuneConfiguration(ftc)
           .setFeatureExtractor(3).nOutReplace(5, 5).build())
    frozen = [t.clone() for i in range(4) for t in tree_leaves(net._params[i])]
    t0 = time.perf_counter()
    _, losses = _timed_fit(net, [five(ds) for ds in batches[5:15]], warmup=0)
    tune_s = time.perf_counter() - t0
    after = [t for i in range(4) for t in tree_leaves(net._params[i])]
    check(len(frozen) == 4 and all(torch.equal(a, b) for a, b in zip(after, frozen)),
          "graphs (g): a frozen layer's parameters moved in fine-tuning")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"graphs (g): fine-tune losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    saver_dir = os.path.join("chiprun_out", "graphs_g_earlystop")
    saver = es.LocalFileModelSaver(saver_dir)
    conf = (es.EarlyStoppingConfiguration.Builder()
            .epochTerminationConditions(es.ScoreImprovementEpochTerminationCondition(2),
                                        es.MaxEpochsTerminationCondition(5))
            .scoreCalculator(es.DataSetLossCalculator(ListDataSetIterator(hold)))
            .modelSaver(saver).build())
    t0 = time.perf_counter()
    result = es.EarlyStoppingTrainer(
        conf, net, ListDataSetIterator([five(ds) for ds in batches[:4]])).fit()
    es_s = time.perf_counter() - t0
    best = result.bestModel
    rescored = float(np.mean([best.score(ds) for ds in hold]))
    err = abs(rescored - result.bestModelScore) / abs(result.bestModelScore)
    check(best is not net and best.device.type == "cuda" and err <= 1e-5,
          f"graphs (g): the restored best model scores {rescored} against "
          f"{result.bestModelScore} (|rel err| {err:.3e}, allowed 1e-5)")
    out = {"fine_tune_losses": losses, "fine_tune_s": tune_s,
           "early_stopping": {"scores": result.scoreVsEpoch,
                              "best_epoch": result.bestModelEpoch,
                              "epochs": result.totalEpochs,
                              "reason": result.terminationReason,
                              "details": result.terminationDetails,
                              "best_rescored_rel_err": err, "s": es_s}}
    log(f"graphs (g) ({CARD}): fine-tune {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"early stopping {json.dumps(out['early_stopping'], default=str)}")
    return out


def _parallel_wrapper_part():
    """(h) ``ParallelWrapper`` over a data axis of one NCCL rank
    (``nccl_world``: its gradient and loss all-reduces, BatchNorm's
    synchronised moments run through NCCL on the card) on the ResNet-50
    graph at B=32, 3 steps, against plain ``fit`` from the same seed:
    parameters, layer state and losses bit-equal (cuDNN set to
    deterministic algorithms for the part); each path's step ms."""
    import torch

    from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves

    ds = _resnet_batch(RESNET_B, 0)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = _resnet().init()
        plain_ms, plain_losses = _timed_fit(plain, [ds] * 3, warmup=1)
        plain_params, plain_state = plain.params().torch, tree_leaves(plain._state)
        del plain
        torch.cuda.empty_cache()
        with nccl_world():
            net = _resnet().init()
            pw = ParallelWrapper(net)
            check(pw.mesh.group("data") is not None, "graphs (h): no NCCL group")
            times, losses = [], []
            for i in range(3):
                t0 = time.perf_counter()
                pw.fit(ds)
                losses.append(net.score())
                _sync()
                if i >= 1:
                    times.append((time.perf_counter() - t0) * 1e3)
        same = torch.equal(net.params().torch, plain_params) and losses == plain_losses \
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(net._state), plain_state))
        check(same, f"graphs (h): ParallelWrapper at world size 1 differs from fit: "
              f"params {max_err(net.params().torch, plain_params):.3e}, losses {losses} "
              f"vs {plain_losses}")
    finally:
        torch.backends.cudnn.deterministic = det
    out = {"wrapper_step_ms": float(np.mean(times)), "fit_step_ms": plain_ms,
           "losses": losses, "bit_equal": same}
    log(f"graphs (h) ({CARD}): ParallelWrapper {out['wrapper_step_ms']:.3f} ms a step, "
        f"fit {plain_ms:.3f} ms, bit-equal {same}")
    del net
    torch.cuda.empty_cache()
    return out


def _card_vs_cpu(run, label):
    """``run(device)`` -> [forward, *gradients] on the CPU and on the card:
    the forward within 1e-5 and each gradient within 1e-4 of the CPU's
    largest |value|; the worst share of the allowed error."""
    host, card = run("cpu"), run(DEVICE)
    worst = 0.0
    for i, (a, b) in enumerate(zip(card, host)):
        err = max_err(a.cpu(), b)
        allowed = rel_bound(b, 1e-5 if i == 0 else 1e-4)
        worst = max(worst, err / allowed)
        check(err <= allowed, f"graphs (i) {label} {'forward' if i == 0 else f'gradient {i}'}"
              f": card vs CPU |err| {err:.3e} > {allowed:.3e}")
    check(len(card) == len(host), f"graphs (i) {label}: {len(card)} vs {len(host)} tensors")
    return worst


def _layers_vertices_part():
    """(i) the second half's 27 layer types (``tests/torch_nn_cases.py``'s
    cases from ``prelu`` on) and the 12 vertex types (``tests/
    torch_graph_cases.py``'s cases), fp32: forward in training mode
    (and with the case's mask) and the gradients of sum(out * c) with
    respect to every parameter and the float inputs, on the card against
    the CPU at the recipes' small sizes; each case's worst share of its
    allowed error."""
    import torch

    from deeplearning4j_tpu_torch import nn as pnn
    from deeplearning4j_tpu_torch.models import random as prng
    from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

    GC = _graph_recipes()
    import torch_nn_cases as C

    shares = {}
    for cid in C.SECOND_HALF_IDS:
        layer, _ = C.build(pnn, cid)
        params0 = layer.init_params(prng.prng_key(3), torch.float32, "cpu")
        x0, mask0 = C.inputs(cid)
        float_x = np.issubdtype(x0.dtype, np.floating)

        def run(dev):
            params = tree_map(lambda t: t.to(dev).requires_grad_(), params0)
            x = torch.tensor(x0, device=dev, requires_grad=float_x)
            kw = {} if mask0 is None else {"mask": torch.tensor(mask0, device=dev)}
            out, _ = layer.apply(params, x, training=True, rng=prng.prng_key(11), **kw)
            ct = torch.tensor(C.cotangent(tuple(out.shape)), device=dev)
            wrt = tree_leaves(params) + ([x] if float_x else [])
            grads = torch.autograd.grad((out * ct).sum(), wrt, allow_unused=True)
            return [out.detach()] + [torch.zeros_like(w) if g is None else g
                                     for w, g in zip(wrt, grads)]

        shares[cid] = _card_vs_cpu(run, cid)
    for cid, (name, _), _ in GC.VERTEX_CASES:
        vertex = GC.make_vertex(pgraph, cid)
        xs0 = GC.vertex_inputs(cid)
        n_float = len(xs0) - (1 if cid.endswith("mask") else 0)
        has = getattr(vertex, "has_params", False)
        params0 = vertex.init_params(prng.prng_key(3), torch.float32, "cpu") if has else {}

        def run(dev):
            params = tree_map(lambda t: t.to(dev).requires_grad_(), params0)
            xs = [torch.tensor(x, device=dev, requires_grad=i < n_float)
                  for i, x in enumerate(xs0)]
            out = vertex.apply(xs, params=params) if has else vertex.apply(xs)
            ct = torch.tensor(C.cotangent(tuple(out.shape)), device=dev)
            wrt = tree_leaves(params) + xs[:n_float]
            return [out.detach()] + list(torch.autograd.grad((out * ct).sum(), wrt))

        shares[cid] = _card_vs_cpu(run, cid)
    worst = max(shares, key=shares.get)
    log(f"graphs (i) ({CARD}): {len(shares)} layer and vertex cases card vs CPU, worst "
        f"share of the allowed error {shares[worst]:.3f} ({worst})")
    return {"cases": len(shares), "worst_share": shares}


def graphs_phase():
    """``ComputationGraph`` and the second half of the networks on the
    card: (e) ResNet-50, (f) the attention graph on rows 1-2, (g) transfer
    learning and early stopping, (h) ParallelWrapper, (i) the new layers
    and vertices against the CPU (see the module docstring). Every part's
    failure fails the phase."""
    import tempfile

    out = {"card": CARD}
    t = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as d:
        out["resnet50"] = _resnet_part(d)
    t.append(time.perf_counter())
    out["attention"] = _graph_attention_part()
    t.append(time.perf_counter())
    out["transfer_earlystop"] = _transfer_earlystop_part()
    t.append(time.perf_counter())
    out["parallel_wrapper"] = _parallel_wrapper_part()
    t.append(time.perf_counter())
    out["layers_vertices"] = _layers_vertices_part()
    t.append(time.perf_counter())
    out["part_s"] = dict(zip("efghi", np.diff(t).tolist()))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "graphs_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    log(f"graphs ({CARD}): part seconds {json.dumps(out['part_s'])}")
    return out


# virtual 'model' ranks of the mesh serving phase's one-process loop
VIRTUAL_RANKS = (2, 4)


def sharded_steps(cfg, params, prompts, kv, ranks, device="cuda"):
    """Four prompts prefilled into slots 0-3 of a 16-slot paged pool
    (16-token blocks, ``kv`` storage), then one fused decode step over
    all 16 slots, through the sharded step bodies of ``ranks`` virtual
    'model' ranks in one process (:func:`drive_ranks`: each rank's body
    on its ``place_params`` shards and its heads of the pool, the partial
    sums added in rank order), or unsharded for ``ranks`` 0. Returns the
    prefills' sampled tokens, the decode step's logits (S, vocab), its
    ms (median of 5, host included), the pool's heads a rank and the
    kernels' launches of the prefills and the first decode step (the
    counts are set to 0 first)."""
    import torch

    from deeplearning4j_tpu_torch.models import bert as tbert
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    from deeplearning4j_tpu_torch.serving import prefill_buckets

    S, B = 16, 16
    meshes = [None] if not ranks else [
        Mesh(np.arange(ranks), ("model",), rank=r) for r in range(ranks)]
    ps = [tbert.compute_params(params if m is None else tbert.place_params(
        params, cfg, m), cfg, device) for m in meshes]
    caches = [tbert.init_kv_cache(cfg, S, cfg.max_seq, block_size=B,
                                  kv_dtype=kv, device=device, mesh=m)
              for m in meshes]
    prefill = [tbert.make_paged_prefill(cfg, B, m, kv_dtype=kv)
               for m in meshes]
    decode = [tbert.make_paged_decode_logits(cfg, B, m, kv_dtype=kv,
                                             paged_attention="fused")
              for m in meshes]

    def run(steps, *args):
        if len(steps) == 1:
            return steps[0](ps[0], caches[0], *args)
        with torch.no_grad():
            return tbert.drive_ranks([f.body(p, c, *args) for f, p, c in
                                      zip(steps, ps, caches)])[0]

    buckets = prefill_buckets(cfg.max_seq)
    reset_launches()
    tables = np.zeros((S, cfg.max_seq // B), np.int32)
    lengths = np.zeros(S, np.int64)
    tokens = np.zeros(S, np.int64)
    nxt, tok0 = 1, []
    for i, p in enumerate(prompts[:4]):
        n = len(p)
        bucket = next(b for b in buckets if b >= n)
        mine = list(range(nxt, nxt + -(-(n + 1) // B)))
        nxt += len(mine)
        tables[i, :len(mine)] = mine
        row = np.zeros(-(-bucket // B), np.int32)
        row[:-(-n // B)] = mine[:-(-n // B)]
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = p
        _, t = run(prefill, padded, row, n, np.array([0, i], np.uint32),
                   0.0, 0, 0)
        tok0.append(int(t))
        tokens[i], lengths[i] = tok0[-1], n
    zero = np.zeros(S, np.int64)
    logits = run(decode, tables, lengths, tokens, zero, zero)
    launches = read_launches()
    times = []
    for _ in range(5):   # the step rewrites the same K/V: it repeats
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(decode, tables, lengths, tokens, zero, zero)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return tok0, logits.float(), float(np.median(times)), \
        caches[0]["layers"][0]["k"].shape[2], launches


def virtual_ranks_part(cfg, params, prompts):
    """Part b of :func:`mesh_serving_phase`: :func:`sharded_steps` over
    2 and 4 virtual ranks (6 and 3 heads of 64 a rank) against the
    unsharded step, on bf16 and int8 pools, then in fp32.

    - bf16: the decode logits within twice the unsharded bf16 step's own
      largest distance from its fp32 evaluation (the same weights and
      pool storage, fp32 compute): a sharded step rounds each rank's
      partial of a row-parallel product to bf16 before the sum, then the
      sum, so each such layer takes one more bf16 rounding than the
      unsharded step's fp32-accumulated product — the error budget of a
      bf16 evaluation, twice;
    - fp32 (fp32 pool): the prefills' tokens and the decode step's greedy
      tokens of the four live slots equal the unsharded step's, and the
      logits within 2^-13 of the largest |logit| (the sums reassociate);
    - every sharded run: row 1 launches ranks x layers x 4 prefills and
      row 6 ranks x layers (one decode step), on pools of heads / ranks
      heads."""
    import torch

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    out = {}
    for kv in ("float32", "int8"):
        _, base, base_ms, _, _ = sharded_steps(cfg, params, prompts, kv, 0)
        _, ref32, _, _, _ = sharded_steps(cfg32, params, prompts, kv, 0)
        own = 2 * float((base - ref32).abs().max())
        for n in VIRTUAL_RANKS:
            _, got, ms, heads, la = sharded_steps(cfg, params, prompts, kv,
                                                  n)
            case = f"bf16 {kv} pool, {n} ranks"
            check(heads == cfg.heads // n,
                  f"{case}: a rank's pool holds {heads} heads")
            check(la["mha_attention_packed"] == n * cfg.layers * 4
                  and la["paged_decode_attention"] == n * cfg.layers,
                  f"{case}: launches {la}")
            err = float((got - base).abs().max())
            check(err <= own, f"{case}: logits {err} from the unsharded "
                  f"step, beyond twice its own distance from fp32 ({own})")
            out[case] = {"max_abs_err": err, "bound": own, "ms": ms,
                         "unsharded_ms": base_ms, "heads_a_rank": heads,
                         "launches": {k: la[k] for k in (
                             "mha_attention_packed",
                             "paged_decode_attention")}}
    tok32, ref32, ms32, _, _ = sharded_steps(cfg32, params, prompts,
                                             "float32", 0)
    lim = 2.0 ** -13 * float(ref32.abs().max())
    for n in VIRTUAL_RANKS:
        tok, got, ms, _, _ = sharded_steps(cfg32, params, prompts,
                                           "float32", n)
        case = f"fp32, {n} ranks"
        err = float((got - ref32).abs().max())
        check(tok == tok32, f"{case}: prefill tokens {tok} against {tok32}")
        check(torch.equal(got[:4].argmax(-1), ref32[:4].argmax(-1)),
              f"{case}: greedy decode tokens differ")
        check(err <= lim, f"{case}: logits {err} from the unsharded step "
              f"(limit {lim})")
        out[case] = {"max_abs_err": err, "bound": lim, "tokens_equal": True,
                     "ms": ms, "unsharded_ms": ms32}
    log("mesh serving virtual ranks: " + json.dumps(out))
    return out


def _cfg_json(cfg) -> str:
    d = dataclasses.asdict(cfg)
    for k, v in d.items():
        if type(v).__name__ == "dtype":        # torch.bfloat16 -> "bfloat16"
            d[k] = str(v).replace("torch.", "")
    return json.dumps(d)


def serve_host(argv) -> int:
    """``python3 chip_smoke.py --serve-host I --cfg JSON --device DEV
    [--host-class prefill|decode|mixed]``: host I of the front door and
    disagg phases, in a process of its own (its own interpreter lock and
    CUDA context, as a host of a fleet has). The
    engine phase's weights (``init_params(cfg, seed=0)``) are deployed in
    a ``ModelRegistry``; ``registry.generation_engine("bert", slots=16,
    max_len=cfg.max_seq, block_size=16, kv_dtype="float32",
    paged_attention="fused")`` is warmed up and served behind
    ``LoopbackHost(host_class=...)`` (default ``"mixed"``) and
    ``HostRpcServer`` on 127.0.0.1. Prints ``{"url": ...}`` once serving,
    then answers each line on its standard input with one JSON line:
    ``report`` (once the engine is idle: its prefills, decode steps and
    kernel launches since the warm-up, the KV bytes it exported and
    imported), ``resume <jobs>`` (each ``{"prompt", "resume", "max_new"}``
    submitted to the engine itself, seated at ``len(resume)``: the
    tokens it generates from there), ``stop`` (shut down: the shutdown
    law of the engine and the server, their ledger dimensions and the
    final report; then exit)."""
    import torch

    from deeplearning4j_tpu_torch.models import TransformerConfig, init_params
    from deeplearning4j_tpu_torch.serving import (
        CausalLMAdapter, HostRpcServer, LoopbackHost, ModelRegistry,
        ResourceLedger, check_shutdown)

    i = int(argv[argv.index("--serve-host") + 1])
    fields = json.loads(argv[argv.index("--cfg") + 1])
    device = argv[argv.index("--device") + 1]
    host_class = argv[argv.index("--host-class") + 1] \
        if "--host-class" in argv else "mixed"
    for k, v in fields.items():
        if k.endswith("dtype"):
            fields[k] = getattr(torch, v)
    cfg = TransformerConfig(**fields)
    reg = ModelRegistry()
    reg.deploy("bert", CausalLMAdapter(init_params(cfg, seed=0,
                                                   device=device),
                                       cfg, device=device))
    g = reg.generation_engine("bert", slots=16, max_len=cfg.max_seq,
                              block_size=16, kv_dtype="float32",
                              paged_attention="fused", queue_capacity=48,
                              name=f"fd-h{i}")
    g.warmup()
    srv = HostRpcServer(LoopbackHost(i, generation=g,
                                     host_class=host_class))
    reset_launches()
    m = g.metrics
    base = (m.prefills_total.value, m.decode_steps_total.value)

    def report():
        deadline = time.monotonic() + 60.0
        while (g.live_slots or g.queue_depth) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        n = read_launches()
        return {"prefills": m.prefills_total.value - base[0],
                "decode_steps": m.decode_steps_total.value - base[1],
                "packed_launches": n["mha_attention_packed"],
                "paged_launches": n["paged_decode_attention"],
                "decode_step_ms_mean": m.decode_step_ms.mean,
                "prefill_ms_mean": m.prefill_ms.mean,
                "kv_migrate_bytes_out": m.kv_migrate_bytes_out.value,
                "kv_migrate_bytes_in": m.kv_migrate_bytes_in.value,
                "kv_swap_bytes_in": m.kv_swap_bytes_in.value}

    def resume(jobs):
        # straight into the engine, no RPC: each job seated at its resume
        # point through the recompute prefill, greedy as the replay
        hs = [g.submit(np.asarray(j["prompt"], np.int32),
                       max_new_tokens=j["max_new"], seed=0,
                       resume_tokens=np.asarray(j["resume"], np.int32),
                       resume_step=len(j["resume"])) for j in jobs]
        return {"tokens": [h.result(timeout=300) for h in hs]}

    print(json.dumps({"url": srv.url}), flush=True)
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "report":
            print(json.dumps(report()), flush=True)
        elif cmd.startswith("resume "):
            print(json.dumps(resume(json.loads(cmd[len("resume "):]))),
                  flush=True)
        elif cmd == "stop":
            final = report()
            srv.stop()
            reg.shutdown()
            dims = ResourceLedger(engines=[g], rpc_servers=[srv]
                                  ).snapshot().dims
            print(json.dumps({
                "report": final,
                "shutdown": check_shutdown(g) + check_shutdown(srv),
                "ledger": {k: v for k, v in dims.items()
                           if not k.startswith("process.")}}), flush=True)
            return 0
    return 1


class HostProcess:
    """One :func:`serve_host` process, started at construction; its
    answers are read with a timeout, and :meth:`kill` ends it whatever
    state it is in."""

    def __init__(self, host_id: int, cfg, device: str,
                 host_class: str = "mixed"):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-host",
             str(host_id), "--cfg", _cfg_json(cfg), "--device", device,
             "--host-class", host_class],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)
        self.url = None

    def read(self, timeout: float = 300.0) -> dict:
        import select

        ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
        check(bool(ready), f"host process {self.proc.pid}: no answer in "
              f"{timeout} s")
        line = self.proc.stdout.readline()
        check(bool(line), f"host process {self.proc.pid} exited "
              f"({self.proc.poll()})")
        return json.loads(line)

    def ask(self, cmd: str) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self.read()

    def start(self) -> str:
        self.url = self.read()["url"]
        return self.url

    def stop(self) -> dict:
        out = self.ask("stop")
        check(self.proc.wait(60) == 0, "host process did not exit cleanly")
        return out

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


def fleet_part(hosts, cfg, prompts, plain_streams, max_new):
    """Parts b and c of :func:`front_door_phase` over the started host
    processes; returns the stats (the front door under ``"_fd"``)."""
    from deeplearning4j_tpu_torch.serving import (
        ClusterDirectory, ClusterFrontDoor, FaultPlan, HeartbeatPump,
        HedgePolicy, LoadGenerator, LoopbackTransport, RejectedError,
        RemoteHost, TraceRequest, Tracer, drain_host, front_door_submitter)
    from deeplearning4j_tpu_torch.serving.tracing import TERMINAL_REASONS

    t0 = time.perf_counter()
    urls = [h.start() for h in hosts]
    d = ClusterDirectory(heartbeat_timeout_s=5.0)
    pumps = []
    for i, url in enumerate(urls):
        rem = RemoteHost(i, url)
        d.join(rem)
        pump = HeartbeatPump(rem, LoopbackTransport(d), interval_s=0.2)
        pump.pump_once()
        pumps.append(pump.start())
    tracer = Tracer(sample_rate=1.0, capacity=256)
    fd = ClusterFrontDoor(d, tracer=tracer, hedge=HedgePolicy(
        hedge_after_ms=5000.0, max_attempts=3, poll_wait_ms=50.0))
    stats = {"_fd": fd, "hosts_start_s": time.perf_counter() - t0}

    def replay(spacing_s=0.02, during=None, tenant=lambda i: "chat"):
        handles = {}
        submit_fd = front_door_submitter(fd)

        def submit(tr, on_token):
            try:
                handles[tr.index] = h = submit_fd(tr, on_token)
            except RejectedError as e:     # a typed shed at submit
                handles[tr.index] = e
                raise
            return h
        trace = [TraceRequest(index=i, arrival_s=i * spacing_s, kind="chat",
                              prompt=tuple(int(t) for t in p),
                              max_new_tokens=max_new, tenant=tenant(i),
                              priority=None, seed=0)
                 for i, p in enumerate(prompts)]
        side = threading.Thread(target=during) if during else None
        if side is not None:
            side.start()
        report = LoadGenerator(trace, submit, drain_timeout_s=300.0).run()
        if side is not None:
            side.join(300)
        check(report.stuck_streams == 0,
              f"front door: {report.stuck_streams} stuck stream(s)")
        streams = []
        for i in range(len(prompts)):
            h = handles[i]
            exc = h if isinstance(h, BaseException) \
                else h.future.exception(timeout=0)
            streams.append(h.result() if exc is None else exc)
        return report, streams

    # ---- b: the fleet over HTTP ------------------------------------------
    before = [h.ask("report") for h in hosts]
    # one tenant label a request: its front-door trace is found again
    report, streams = replay(tenant=lambda i: f"b{i}")
    after = [h.ask("report") for h in hosts]
    bad = [i for i, (a, b) in enumerate(zip(streams, plain_streams))
           if a != b]
    if bad:
        # what a differing stream went through, before the check fails
        _, paths = request_paths(tracer, "b", len(prompts))
        log("front door: differing streams: " + json.dumps({i: {
            "path": paths.get(i), "tokens": len(streams[i]),
            "first_difference": next((k for k, (x, y) in enumerate(zip(
                streams[i], plain_streams[i])) if x != y), None)}
            for i in bad}) + f"; hedges {fd.hedges.to_dict()}; hosts "
            + json.dumps([{k: a[k] - b[k] for k in ("prefills",
                                                      "decode_steps")}
                          for a, b in zip(after, before)]))
    check(not bad, f"front door: streams {bad} differ from the engine "
          "phase's")
    check(report.watermark_clean, "front door: a stream's on_token tokens "
          "differ from its result")
    routed = fd.routed_by_host.to_dict()
    check(routed.get("h0", 0) > 0 and routed.get("h1", 0) > 0,
          f"front door: both hosts must serve, routed {routed}")
    delta = [{k: a[k] - b[k] for k in ("prefills", "decode_steps",
                                       "packed_launches", "paged_launches")}
             for a, b in zip(after, before)]
    for i, dh in enumerate(delta):
        check(dh["packed_launches"] == cfg.layers * dh["prefills"],
              f"front door: host {i} launched the packed kernel "
              f"{dh['packed_launches']} times for {dh['prefills']} prefills")
        check(dh["paged_launches"] == cfg.layers * dh["decode_steps"],
              f"front door: host {i} launched the paged kernel "
              f"{dh['paged_launches']} times for {dh['decode_steps']} "
              "decode steps")
    rep = report.to_dict()
    stats.update({
        "fleet_tokens_per_sec": report.tokens_per_sec,
        "fleet_ttft_p50_ms": rep["ttft_p50_ms"],
        "fleet_ttft_p99_ms": rep["ttft_p99_ms"],
        "fleet_latency_p50_ms": rep["latency_p50_ms"],
        "fleet_latency_p99_ms": rep["latency_p99_ms"],
        "fleet_duration_s": report.duration_s,
        "fleet_routed_by_host": routed, "fleet_hedges": fd.hedges.to_dict(),
        "fleet_hosts": delta,
        "fleet_decode_step_ms_mean": [a["decode_step_ms_mean"]
                                      for a in after],
        "packed_launches": sum(dh["packed_launches"] for dh in delta),
        "paged_launches": sum(dh["paged_launches"] for dh in delta)})
    log("front door fleet: " + json.dumps(
        {k: v for k, v in stats.items() if k != "_fd"}))

    # ---- c: chaos ---------------------------------------------------------
    plan = (FaultPlan(seed=11)
            .fail("rpc.dispatch", rate=0.05)
            .fail("rpc.stream", rate=0.005)
            .poison("rpc.response", lambda raw: dict(raw, tokens=None),
                    rate=0.005))
    hedges0 = dict(fd.hedges.to_dict())
    with plan:
        # one tenant label a request: its front-door trace is found again
        chaos, cstreams = replay(tenant=lambda i: f"r{i}")
    fired = plan.fired()
    # each request's front-door trace: its resume points and its path
    resumed, paths = request_paths(tracer, "r", len(prompts))
    # the exact reference of a resumed stream: the clean stream up to its
    # first resume point r, then what host 0's engine generates when
    # seated at r on (prompt, the stream so far) through the same
    # recompute prefill; again at each later resume point
    expected = {i: list(streams[i]) for i in resumed}
    for k in range(max((len(v) for v in resumed.values()), default=0)):
        jobs = [(i, v[k]) for i, v in resumed.items() if len(v) > k]
        got = hosts[0].ask("resume " + json.dumps([
            {"prompt": [int(t) for t in prompts[i]],
             "resume": expected[i][:r], "max_new": max_new}
            for i, r in jobs]))["tokens"]
        for (i, r), cont in zip(jobs, got):
            expected[i] = expected[i][:r] + cont
    shed, off_clean = {}, {}
    for i, (a, b) in enumerate(zip(cstreams, streams)):
        if isinstance(a, BaseException):
            check(isinstance(a, RejectedError)
                  and a.reason in TERMINAL_REASONS and a.reason != "ok",
                  f"chaos: request {i} failed untyped: {a!r}")
            shed[a.reason] = shed.get(a.reason, 0) + 1
            continue
        want = expected.get(i, b)
        check(a == want, f"chaos: stream {i} (resumed at "
              f"{resumed.get(i, [])}, {len(a)} tokens) differs from its "
              f"reference ({len(want)} tokens): {a} against {want}")
        if a != b:
            off_clean[i] = (resumed[i], next(
                k for k, (x, y) in enumerate(zip(a, b)) if x != y))
    check(chaos.watermark_clean, "chaos: a stream delivered a token twice "
          "or skipped one")
    kinds = {}
    for e in fired:
        key = f"{e['point']}:{e['kind']}"
        kinds[key] = kinds.get(key, 0) + 1
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/front_door_chaos.json", "w") as f:
        json.dump({"fired": fired, "shed": shed, "resumed": resumed,
                   "paths": paths}, f)
    hedges = {k: v - hedges0.get(k, 0) for k, v in fd.hedges.to_dict().items()}
    stats.update({"chaos_fired": kinds, "chaos_shed": shed,
                  "chaos_ok": len(prompts) - sum(shed.values()),
                  "chaos_resumed": len(resumed),
                  "chaos_resumed_off_clean": off_clean,
                  "chaos_shed_paths": {
                      i: paths.get(i) for i, a in enumerate(cstreams)
                      if isinstance(a, BaseException)},
                  "chaos_hedges": hedges,
                  "chaos_tokens_per_sec": chaos.tokens_per_sec})

    # ---- c: drain one host mid-replay -------------------------------------
    drained = {}

    def drain_later():
        time.sleep(0.3)
        t = time.perf_counter()
        drained["ok"] = drain_host(d, 1, timeout=300.0)
        drained["s"] = time.perf_counter() - t

    before = dict(fd.routed_by_host.to_dict())
    report, dstreams = replay(during=drain_later,
                              tenant=lambda i: f"d{i}")
    check(drained.get("ok") is True, "drain: host 1 did not drain")
    check(d.host_ids() == [0], f"drain: hosts {d.host_ids()} after the "
          "drain, expected [0]")
    if report.reasons() != {"ok": len(prompts)}:
        # what a shed request went through, before the check fails
        _, paths = request_paths(tracer, "d", len(prompts))
        log("drain: shed requests' paths: " + json.dumps({
            i: paths.get(i) for i, a in enumerate(dstreams)
            if isinstance(a, BaseException)}) + f"; drain took "
            f"{drained.get('s')} s")
    check(report.reasons() == {"ok": len(prompts)},
          f"drain: requests shed {report.reasons()}")
    bad = [i for i, (a, b) in enumerate(zip(dstreams, streams)) if a != b]
    check(not bad, f"drain: streams {bad} differ from the clean replay")
    after = fd.routed_by_host.to_dict()
    stats.update({"drain_s": drained["s"], "drain_routed": {
        k: v - before.get(k, 0) for k, v in after.items()}})
    for pump in pumps:
        pump.stop()
    return stats


def disagg_phase(cfg, params, prompts, engine, front, device="cuda",
                 max_new=64):
    """Disaggregated prefill/decode with KV page migration at full width,
    on the engine phase's model (BERT-base causal LM, bf16,
    ``attention_impl="flash"``, seeded weights; 16 slots, max_len 512,
    16-token blocks, fused paged decode) and 32-prompt chat mix with 64
    new tokens. Every check fails the run.

    a. Loopback fleet, one process, each pool (``"float32"``: bf16 pages;
       ``"int8"``): two hosts with ``prefix_cache_blocks=8``, run once as
       ``("mixed", "mixed")`` with no policy and once as ``("prefill",
       "decode")`` behind ``ClusterFrontDoor(disagg=DisaggPolicy())``;
       two waves of the mix (arrivals 20 ms apart), wave 2 repeating wave
       1's prompts. Every disaggregated stream, and every mixed stream of
       wave 1, equals the engine phase's stream for its pool (the pages
       move byte for byte); wave 1 migrates 32 streams with 0 fallbacks;
       the prefill host runs no decode step and the decode host no
       prefill, and rows 1 and 6 launch layers x the prefill host's
       prefills and layers x the decode host's steps. TTFT p50, ITL p99
       and tokens/s of both placements, KV bytes migrated per stream, the
       prefix-route hit rate of wave 2.
    b. Processes over HTTP: host 0 ``--host-class prefill`` and host 1
       ``--host-class decode`` (:func:`serve_host`, the front door
       phase's pool), a ``RemoteHost`` directory and
       ``ClusterFrontDoor(disagg=DisaggPolicy())``; the mix replayed with
       arrivals 20 ms apart. Every stream equals the engine phase's; 32
       migrations cross ``/rpc/v1/migrate``; host 0's exported bytes equal
       host 1's imported bytes; row 6 on host 0 and row 1 on host 1
       launch 0 times. Fleet tokens/s and TTFT beside the front door
       phase's two mixed hosts, and each migrate RPC's wall time and
       payload.
    c. Migration faults on a loopback fleet (``"float32"`` pool): a seeded
       ``FaultPlan`` fires ``kv.migrate``, ``kv.migrate.export`` and
       ``kv.migrate.import`` twice each over the 32 streams. Nothing is
       shed; the front door's fallbacks equal the streams whose trace
       shows one, by stage as the points fired; a stream recomputed
       from scratch equals the engine phase's stream, and one recomputed
       from its first token equals the decode host's engine seated at
       ``resume_tokens=[first]`` (a bf16 recompute may leave the clean
       stream: counted).
    The host processes start first and come up while (c) runs."""
    hosts = [HostProcess(i, cfg, device, host_class=c)
             for i, c in enumerate(("prefill", "decode"))]
    try:
        stats = {"faults": migrate_faults_part(
            cfg, params, prompts, engine["float32"]["streams"], device,
            max_new)}
        t0 = time.perf_counter()
        urls = [h.start() for h in hosts]
        stats["hosts_ready_wait_s"] = time.perf_counter() - t0
        for kv in ("float32", "int8"):
            stats[kv] = loopback_disagg_part(
                cfg, params, prompts, engine[kv]["streams"], kv, device,
                max_new)
        stats["rpc"] = rpc_disagg_part(hosts, urls, cfg, prompts,
                                       engine["float32"]["streams"], front,
                                       max_new)
        reports = [h.stop() for h in hosts]
    finally:
        for h in hosts:
            h.kill()
    bad = [v for r in reports for v in r["shutdown"]]
    check(not bad, f"disagg: host shutdown law: {bad}")
    log(f"disagg ({CARD}): " + json.dumps(stats, default=str))
    return stats


def loopback_fleet(cfg, params, kv, classes, disagg, device, tracer=None):
    """Two warmed-up engines behind ``LoopbackHost``s of ``classes``, a
    directory that has their heartbeats, and a front door (with a
    ``DisaggPolicy`` when ``disagg``)."""
    from deeplearning4j_tpu_torch.serving import (
        ClusterDirectory, ClusterFrontDoor, DisaggPolicy, GenerationEngine,
        LoopbackHost, ServingMetrics)

    engines, hosts = [], []
    d = ClusterDirectory(heartbeat_timeout_s=600.0)
    for i, c in enumerate(classes):
        g = GenerationEngine(params, cfg, slots=16, max_len=cfg.max_seq,
                             paged_attention="fused", kv_dtype=kv,
                             prefix_cache_blocks=8, queue_capacity=64,
                             device=device, name=f"dis-{c}{i}")
        g.warmup()
        g.metrics = ServingMetrics()   # idle here
        engines.append(g)
        hosts.append(LoopbackHost(i, generation=g, host_class=c))
        d.join(hosts[-1])
        d.heartbeat(hosts[-1].status())
    kw = {} if tracer is None else {"tracer": tracer}
    fd = ClusterFrontDoor(d, disagg=DisaggPolicy() if disagg else None,
                          **kw)
    return engines, hosts, d, fd


def disagg_replay(fd, prompts, max_new, tenant=lambda i: "chat"):
    """The mix through ``fd`` by ``LoadGenerator``, one arrival every
    20 ms: the report, the streams (an exception for a shed one) and the
    gaps between each stream's consecutive tokens (ms)."""
    from deeplearning4j_tpu_torch.serving import (
        LoadGenerator, TraceRequest, front_door_submitter)

    submit_fd = front_door_submitter(fd)
    stamps, handles = {}, {}

    def submit(tr, on_token):
        st = stamps[tr.index] = []

        def stamped(tok):
            st.append(time.perf_counter())
            on_token(tok)
        try:
            handles[tr.index] = h = submit_fd(tr, stamped)
        except Exception as e:
            handles[tr.index] = e
            raise
        return h
    trace = [TraceRequest(index=i, arrival_s=i * 0.02, kind="chat",
                          prompt=tuple(int(t) for t in p),
                          max_new_tokens=max_new, tenant=tenant(i),
                          priority=None, seed=0)
             for i, p in enumerate(prompts)]
    report = LoadGenerator(trace, submit, drain_timeout_s=300.0).run()
    check(report.stuck_streams == 0,
          f"disagg: {report.stuck_streams} stuck stream(s)")
    streams = []
    for i in range(len(prompts)):
        h = handles[i]
        exc = h if isinstance(h, BaseException) \
            else h.future.exception(timeout=0)
        streams.append([int(t) for t in h.result()] if exc is None else exc)
    itl = [(b - a) * 1e3 for st in stamps.values()
           for a, b in zip(st, st[1:])]
    return report, streams, itl


def loopback_disagg_part(cfg, params, prompts, plain, kv, device, max_new):
    """Part a of :func:`disagg_phase` for one pool."""
    from deeplearning4j_tpu_torch.serving import check_shutdown

    out, n = {}, len(prompts)
    for placement in ("mixed", "disaggregated"):
        dis = placement == "disaggregated"
        engines, hosts, d, fd = loopback_fleet(
            cfg, params, kv, ("prefill", "decode") if dis
            else ("mixed", "mixed"), dis, device)
        try:
            waves = []
            for w in range(2):
                if w == 1:
                    # wave 1's retired streams sit in the decode side's
                    # prefix cache; fresh heartbeats advertise them
                    deadline = time.time() + 10
                    while dis and not len(engines[1]._prefix_cache or ()) \
                            and time.time() < deadline:
                        time.sleep(0.02)
                    for h in hosts:
                        d.heartbeat(h.status())
                fm = fd.metrics
                before = (fm.kv_migrations_total.value,
                          fm.kv_migrate_fallbacks_total.value,
                          fm.prefix_route_hits_total.value,
                          [g.metrics.prefills_total.value for g in engines],
                          [g.metrics.decode_steps_total.value
                           for g in engines],
                          engines[1].metrics.kv_migrate_bytes_in.value)
                reset_launches()
                report, streams, itl = disagg_replay(fd, prompts, max_new)
                launched = read_launches()
                check(report.reasons() == {"ok": n},
                      f"disagg {kv} {placement} wave {w + 1}: requests "
                      f"ended {report.reasons()}")
                equal = sum(a == b for a, b in zip(streams, plain))
                rep = report.to_dict()
                wave = {
                    "tokens_per_sec": report.tokens_per_sec,
                    "ttft_p50_ms": rep["ttft_p50_ms"],
                    "ttft_p99_ms": rep["ttft_p99_ms"],
                    "itl_p50_ms": float(np.percentile(itl, 50)),
                    "itl_p99_ms": float(np.percentile(itl, 99)),
                    "streams_equal_engine_phase": equal,
                    "migrations": fm.kv_migrations_total.value - before[0],
                    "fallbacks":
                        fm.kv_migrate_fallbacks_total.value - before[1],
                    "prefix_route_hits":
                        fm.prefix_route_hits_total.value - before[2],
                    "prefills": [g.metrics.prefills_total.value - b
                                 for g, b in zip(engines, before[3])],
                    "decode_steps": [g.metrics.decode_steps_total.value - b
                                     for g, b in zip(engines, before[4])],
                    "packed_launches": launched["mha_attention_packed"],
                    "paged_launches": launched["paged_decode_attention"],
                    "migrated_bytes":
                        engines[1].metrics.kv_migrate_bytes_in.value
                        - before[5]}
                wave["prefix_route_hit_rate"] = wave["prefix_route_hits"] / n
                label = f"disagg {kv} {placement} wave {w + 1}"
                if dis or w == 0:
                    # a mixed host's wave 2 seats prompts from its prefix
                    # cache and feeds their tails through decode steps:
                    # bf16 K/V rounded another way, counted only
                    bad = [i for i, (a, b) in enumerate(zip(streams, plain))
                           if a != b]
                    check(not bad, f"{label}: streams {bad} differ from "
                          "the engine phase's")
                pre, dec = wave["prefills"], wave["decode_steps"]
                check(wave["packed_launches"] == cfg.layers * sum(pre),
                      f"{label}: packed launches "
                      f"{wave['packed_launches']} for prefills {pre}")
                check(wave["paged_launches"] == cfg.layers * sum(dec),
                      f"{label}: paged launches {wave['paged_launches']} "
                      f"for decode steps {dec}")
                if dis:
                    check(dec[0] == 0 and pre[1] == 0,
                          f"{label}: the prefill host ran {dec[0]} decode "
                          f"steps, the decode host {pre[1]} prefills")
                    check(wave["migrations"] + wave["fallbacks"] == n,
                          f"{label}: {wave['migrations']} migrations and "
                          f"{wave['fallbacks']} fallbacks for {n} streams")
                    if w == 0:
                        check(wave["migrations"] == n
                              and wave["fallbacks"] == 0,
                              f"{label}: {wave['migrations']} migrations, "
                              f"{wave['fallbacks']} fallbacks")
                    wave["migrated_bytes_per_stream"] = \
                        wave["migrated_bytes"] / max(wave["migrations"], 1)
                log(f"{label}: " + json.dumps(wave))
                waves.append(wave)
            out[placement] = waves
        finally:
            for g in engines:
                g.shutdown()
        out.setdefault("_shutdown", []).extend(
            v for g in engines for v in check_shutdown(g))
    bad = out.pop("_shutdown")
    check(not bad, f"disagg {kv}: shutdown law: {bad}")
    return out


def migrate_faults_part(cfg, params, prompts, plain, device, max_new):
    """Part c of :func:`disagg_phase`."""
    from deeplearning4j_tpu_torch.serving import (
        FaultPlan, Tracer, check_shutdown)

    n = len(prompts)
    tracer = Tracer(sample_rate=1.0, capacity=256)
    engines, hosts, d, fd = loopback_fleet(
        cfg, params, "float32", ("prefill", "decode"), True, device,
        tracer=tracer)
    try:
        # each point's call indices: one kv.migrate and one export call a
        # stream, in arrival order; import calls only for streams whose
        # pages were captured (28 of them here)
        plan = (FaultPlan(seed=16)
                .fail("kv.migrate", at=(3, 17))
                .fail("kv.migrate.export", at=(5, 21))
                .fail("kv.migrate.import", at=(8, 24)))
        with plan:
            report, streams, _ = disagg_replay(fd, prompts, max_new,
                                               tenant=lambda i: f"r{i}")
        fired = [(e["point"], e["index"]) for e in plan.fired()]
        check(report.reasons() == {"ok": n},
              f"disagg faults: requests ended {report.reasons()}")
        by_point = {}
        for p, _ in fired:
            by_point[p] = by_point.get(p, 0) + 1
        check(all(by_point.get(p, 0) >= 2 for p in (
            "kv.migrate", "kv.migrate.export", "kv.migrate.import")),
            f"disagg faults: fired {by_point}")
        # each stream's fallback stage, from its front-door trace
        stage = {}
        for tr in tracer.traces():
            if tr.kind != "cluster.generate" or not (
                    tr.tenant or "").startswith("r"):
                continue
            for name, _, a in tr.events:
                if name == "cluster.migrate.fallback":
                    stage[int(tr.tenant[1:])] = (a or {}).get("stage")
        fm = fd.metrics
        fallbacks = fm.kv_migrate_fallbacks_total.value
        migrations = fm.kv_migrations_total.value
        stages = {}
        for s in stage.values():
            stages[s] = stages.get(s, 0) + 1
        check(fallbacks == len(stage) and migrations + fallbacks == n,
              f"disagg faults: {fallbacks} fallbacks, {migrations} "
              f"migrations, traces show {stages}")
        check(stages.get("prefill", 0) == by_point["kv.migrate"]
              and stages.get("import", 0) == by_point["kv.migrate.import"]
              and stages.get("export", 0) <= by_point["kv.migrate.export"],
              f"disagg faults: fallback stages {stages} against fired "
              f"{by_point}")
        check(fm.rejected_total.value == 0,
              f"disagg faults: {fm.rejected_total.value} shed")
        # the reference of each recomputed stream: from scratch, the
        # engine phase's stream; from its first token, the decode host's
        # engine seated at resume_tokens=[first]
        resumed = sorted(i for i, s in stage.items() if s != "prefill")
        seated = [engines[1].submit(prompts[i], max_new_tokens=max_new,
                                    seed=0,
                                    resume_tokens=streams[i][:1],
                                    resume_step=1) for i in resumed]
        want = dict(enumerate(plain))
        for i, h in zip(resumed, seated):
            want[i] = streams[i][:1] + [int(t) for t in
                                        h.result(timeout=300)]
        bad = [i for i in range(n) if streams[i] != want[i]]
        check(not bad, f"disagg faults: streams {bad} differ from their "
              "references")
        first_bad = [i for i in resumed if streams[i][0] != plain[i][0]]
        check(not first_bad, f"disagg faults: first tokens of {first_bad} "
              "differ from the engine phase's")
        off_clean = [i for i in stage if streams[i] != plain[i]]
        out = {"fired": by_point, "fallbacks": fallbacks,
               "migrations": migrations, "fallback_stages": stages,
               "recomputed_from_first_token": len(resumed),
               "recomputed_from_scratch": stages.get("prefill", 0),
               "recomputed_off_clean": len(off_clean)}
    finally:
        for g in engines:
            g.shutdown()
    bad = [v for g in engines for v in check_shutdown(g)]
    check(not bad, f"disagg faults: shutdown law: {bad}")
    log("disagg faults: " + json.dumps(out))
    return out


def timed_remote_host():
    """``RemoteHost`` that records each migrate RPC's kind, wall time and
    page payload (base64 characters), and every HTTP call's path, start,
    wall time and error."""
    from deeplearning4j_tpu_torch.serving import RemoteHost

    class TimedRemoteHost(RemoteHost):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.migrate_calls = []
            self.http_calls = []   # (path, start, ms, error or None)

        def _http_json(self, path, payload, timeout_s=None):
            t, err = time.perf_counter(), None
            try:
                return super()._http_json(path, payload, timeout_s=timeout_s)
            except BaseException as e:
                err = f"{type(e).__name__}: {e}"
                raise
            finally:
                self.http_calls.append(
                    (path, t, (time.perf_counter() - t) * 1e3, err))

        def _migrate_rpc(self, req):
            t = time.perf_counter()
            resp = super()._migrate_rpc(req)
            pages = req.pages if req.kind == "import" else resp.pages
            self.migrate_calls.append((
                req.kind, (time.perf_counter() - t) * 1e3,
                sum(len(leaf["b64"]) for layer in pages or ()
                    for leaf in layer.values())))
            return resp
    return TimedRemoteHost


def rpc_disagg_part(hosts, urls, cfg, prompts, plain, front, max_new):
    """Part b of :func:`disagg_phase` over the started host processes."""
    from deeplearning4j_tpu_torch.serving import (
        ClusterDirectory, ClusterFrontDoor, DisaggPolicy, HeartbeatPump,
        LoopbackTransport, Tracer)

    n = len(prompts)
    remote = timed_remote_host()
    d = ClusterDirectory(heartbeat_timeout_s=5.0)
    tracer = Tracer(sample_rate=1.0, capacity=256)

    class StampedTransport(LoopbackTransport):
        """Records when each heartbeat reaches the directory."""

        def __init__(self, directory):
            super().__init__(directory)
            self.stamps = []

        def publish(self, status):
            self.stamps.append(time.perf_counter())
            super().publish(status)

    pumps, rems, transports = [], [], []
    for i, url in enumerate(urls):
        rem = remote(i, url)
        d.join(rem)
        tp = StampedTransport(d)
        pump = HeartbeatPump(rem, tp, interval_s=0.2)
        pump.pump_once()
        pumps.append(pump.start())
        rems.append(rem)
        transports.append(tp)
    try:
        fd = ClusterFrontDoor(d, disagg=DisaggPolicy(), tracer=tracer)
        check(fd.disagg.enabled(d), "disagg rpc: the policy is not enabled")
        before = [h.ask("report") for h in hosts]
        t0, cpu0 = time.perf_counter(), time.process_time()
        report, streams, itl = disagg_replay(fd, prompts, max_new)
        t1, cpu1 = time.perf_counter(), time.process_time()
        after = [h.ask("report") for h in hosts]
    finally:
        for pump in pumps:
            pump.stop()
    wire = rpc_wire_record(t0, t1, transports, rems, tracer, streams)
    if report.reasons() != {"ok": n} \
            or fd.metrics.kv_migrate_fallbacks_total.value:
        log("disagg rpc: the wire when it failed: "
            + json.dumps(wire, default=str))
    check(report.reasons() == {"ok": n},
          f"disagg rpc: requests ended {report.reasons()}: "
          f"{wire['failed']}")
    bad = [i for i, (a, b) in enumerate(zip(streams, plain)) if a != b]
    check(not bad, f"disagg rpc: streams {bad} differ from the engine "
          "phase's")
    delta = [{k: a[k] - b[k] for k in (
        "prefills", "decode_steps", "packed_launches", "paged_launches",
        "kv_migrate_bytes_out", "kv_migrate_bytes_in", "kv_swap_bytes_in")}
        for a, b in zip(after, before)]
    fm = fd.metrics
    check(fm.kv_migrations_total.value == n
          and fm.kv_migrate_fallbacks_total.value == 0,
          f"disagg rpc: {fm.kv_migrations_total.value} migrations, "
          f"{fm.kv_migrate_fallbacks_total.value} fallbacks")
    check(delta[0]["kv_migrate_bytes_out"]
          == delta[1]["kv_migrate_bytes_in"] > 0,
          f"disagg rpc: host 0 exported {delta[0]['kv_migrate_bytes_out']} "
          f"bytes, host 1 imported {delta[1]['kv_migrate_bytes_in']}")
    check(delta[0]["paged_launches"] == 0 and delta[0]["decode_steps"] == 0
          and delta[1]["packed_launches"] == 0 and delta[1]["prefills"] == 0,
          f"disagg rpc: the prefill host ran {delta[0]['decode_steps']} "
          f"decode steps ({delta[0]['paged_launches']} paged launches), "
          f"the decode host {delta[1]['prefills']} prefills "
          f"({delta[1]['packed_launches']} packed launches)")
    check(delta[0]["packed_launches"] == cfg.layers * delta[0]["prefills"]
          and delta[0]["prefills"] == n,
          f"disagg rpc: host 0 launched the packed kernel "
          f"{delta[0]['packed_launches']} times for "
          f"{delta[0]['prefills']} prefills")
    check(delta[1]["paged_launches"]
          == cfg.layers * delta[1]["decode_steps"] > 0,
          f"disagg rpc: host 1 launched the paged kernel "
          f"{delta[1]['paged_launches']} times for "
          f"{delta[1]['decode_steps']} decode steps")
    calls = [c for r in rems for c in r.migrate_calls]
    walls = {k: [ms for kind, ms, _ in calls if kind == k]
             for k in ("prefill", "import")}
    check(all(len(v) == n for v in walls.values()),
          "disagg rpc: migrate calls "
          f"{[(k, len(v)) for k, v in walls.items()]}")
    rep = report.to_dict()
    out = {"fleet_tokens_per_sec": report.tokens_per_sec,
           "heartbeat_gap_max_ms": wire["heartbeat_gap_max_ms"],
           "http_ms_max": wire["http_ms_max"],
           "connect_retries": wire["connect_retries"],
           "front_process_cores": (cpu1 - cpu0) / (t1 - t0),
           "front_process_threads": sum(wire["threads"].values()),
           "ttft_p50_ms": rep["ttft_p50_ms"],
           "ttft_p99_ms": rep["ttft_p99_ms"],
           "itl_p99_ms": float(np.percentile(itl, 99)),
           "migrations": fm.kv_migrations_total.value,
           "hosts": delta,
           "kv_bytes_per_stream": delta[1]["kv_migrate_bytes_in"] / n,
           "wire_b64_bytes_per_stream":
               sum(b for kind, _, b in calls if kind == "import") / n}
    for k, v in walls.items():
        out[f"migrate_{k}_rpc_ms_p50"] = float(np.percentile(v, 50))
        out[f"migrate_{k}_rpc_ms_p99"] = float(np.percentile(v, 99))
    # the first token reaches the client once the prefill RPC is back
    out["prefill_rpc_share_of_ttft_p50"] = \
        out["migrate_prefill_rpc_ms_p50"] / out["ttft_p50_ms"]
    out["front_door_mixed"] = {k: front[k] for k in (
        "fleet_tokens_per_sec", "fleet_ttft_p50_ms", "fleet_ttft_p99_ms")}
    log("disagg rpc: " + json.dumps(out))
    return out


def rpc_wire_record(t0, t1, transports, rems, tracer, streams):
    """What the wire did while the replay ran from ``t0`` to ``t1``
    (``time.perf_counter``): each host's longest gap between heartbeats
    reaching the directory, each HTTP path's slowest call, every failed
    HTTP call, each host's handshakes tried again
    (``RemoteHost.connect_retries``, counted over the whole part), each
    failed stream's exception chain, and the events of every request
    that was shed, bounced or fell back (ms from ``t0``)."""
    def rel(t):
        return round((t - t0) * 1e3, 1)

    gaps = []
    for tp in transports:
        st = [t0] + [t for t in tp.stamps if t0 <= t <= t1] + [t1]
        gap, at = max((b - a, a) for a, b in zip(st, st[1:]))
        gaps.append({"ms": round(gap * 1e3, 1), "from_ms": rel(at)})
    slowest, errors = {}, []
    for h, rem in enumerate(rems):
        for path, t, ms, err in rem.http_calls:
            if not t0 <= t <= t1:
                continue
            key = path.rsplit("/", 1)[-1]
            if ms > slowest.get(key, (0.0,))[0]:
                slowest[key] = (round(ms, 1), h, rel(t))
            if err is not None:
                errors.append({"host": h, "path": key, "at_ms": rel(t),
                               "ms": round(ms, 1), "error": err[:300]})
    failed = {}
    for i, s in enumerate(streams):
        chain, e = [], s if isinstance(s, BaseException) else None
        while e is not None and len(chain) < 6:
            chain.append(f"{type(e).__name__}: {e}"[:300])
            e = e.__cause__ or e.__context__
        if chain:
            failed[i] = chain
    odd = [[(name, rel(t), a) for name, t, a in tr.events]
           for tr in tracer.traces()
           if any(name in ("cluster.shed", "cluster.bounce",
                           "cluster.migrate.fallback")
                  for name, _, _ in tr.events)]
    threads = {}
    for th in threading.enumerate():
        key = th.name.split("[")[0].split("-")[0]
        threads[key] = threads.get(key, 0) + 1
    return {"heartbeat_gap_max_ms": [g["ms"] for g in gaps],
            "connect_retries": [rem.connect_retries for rem in rems],
            "heartbeat_gaps": gaps, "threads": threads,
            "http_ms_max": {k: v[0] for k, v in slowest.items()},
            "http_slowest": slowest, "http_errors": errors,
            "failed": failed, "odd_requests": odd}


def request_paths(tracer, prefix, n):
    """From the front door's traces of requests labelled ``prefix + i``:
    each request's resume points (where it has any) and its path over
    the hosts (routes, bounces, resumes)."""
    resumed, paths = {}, {}
    for tr in tracer.traces():
        if tr.kind != "cluster.generate" or tr.tenant not in {
                f"{prefix}{i}" for i in range(n)}:
            continue
        i = int(tr.tenant[len(prefix):])
        evs = [(name, a or {}) for name, _, a in tr.events]
        steps = sorted({a["resume_step"] for name, a in evs
                        if name == "stream.resume"})
        if steps:
            resumed[i] = steps
        paths[i] = [f"{name}@h{a['host']}" + (f":{a['reason']}"
                                               if "reason" in a else "")
                    for name, a in evs if "host" in a and name in (
                        "cluster.route", "cluster.bounce", "stream.resume")]
    return resumed, paths


# ---------------------------------------------------------------- samediff
# SameDiff (BASELINE config #4's encoder, built through the graph API as
# the TF importer emits it: tests/torch_samediff_cases.py), fuseAttention
# on rows 1-5, save/load, the serving adapters, gradient checks and the
# sharded checkpoint loop on the card (:func:`samediff_phase`)

SD_B, SD_WARM, SD_STEPS = 32, 2, 8            # (a): config #4's B; T = 128
SD_LONG_B, SD_LONG_T = 4, 1024                # (b): the packed rows
SD_STREAM_L, SD_STREAM_B, SD_STREAM_T = 2, 2, 2048   # (c): the streamed rows
ROWS_1_5 = ("mha_attention_packed", "mha_packed_backward", "flash_forward",
            "flash_bwd_dq", "flash_bwd_dkv")


def _sd_recipes():
    """``tests/torch_samediff_cases.py`` (jax-free recipes)."""
    _graph_recipes()   # puts tests/ on sys.path
    import torch_samediff_cases

    return torch_samediff_cases


def _sd_launches():
    got = read_launches()
    return {k: got[k] for k in ROWS_1_5}


def _sd_graph(C, L, T, B, compute=None, seed=0):
    """Config #4's encoder at depth ``L`` and length ``T`` on the card,
    constants made trainable, the MLM head (seeded XAVIER) and Adam(1e-4);
    (sd, encoder output name, loss name)."""
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.train import Adam

    cfg = dict(C.BERT_BASE, L=L, T=T)
    sd, _, out = C.build_bert_encoder(**cfg, seed=seed, device=DEVICE)
    n = sd.convertAllConstantsToVariables()
    check(n == 4 + 12 * L, f"samediff: {n} constants made trainable, expected "
          f"{4 + 12 * L}")
    loss = C.add_mlm_head(sd, out, cfg["H"], cfg["V"], B, T)
    sd.setTrainingConfig(TrainingConfig(updater=Adam(1e-4), computeDtype=compute))
    return sd, out, loss


class _KeepGrads:
    """A listener that asks the graph to keep each step's gradients."""
    requiresGradients = True

    def iterationDone(self, model, iteration, epoch):
        pass


def _sd_timed_fit(sd, batch, warmup, steps):
    """``warmup`` then ``steps`` fit steps on one batch, each ending in a
    read of its loss; (tokens/s, mean step ms, timed losses, peak GB)."""
    import torch

    for _ in range(warmup):
        sd.fit(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses += sd.fit(batch)
    wall = time.perf_counter() - t0
    B, T = batch["ids"].shape
    return (B * T * steps / wall, wall / steps * 1e3, losses,
            torch.cuda.max_memory_allocated() / 1e9)


def _sd_traced_step(sd, batch, label):
    """One more fit step under the port's ``profiler.device_trace``: its
    wall (the step ends in a read of its loss) against the device's busy
    time, the sum of the kernels, copies and fills that ran on the card
    (``report_profile``), and the busy share."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.profiler import device_trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with device_trace(d) as prof:
            t0 = time.perf_counter()
            sd.fit(batch)
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = report_profile(prof, wall_ms, f"{label} one traced step ({CARD})")
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms == 0:   # torch.profiler can drop kernel records after a
        # process's first profiled call: a reading, not a failure
        log(f"{label}: device busy not measured (the trace holds no device events)")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "device_events": sum(n for _, _, n in kernels)}


def _sd_config4_part(C):
    """(a) config #4 at its sizes, FLOAT then HALF from the same initial
    values; returns the graph, trained SD_WARM steps in FLOAT, for (d)
    and (e)."""
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.train import Adam

    sd, out, _ = _sd_graph(C, 12, 128, SD_B)
    fused = sd.fuseAttention()
    check(fused == 12, f"samediff (a): fuseAttention fused {fused} sites, expected 12")
    init = {n: sd._values[n].clone() for n in sd._trainable_names()}
    batch = C.mlm_batch(C.BERT_BASE["V"], SD_B, 128)
    res = {"fused_sites": fused, "params": sd.numParams()}
    for compute in (None, "HALF"):
        label = compute or "FLOAT"
        if compute:
            sd._values.update({n: v.clone() for n, v in init.items()})
            sd.setTrainingConfig(TrainingConfig(updater=Adam(1e-4), computeDtype=compute))
        reset_launches()
        tok_s, step_ms, losses, peak = _sd_timed_fit(sd, batch, SD_WARM, SD_STEPS)
        got = _sd_launches()
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"samediff (a) {label}: the loss did not fall over the timed steps: {losses}")
        res[label] = {"tokens_per_sec": tok_s, "step_ms": step_ms, "losses": losses,
                      "peak_gb": peak, "launches": got,
                      "traced_step": _sd_traced_step(sd, batch, f"samediff (a) {label}")}
        log(f"samediff (a) config #4 {label} ({CARD}): {tok_s:.1f} tokens/s, "
            f"{step_ms:.3f} ms a step, peak {peak:.2f} GB, rows 1-5 {got} "
            f"over {SD_WARM + SD_STEPS} steps (T = 128: the einsum route)")
    # (d) and (e) take a FLOAT-trained state: from the initial values,
    # SD_WARM steps in FLOAT
    sd._values.update({n: v.clone() for n, v in init.items()})
    sd.setTrainingConfig(TrainingConfig(updater=Adam(1e-4)))
    for _ in range(SD_WARM):
        sd.fit(batch)
    return sd, out, batch, res


def _sd_within(got, want, tol, what):
    """max |got - want| against ``tol`` (an absolute bound); returns it."""
    err = max_err(got, want)
    check(err <= tol, f"{what}: max |err| {err:.3e} > {tol:.3e}")
    return err


def _sd_route_part(C, L, T, B, rows_fwd, rows_bwd, label, make=None, phase="samediff"):
    """(b)/(c): the L-layer graph at length T (``make(compute)`` gives
    (sd, output name, loss name); by default the API-built encoder of
    :func:`_sd_graph`), fp32 and bf16 (HALF: the
    step's compute dtype, and the output on the values cast to it): one
    ``output`` and one fit step unfused (the einsum chain), then the same
    after ``fuseAttention`` (the kernels). Launch counts per output and
    per step; layer 0's attention output (fused from the same inputs)
    against the unfused one by ``judge``; the encoder output and the
    step's gradients and loss by networks (c)'s rule: fp32 within 1e-4 of
    each tensor's largest |value| (the loss 1e-5 relative), bf16 within
    2^-6 of the fp32 einsum's largest |value| or twice the bf16 einsum's
    own distance from fp32."""
    import torch

    rng = np.random.default_rng(2)
    batch = {"ids": rng.integers(0, C.BERT_BASE["V"], (B, T)).astype(np.int32),
             "targets": rng.integers(0, C.BERT_BASE["V"], (B, T)).astype(np.int32)}
    res, ref32 = {}, None
    make = make or (lambda compute: _sd_graph(C, L, T, B, compute))
    for compute in (None, "HALF"):
        dt = compute or "FLOAT"
        sd, out, _ = make(compute)
        att0 = next(o for o in sd._ops if o.opname == "softmax")
        att0 = next(o.outputs[0] for o in sd._ops if o.opname == "matmul"
                    and o.inputs[0] == att0.outputs[0])
        init = {n: v.clone() for n, v in sd._values.items()}
        keep = _KeepGrads()
        sd.listeners = [keep]
        want_names = ["l0/qkv_w", f"l{L - 1}/fc2_w", "tok_emb", "lm_head"]

        def run():
            # the output in the step's compute dtype: computeDtype casts
            # only fit's leaves, so a bf16 output runs on cast values
            sd._values.update({n: v.to(torch.bfloat16) if compute and
                               v.dtype == torch.float32 else v.clone()
                               for n, v in init.items()})
            reset_launches()
            o = sd.output({"ids": batch["ids"]}, [out, att0])
            n_out = _sd_launches()
            sd._values.update({n: v.clone() for n, v in init.items()})
            sd._opt_state = None
            reset_launches()
            step_loss = sd.fit(batch)[0]
            n_step = _sd_launches()
            torch.cuda.synchronize()
            grads = {n: sd._last_grads[n].float() for n in want_names}
            return {"out": o[out].torch.float(), "att0": o[att0].torch, "loss": step_loss,
                    "grads": grads, "out_launches": n_out, "step_launches": n_step}

        plain = run()
        fused = sd.fuseAttention()
        check(fused == L, f"{phase} ({label}) {dt}: fuseAttention fused {fused}, expected {L}")
        kern = run()
        check(not any(plain["step_launches"].values()) and
              not any(plain["out_launches"].values()),
              f"{phase} ({label}) {dt}: the unfused graph launched {plain['step_launches']}")
        want_out = {r: (L if r in rows_fwd else 0) for r in ROWS_1_5}
        want_step = {r: (L if r in rows_fwd + rows_bwd else 0) for r in ROWS_1_5}
        check(kern["out_launches"] == want_out,
              f"{phase} ({label}) {dt}: an output launched {kern['out_launches']}, "
              f"expected {want_out}")
        check(kern["step_launches"] == want_step,
              f"{phase} ({label}) {dt}: a fit step launched {kern['step_launches']}, "
              f"expected {want_step}")
        def rows(t):   # (B, A, T, D) -> (B, T, A*D): one head's D values a row
            return t.transpose(1, 2).flatten(2)

        if compute is None:
            a_err = max_err(kern["att0"], plain["att0"])
            a_share = a_err / rel_bound(plain["att0"], 1e-5)
            a_rule = "1e-5 of max|ref|"
            check(a_share <= 1.0, f"{phase} ({label}) FLOAT: layer 0 attention, "
                  f"kernels vs einsum {a_err:.3e}")
            errs = {"out": _sd_within(kern["out"], plain["out"],
                                      1e-4 * plain["out"].abs().max().item(),
                                      f"{phase} ({label}) FLOAT: encoder output")}
            for n in want_names:
                g = plain["grads"][n]
                errs[n] = _sd_within(kern["grads"][n], g, 1e-4 * g.abs().max().item(),
                                     f"{phase} ({label}) FLOAT: gradient of {n}")
            loss_err = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
            check(loss_err <= 1e-5, f"{phase} ({label}) FLOAT: loss {kern['loss']} vs "
                  f"{plain['loss']}")
            ref32 = plain
        else:
            # the ops phase's bf16 rule: judge against the fp32 einsum, or
            # twice the bf16 einsum route's own share where that is larger
            a_err, a_share, a_rule = judge(rows(kern["att0"]), rows(ref32["att0"]), 64,
                                           False, FWD_FLOOR)
            _, own, _ = judge(rows(plain["att0"]), rows(ref32["att0"]), 64, False,
                              FWD_FLOOR)
            a_rule += f"; the bf16 einsum route's share {own:.3f}"
            check(a_share <= max(1.0, 2 * own), f"{phase} ({label}) HALF: layer 0 "
                  f"attention, kernels vs fp32 take {a_share:.3f} of the bound ({a_rule})")
            errs = {}
            for n, got, want, base in (
                    [("out", kern["out"], plain["out"], ref32["out"])]
                    + [(n, kern["grads"][n], plain["grads"][n], ref32["grads"][n])
                       for n in want_names]):
                tol = max(2 ** -6 * base.abs().max().item(), 2 * max_err(want, base))
                errs[n] = _sd_within(got, want, tol, f"{phase} ({label}) HALF: {n}")
            loss_err = abs(kern["loss"] - plain["loss"]) / abs(ref32["loss"])
            check(loss_err <= max(2 ** -6, 2 * abs(plain["loss"] - ref32["loss"])
                                  / abs(ref32["loss"])),
                  f"{phase} ({label}) HALF: loss {kern['loss']} vs {plain['loss']}")
        res[dt] = {"fused_sites": fused, "out_launches": kern["out_launches"],
                   "step_launches": kern["step_launches"], "att0_max_abs_err": a_err,
                   "att0_share_of_bound": a_share, "max_abs_err": errs,
                   "loss_rel_err": loss_err, "loss": kern["loss"]}
        log(f"{phase} ({label}) L={L} T={T} B={B} {dt} ({CARD}): per output "
            f"{kern['out_launches']}, per step {kern['step_launches']}; kernels vs "
            f"einsum: layer 0 attention {a_err:.3e} ({a_share:.3f} of {a_rule}), "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        del sd, init, plain, kern
        torch.cuda.empty_cache()
    return res


def _sd_save_load_part(sd, out, batch, tmp_dir):
    """(d) (a)'s FLOAT graph written with its Adam state and read back on
    the card: the output bit-equal, then one more step on each with the
    same bits (deterministic algorithms for both steps: the embedding
    gather's backward accumulates with atomics otherwise)."""
    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves

    path = os.path.join(tmp_dir, "config4.sdz")
    t0 = time.perf_counter()
    sd.save(path, save_updater_state=True)
    back = SameDiff.load(path, device=DEVICE)
    io_s = time.perf_counter() - t0
    ids = {"ids": batch["ids"]}
    a, b = sd.output(ids, out)[out].torch, back.output(ids, out)[out].torch
    check(torch.equal(a, b), f"samediff (d): the restored output differs by {max_err(a, b):.3e}")
    same_state = all(torch.equal(x.cpu(), y.cpu()) for x, y in
                     zip(tree_leaves(sd._opt_state), tree_leaves(back._opt_state)))
    check(same_state, "samediff (d): the restored Adam state differs")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        la, lb = sd.fit(batch)[0], back.fit(batch)[0]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diff = [n for n in sd._trainable_names()
            if not torch.equal(sd._values[n], back._values[n])]
    check(la == lb and not diff, f"samediff (d): one more step: losses {la} / {lb}, "
          f"params differing: {diff[:5]}")
    out_d = {"save_load_s": io_s, "file_mb": os.path.getsize(path) / 1e6,
             "loss_after": la}
    log(f"samediff (d) ({CARD}): saved and loaded in {io_s:.2f} s "
        f"({out_d['file_mb']:.1f} MB); output and the next step bit-equal")
    return out_d


def _sd_serving_part(C, sd, out):
    """(e) the registry's adapters on the card: (a)'s encoder
    (``SameDiffAdapter``, input ``ids``), LeNet
    (``MultiLayerNetworkAdapter``), the graphs phase's attention graph at rows of
    (512, 768) (``ComputationGraphAdapter``) and ``ParallelInference``'s
    engine: each request of 3 rows padded to bucket 4 equals the model's
    own call on the same padded batch bit for bit, and the unpadded call
    within 1e-5 of its largest |value| (cuBLAS may take another kernel
    for 3 rows); rows/s over 10 requests of 4 rows."""
    import torch

    from deeplearning4j_tpu_torch import nn as pnn
    from deeplearning4j_tpu_torch import train as ptrain
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.serving.registry import SameDiffAdapter

    rng = np.random.default_rng(6)
    lenet = MultiLayerNetwork(_lenet_conf(), device=DEVICE).init()
    GC = _graph_recipes()
    cg = pnn.ComputationGraph(GC.attention_graph(pnn, ptrain, d=SA_D, heads=SA_HEADS,
                                                 T=SA_T), device=DEVICE).init()
    models = {
        "samediff": (SameDiffAdapter(sd, input_name="ids", output_name=out),
                     lambda x: sd.output({"ids": x}, out)[out].toNumpy(),
                     lambda n: rng.integers(0, C.BERT_BASE["V"], (n, 128)).astype(np.int32)),
        "lenet": (lenet, lambda x: lenet.output(x).toNumpy(),
                  lambda n: rng.random((n, 784)).astype(np.float32)),
        "attention_graph": (cg, lambda x: cg.outputSingle(x).toNumpy(),
                            lambda n: rng.standard_normal((n, SA_T, SA_D)).astype(np.float32)),
    }
    reg = ModelRegistry(default_buckets=(1, 2, 4))
    res = {}
    for name, (model, call, rows) in models.items():
        reg.deploy(name, model)
        with reg.engine(name, max_wait_ms=0) as eng:
            x = rows(3)
            got = np.asarray(eng.output(x))
            padded = np.concatenate([x, np.zeros((1,) + x.shape[1:], x.dtype)])
            check(np.array_equal(got, call(padded)[:3]),
                  f"samediff (e) {name}: the engine's rows differ from the padded call")
            err = float(np.abs(got - call(x)).max())
            check(err <= 1e-5 * max(float(np.abs(got).max()), 1.0),
                  f"samediff (e) {name}: the engine's rows vs the unpadded call {err:.3e}")
            x4 = rows(4)
            eng.output(x4)
            t0 = time.perf_counter()
            for _ in range(10):
                eng.output(x4)
            rps = 40 / (time.perf_counter() - t0)
        res[name] = {"rows_per_sec": rps, "unpadded_max_abs_err": err}
    pi = ParallelInference.Builder(lenet).batchLimit(4).build()
    with pi.engine(max_wait_ms=0) as eng:
        x = models["lenet"][2](3)
        got = np.asarray(eng.output(x))
        check(np.array_equal(got, pi.output(x).toNumpy()),
              "samediff (e): ParallelInference.engine differs from its output()")
        t0 = time.perf_counter()
        for _ in range(10):
            eng.output(models["lenet"][2](4))
        res["parallel_inference"] = {"rows_per_sec": 40 / (time.perf_counter() - t0)}
    log(f"samediff (e) serving ({CARD}): " + ", ".join(
        f"{k} {v['rows_per_sec']:.1f} rows/s" for k, v in res.items()))
    del cg, lenet
    torch.cuda.empty_cache()
    return res


def _sd_gradcheck_part():
    """(f) ``check_gradients`` on the card in float64: a dense net and a
    conv net (tests/test_gradchecks.py's), 40 parameters each; the worst
    relative error among the indices past ``min_abs_error`` must be under
    the reference's ``max_rel_error`` (1e-3)."""
    from deeplearning4j_tpu_torch import nn as pnn
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.train import Sgd
    from deeplearning4j_tpu_torch.utils import gradientcheck as gc

    rng = np.random.default_rng(42)
    nets = {
        "dense": ([L.DenseLayer(nOut=5, activation="TANH"),
                   L.OutputLayer(nOut=3, lossFunction="MCXENT")],
                  pnn.InputType.feedForward(4), rng.normal(size=(6, 4)),
                  np.eye(3)[rng.integers(0, 3, 6)]),
        "conv": ([L.ConvolutionLayer(nOut=3, kernelSize=(3, 3), activation="TANH"),
                  L.SubsamplingLayer(poolingType="AVG", kernelSize=(2, 2), stride=(2, 2)),
                  L.OutputLayer(nOut=2, lossFunction="MCXENT")],
                 pnn.InputType.convolutional(8, 8, 2), rng.normal(size=(3, 2, 8, 8)),
                 np.eye(2)[rng.integers(0, 2, 3)]),
    }
    res = {}
    for name, (layers, itype, x, y) in nets.items():
        conf = pnn.NeuralNetConfiguration.Builder().seed(7).updater(Sgd(0.1)).list()
        for l in layers:
            conf = conf.layer(l)
        net = pnn.MultiLayerNetwork(conf.setInputType(itype).build(), device=DEVICE).init()
        ok = gc.check_gradients(net, x, y, subset=40)
        rows = gc.gradient_errors(net, x, y, subset=40)
        worst = max([r[3] for r in rows if r[4] > 1e-8] or [0.0])
        check(ok and worst < 1e-3, f"samediff (f) {name}: gradient check failed, worst "
              f"relative error {worst:.3e}")
        # the gate's reading (indices past min_abs_error), and the largest
        # relative and absolute errors over every checked index
        res[name] = {"checked": len(rows), "worst_rel_err": worst,
                     "max_rel_err_all": max(r[3] for r in rows),
                     "max_abs_err_all": max(r[4] for r in rows)}
    log(f"samediff (f) gradient checks on the card ({CARD}): {res}")
    return res


def _sd_checkpoint_part(tmp_dir):
    """(g) ``train_with_checkpointing`` over ``make_train_step(cfg, mesh)``
    (2-layer fp32 BERT at full widths, B=8, T=128) at world size 1 on
    NCCL: 6 steps without a break against a run stopped by SIGTERM during
    step 3 and resumed from its latest checkpoint; the parameters and the
    AdamW state bit-equal (deterministic algorithms for both runs)."""
    import signal

    import torch

    from deeplearning4j_tpu_torch.models import TransformerConfig, init_params
    from deeplearning4j_tpu_torch.models import bert as tbert
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
        GracefulShutdown, ShardedCheckpointManager, train_with_checkpointing)
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves

    steps, stop_at = 6, 3
    cfg = TransformerConfig(layers=2, dtype=torch.float32, remat=False,
                            attention_impl="flash")
    batches = [train_batch(cfg, 8, 128, seed=s) for s in range(steps)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with nccl_world():
            mesh = make_mesh()
            init, step = tbert.make_train_step(cfg, mesh)

            def fresh():
                p = tbert.place_params(init_params(cfg, seed=0, device=DEVICE), cfg, mesh)
                return p, init(p)

            params, state = fresh()
            whole = []
            for s in range(steps):
                params, state, loss = step(params, state, batches[s])
                whole.append(float(loss))

            class Preempt:
                def iterationDone(self, model, it, ep):
                    if it == stop_at - 1:
                        signal.raise_signal(signal.SIGTERM)

            path = os.path.join(tmp_dir, "ckpt")
            mgr = ShardedCheckpointManager(path, keep_last=2, save_interval_steps=2,
                                           mesh=mesh)
            p, st = fresh()
            t0 = time.perf_counter()
            with GracefulShutdown() as stop:
                p, st, done, first = train_with_checkpointing(
                    step, p, st, lambda s: batches[s], steps, mgr, shutdown=stop,
                    listeners=[Preempt()])
            p, st, at, _ = ShardedCheckpointManager(path, mesh=mesh).restore(*fresh())
            p, st, _, second = train_with_checkpointing(
                step, p, st, lambda s: batches[s], steps, mgr, start_step=at)
            wall = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(params))) \
        and all((torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
                for a, b in zip(tree_leaves(st), tree_leaves(state)))
    check(done == stop_at and at == stop_at and same and first + second == whole,
          f"samediff (g): stopped at {done}, restored {at}, bit-equal {same}, "
          f"losses {first + second} vs {whole}")
    log(f"samediff (g) checkpointed training ({CARD}): stopped at step {done}, "
        f"resumed from {at}, params and AdamW state bit-equal to the unbroken run; "
        f"kept steps {mgr.all_steps()}; {wall:.2f} s for the broken run")
    return {"stopped_at": done, "restored": at, "bit_equal": same,
            "kept": mgr.all_steps(), "losses": whole, "wall_s": wall}


def samediff_phase():
    """SameDiff on the card (the module docstring's samediff phase): (a)
    config #4 at its sizes, (b) the 12-layer graph at T = 1024 on rows
    1-2, (c) a 2-layer copy at T = 2048 on rows 3-5, (d) save/load, (e)
    the serving adapters, (f) gradient checks, (g) checkpointed training.
    Every part's failure fails the phase."""
    import tempfile

    import torch

    C = _sd_recipes()
    out = {"card": CARD}
    marks = [time.perf_counter()]
    sd, enc, batch, out["config4"] = _sd_config4_part(C)
    marks.append(time.perf_counter())
    out["packed"] = _sd_route_part(C, 12, SD_LONG_T, SD_LONG_B,
                                   ("mha_attention_packed",), ("mha_packed_backward",),
                                   "b")
    marks.append(time.perf_counter())
    out["streamed"] = _sd_route_part(C, SD_STREAM_L, SD_STREAM_T, SD_STREAM_B,
                                     ("flash_forward",), ("flash_bwd_dq", "flash_bwd_dkv"),
                                     "c")
    marks.append(time.perf_counter())
    with tempfile.TemporaryDirectory() as d:
        out["save_load"] = _sd_save_load_part(sd, enc, batch, d)
        marks.append(time.perf_counter())
        out["serving"] = _sd_serving_part(C, sd, enc)
        marks.append(time.perf_counter())
        del sd
        torch.cuda.empty_cache()
        out["gradcheck"] = _sd_gradcheck_part()
        marks.append(time.perf_counter())
        out["checkpoint"] = _sd_checkpoint_part(d)
        marks.append(time.perf_counter())
    out["part_s"] = dict(zip("abcdefg", np.diff(marks).tolist()))
    log(f"samediff ({CARD}): " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# The importers phase: config #4 imported from ONNX bytes and fused onto
# rows 1-2, OnnxRunner over the same bytes, and the 16 zoo models on the
# card against the CPU (:func:`importers_phase`)

IMP_WARM, IMP_CALLS = 1, 5        # (a): output calls, warm-up then timed
IMP_CPU_ROWS = 4                  # (a): rows of the batch the CPU recomputes
ZOO_B, ZOO_CHARS_T = 2, 50        # (d): the batch; TextGenerationLSTM's length


def _onnx_recipes():
    """``tests/torch_onnx_cases.py`` (jax-free: the port's ONNX writer)."""
    _graph_recipes()   # puts tests/ on sys.path
    import torch_onnx_cases

    return torch_onnx_cases


def _imp_config4_part(C, O):
    """(a) config #4 written as ONNX bytes and imported on the card: the
    import's seconds, ``output`` unfused then fused (12 sites; at T = 128
    the fused op takes the einsum, so rows 1-5 launch 0 times), tokens/s
    and peak memory over IMP_CALLS timed calls; the fused output against
    the unfused (1e-6 of its largest |value|: the einsum route is the
    chain's arithmetic), against ``build_bert_encoder``'s API-built graph
    at the same weights on the card and against the port's CPU import of
    the same bytes on the batch's first IMP_CPU_ROWS rows (each 1e-4 of
    the largest |value|: layernorm's Pow/Sqrt/Div against the API graph's
    rsqrt, and the card's GEMMs against the host's). Returns (bytes, ids,
    the unfused output, results)."""
    import torch

    from deeplearning4j_tpu_torch.modelimport.onnx import OnnxFrameworkImporter

    cfg = C.BERT_BASE
    t0 = time.perf_counter()
    data = O.bert_onnx_bytes(**cfg)
    write_s = time.perf_counter() - t0
    ids = C.mlm_batch(cfg["V"], SD_B, cfg["T"])["ids"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = OnnxFrameworkImporter.runImport(data, device=DEVICE)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    feed = {"ids": ids}
    unfused = sd.output(feed, O.OUTPUT)[O.OUTPUT].torch
    fused_sites = sd.fuseAttention()
    check(fused_sites == 12, f"importers (a): fuseAttention fused {fused_sites}, expected 12")
    for _ in range(IMP_WARM):
        sd.output(feed, O.OUTPUT)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(IMP_CALLS):
        out = sd.output(feed, O.OUTPUT)[O.OUTPUT].torch
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _sd_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    tok_s = ids.size * IMP_CALLS / wall
    check(tuple(out.shape) == (SD_B, cfg["T"], cfg["H"]) and bool(torch.isfinite(out).all()),
          f"importers (a): output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    check(not any(launches.values()), f"importers (a): T = 128 launched {launches}")
    errs = {"fused_vs_unfused": _sd_within(out, unfused, 1e-6 * unfused.abs().max().item(),
                                           "importers (a): fused against unfused")}
    del sd
    api, _, api_out = C.build_bert_encoder(**cfg, device=DEVICE)
    want = api.output({"ids": ids}, api_out)[api_out].torch
    errs["api_graph"] = _sd_within(out, want, 1e-4 * want.abs().max().item(),
                                   "importers (a): the ONNX import against the API-built graph")
    del api, want
    host = OnnxFrameworkImporter.runImport(data, device="cpu")
    t0 = time.perf_counter()
    want = host.output({"ids": ids[:IMP_CPU_ROWS]}, O.OUTPUT)[O.OUTPUT].torch
    cpu_s = time.perf_counter() - t0
    errs["cpu"] = _sd_within(out[:IMP_CPU_ROWS].cpu(), want, 1e-4 * want.abs().max().item(),
                             "importers (a): the card against the CPU")
    del host, want
    res = {"bytes": len(data), "write_s": write_s, "import_s": import_s,
           "fused_sites": fused_sites, "tokens_per_sec": tok_s,
           "output_ms": wall / IMP_CALLS * 1e3, "peak_gb": peak, "launches": launches,
           "max_abs_err": errs, "cpu_rows_s": cpu_s}
    log(f"importers (a) config #4 from {len(data) / 1e6:.1f} MB of ONNX bytes ({CARD}): "
        f"written in {write_s:.2f} s, imported in {import_s:.2f} s, {fused_sites} sites fused; "
        f"output {tok_s:.1f} tokens/s ({wall / IMP_CALLS * 1e3:.3f} ms a call, B={SD_B}, "
        f"T={cfg['T']}), peak {peak:.2f} GB, rows 1-5 {launches}; max |err|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return data, ids, unfused, res


def _imp_route_part(C, O):
    """(b) the same ONNX graph written at T = 1024 and imported on the card,
    12 layers, B = 4, its constants made trainable and the MLM head of
    :func:`_sd_graph`: through :func:`_sd_route_part`, unfused then after
    ``fuseAttention`` — row 1 exactly 12 launches an ``output``, rows 1
    and 2 exactly 12 a fit step, fused against unfused (output, loss,
    gradients) by the samediff phase's (b) rule; fp32 and bf16."""
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.modelimport.onnx import OnnxFrameworkImporter
    from deeplearning4j_tpu_torch.train import Adam

    L, T, B = 12, SD_LONG_T, SD_LONG_B
    cfg = dict(C.BERT_BASE, L=L, T=T)
    data = O.bert_onnx_bytes(**cfg)

    def make(compute):
        sd = OnnxFrameworkImporter.runImport(data, device=DEVICE)
        n = sd.convertAllConstantsToVariables()
        check(n == 4 + 12 * L, f"importers (b): {n} constants made trainable, expected "
              f"{4 + 12 * L}")
        loss = C.add_mlm_head(sd, O.OUTPUT, cfg["H"], cfg["V"], B, T)
        sd.setTrainingConfig(TrainingConfig(updater=Adam(1e-4), computeDtype=compute))
        return sd, O.OUTPUT, loss

    return _sd_route_part(C, L, T, B, ("mha_attention_packed",), ("mha_packed_backward",),
                          "b", make=make, phase="importers")


def _imp_runner_part(data, ids, unfused):
    """(c) ``OnnxRunner`` over (a)'s bytes on the card: its names, and its
    ``run`` bit-equal to (a)'s unfused ``output`` (the same graph, the same
    kernels, one card)."""
    import torch

    from deeplearning4j_tpu_torch.interop import OnnxRunner

    t0 = time.perf_counter()
    runner = OnnxRunner(data, device=DEVICE)
    got = runner.run({"ids": ids})
    wall = time.perf_counter() - t0
    check(runner.input_names == ["ids"] and runner.output_names == ["encoder_out"],
          f"importers (c): names {runner.input_names} -> {runner.output_names}")
    got = torch.from_numpy(got["encoder_out"])
    want = unfused.cpu()
    err = max_err(got, want)
    check(torch.equal(got, want), f"importers (c): OnnxRunner against (a)'s output "
          f"max |err| {err:.3e}")
    log(f"importers (c) OnnxRunner ({CARD}): built and run in {wall:.2f} s, bit-equal to "
        f"(a)'s output")
    return {"bit_equal": True, "max_abs_err": err, "wall_s": wall}


def _imp_zoo_part():
    """(d) each of the 16 zoo architectures, ``init()`` on the card at its
    own default input shape, one ``output`` at B = ZOO_B, held against the
    port's CPU network carrying the card's parameters and state (no
    second init): the same shape, finite, within 1e-4 of the CPU's
    largest |value| (fp32, TF32 off)."""
    import torch

    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.updaters import tree_map

    rng = np.random.default_rng(5)
    res = {}
    for name in zoo.__all__[1:]:
        t0 = time.perf_counter()
        m = getattr(zoo, name)()
        net = m.init(device=DEVICE)
        graph = isinstance(net, ComputationGraph)
        shape = (ZOO_B, ZOO_CHARS_T, m.numClasses) \
            if name == "TextGenerationLSTM" else (ZOO_B, *m.inputShape)
        x = rng.normal(size=shape).astype(np.float32)
        card = (net.outputSingle(x) if graph else net.output(x)).torch
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        host = (ComputationGraph if graph else MultiLayerNetwork)(net.conf, device="cpu")
        host.setParamTrees(tree_map(lambda t: t.cpu().numpy(), net._params),
                           tree_map(lambda t: t.cpu().numpy(), net._state))
        t1 = time.perf_counter()
        want = (host.outputSingle(x) if graph else host.output(x)).torch
        cpu_s = time.perf_counter() - t1
        err = max_err(card.cpu(), want)
        bound = 1e-4 * want.abs().max().item()
        check(card.shape == want.shape and bool(torch.isfinite(card).all()),
              f"importers (d) {name}: card {tuple(card.shape)} against CPU {tuple(want.shape)}")
        check(err <= bound, f"importers (d) {name}: card vs CPU max |err| {err:.3e} > "
              f"{bound:.3e}")
        res[name] = {"input": list(shape), "output": list(card.shape),
                     "params": net.numParams(), "max_abs_err": err,
                     "share_of_bound": err / bound if bound else 0.0,
                     "card_s": card_s, "cpu_s": cpu_s}
        del net, host, card, want
        torch.cuda.empty_cache()
    worst = max(res, key=lambda k: res[k]["share_of_bound"])
    log(f"importers (d) the zoo ({CARD}): {len(res)} architectures at their default "
        f"shapes, B={ZOO_B}, card against CPU; worst {worst} "
        f"{res[worst]['max_abs_err']:.3e} ({res[worst]['share_of_bound']:.3f} of 1e-4 "
        f"of max|CPU|)")
    return res


def importers_phase():
    """The ONNX importer, ``OnnxRunner`` and the zoo on the card (the
    module docstring's importers phase): (a) config #4 imported from ONNX
    bytes, (b) the same graph at T = 1024 on rows 1-2, (c) ``OnnxRunner``,
    (d) the 16 zoo models against the CPU. The card has no ``h5py``, so
    the Keras importer is held to the JAX package on the CPU only. Every
    part's failure fails the phase."""
    import torch

    C, O = _sd_recipes(), _onnx_recipes()
    out = {"card": CARD}
    marks = [time.perf_counter()]
    data, ids, unfused, out["config4"] = _imp_config4_part(C, O)
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    out["packed"] = _imp_route_part(C, O)
    marks.append(time.perf_counter())
    out["runner"] = _imp_runner_part(data, ids, unfused)
    del data, unfused
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    out["zoo"] = _imp_zoo_part()
    marks.append(time.perf_counter())
    out["part_s"] = dict(zip("abcd", np.diff(marks).tolist()))
    log(f"importers ({CARD}): parts' seconds " + json.dumps(out["part_s"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/importers_phase.json", "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


# ------------------------------------------------------- embeddings and rl
# text/, graph/, rl/ and arbiter/ on the card (:func:`embeddings_rl_phase`);
# the recipes are tests/torch_embedding_cases.py's

# text8's 17M tokens cut to 1M: the pairs are built on the host each epoch
EMB_TOKENS = 1_000_000
# word2vec.c's defaults (window 5, 5 negatives, sample 1e-3, min-count 5,
# alpha 0.025 skip-gram / 0.05 CBOW) at GoogleNews-vectors-negative300's
# width; the reference's batch of 512
W2V_CONF = dict(layerSize=300, windowSize=5, negativeSample=5, sampling=1e-3,
                batchSize=512, epochs=1, seed=1)
W2V_LR = {"SkipGram": 0.025, "CBOW": 0.05}
# Perozzi et al.: d 128, window 10, walk length 40; walks per vertex cut
# from 80 to 1 for the phase's time
DW_CONF = dict(vectorSize=128, windowSize=10, walkLength=40, walksPerVertex=1,
               seed=3)
DW_CUT = (1000, 32_400)          # the CPU's copy: BlogCatalog's mean degree
# GloVe paper: d 300, x_max 100, alpha 0.75, window 10; the glove demo's
# vocab min count 5; 2 iterations of its 15+ (the phase's time); the corpus
# cut to what the host's co-occurrence pass does in seconds
GLOVE_CONF = dict(layerSize=300, xMax=100.0, alpha=0.75, windowSize=10,
                  minWordFrequency=5, iterations=2, learningRate=0.05, seed=4)
GLOVE_SENTENCES, GLOVE_CUT_SENTENCES = 40, 8
# fastText's defaults: dim 100, bucket 2M, n-grams 3-6, window 5, 5
# negatives, lr 0.05, t 1e-4, min count 5; one epoch of its 5
FT_CONF = dict(layerSize=100, bucket=2_000_000, minn=3, maxn=6, windowSize=5,
               negativeSample=5, learningRate=0.05, sampling=1e-4, epochs=1,
               seed=5)
FT_CUT_SENTENCES = 20    # the CPU's copy: 20k tokens of the cut, bucket 2M
PV_CONF = dict(layerSize=300, windowSize=5, negativeSample=5, epochs=5,
               learningRate=0.025, minWordFrequency=1, seed=6)
# Card against CPU, a table's largest difference over its largest |CPU
# value|: both run the same gathers, the same scatters in the same order
# (the CUDA scatter adds a row's contributions in their order, as the CPU
# does); they differ in the summation order of the D-term dots and the
# sigmoid's last bit. The same differences between the port and the JAX
# package on the CPU (tests/test_torch_text.py) reach 2.3e-6 over up to
# 3 epochs, and card against CPU here 1.2e-6 (the H100): held to 1e-5.
CARD_CPU_TOL = 1e-5
# a nearest list may swap two neighbours whose CPU cosines differ by less
NEAREST_TIE = 1e-4
# rl4j-examples' Cartpole QLConfiguration (seed 123, maxEpochStep 200,
# replay 150000, batch 32, hard target update 500, 10 warm-up steps,
# gamma 0.99, TD clamp 1.0, min epsilon 0.1 over 1000 steps, double DQN)
# without its reward scaling, maxStep cut from 150000
DQN_CONF = dict(seed=123, maxEpochStep=200, expRepMaxSize=150_000, batchSize=32,
                targetDqnUpdateFreq=500, updateStart=10, gamma=0.99,
                errorClamp=1.0, minEpsilon=0.1, epsilonNbStep=1000,
                doubleDQN=True)
DQN_MAX_STEP = 5_000
EMB_PROFILE_SENTENCES = 10   # a profiled fit of ~120 steps
# after rl4j-examples' async CartPole learners: 16 workers (here
# lockstep envs), nStep 5, gamma 0.99; maxStep cut
NSTEP_CONF = dict(seed=123, gamma=0.99, nStep=5, numEnvs=16,
                  targetDqnUpdateFreq=100, minEpsilon=0.1, epsilonNbStep=9000,
                  maxEpochStep=200, errorClamp=100.0, maxStep=16 * 5 * 100)
A2C_CONF = dict(seed=123, gamma=0.99, nStep=5, numEnvs=16, maxEpochStep=200,
                maxStep=16 * 5 * 100)
# Card against CPU after 20 updates (5 for the vector learners) of one
# network from the same parameters on the same batches: each loss and
# the Q-values within 1e-4 of their size; the parameters within 1e-3 of
# their norm (Adam moves a weight whose gradient sits at rounding level by
# +-lr either way: one such weight of these 16-wide nets is ~1e-4 of it)
RL_LOSS_TOL, RL_PARAM_TOL = 1e-4, 1e-3
ARBITER_TOL = 1e-4       # a candidate's test loss, relative


_EMB_T0 = [0.0]


def _tick(label):
    """Log the seconds since the embeddings phase began."""
    log(f"  [{time.perf_counter() - _EMB_T0[0]:.1f} s] {label}")


@contextlib.contextmanager
def _counting():
    """Every fit's steps (``word2vec.StepRunner`` runs them all) counted:
    calls, batch rows, and the time of the first call."""
    import deeplearning4j_tpu_torch.text.word2vec as w2v

    call = w2v.StepRunner.__call__
    st = {"steps": 0, "rows": 0, "t0": None}

    def wrapped(self, batch, lr):
        if st["t0"] is None:
            st["t0"] = time.perf_counter()
        st["steps"] += 1
        st["rows"] += len(batch)
        return call(self, batch, lr)

    w2v.StepRunner.__call__ = wrapped
    try:
        yield st
    finally:
        w2v.StepRunner.__call__ = call


def _emb_fit(fit, device, label):
    """Run ``fit()``; (its result, the fit's stats): wall seconds, steps,
    rows (pairs), the loop's wall from the first step to the tables back
    on the host, rows/s, and on the card the peak memory; logged under
    ``label``."""
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _counting() as st:
        out = fit()
    _sync()
    t1 = time.perf_counter()
    loop = t1 - (st["t0"] or t1)
    stats = {"fit_s": t1 - t0, "steps": st["steps"], "pairs": st["rows"],
             "loop_s": loop, "pairs_per_s": st["rows"] / max(loop, 1e-9)}
    stats["peak_bytes"] = (torch.cuda.max_memory_allocated() if device == "cuda"
                           else None)
    log(f"  {label} on {device}: " + json.dumps(stats))
    return out, stats


def _vs_cpu(card, cpu, label, tol=CARD_CPU_TOL):
    """The largest |card - cpu| over the largest |cpu|, checked <= tol."""
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    check(card.shape == cpu.shape, f"{label}: shapes {card.shape} {cpu.shape}")
    rel = float(np.abs(card - cpu).max() / max(np.abs(cpu).max(), 1e-30))
    check(rel <= tol, f"{label}: card against CPU {rel:.3e} of max|CPU| "
          f"(allowed {tol:g})")
    return rel


def _same_nearest(card_list, cpu_list, cpu_sim, label):
    """Two nearest lists equal, but where the CPU's cosines of the two
    neighbours at a position differ by less than NEAREST_TIE; returns the
    positions that swapped."""
    swaps = 0
    check(len(card_list) == len(cpu_list), f"{label}: lengths")
    for a, b in zip(card_list, cpu_list):
        if a != b:
            swaps += 1
            gap = abs(cpu_sim(a) - cpu_sim(b))
            check(gap <= NEAREST_TIE, f"{label}: {a!r} against {b!r}, CPU "
                  f"cosines {gap:.2e} apart (a tie is < {NEAREST_TIE:g})")
    return swaps


def _topic_hits(model, topics, k):
    """Planted groups whose first word has its k nearest words all in its
    group. (Every vector of a one-epoch fit shares one strong direction,
    cosines ~0.999 between most words: the groups show in the order of the
    nearest, not as well-separated clusters.)"""
    return sum(set(model.wordsNearest(g[0], k)) <= set(g[1:]) for g in topics)


def _w2v_part(sents, words, topics):
    """(a) Word2Vec skip-gram and CBOW (see :func:`embeddings_rl_phase`)."""
    import torch

    import torch_embedding_cases as E
    import deeplearning4j_tpu_torch.text.word2vec as w2v
    from deeplearning4j_tpu_torch.text import CollectionSentenceIterator, Word2Vec

    def fit(algo, sentences, device, min_count):
        kw = dict(W2V_CONF, learningRate=W2V_LR[algo], minWordFrequency=min_count,
                  elementsLearningAlgorithm=algo)
        model = Word2Vec(iterate=CollectionSentenceIterator(sentences),
                         device=device, **kw)
        return _emb_fit(model.fit, device,
                        f"embeddings (a) {algo} {len(sentences)} sentences")

    out = {}
    sg, out["skipgram"] = fit("SkipGram", sents, DEVICE, E.MIN_COUNT)
    V, D = sg.syn0.shape
    check(V == E.TEXT8_VOCAB and D == 300, f"embeddings (a): table {V}x{D}")
    out["table_bytes"] = 2 * V * D * 4
    hits = out["skipgram_topic_hits"] = _topic_hits(sg, topics, 3)
    out["skipgram_topic_hits_top7"] = _topic_hits(sg, topics, 7)
    check(hits >= 14, f"embeddings (a): {hits} of {len(topics)} planted groups "
          f"nearest each other (skip-gram, top 3; want >= 14)")
    cb, out["cbow"] = fit("CBOW", sents, DEVICE, E.MIN_COUNT)
    hits = out["cbow_topic_hits"] = _topic_hits(cb, topics, 3)
    out["cbow_topic_hits_top7"] = _topic_hits(cb, topics, 7)
    check(hits >= 14, f"embeddings (a): {hits} of {len(topics)} planted groups "
          f"nearest each other (CBOW, top 3; want >= 14)")
    del cb
    _tick("embeddings (a) full fits and planted groups")
    # one step's device time at the fit's shapes, eager (as the fit runs)
    gen = torch.Generator().manual_seed(0)
    s0 = torch.from_numpy(sg.syn0).to(DEVICE)
    s1 = torch.from_numpy(sg._syn1).to(DEVICE)
    idx = torch.randint(0, V, (512, 7), generator=gen).to(DEVICE)
    def step():
        w2v._sg_step(s0, s1, idx[:, 0], idx[:, 1], idx[:, 2:], 1e-4)

    # device time of one step's kernels (replayed from a graph, as the fit
    # runs them), and of one eager step launched from the host
    out["sg_step_ms"] = time_ms(step, iters=20, reps=5, graph=True)
    out["sg_step_eager_ms"] = time_ms(step, iters=50, reps=3, graph=False)
    del s0, s1
    # card against CPU on the cut corpus: the full vocabulary, ~72k tokens
    cut = E.text8_cut(words)
    for algo in ("SkipGram", "CBOW"):
        card, st = fit(algo, cut, DEVICE, 1)
        again, _ = fit(algo, cut, DEVICE, 1)
        check(np.array_equal(card.syn0, again.syn0)
              and np.array_equal(card._syn1, again._syn1),
              f"embeddings (a) {algo} cut: two card fits differ")
        # the same fit with every step launched eagerly (no graph captured)
        capture = w2v.StepRunner._capture
        w2v.StepRunner._capture = lambda self: None
        try:
            eager, _ = fit(algo, cut, DEVICE, 1)
        finally:
            w2v.StepRunner._capture = capture
        check(np.array_equal(card.syn0, eager.syn0)
              and np.array_equal(card._syn1, eager._syn1),
              f"embeddings (a) {algo} cut: the replayed fit differs from the eager fit")
        host, hst = fit(algo, cut, "cpu", 1)
        check(card.vocab.numWords() == E.TEXT8_VOCAB, "embeddings (a): cut vocabulary")
        res = {"card": st, "cpu": hst,
               "syn0_rel": _vs_cpu(card.syn0, host.syn0, f"embeddings (a) {algo} syn0"),
               "syn1_rel": _vs_cpu(card._syn1, host._syn1, f"embeddings (a) {algo} syn1"),
               "nearest_swaps": sum(
                   _same_nearest(card.wordsNearest(g[0], 10), host.wordsNearest(g[0], 10),
                                 lambda w, g=g: host.similarity(g[0], w),
                                 f"embeddings (a) {algo} nearest {g[0]}")
                   for g in topics)}
        out[f"cut_{algo}"] = res
        _tick(f"embeddings (a) {algo} card vs CPU")
    log(f"embeddings (a) Word2Vec ({CARD}): {V}x{D}, tables "
        f"{out['table_bytes']} B, skip-gram {out['skipgram']['pairs_per_s']:.0f} "
        f"pairs/s ({out['skipgram']['steps']} steps, fit {out['skipgram']['fit_s']:.2f} s, "
        f"peak {out['skipgram']['peak_bytes']} B), step {out['sg_step_ms']:.4f} ms "
        f"replayed, {out['sg_step_eager_ms']:.4f} ms eager, "
        f"CBOW {out['cbow']['pairs_per_s']:.0f} pairs/s; planted groups "
        f"{out['skipgram_topic_hits']}/{out['cbow_topic_hits']} of {len(topics)}; "
        f"card vs CPU (cut) skip-gram {out['cut_SkipGram']['syn0_rel']:.3e}, "
        f"CBOW {out['cut_CBOW']['syn0_rel']:.3e}; two fits of each bit-equal, and "
        f"equal to an eager fit")
    return out, sg


def _emb_profile(sents):
    """The device's busy share over one card fit on the cut corpus."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.text import CollectionSentenceIterator, Word2Vec

    model = Word2Vec(iterate=CollectionSentenceIterator(sents), device=DEVICE,
                     minWordFrequency=1, learningRate=W2V_LR["SkipGram"], **W2V_CONF)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = report_profile(prof, wall, "embeddings (a) skip-gram fit profile")
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall}


def _deepwalk_part():
    """(b) DeepWalk on a BlogCatalog-sized graph."""
    import torch_embedding_cases as E
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph

    def graph(n, edges):
        g = Graph(n)
        for a, b in edges.tolist():
            g.addEdge(a, b)
        return g

    def fit(g, device):
        return _emb_fit(lambda: DeepWalk(device=device, **DW_CONF).fit(g), device,
                        f"embeddings (b) DeepWalk {g.numVertices()} vertices")

    n, edges = E.blogcatalog_like()
    g = graph(n, edges)
    out = {"vertices": n, "edges": len(edges),
           "max_degree": max(g.getDegree(v) for v in range(g.numVertices())),
           "table_bytes": 2 * g.numVertices() * DW_CONF["vectorSize"] * 4}
    _tick("embeddings (b) graph built")
    gv, out["fit"] = fit(g, DEVICE)
    gv2, out["fit_again"] = fit(g, DEVICE)
    check(np.array_equal(gv.vectors, gv2.vectors),
          "embeddings (b): two DeepWalk fits from one seed differ on the card")
    check(np.isfinite(gv.vectors).all(), "embeddings (b): non-finite vectors")
    del g, gv, gv2
    cut = graph(*E.blogcatalog_like(*DW_CUT, seed=1))
    card, out["cut_card"] = fit(cut, DEVICE)
    host, out["cut_cpu"] = fit(cut, "cpu")
    out["cut_rel"] = _vs_cpu(card.vectors, host.vectors, "embeddings (b) cut vectors")
    out["nearest_swaps"] = sum(
        _same_nearest([int(u) for u in card.verticesNearest(v, 10)],
                      [int(u) for u in host.verticesNearest(v, 10)],
                      lambda u, v=v: host.similarity(v, u),
                      f"embeddings (b) nearest {v}") for v in range(10))
    log(f"embeddings (b) DeepWalk ({CARD}): {out['vertices']} vertices, "
        f"{out['edges']} edges (max degree {out['max_degree']}), d 128, "
        f"{out['fit']['pairs_per_s']:.0f} pairs/s ({out['fit']['steps']} steps, "
        f"fit {out['fit']['fit_s']:.2f} s, peak {out['fit']['peak_bytes']} B), "
        f"two fits bit-equal; card vs CPU (cut) {out['cut_rel']:.3e}")
    return out


def _glove_ft_pv_part(sents, words, topics, sg, tmp_dir):
    """(c) GloVe, FastText, ParagraphVectors and the serializer."""
    import torch_embedding_cases as E
    from deeplearning4j_tpu_torch.text import (
        CollectionSentenceIterator, FastText, Glove, ParagraphVectors,
        WordVectorSerializer)
    from deeplearning4j_tpu_torch.text.paragraph_vectors import LabelledDocument

    out = {}

    def glove(sentences, device):
        m = Glove(iterate=CollectionSentenceIterator(sentences), device=device,
                  **GLOVE_CONF)
        return _emb_fit(m.fit, device, f"embeddings (c) GloVe {len(sentences)} sentences")

    g, out["glove"] = glove(sents[:GLOVE_SENTENCES], DEVICE)
    V = g.vocab.numWords()
    out["glove"].update(vocab=V, table_bytes=4 * V * 300 * 4 + 4 * V * 4)
    check(np.isfinite(g.syn0).all(), "embeddings (c): GloVe vectors not finite")
    _tick("embeddings (c) GloVe")
    gc, _ = glove(sents[:GLOVE_CUT_SENTENCES], DEVICE)
    gh, _ = glove(sents[:GLOVE_CUT_SENTENCES], "cpu")
    out["glove_cut_rel"] = _vs_cpu(gc.syn0, gh.syn0, "embeddings (c) GloVe cut")
    del g, gc, gh

    def fasttext(sentences, device, min_count):
        m = FastText(iterate=CollectionSentenceIterator(sentences), device=device,
                     minWordFrequency=min_count, **FT_CONF)
        return _emb_fit(m.fit, device,
                        f"embeddings (c) FastText {len(sentences)} sentences")

    # the full vocabulary at min count 1 in ~72k tokens: the whole
    # (71,290 + 2M) x 100 input table on the card
    cut = E.text8_cut(words)
    _tick("embeddings (c) GloVe card vs CPU")
    ft, out["fasttext"] = fasttext(cut, DEVICE, 1)
    V = ft.vocab.numWords()
    check(V == E.TEXT8_VOCAB, f"embeddings (c): FastText vocabulary {V}")
    out["fasttext"]["table_bytes"] = (V + FT_CONF["bucket"]) * 100 * 4 + V * 100 * 4
    # one OOV word: a planted word with a letter doubled shares most of
    # its n-grams, and lands nearer its source than another group's word
    src, other = topics[0][0], topics[1][0]
    oov = src[:2] + src[2] + src[2:]
    check(not ft.hasWord(oov), f"embeddings (c): {oov!r} is in the vocabulary")
    vo = ft.getWordVector(oov)

    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    out["oov"] = {"word": oov, "cos_source": cos(vo, ft.getWordVector(src)),
                  "cos_other": cos(ft.getWordVector(other), ft.getWordVector(src))}
    check(np.isfinite(vo).all() and out["oov"]["cos_source"] > out["oov"]["cos_other"],
          f"embeddings (c): OOV vector {out['oov']}")
    del ft
    _tick("embeddings (c) FastText and the OOV word")
    fc, out["fasttext_cut_card"] = fasttext(cut[:FT_CUT_SENTENCES], DEVICE, 1)
    fh, out["fasttext_cut_cpu"] = fasttext(cut[:FT_CUT_SENTENCES], "cpu", 1)
    out["fasttext_cut_rel"] = _vs_cpu(fc._bucket_table, fh._bucket_table,
                                      "embeddings (c) FastText cut table")
    _vs_cpu(fc.getWordVector(oov), fh.getWordVector(oov), "embeddings (c) FastText OOV")
    del fc, fh
    _tick("embeddings (c) FastText card vs CPU")

    docs = E.documents(words, topics)

    def pv(device):
        m = ParagraphVectors(labelledDocuments=[LabelledDocument(*d) for d in docs],
                             device=device, **PV_CONF)
        return _emb_fit(m.fit, device, "embeddings (c) ParagraphVectors")

    pc, out["pv"] = pv(DEVICE)
    ph, _ = pv("cpu")
    probe = " ".join(topics[2][:6])
    out["pv_rel"] = _vs_cpu(pc.doc_vectors, ph.doc_vectors, "embeddings (c) doc vectors")
    out["pv_infer_rel"] = _vs_cpu(pc.inferVector(probe), ph.inferVector(probe),
                                  "embeddings (c) inferVector")

    # the serializer: (a)'s card vectors in Google's binary format, read
    # back on the CPU and written again, then read on the card and written
    # again: every vector bit-equal, the two rewrites byte-equal (a read
    # model's vocabulary is indexed anew, by count then word, as the
    # reference's is, so the first rewrite orders the words so)
    _tick("embeddings (c) ParagraphVectors")
    files = [os.path.join(tmp_dir, f"w2v{i}.bin") for i in range(3)]
    WordVectorSerializer.writeBinaryModel(sg, files[0])
    for dev, src_f, dst_f in (("cpu", files[0], files[1]), (DEVICE, files[1], files[2])):
        back = WordVectorSerializer.readBinaryModel(src_f, device=dev)
        check(np.array_equal(back.syn0[[back.vocab.indexOf(w) for w in sg.vocab.words()]],
                             sg.syn0), f"embeddings (c): binary read on {dev}")
        WordVectorSerializer.writeBinaryModel(back, dst_f)
    blobs = [open(f, "rb").read() for f in files]
    check(len(blobs[0]) == len(blobs[1]) and blobs[1] == blobs[2],
          "embeddings (c): binary round trip bytes")
    out["binary_bytes"] = len(blobs[0])
    _tick("embeddings (c) binary round trip")
    npz = os.path.join(tmp_dir, "pv.npz")
    WordVectorSerializer.writeParagraphVectors(pc, npz)
    back = WordVectorSerializer.readParagraphVectors(npz, device=DEVICE)
    check(np.array_equal(back.doc_vectors, pc.doc_vectors) and back.doc_labels == pc.doc_labels,
          "embeddings (c): ParagraphVectors npz round trip")
    _tick("embeddings (c) npz round trip")
    log(f"embeddings (c) ({CARD}): GloVe {out['glove']['vocab']} words "
        f"{out['glove']['pairs_per_s']:.0f} triples/s, card vs CPU (cut) "
        f"{out['glove_cut_rel']:.3e}; FastText ({E.TEXT8_VOCAB} + 2M) x 100, "
        f"tables {out['fasttext']['table_bytes']} B, "
        f"{out['fasttext']['pairs_per_s']:.0f} pairs/s, peak "
        f"{out['fasttext']['peak_bytes']} B, OOV {out['oov']}, card vs CPU (cut) "
        f"{out['fasttext_cut_rel']:.3e}; ParagraphVectors {len(docs)} docs "
        f"{out['pv']['pairs_per_s']:.0f} pairs/s, card vs CPU {out['pv_rel']:.3e}, "
        f"inferVector {out['pv_infer_rel']:.3e}; binary {out['binary_bytes']} B "
        f"round trip byte-equal")
    return out


def _rl_params(tree):
    """A parameter tree's leaves as one float64 host vector."""
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves

    return np.concatenate([l.detach().double().cpu().numpy().ravel()
                           for l in tree_leaves(tree)])


def _rl_compare(card_fn, host_fn, batches, label):
    """Run ``card_fn(batch)`` and ``host_fn(batch)`` (each an update,
    returning (loss, params tree)) over the same batches: the largest
    relative loss difference, and the parameters' relative norm
    difference at the end; both checked."""
    worst = 0.0
    for b in batches:
        lc, pc = card_fn(b)
        lh, ph = host_fn(b)
        worst = max(worst, abs(float(lc) - float(lh)) / max(abs(float(lh)), 1e-30))
    a, h = _rl_params(pc), _rl_params(ph)
    norm = float(np.linalg.norm(a - h) / np.linalg.norm(h))
    check(worst <= RL_LOSS_TOL and norm <= RL_PARAM_TOL,
          f"{label}: card vs CPU over {len(batches)} updates: loss {worst:.3e} "
          f"(allowed {RL_LOSS_TOL:g}), params {norm:.3e} of their norm "
          f"(allowed {RL_PARAM_TOL:g})")
    return {"loss_rel": worst, "param_rel_norm": norm}


def _rl_part():
    """(d) rl4j's learners on CartPole."""
    import torch

    import torch_embedding_cases as E
    import deeplearning4j_tpu_torch.rl as rl
    from deeplearning4j_tpu_torch.rl.qlearning import clone_tree, to_device
    from deeplearning4j_tpu_torch.train.updaters import tree_map

    out = {}
    # DQN at the example's configuration, maxStep cut
    cfg = rl.QLearningConfiguration(maxStep=DQN_MAX_STEP, **DQN_CONF)
    _tick("rl (d) start")
    dqn = rl.QLearningDiscreteDense(rl.CartPole(seed=123, max_steps=200),
                                    E.cartpole_dqn_conf(), cfg, device=DEVICE)
    _tick("rl (d) DQN built")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rewards = dqn.train()
    wall = time.perf_counter() - t0
    first, last = float(np.mean(rewards[:10])), float(np.mean(rewards[-10:]))
    batch = dqn.replay.sample(32)
    out["dqn"] = {"episodes": len(rewards), "first10": first, "last10": last,
                  "env_steps_per_s": DQN_MAX_STEP / wall, "wall_s": wall,
                  "peak_bytes": torch.cuda.max_memory_allocated(),
                  "param_bytes": int(_rl_params(dqn._params).size * 4),
                  "update_ms": time_ms(lambda: dqn._update(batch), iters=20, reps=3,
                                       graph=False)}
    check(last > first, f"rl (d): DQN's last 10 episodes {last:.1f} <= its first "
          f"10 {first:.1f}")
    # card against CPU: 20 updates from the same parameters on the same
    # replay batches
    host, card = (rl.QLearningDiscreteDense(rl.CartPole(seed=123), E.cartpole_dqn_conf(),
                                            rl.QLearningConfiguration(**DQN_CONF), device=d)
                  for d in ("cpu", DEVICE))
    card._params = tree_map(lambda t: t.to(DEVICE), host._params)
    card._target, card._opt_state = clone_tree(card._params), card._tx.init(card._params)
    batches = [dqn.replay.sample(32) for _ in range(20)]

    def update(m):
        def run(b):
            loss = m._update(b)
            return loss, m._params
        return run

    _tick("rl (d) DQN run")
    out["dqn_vs_cpu"] = _rl_compare(update(card), update(host), batches, "rl (d) DQN")
    obs = batches[0][0]
    qc = card._q_fn(card._params, torch.from_numpy(obs).to(DEVICE)).cpu().numpy()
    qh = host._q_fn(host._params, torch.from_numpy(obs)).detach().numpy()
    out["dqn_q_rel"] = _vs_cpu(qc, qh, "rl (d) DQN Q-values", tol=RL_LOSS_TOL)
    del dqn, host, card

    def venv():
        return rl.VectorizedMDP([lambda i=i: rl.CartPole(seed=123 + i, max_steps=200)
                                 for i in range(16)])

    nq = rl.AsyncNStepQLearningDiscreteDense(
        venv(), E.cartpole_dqn_conf(l2=0.0), rl.AsyncQLearningConfiguration(**NSTEP_CONF),
        device=DEVICE)
    pi, v = E.cartpole_a2c_confs()
    a2 = rl.A2CDiscreteDense(venv(), pi, v, rl.A2CConfiguration(**A2C_CONF),
                             device=DEVICE)
    for key, learner in (("nstep_q", nq), ("a2c", a2)):
        t0 = time.perf_counter()
        r = learner.train()
        wall = time.perf_counter() - t0
        out[key] = {"episodes": len(r), "first10": float(np.mean(r[:10])),
                    "last10": float(np.mean(r[-10:])), "wall_s": wall,
                    "env_steps_per_s": learner.config.maxStep / wall}
        check(len(r) > 10 and np.isfinite(r).all(), f"rl (d) {key}: {len(r)} episodes")
    _tick("rl (d) DQN card vs CPU, vector learners' runs")
    # their updates on the card against the CPU from the same parameters
    rng = np.random.RandomState(0)
    ups = [(rng.randn(80, 4).astype(np.float32) * 0.1, rng.randint(2, size=80).astype(np.int32),
            rng.randn(80).astype(np.float32) * 3) for _ in range(5)]
    hq = rl.AsyncNStepQLearningDiscreteDense(
        venv(), E.cartpole_dqn_conf(l2=0.0), rl.AsyncQLearningConfiguration(**NSTEP_CONF),
        device="cpu")
    cq = rl.AsyncNStepQLearningDiscreteDense(
        venv(), E.cartpole_dqn_conf(l2=0.0), rl.AsyncQLearningConfiguration(**NSTEP_CONF),
        device=DEVICE)
    cq._params = tree_map(lambda t: t.to(DEVICE), hq._params)
    cq._opt_state = cq._tx.init(cq._params)

    def nq_update(m):
        def run(b):
            m._params, m._opt_state, loss = m._update_fn(
                m._params, m._opt_state, *to_device(m.device, *b))
            return loss, m._params
        return run

    out["nstep_q_vs_cpu"] = _rl_compare(nq_update(cq), nq_update(hq), ups, "rl (d) n-step Q")
    ha = rl.A2CDiscreteDense(venv(), pi, v, rl.A2CConfiguration(**A2C_CONF), device="cpu")
    ca = rl.A2CDiscreteDense(venv(), pi, v, rl.A2CConfiguration(**A2C_CONF), device=DEVICE)
    ca._pi = tree_map(lambda t: t.to(DEVICE), ha._pi)
    ca._v = tree_map(lambda t: t.to(DEVICE), ha._v)
    ca._opt = ca._tx.init({"pi": ca._pi, "v": ca._v})

    def a2c_update(m):
        def run(b):
            loss = m._update(*b)
            return loss, {"pi": m._pi, "v": m._v}
        return run

    out["a2c_vs_cpu"] = _rl_compare(a2c_update(ca), a2c_update(ha), ups, "rl (d) A2C")
    log(f"rl (d) ({CARD}): DQN {out['dqn']['episodes']} episodes in {DQN_MAX_STEP} "
        f"steps, first 10 {first:.1f} -> last 10 {last:.1f}, "
        f"{out['dqn']['env_steps_per_s']:.1f} env steps/s, update "
        f"{out['dqn']['update_ms']:.3f} ms, parameters {out['dqn']['param_bytes']} B, "
        f"peak {out['dqn']['peak_bytes']} B; "
        f"card vs CPU {out['dqn_vs_cpu']}; n-step Q {out['nstep_q']['env_steps_per_s']:.1f}"
        f" and A2C {out['a2c']['env_steps_per_s']:.1f} env steps/s (16 envs); "
        f"{out['nstep_q_vs_cpu']}, {out['a2c_vs_cpu']}")
    return out


def _arbiter_part():
    """(e) a random search on the card against the same search on the CPU."""
    import torch

    import torch_embedding_cases as E
    from deeplearning4j_tpu_torch.arbiter import (
        ContinuousParameterSpace, IntegerParameterSpace, MaxCandidatesCondition,
        OptimizationConfiguration, OptimizationRunner, RandomSearchGenerator)
    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

    train = list(MnistDataSetIterator(256, train=True, num_examples=2560))
    test = next(iter(MnistDataSetIterator(1000, train=False, num_examples=1000)))

    def search(device):
        def build(hp):
            return MultiLayerNetwork(E.mnist_mlp_conf(hp["lr"], hp["hidden"]),
                                     device=device).init()

        def score(model, hp):
            for ds in train:
                model.fit(ds)
            return model.score(test)

        runner = OptimizationRunner(OptimizationConfiguration(
            candidate_generator=RandomSearchGenerator(
                {"lr": ContinuousParameterSpace(1e-4, 1e-2, log_uniform=True),
                 "hidden": IntegerParameterSpace(64, 1024)}, seed=7),
            model_builder=build, score_function=score,
            termination_conditions=[MaxCandidatesCondition(4)]))
        t0 = time.perf_counter()
        best = runner.execute()
        return best, runner.results, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    best, res, wall = search(DEVICE)
    peak = torch.cuda.max_memory_allocated()
    hbest, hres, hwall = search("cpu")
    check(len(res) == 4 and all(r.score is not None for r in res),
          f"arbiter (e): {[r.exception for r in res]}")
    rel = max(abs(a.score - b.score) / abs(b.score) for a, b in zip(res, hres))
    check(rel <= ARBITER_TOL and best.candidate.index == hbest.candidate.index,
          f"arbiter (e): card vs CPU scores {rel:.3e} (allowed {ARBITER_TOL:g}), best "
          f"{best.candidate.index} against {hbest.candidate.index}")
    param_bytes = max(4 * (784 * r.candidate.hyperparameters["hidden"]
                           + r.candidate.hyperparameters["hidden"] * 11 + 10)
                      for r in res)
    out = {"candidates": [{"hp": r.candidate.hyperparameters, "score": r.score,
                           "s": r.duration_sec} for r in res],
           "best": best.candidate.index, "score_rel": rel, "wall_s": wall,
           "cpu_wall_s": hwall, "peak_bytes": peak, "max_param_bytes": param_bytes,
           "images_per_s": 4 * len(train) * 256 / wall}
    log(f"arbiter (e) ({CARD}): 4 candidates in {wall:.2f} s (CPU {hwall:.2f} s), "
        f"{out['images_per_s']:.0f} training images/s, peak {peak} B, the largest "
        f"candidate's parameters {param_bytes} B, "
        f"best {best.candidate.index} {best.candidate.hyperparameters}, card vs CPU "
        f"scores {rel:.3e}")
    return out


def embeddings_rl_phase():
    """``text/``, ``graph/``, ``rl/`` and ``arbiter/`` on the card (the
    module docstring's embeddings and rl phase). Every part's failure
    fails the phase."""
    import tempfile

    import torch

    _graph_recipes()   # puts tests/ on sys.path
    import torch_embedding_cases as E

    reduced = {
        "word2vec corpus": f"text8's 17M tokens -> {EMB_TOKENS} (pairs are built "
                           "on the host each epoch, as in the reference)",
        "word2vec card vs CPU": "the full vocabulary once each + 4 phrases a "
                                "planted group, ~72k tokens (the CPU's fit time)",
        "deepwalk walks per vertex": "80 -> 1 (the phase's time); card vs CPU on a "
                                     "1,000-vertex copy",
        "glove": f"corpus -> {GLOVE_SENTENCES}k tokens (the host's co-occurrence "
                 f"pass), iterations -> 2; card vs CPU on {GLOVE_CUT_SENTENCES}k",
        "fasttext": "epochs 5 -> 1, on the ~72k-token cut (the full vocabulary "
                    "at min count 1); card vs CPU on 20k tokens of it",
        "dqn maxStep": f"150000 -> {DQN_MAX_STEP} (the phase's time)",
        "n-step Q / A2C maxStep": f"-> {A2C_CONF['maxStep']}"}
    for what, why in reduced.items():
        log(f"reduced: {what}: {why}")
    out = {"card": CARD, "reduced": reduced}
    marks = [time.perf_counter()]
    _EMB_T0[0] = marks[0]
    sents, words, topics = E.text8_like(EMB_TOKENS)
    out["w2v"], sg = _w2v_part(sents, words, topics)
    out["profile"] = _emb_profile(E.text8_cut(words)[:EMB_PROFILE_SENTENCES])
    _tick("embeddings (a) profile")
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    out["deepwalk"] = _deepwalk_part()
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    with tempfile.TemporaryDirectory() as d:
        out["glove_fasttext_pv"] = _glove_ft_pv_part(sents, words, topics, sg, d)
    del sg
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    out["rl"] = _rl_part()
    marks.append(time.perf_counter())
    out["arbiter"] = _arbiter_part()
    marks.append(time.perf_counter())
    out["part_s"] = dict(zip("abcde", np.diff(marks).tolist()))
    log(f"embeddings and rl ({CARD}): parts' seconds " + json.dumps(out["part_s"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/embeddings_rl_phase.json", "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


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
    if "--serve-host" in sys.argv:
        return serve_host(sys.argv)
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
    packed_rows, paged_rows = timed_phase("kernels",
                                          kernel_checks(kernel_phase))
    train_rows = timed_phase("train kernels",
                             kernel_checks(train_kernel_phase))
    timed_phase("kernel chain", kernel_checks(chain_phase))
    timed_phase("head dims", kernel_checks(head_dim_phase))
    update_rows = timed_phase("loss and update kernels",
                              kernel_checks(loss_update_kernel_phase))
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
    timed_phase("kv lifecycle fp32", kv_lifecycle_phase, cfg)
    timed_phase("shared prefix", shared_prefix_phase, cfg, params)
    timed_phase("occupancy", occupancy_phase, cfg, params)
    timed_phase("contiguous", contiguous_phase, cfg, params, prompts)
    timed_phase("speculative fp32", speculative_fp32_phase, cfg, prompts)
    spec = timed_phase("speculative", speculative_phase, cfg, params,
                       prompts, engine["float32"]["streams"])
    resil = timed_phase("resilience and qos", resilience_qos_phase, cfg,
                        params, prompts, engine["float32"]["streams"],
                        engine["float32"]["decode_tokens_per_sec"])
    front = timed_phase("front door", front_door_phase, cfg, params,
                        prompts, engine["float32"]["streams"],
                        engine["float32"]["decode_tokens_per_sec"])
    dis = timed_phase("disagg", disagg_phase, cfg, params, prompts, engine,
                      front)
    mserve = timed_phase("mesh serving", mesh_serving_phase, cfg, params,
                         prompts, engine)
    ops_run = timed_phase("ops", kernel_checks(ops_phase))
    del params
    torch.cuda.empty_cache()
    nets = timed_phase("networks", networks_phase)
    torch.cuda.empty_cache()
    graphs = timed_phase("graphs", graphs_phase)
    torch.cuda.empty_cache()
    sdiff = timed_phase("samediff", samediff_phase)
    torch.cuda.empty_cache()
    imps = timed_phase("importers", importers_phase)
    torch.cuda.empty_cache()
    timed_phase("embeddings and rl", embeddings_rl_phase)
    torch.cuda.empty_cache()
    mlm = timed_phase("mlm train", mlm_phase)
    longctx = timed_phase("long-context train", long_context_phase)
    mesh = timed_phase("mesh", mesh_phase, mlm, longctx)
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
        if name == "paged_decode_attention":
            kernels[-1]["library"] = PAGED_LIBRARY
            k4 = next(c for c in spec["cells"]
                      if c["k"] == 4 and c["kv_dtype"] == "float32")
            kernels[-1]["launches_speculative_k4"] = k4["paged_launches"]
        if name == "fused_adamw":
            kernels[-1].update(kernel_ms=main["kernel_ms"],
                               host_ms=main["host_ms"])
        # the mesh phase: rows 1-2 under the mesh MLM step (a), rows 3-5
        # under the mesh long-context step (b) and, per schedule, the
        # ring's one-process loop (c)
        for part in ("mlm", "long_context"):
            if name in mesh[part]["launches"]:
                kernels[-1]["launches_mesh"] = mesh[part]["launches"][name]
        if name in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"):
            kernels[-1]["launches_ring_loop"] = {
                sched: mesh["ring"][sched]["launches"][name]
                for sched, _, _ in RING_SCHEDULES}
        if name == "mha_attention_packed":
            kernels[-1]["launches_resilience_qos"] = resil["packed_launches"]
            kernels[-1]["launches_front_door"] = front["packed_launches"]
            kernels[-1]["launches_inference_engine"] = \
                front["ie_packed_launches"]
            # the prefill host's, over HTTP (disagg b)
            kernels[-1]["launches_disagg"] = \
                dis["rpc"]["hosts"][0]["packed_launches"]
            kernels[-1]["launches_mesh_serving"] = \
                mserve["engine"]["float32"]["packed_launches"]
        if name in ("mha_attention_packed", "mha_packed_backward"):
            # the networks phase (c): two SelfAttentionLayers, 7 fit steps
            kernels[-1]["launches_networks"] = {
                dt: run["launches"][name]
                for dt, run in nets["self_attention"].items()}
            # the graphs phase (f): the attention graph, 7 fit steps
            kernels[-1]["launches_graphs"] = {
                dt: run["launches"][name]
                for dt, run in graphs["attention"].items()}
        if name in ROWS_1_5:
            # the samediff phase: config #4 at T = 128 (a, the einsum
            # route: 0), per output and per fit step at T = 1024 (b) and
            # T = 2048 (c)
            kernels[-1]["launches_samediff"] = {
                **{f"a {dt}": sdiff["config4"][dt]["launches"][name]
                   for dt in ("FLOAT", "HALF")},
                **{f"{part} {dt} {what}": sdiff[key][dt][f"{what}_launches"][name]
                   for part, key in (("b", "packed"), ("c", "streamed"))
                   for dt in ("FLOAT", "HALF") for what in ("out", "step")}}
            # the importers phase: config #4 from ONNX bytes at T = 128
            # (a, the einsum route: 0), per output and per fit step of the
            # same graph at T = 1024 (b)
            kernels[-1]["launches_importers"] = {
                "a FLOAT": imps["config4"]["launches"][name],
                **{f"b {dt} {what}": imps["packed"][dt][f"{what}_launches"][name]
                   for dt in ("FLOAT", "HALF") for what in ("out", "step")}}
        if name in ATTENTION_ROWS.values():
            # the ops phase: (a) and (b), by part
            parts = [(f"mha {k}", v) for k, v in ops_run["mha"].items()] \
                + [(f"sdpa {k}", v) for k, v in ops_run["sdpa"].items()]
            kernels[-1]["launches_ops"] = {
                part: run["launches"][name] for part, run in parts
                if run["launches"][name]}
        if name == "paged_decode_attention":
            kernels[-1]["launches_resilience_qos"] = resil["paged_launches"]
            kernels[-1]["launches_front_door"] = front["paged_launches"]
            # the decode host's, over HTTP (disagg b)
            kernels[-1]["launches_disagg"] = \
                dis["rpc"]["hosts"][1]["paged_launches"]
            kernels[-1]["launches_mesh_serving"] = \
                mserve["engine"]["float32"]["paged_launches"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
