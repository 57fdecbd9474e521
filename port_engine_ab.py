#!/usr/bin/env python3
"""Compare the PyTorch port's serving engine between two checkouts on one
GPU: the chat mix of ``chip_smoke.py``'s engine phase (32 requests of
4..127 tokens, 64 new tokens each, 16 slots, BERT-base widths as a causal
LM in bf16, fused paged decode, bf16 pool) through each tree, in turns A,
B, B, A, two timed runs per turn after a warmup, each turn in its own
process. Prints one JSON line per run: decode tokens/s, the mean decode
step and end-to-end tokens/s, with the card's name and power limit.

    python3 port_engine_ab.py [--spec-k K] PATH_A PATH_B

``--spec-k K`` (K >= 1) serves the mix speculatively instead, as
``chip_smoke.py``'s speculative grid does: the grid's draft (one layer at
half the hidden and mlp widths, bf16, seed 2), k = K, ``lm_head`` zeroed
in both models so every proposal is accepted; each line then adds the
acceptance rate.

Each path is the root of a checkout (its kernels build there at first
use). Run from anywhere; needs one CUDA card.
"""
import json
import os
import subprocess
import sys
import time


def run_tree(root: str, spec_k: int):
    sys.path.insert(0, root)
    import dataclasses

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models import TransformerConfig, init_params
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, ServingMetrics, SpecConfig)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = TransformerConfig(causal=True, remat=False, attention_impl="flash")
    params = init_params(cfg, seed=0, device="cuda")
    spec = None
    if spec_k:
        dcfg = dataclasses.replace(cfg, hidden=cfg.hidden // 2, layers=1,
                                   mlp_dim=cfg.mlp_dim // 2)
        dparams = init_params(dcfg, seed=2, device="cuda")
        params = dict(params, lm_head=torch.zeros_like(params["lm_head"]))
        spec = SpecConfig(dict(dparams, lm_head=torch.zeros_like(
            dparams["lm_head"])), dcfg, k=spec_k)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 128)))
               .astype(np.int32) for _ in range(32)]
    with GenerationEngine(params, cfg, slots=16, max_len=512,
                          paged_attention="fused", queue_capacity=64,
                          speculative=spec, device="cuda") as eng:
        eng.warmup()
        for rep in range(2):
            eng.metrics = ServingMetrics()
            t0 = time.perf_counter()
            # zeroed logits pick one token every step: no eos, so every
            # stream runs its 64 tokens
            kw = {"eos_id": None} if spec_k else {}
            hs = [eng.submit(p, max_new_tokens=64, **kw) for p in prompts]
            for h in hs:
                h.result(timeout=600)
            wall = time.perf_counter() - t0
            m = eng.metrics
            print(json.dumps({
                "tree": root, "rep": rep, "card": card, "spec_k": spec_k,
                "decode_tokens_per_sec": m.decode_tokens_per_sec(),
                "decode_step_ms_mean": m.decode_step_ms.mean,
                "end_to_end_tokens_per_sec": len(prompts) * 64 / wall,
                "decode_steps": int(m.decode_steps_total.value),
                "acceptance_rate": m.spec_acceptance_rate.value
                if spec_k else None}),
                flush=True)


def main() -> int:
    args = sys.argv[1:]
    spec_k = 0
    if len(args) >= 2 and args[0] == "--spec-k":
        spec_k = int(args[1])
        args = args[2:]
    if len(args) == 2 and args[0] == "--tree":
        run_tree(os.path.abspath(args[1]), spec_k)
        return 0
    if len(args) != 2 or spec_k < 0:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = args
    for root in (a, b, b, a):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--spec-k", str(spec_k), "--tree",
                             root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
