#!/usr/bin/env python3
"""How long ``chip_smoke.py``'s resilience engine goes between watchdog
heartbeats while it seats prompts.

Builds the kernels, runs the engine phase's mix once for its reference
streams (BERT-base causal LM, bf16, flash, seeded weights, the 32-request
chat mix), then ``chip_smoke.resilience_qos_phase`` three times with
``GenerationEngine._admit`` timed. Each run prints one JSON line: pass or
the failed check, its wall seconds, the watchdog's restart seconds and
post-restart passes, the five longest admission turns of the
``resilience`` engine as ``(engine, prefills, ms)``, and the longest turn
for each count of prefills it ran. The phase arms a 500 ms watchdog; a
turn longer than that without a heartbeat restarts the scheduler.

Needs one card; from the repo root: ``python3 torch_tools/resilience_probe.py``
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RUNS = 3


def main() -> int:
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models import TransformerConfig, init_params
    from deeplearning4j_tpu_torch.serving import generation

    turns = []
    admit = generation.GenerationEngine._admit

    def timed_admit(self, pool):
        n0 = self.metrics.prefills_total.value
        t0 = time.perf_counter()
        try:
            return admit(self, pool)
        finally:
            n = self.metrics.prefills_total.value - n0
            if n:
                turns.append((self.name, n,
                              (time.perf_counter() - t0) * 1e3))

    generation.GenerationEngine._admit = timed_admit
    cs.build()
    cfg = TransformerConfig(causal=True, remat=False, attention_impl="flash")
    params = init_params(cfg, seed=0, device="cuda")
    prompts = cs.chat_mix(cfg.vocab_size, max_len=cfg.max_seq)
    ref = cs.engine_phase(cfg, params, prompts)["float32"]
    ok = True
    for run in range(RUNS):
        del turns[:]
        t0 = time.perf_counter()
        row = dict(run=run, ok=True, error=None)
        try:
            stats = cs.resilience_qos_phase(cfg, params, prompts,
                                            ref["streams"],
                                            ref["decode_tokens_per_sec"])
            row.update({k: stats[k] for k in (
                "watchdog_restart_s", "watchdog_post_restart_passes")})
        except AssertionError as e:
            row.update(ok=False, error=str(e))
            ok = False
        mine = [t for t in turns if t[0] == "resilience"]
        longest = {}
        for _name, n, ms in mine:
            longest[n] = max(ms, longest.get(n, 0.0))
        row.update(s=time.perf_counter() - t0,
                   top_turns=sorted(mine, key=lambda t: -t[2])[:5],
                   turn_ms_max_by_prefills=dict(sorted(longest.items())))
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print(json.dumps({"all_ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
