#!/usr/bin/env python3
"""Run the port's on-card kernel tests under ``compute-sanitizer``.

Builds every kernel under ``deeplearning4j_tpu_torch/ops/csrc`` first
(outside the sanitizer), then runs ``tests/test_torch_cuda.py`` under:

- ``--tool memcheck`` (out-of-bounds and misaligned device accesses,
  CUDA API errors) over every test of the file;
- ``--tool racecheck`` (shared-memory hazards) over the packed forward
  (row 1) and paged decode (row 6) tests;
- ``--tool initcheck`` (reads of uninitialised device memory) over the
  same selection as racecheck.

Each run's full output goes to ``chiprun_out/sanitizer_<tool>.txt``; the
script prints one JSON line per run (the tool, its exit code, its
``ERROR SUMMARY`` line, the pytest summary line, and whether the tool
accepted the device) and exits non-zero when a tool reported an error or
could not run. Needs one card; from the
repo root:

    python3 tools/sanitize_kernels.py [--timeout 900]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROW_1_AND_6 = ("test_packed_fp32_matches_plain or "
               "test_packed_bf16_matches_plain or test_paged_matches_plain")


def sanitizer() -> str:
    for cand in (shutil.which("compute-sanitizer"),
                 "/usr/local/cuda/bin/compute-sanitizer"):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("compute-sanitizer is not on PATH or in "
                            "/usr/local/cuda/bin")


def run(tool: str, select: str, timeout: float) -> dict:
    cmd = [sanitizer(), "--tool", tool, "--error-exitcode", "86",
           "--print-limit", "50"]
    if tool == "memcheck":
        cmd += ["--leak-check", "no"]
    cmd += [sys.executable, "-m", "pytest", "--noconftest", "-q",
            "-p", "no:cacheprovider", "tests/test_torch_cuda.py"]
    if select:
        cmd += ["-k", select]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        out, rc = p.stdout + p.stderr, p.returncode
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or b"").decode(errors="replace") \
            if isinstance(e.stdout, bytes) else (e.stdout or "")
        rc = "timeout"
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/sanitizer_{tool}.txt", "w") as f:
        f.write(" ".join(cmd) + "\n" + out)
    summary = re.findall(r"ERROR SUMMARY: .*", out)
    tests = re.findall(r"^=*\s*\d+ (?:passed|failed).*$", out, re.M)
    return {"tool": tool, "select": select or "all", "rc": rc,
            # the tool's own refusal: it then fails every CUDA call of the
            # program (error 999), and nothing under test ran on the card
            "device_supported": "Device not supported" not in out,
            "error_summary": summary[-1] if summary else None,
            "pytest": tests[-1].strip("= ") if tests else None,
            "tail": out.strip().splitlines()[-3:] if out.strip() else []}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for each sanitizer run")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sanitize_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.ops import _build

    took = _build.build()
    print(json.dumps({"build_s": took}), flush=True)
    results = [run("memcheck", "", args.timeout),
               run("racecheck", ROW_1_AND_6, args.timeout),
               run("initcheck", ROW_1_AND_6, args.timeout)]
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
