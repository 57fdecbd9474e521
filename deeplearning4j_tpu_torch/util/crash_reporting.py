"""Crash forensics (counterpart: ``deeplearning4j_tpu/util/
crash_reporting.py``; ref: org.deeplearning4j.util.CrashReportingUtil).

A dump holds the exception and its traceback, the card's memory counters
(``torch.cuda.memory_stats`` of a CUDA device; nothing for the CPU), the
host's peak RSS, the caller's context lines, the serving flight recorder's
snapshot and a description of the model. Enabled by default
(``crashDumpsEnabled(False)`` to opt out); dumps land in the current
directory or ``crashDumpOutputDirectory(path)`` as
``dl4jtpu-crash-<time>-<pid>.txt``.
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import traceback
from typing import Optional

_enabled = True
_out_dir: Optional[str] = None

#: the allocator counters a dump keeps (``torch.cuda.memory_stats`` keys)
MEMORY_KEYS = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
               "reserved_bytes.all.current", "reserved_bytes.all.peak",
               "num_alloc_retries", "num_ooms")


def crashDumpsEnabled(enabled: bool):
    """(ref: CrashReportingUtil.crashDumpsEnabled)."""
    global _enabled
    _enabled = bool(enabled)


def crashDumpOutputDirectory(path: Optional[str]):
    """(ref: CrashReportingUtil.crashDumpOutputDirectory)."""
    global _out_dir
    _out_dir = path


def _device_lines(device) -> list:
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return [f"device: {dev if dev is not None else 'unknown'} "
                "(no device memory counters)"]
    try:
        stats = torch.cuda.memory_stats(dev)
        keep = {k: stats[k] for k in MEMORY_KEYS if k in stats}
        return [f"device: {dev} {torch.cuda.get_device_name(dev)}",
                f"  memory: {keep or 'no memory stats exposed'}"]
    except Exception as e:   # the device itself may be what died
        return [f"device: {dev} <memory query failed: {e}>"]


def _model_lines(model) -> list:
    lines = [f"class: {type(model).__name__}"]
    if isinstance(model, dict):
        n = 0
        stack = [model]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t.values())
            elif isinstance(t, (list, tuple)):
                stack.extend(t)
            elif hasattr(t, "numel"):
                n += int(t.numel())
        lines.append(f"numParams: {n}")
    return lines


def writeMemoryCrashDump(model, exception: BaseException,
                         context: Optional[dict] = None,
                         device=None) -> Optional[str]:
    """Write the dump; returns the path (None when disabled or when the
    dump itself fails — crash reporting must never mask the original
    error). ``context`` adds caller-provided key/value lines (the serving
    engine records which point failed); ``device`` selects whose memory
    counters are read."""
    if not _enabled:
        return None
    try:
        lines = ["deeplearning4j_tpu_torch crash dump",
                 f"time: {datetime.datetime.now().isoformat()}",
                 f"pid: {os.getpid()}", "",
                 "---- exception " + "-" * 50,
                 "".join(traceback.format_exception(
                     type(exception), exception, exception.__traceback__)),
                 "---- devices " + "-" * 52]
        lines.extend(_device_lines(device))
        try:
            import resource  # Unix-only; dumps degrade gracefully elsewhere
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss is KiB on Linux, bytes on macOS
            rss_mb = rss / (1048576.0 if sys.platform == "darwin" else 1024.0)
            lines.append(f"host max RSS: {rss_mb:.1f} MB")
        except ImportError:
            pass
        if context:
            lines.append("")
            lines.append("---- context " + "-" * 52)
            for k in sorted(context):
                lines.append(f"{k}: {context[k]}")
        try:
            from deeplearning4j_tpu_torch.serving.tracing import (
                flight_recorder)
            events = flight_recorder().snapshot()
            if events:
                lines.append("")
                lines.append(f"---- flight recorder (last {len(events)} "
                             "events) " + "-" * 20)
                for e in events:
                    lines.append(json.dumps(e, default=str))
        except Exception:
            pass
        lines.append("")
        lines.append("---- model " + "-" * 54)
        lines.extend(_model_lines(model))
        name = (f"dl4jtpu-crash-{datetime.datetime.now():%Y%m%d-%H%M%S}"
                f"-{os.getpid()}.txt")
        path = os.path.join(_out_dir or os.getcwd(), name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return path
    except Exception:
        return None  # never shadow the original failure
