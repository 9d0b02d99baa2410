"""Tracing and timing helpers (port of reslic_tcm_tpu/utils/profiling.py).

``trace(log_dir)`` wraps ``torch.profiler`` (the CPU, and the card when one
is present) and writes a trace that TensorBoard and Chrome's trace viewer
read; ``timed`` measures host wall time ending in a device fence;
``throughput_mp_s`` reports the north-star megapixels per second.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its trace (``*.pt.trace.json``) into
    ``log_dir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _fence(tree) -> None:
    """Wait for the work that produces every CUDA tensor in ``tree`` (a
    tensor, or dicts, lists and tuples of them); CPU tensors are ready."""
    devices = set()

    def visit(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(tree)
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(label: str = "", results: dict | None = None, sync=None):
    """Wall-clock a block; ``sync`` (or the block's ``out["sync"]``) is a
    tensor or a nest of tensors whose devices are synchronised first."""
    t0 = time.perf_counter()
    out = {}
    try:
        yield out
    finally:
        if sync is not None:
            _fence(sync)
        elif "sync" in out:
            _fence(out["sync"])
        dt = time.perf_counter() - t0
        out["seconds"] = dt
        if results is not None:
            results[label] = dt
        if label:
            print(f"[timed] {label}: {dt * 1000:.2f} ms")


def throughput_mp_s(pixels: int, seconds: float) -> float:
    return pixels / 1e6 / seconds
