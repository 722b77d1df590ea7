"""Device resolution, kernel launch counters and the gated profiler range
(``span``).

Rule: an entry point runs on ``cuda`` unless the caller asks for the CPU.
With no CUDA device and no explicit CPU request it raises — it never
falls back to the host quietly, so a run that meant to exercise the
card cannot silently measure the CPU.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); anything else is
    taken as given, and a ``cuda`` request without CUDA raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "emqx_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# one count per hand-written kernel: a wrapper adds one exactly where it
# launches its kernel, so a run can show the main path went through it
LAUNCHES: dict[str, int] = {"shape_match": 0, "prefix_sum": 0,
                            "ring_rotate": 0}
# the same launches by input shape, for a wrapper that passes its shape
LAUNCH_SHAPES: dict[str, dict[tuple, int]] = {"prefix_sum": {},
                                             "shape_match": {}}


# per thread: the launches being recorded instead of counted
# (recording_launches)
_capture = threading.local()


def count_launch(name: str, shape: tuple | None = None) -> None:
    calls = getattr(_capture, "calls", None)
    if calls is not None:
        # captured into a graph (its replays count it) or a warm-up's
        calls.append((name, shape))
        return
    LAUNCHES[name] += 1
    if shape is not None:
        per = LAUNCH_SHAPES[name]
        per[shape] = per.get(shape, 0) + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for per in LAUNCH_SHAPES.values():
        per.clear()


@contextlib.contextmanager
def recording_launches():
    """On this thread, the wrappers' launches are recorded into the
    yielded list instead of counted: within a CUDA graph capture, so each
    replay of the graph can count the launches it makes (``count_launch``
    per recorded call), and around launches that serve no traffic (a
    warm-up). Nests: the outer recording resumes on exit."""
    calls: list = []
    outer = getattr(_capture, "calls", None)
    _capture.calls = calls
    try:
        yield calls
    finally:
        _capture.calls = outer


_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records
    on this thread; otherwise a no-op that enters no ``record_function``
    (entering one costs microseconds even with no profiler running)."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN
