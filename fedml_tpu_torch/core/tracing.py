"""Trace context of the comm layer, and on-demand device profiling of
listed rounds (port of part of ``fedml_tpu/core/tracing.py``).

**Context propagation.** The instrumented comm wrapper
(``core/comm/instrument.py``) stamps every outbound message with
``trace_id`` (one per run, from ``run_id``) and ``trace_flow`` (a per-send
id unique across the world) through :func:`stamp_context`; a handler
links an effect to its cause with :func:`continue_context` (the reply
names the request's flow as its parent span). A message that comes back
through the layer already stamped (a reliable-channel retransmit, an
injected duplicate) keeps its flow id. The stitcher and the round
analyzer of the JAX module belong to a later slice.

**Round profiling** (``RoundProfiler``):
``args.profile_rounds`` (a list or a comma-separated string of round
indices) names the rounds to capture; the captures land under
``<telemetry_dir>/profile/round_NNNN/``. The round loop calls
``tick(round_idx)`` at each round's start and ``close()`` at the end of
training; a window runs from its round's tick to the next tick (or
``close``), so it holds the round's training and its evaluation.

Where the JAX package writes a ``jax.profiler`` trace, this writes a
``torch.profiler`` Chrome trace (``trace.json``) and a summary
(``summary.json``): the window's wall seconds, the device's busy
seconds (the union of its kernel, copy and set intervals), their plain
sum, the number of device intervals (kernels, copies and sets), and
device seconds and launches by kernel name. On the CPU the
summary's device entries are empty.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from typing import Optional

import torch

from .. import constants

# message keys the comm layer's byte estimate ignores (comm metadata, not
# payload; see instrument.payload_nbytes)
TRACE_CTX_KEYS = (
    constants.MSG_ARG_KEY_TRACE_ID,
    constants.MSG_ARG_KEY_TRACE_SPAN,
    constants.MSG_ARG_KEY_TRACE_FLOW,
)

# flow-id space: (rank + 1) in the high bits, a process-wide counter low,
# so ids are unique across every rank of a world without coordination
_flow_counter = itertools.count(1)
_flow_lock = threading.Lock()


def _next_flow_id(rank: int) -> int:
    with _flow_lock:
        n = next(_flow_counter)
    return ((int(rank) + 1) << 40) | n


def trace_id_for(telemetry) -> str:
    """One trace per run: every process of a federation derives the same
    id from the shared ``run_id``."""
    return f"fedrun-{telemetry.run_id}"


def stamp_context(msg, telemetry, rank: int = 0):
    """Stamp trace context onto an outbound message; returns
    ``(flow_id, is_resend)``. ``flow_id`` is None for a self-addressed
    loopback (it never crosses a wire); ``is_resend`` is True when the
    message already carried a flow id, which is kept."""
    existing = msg.get(constants.MSG_ARG_KEY_TRACE_FLOW)
    if existing is not None:
        return int(existing), True
    if int(msg.get_sender_id()) == int(msg.get_receiver_id()):
        return None, False
    flow_id = _next_flow_id(rank)
    msg.add_params(constants.MSG_ARG_KEY_TRACE_ID, trace_id_for(telemetry))
    msg.add_params(constants.MSG_ARG_KEY_TRACE_FLOW, flow_id)
    return flow_id, False


def continue_context(in_msg, out_msg) -> None:
    """Causally link ``out_msg`` to the message that triggered it: the
    trace id carries over and the inbound flow becomes the parent span.
    A no-op when the inbound message was never stamped."""
    trace_id = in_msg.get(constants.MSG_ARG_KEY_TRACE_ID)
    parent_flow = in_msg.get(constants.MSG_ARG_KEY_TRACE_FLOW)
    if trace_id is not None:
        out_msg.add_params(constants.MSG_ARG_KEY_TRACE_ID, trace_id)
    if parent_flow is not None:
        out_msg.add_params(constants.MSG_ARG_KEY_TRACE_SPAN, int(parent_flow))


class RoundProfiler:
    def __init__(self, args=None, device: Optional[torch.device] = None) -> None:
        raw = getattr(args, "profile_rounds", None) if args else None
        if raw is None:
            rounds = set()
        elif isinstance(raw, str):
            rounds = {int(r) for r in raw.replace(",", " ").split() if r.strip()}
        else:
            rounds = {int(r) for r in raw}
        self.rounds = rounds
        base = getattr(args, "telemetry_dir", None) if args else None
        self.out_dir = os.path.join(base, "profile") if base else None
        if self.rounds and not self.out_dir:
            logging.warning(
                "profile_rounds=%s ignored: telemetry_dir is unset (the "
                "capture needs somewhere to land)", sorted(self.rounds),
            )
            self.rounds = set()
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._active: Optional[int] = None
        self._prof = None
        self._t0 = 0.0

    def tick(self, round_idx: int) -> None:
        if self._active is not None and round_idx != self._active:
            self._stop()
        if round_idx in self.rounds and self._active is None:
            self._start(int(round_idx))

    def close(self) -> None:
        if self._active is not None:
            self._stop()

    def _start(self, round_idx: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._active = round_idx
        self._t0 = time.perf_counter()

    def _stop(self) -> None:
        from torch.autograd import DeviceType

        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        prof, round_idx = self._prof, self._active
        prof.__exit__(None, None, None)
        self._prof, self._active = None, None
        by_name, counts, spans = {}, {}, []
        for e in prof.events():
            # device work only: record_function ranges are mirrored onto
            # the device timeline as user annotations
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
                counts[e.name] = counts.get(e.name, 0) + 1
                spans.append((e.time_range.start, e.time_range.end))
        path = os.path.join(self.out_dir, f"round_{round_idx:04d}")
        os.makedirs(path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
        summary = {
            "round": round_idx,
            "wall_s": wall,
            "device_busy_s": _union_us(spans) / 1e6,
            "device_kernel_s": sum(by_name.values()),
            "device_launches": len(spans),
            "device_s_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            "device_launches_by_kernel": counts,
        }
        with open(os.path.join(path, "summary.json"), "w") as f:
            json.dump(summary, f)


def _union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total
