"""Federation-wide tracing: context propagation, on-demand device
profiling of listed rounds, shard stitching and round critical-path
analytics (port of ``fedml_tpu/core/tracing.py``).

**Context propagation.** The instrumented comm wrapper
(``core/comm/instrument.py``) stamps every outbound message with
``trace_id`` (one per run, from ``run_id``) and ``trace_flow`` (a per-send
id unique across the world) through :func:`stamp_context`; a handler
links an effect to its cause with :func:`continue_context` (the reply
names the request's flow as its parent span). A message that comes back
through the layer already stamped (a reliable-channel retransmit, an
injected duplicate) keeps its flow id.

**Stitching** (:func:`stitch_shards`): every process exports a trace
shard into ``telemetry_dir`` (``trace.json`` / ``trace_rankN.json``,
``core/telemetry.py``); the stitcher aligns the shards on their
``wall_t0_us`` anchors, corrects each rank's clock skew from the matched
flow pairs themselves (the RTT-pair estimate), and merges them into one
perfetto-loadable timeline with a named process track per rank.

**Critical-path analytics** (:func:`analyze_rounds`): walks the stitched
timeline round by round and attributes the round's wall time to
segments (``broadcast_send``, ``broadcast_wire``, ``client_dispatch``,
``client_compute``, ``client_encode``, ``upload_wire``,
``server_decode``, ``edge_merge``/``root_fold`` on the edge tier,
``aggregate``, ``other``), naming the straggler and each rank's slack.
``trace_run`` (``cli trace``) drives both and writes
``trace_merged.json`` and ``round_report.json``. The files are the JAX
package's in meaning, so either package's stitcher reads the other's
shards.

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
device seconds and launches by kernel name, and the kernel launches the
capture saw on the host but holds no device record of
(``device_records_lost``, 0 in a whole capture). On the CPU the
summary's device entries are empty.
"""

from __future__ import annotations

import glob
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import constants

# message keys the comm layer's byte estimate ignores (comm metadata, not
# payload; see instrument.payload_nbytes)
TRACE_CTX_KEYS = (
    constants.MSG_ARG_KEY_TRACE_ID,
    constants.MSG_ARG_KEY_TRACE_SPAN,
    constants.MSG_ARG_KEY_TRACE_FLOW,
)

# downlink message types that open a round on a client; the uplink type
# that closes it on the server (the analyzer's segment vocabulary)
_BROADCAST_TYPES = (
    constants.MSG_TYPE_S2C_INIT_CONFIG,
    constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
    constants.MSG_TYPE_S2C_RESYNC,
)
_UPLOAD_TYPE = constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER

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


# torch.profiler keeps only the device records it dates inside its
# capture window on the host's clock, and it dates the card's records
# through a calibration that can be off: on an H100 kernel records came
# dated up to 24 ms before their own launch, the records of the first
# 1-10 launches after the start were dropped, and, late in a long
# process, those of the last ~190 ms of a round (the kernels ran: the
# launch counters saw them). A capture on the card therefore opens this
# much host time before the round's first launch and closes this long
# after its last kernel ends, on an idle card; the margins are left out
# of the summary's wall.
CAPTURE_MARGIN_S = 0.5
# the host-side launch calls a kernel record answers, by correlation id
_LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                           "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"})


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

    @property
    def enabled(self) -> bool:
        return bool(self.rounds)

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
        if self.cuda:
            time.sleep(CAPTURE_MARGIN_S)
        self._active = round_idx
        self._t0 = time.perf_counter()

    def _stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        if self.cuda:
            time.sleep(CAPTURE_MARGIN_S)
        prof, round_idx = self._prof, self._active
        prof.__exit__(None, None, None)
        self._prof, self._active = None, None
        by_name, counts, spans = {}, {}, []
        records, lost = _device_records(prof)
        for name, start, end in records:
            by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
            counts[name] = counts.get(name, 0) + 1
            spans.append((start, end))
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
            "device_records_lost": lost,
        }
        with open(os.path.join(path, "summary.json"), "w") as f:
            json.dump(summary, f)


def _device_records(prof):
    """``(name, start_us, end_us)`` of each record of device work in a
    finished capture: kernels, copies and sets; ``record_function``
    ranges, mirrored onto the device timeline as user annotations, are
    left out. Read from the profiler's raw records: ``prof.events()``
    builds the tree of every host op first, seconds for a round of 10^5
    of them, and only the device's are read here. Names are demangled as
    ``prof.events()`` gives them. Also returns how many kernel launches
    the capture holds on the host with no device record by their
    correlation id: records the profiler dropped."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results
    t0 = raw.trace_start_ns()
    names = {}
    out = []
    recorded, launched = set(), set()
    for e in raw.events():
        if e.device_type() != DeviceType.CUDA:
            if e.name() in _LAUNCH_CALLS:
                launched.add(e.correlation_id())
            continue
        if e.is_user_annotation():
            continue
        recorded.add(e.correlation_id())
        name = e.name()
        if name not in names:
            names[name] = torch._C._demangle(name) if len(name) > 1 else name
        out.append((names[name], (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3))
    return out, len(launched - recorded)


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


# ---------------------------------------------------------------------
# shard stitching
# ---------------------------------------------------------------------

MERGED_TRACE_BASENAME = "trace_merged.json"
ROUND_REPORT_BASENAME = "round_report.json"


def _load_shards(telemetry_dir: str) -> List[Dict[str, Any]]:
    """Read every per-process trace shard (``trace.json`` /
    ``trace_rankN.json``) exported into ``telemetry_dir``."""
    shards = []
    for path in sorted(glob.glob(os.path.join(telemetry_dir, "trace*.json"))):
        if os.path.basename(path) == MERGED_TRACE_BASENAME:
            continue
        with open(path) as fh:
            payload = json.load(fh)
        meta = payload.get("otherData", {})
        shards.append(
            {
                "path": path,
                "rank": int(meta.get("rank", 0) or 0),
                "wall_t0_us": float(meta.get("wall_t0_us", 0.0) or 0.0),
                "events_dropped": int(meta.get("events_dropped", 0) or 0),
                "events": payload.get("traceEvents", []),
            }
        )
    return shards


def _estimate_skews(
    shards: List[Dict[str, Any]]
) -> Dict[int, float]:
    """Per-shard clock-skew estimate (µs, relative to the rank-0 shard)
    from matched flow pairs — the classic RTT-pair offset: with
    ``fwd = recv_ts - send_ts`` for ref→shard flows and ``back`` for
    shard→ref flows, ``skew ≈ (min(fwd) - min(back)) / 2`` (symmetric
    minimum network delay cancels; the shard's events are then shifted
    by -skew). Heartbeats, ACKs and round traffic all contribute pairs.
    A shard with traffic in only one direction falls back to the
    causality bound (shift so the earliest violated flow becomes
    non-negative); a shard with no matched flows keeps its wall-clock
    alignment."""
    if not shards:
        return {}
    ref_idx = min(range(len(shards)), key=lambda i: shards[i]["rank"])
    # flow id -> (shard idx, aligned ts) for "s" and "f" events.
    # FIRST-wins per id: a retransmit re-emits "s" with the original
    # flow id and a duplicate delivery re-emits "f" — pairing a retry
    # send against the first arrival (or vice versa) would feed the
    # estimator a negative/backoff-sized delta and shift the whole
    # shard ("whichever copy arrives first completes the flow")
    starts: Dict[int, Tuple[int, float]] = {}
    ends: Dict[int, Tuple[int, float]] = {}
    for i, sh in enumerate(shards):
        base = sh["wall_t0_us"]
        for ev in sh["events"]:
            ph = ev.get("ph")
            if ph == "s":
                starts.setdefault(ev["id"], (i, ev["ts"] + base))
            elif ph == "f":
                ends.setdefault(ev["id"], (i, ev["ts"] + base))
    skews: Dict[int, float] = {ref_idx: 0.0}
    for i in range(len(shards)):
        if i == ref_idx:
            continue
        fwd = []  # ref (or any corrected shard) -> shard i
        back = []  # shard i -> ref
        for fid, (si, s_ts) in starts.items():
            fi_ts = ends.get(fid)
            if fi_ts is None:
                continue
            fi, e_ts = fi_ts
            if si == ref_idx and fi == i:
                fwd.append(e_ts - s_ts)
            elif si == i and fi == ref_idx:
                back.append(s_ts - e_ts)  # negated: skew_i + (-delay)
        if fwd and back:
            # back stored negated, so min(fwd) ≈ d + skew_i and
            # max(back) ≈ skew_i - d  =>  skew = (min(fwd)+max(back))/2
            skews[i] = (min(fwd) + max(back)) / 2.0
        elif fwd:
            # one-way only: causality bound — a receive must not
            # precede its send; shift just enough
            worst = min(fwd)
            skews[i] = min(worst, 0.0)
        elif back:
            worst = max(back)
            skews[i] = max(worst, 0.0)
        else:
            skews[i] = 0.0
    return skews


def stitch_shards(telemetry_dir: str) -> Dict[str, Any]:
    """Merge every trace shard in ``telemetry_dir`` into one
    perfetto-loadable Chrome-trace payload.

    Steps: wall-clock alignment (each shard's ``wall_t0_us`` anchor),
    per-shard skew correction (:func:`_estimate_skews`), per-rank
    ``pid`` namespacing with process_name metadata (two shards from
    one host share an OS pid; the merged view needs one track group
    per rank), and a global sort. Flow events pass through untouched —
    their ids already match across shards."""
    shards = _load_shards(telemetry_dir)
    if not shards:
        raise FileNotFoundError(
            f"no trace shards (trace*.json) found in {telemetry_dir!r}"
        )
    t0 = min(sh["wall_t0_us"] for sh in shards)
    skews = _estimate_skews(shards)
    merged: List[Dict[str, Any]] = []
    dropped_total = 0
    for i, sh in enumerate(shards):
        offset = sh["wall_t0_us"] - t0 - skews.get(i, 0.0)
        pid = 1000 + sh["rank"]
        dropped_total += sh["events_dropped"]
        merged.append(
            {
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {
                    "name": f"rank{sh['rank']}"
                    + (" (server)" if sh["rank"] == 0 else "")
                },
            }
        )
        for ev in sh["events"]:
            ev = dict(ev)
            ev["ts"] = round(ev["ts"] + offset, 1)
            ev["pid"] = pid
            merged.append(ev)
    meta_evs = [e for e in merged if e.get("ph") == "M"]
    data_evs = sorted(
        (e for e in merged if e.get("ph") != "M"), key=lambda e: e["ts"]
    )
    return {
        "traceEvents": meta_evs + data_evs,
        "displayTimeUnit": "ms",
        "otherData": {
            "shards": [os.path.basename(sh["path"]) for sh in shards],
            "ranks": sorted({sh["rank"] for sh in shards}),
            "skew_us": {
                str(shards[i]["rank"]): round(s, 1) for i, s in skews.items()
            },
            "events_dropped": dropped_total,
        },
    }


def flow_match_stats(events: List[Dict[str, Any]]) -> Dict[str, int]:
    """How many flow starts found their finish (the acceptance gate:
    every comm send span must have a matched receive flow)."""
    starts = {e["id"] for e in events if e.get("ph") == "s"}
    ends = {e["id"] for e in events if e.get("ph") == "f"}
    return {
        "flow_starts": len(starts),
        "flow_ends": len(ends),
        "matched": len(starts & ends),
        "unmatched_starts": len(starts - ends),
        "unmatched_ends": len(ends - starts),
    }


# ---------------------------------------------------------------------
# critical-path analytics
# ---------------------------------------------------------------------


def _spans_from_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Pair B/E events per (pid, tid, name) into [{name, ts, dur, args,
    pid, tid}] (µs). Nested same-name spans pair LIFO."""
    open_stack: Dict[Tuple, List[Dict[str, Any]]] = defaultdict(list)
    spans: List[Dict[str, Any]] = []
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("B", "E"):
            continue
        key = (ev["pid"], ev["tid"], ev["name"])
        if ph == "B":
            open_stack[key].append(ev)
        else:
            if not open_stack[key]:
                continue
            b = open_stack[key].pop()
            spans.append(
                {
                    "name": ev["name"],
                    "pid": ev["pid"],
                    "tid": ev["tid"],
                    "ts": b["ts"],
                    "dur": ev["ts"] - b["ts"],
                    "args": b.get("args", {}),
                }
            )
    return spans


def analyze_rounds(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-round critical-path attribution over a stitched timeline.

    For each round r with a complete broadcast → train → upload →
    aggregate chain, walk the straggler's path (the client whose upload
    lands last at the server) and attribute the round's wall time
    (first broadcast send B → aggregate E) to consecutive segments:

    - ``broadcast_send``: first downlink send B → straggler's downlink
      send B (server-side send-loop serialization);
    - ``broadcast_wire``: straggler's downlink send B → its comm.recv B;
    - ``client_dispatch``: downlink receipt → train span B (handler
      dispatch, dataset switch);
    - ``client_compute``: the straggler's train span;
    - ``client_encode``: train E → upload send B (delta encode);
    - ``upload_wire``: straggler's upload send B → server comm.recv B
      (includes server dispatch-queue wait);
    - ``server_decode``: upload receipt → aggregate B (payload decode);
    - ``aggregate``: the server's aggregate span;
    - ``edge_merge`` / ``root_fold`` (hierarchical server plane only):
      when a round carries edge-tier spans, the two-hop flow
      client→edge→root is split out — ``edge_merge`` is the
      last-closing edge's limb-set export span and ``root_fold`` the
      sum of the root's per-edge merge spans; ``server_decode`` then
      shrinks to the residual of the upload-receipt→aggregate window
      (uplink wire + sibling-edge waits);
    - ``other``: wall − sum(above) — ≈0 when the chain is complete
      (the segments are consecutive walks of the same path); it grows
      exactly when a span is missing or the aggregate was triggered by
      a different client than the straggler (deadline path), so
      ``coverage`` (= named segments / wall) is the chain-consistency
      honesty metric of the report.

    Slack per rank = straggler upload arrival − that rank's arrival
    (how much longer the slowest client ran past each client).
    """
    spans = sorted(_spans_from_events(events), key=lambda s: s["ts"])
    # FIRST-wins everywhere a flow id or (round, rank) keys a span:
    # retransmits re-emit comm.send with the original flow id and
    # duplicate deliveries re-emit comm.recv — last-wins would let a
    # late duplicate inflate a fast client's arrival (flipping the
    # straggler) or pair a retry send against the first receipt
    # (negative wire segments)
    sends = defaultdict(list)   # round -> [send span]
    seen_send_flows = set()
    recvs = {}                  # flow id -> first recv span
    trains = defaultdict(dict)  # round -> rank -> train span
    aggregates = {}             # round -> aggregate span
    edge_merges = defaultdict(list)  # round -> edge_merge spans (hier)
    root_folds = defaultdict(list)   # round -> root_fold spans (hier)
    for sp in spans:
        a = sp["args"] or {}
        if sp["name"] == "comm.send" and "round" in a:
            flow = a.get("flow")
            if flow is not None:
                if flow in seen_send_flows:
                    continue  # retransmit of an already-seen send
                seen_send_flows.add(flow)
            sends[int(a["round"])].append(sp)
        elif sp["name"] == "comm.recv" and a.get("flow") is not None:
            recvs.setdefault(int(a["flow"]), sp)
        elif sp["name"] == "train" and "round" in a and "rank" in a:
            trains[int(a["round"])].setdefault(int(a["rank"]), sp)
        elif sp["name"] == "aggregate" and "round" in a:
            aggregates.setdefault(int(a["round"]), sp)
        elif sp["name"] == "edge_merge" and "round" in a:
            edge_merges[int(a["round"])].append(sp)
        elif sp["name"] == "root_fold" and "round" in a:
            root_folds[int(a["round"])].append(sp)

    reports = []
    for r in sorted(sends):
        downlinks = {}  # receiver rank -> (send span, recv span)
        uploads = {}    # sender rank -> (send span, recv span)
        for sp in sends[r]:
            a = sp["args"]
            rx = recvs.get(int(a.get("flow", -1)))
            if int(a.get("msg_type", -1)) in _BROADCAST_TYPES:
                downlinks.setdefault(int(a["receiver"]), (sp, rx))
            elif int(a.get("msg_type", -1)) == _UPLOAD_TYPE:
                uploads.setdefault(int(a["sender"]), (sp, rx))
        agg = aggregates.get(r)
        arrivals = {
            rank: rx["ts"] for rank, (_, rx) in uploads.items() if rx
        }
        if not downlinks or not arrivals or agg is None:
            continue  # incomplete chain (deadline-dropped round, crash)
        straggler = max(arrivals, key=arrivals.get)
        first_bcast = min(sp["ts"] for sp, _ in downlinks.values())
        wall = (agg["ts"] + agg["dur"]) - first_bcast
        seg = {}
        s_down, s_down_rx = downlinks.get(straggler, (None, None))
        s_up, s_up_rx = uploads[straggler]
        s_train = trains.get(r, {}).get(straggler)
        if s_down is not None:
            seg["broadcast_send"] = s_down["ts"] - first_bcast
            if s_down_rx is not None:
                seg["broadcast_wire"] = s_down_rx["ts"] - s_down["ts"]
        if s_train is not None:
            if s_down_rx is not None:
                seg["client_dispatch"] = s_train["ts"] - s_down_rx["ts"]
            seg["client_compute"] = s_train["dur"]
            seg["client_encode"] = s_up["ts"] - (s_train["ts"] + s_train["dur"])
        if s_up_rx is not None:
            seg["upload_wire"] = s_up_rx["ts"] - s_up["ts"]
            seg["server_decode"] = agg["ts"] - s_up_rx["ts"]
        ems, rfs = edge_merges.get(r), root_folds.get(r)
        if ems and rfs and s_up_rx is not None:
            # hierarchical two-hop split: the upload lands at an EDGE,
            # whose close exports the limb-set (edge_merge) the root
            # then merges (root_fold) before the finalize — name those
            # pieces and leave the uplink wire / sibling-edge waits as
            # the server_decode residual
            last_em = max(ems, key=lambda s: s["ts"] + s["dur"])
            seg["edge_merge"] = last_em["dur"]
            seg["root_fold"] = sum(s["dur"] for s in rfs)
            seg["server_decode"] = max(
                (agg["ts"] - s_up_rx["ts"])
                - seg["edge_merge"]
                - seg["root_fold"],
                0.0,
            )
        seg["aggregate"] = agg["dur"]
        named = sum(seg.values())
        seg["other"] = wall - named
        last = arrivals[straggler]
        reports.append(
            {
                "round": r,
                "wall_s": round(wall / 1e6, 6),
                "segments_s": {
                    k: round(v / 1e6, 6) for k, v in seg.items()
                },
                "coverage": round(named / wall, 4) if wall > 0 else None,
                "straggler_rank": straggler,
                "slack_s": {
                    str(rank): round((last - ts) / 1e6, 6)
                    for rank, ts in sorted(arrivals.items())
                },
                "cohort": sorted(arrivals),
            }
        )
    return reports


def trace_run(
    telemetry_dir: str, out_dir: Optional[str] = None
) -> Dict[str, Any]:
    """Stitch + analyze one run's shards: writes
    ``trace_merged.json`` (perfetto-loadable) and
    ``round_report.json`` into ``out_dir`` (default: the telemetry dir
    itself) and returns a summary. The ``cli trace``
    subcommand calls this."""
    out_dir = out_dir or telemetry_dir
    merged = stitch_shards(telemetry_dir)
    rounds = analyze_rounds(merged["traceEvents"])
    os.makedirs(out_dir, exist_ok=True)
    merged_path = os.path.join(out_dir, MERGED_TRACE_BASENAME)
    with open(merged_path + ".tmp", "w") as fh:
        json.dump(merged, fh)
    os.replace(merged_path + ".tmp", merged_path)
    report_path = os.path.join(out_dir, ROUND_REPORT_BASENAME)
    report = {
        "kind": "round_report",
        "telemetry_dir": os.path.abspath(telemetry_dir),
        "ranks": merged["otherData"]["ranks"],
        "skew_us": merged["otherData"]["skew_us"],
        "flows": flow_match_stats(merged["traceEvents"]),
        "rounds": rounds,
    }
    with open(report_path + ".tmp", "w") as fh:
        json.dump(report, fh, indent=2)
    os.replace(report_path + ".tmp", report_path)
    return {
        "merged_trace": merged_path,
        "round_report": report_path,
        "events": len(merged["traceEvents"]),
        "shards": merged["otherData"]["shards"],
        "ranks": merged["otherData"]["ranks"],
        "flows": report["flows"],
        "rounds_analyzed": len(rounds),
    }
