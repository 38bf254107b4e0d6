"""Checkpoint / resume of the simulation (port of the first half of
``fedml_tpu/core/checkpoint.py``).

``RoundCheckpointer`` saves the round loop's state, {params,
server_state, generator, round_idx} and, when the algorithm keeps state
of its own, ``extra`` (a dict of tensors: S-FedAvg's reputation ``phi``
and Shapley values ``sv``), every ``checkpoint_freq`` rounds and
restores the latest complete step. The format is the port's own
(the JAX package's is orbax's, which the port cannot import): one
``torch.save`` of CPU tensors and Python scalars per step, written into
a temporary directory beside the steps, fsynced, and published by
``os.replace`` onto ``<dir>/<step>``, so a reader sees a step whole or
not at all. The newest ``keep`` steps are kept. ``restore`` reads with
``torch.load(weights_only=True)``, which loads tensors and plain
containers and runs no pickled code.

``restore(target=...)`` loads each tensor the target names onto the
target tensor's device, after checking its shape and dtype against it
(a stale target raises, and :class:`CheckpointWatcher` relearns it).

``DurableIO`` is the seam under the publish and under the round WAL's
file creation and appends (``install_io_seam`` puts another in, as the
JAX package's chaos plane does).

:class:`RoundWAL` is the append-only log of completed rounds, and
:class:`CheckpointWatcher` the publish/watch seam the serving plane
hot-swaps from: latest-wins, a corrupt latest step falls back to the
previous one and is never retried, a stale restore target is relearned
by a target-free restore (``serving_restore_target_relearned_total``).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

_STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


class DurableIO:
    """The physical-write seam under every durable-state mutation: the
    round WAL's file creation and appends and every checkpoint publish.
    Default = real IO; a test or a fault injector installs another that
    can tear, fail, delay or corrupt a write."""

    def wal_create(self, dir_path: str, path: str) -> None:
        """Create the WAL file AND fsync its parent directory: the
        directory entry is its own durable object."""
        fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
        os.close(fd)
        _fsync_dir(dir_path)

    def wal_append(self, path: str, data: bytes, **ctx) -> None:
        """One durable append: write + flush + fsync. ``ctx`` carries the
        record's identity (round_idx, kind) for fault targeting."""
        with open(path, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def ckpt_publish(self, save_fn: Callable[[], None], step: int, dir_path: str) -> None:
        """One checkpoint publish; ``save_fn`` does the real work."""
        save_fn()


_DEFAULT_IO = DurableIO()
_CURRENT_IO: DurableIO = _DEFAULT_IO


def install_io_seam(seam: DurableIO) -> None:
    """Install a process-wide IO seam (fault injection, tests)."""
    global _CURRENT_IO
    _CURRENT_IO = seam


def reset_io_seam() -> None:
    global _CURRENT_IO
    _CURRENT_IO = _DEFAULT_IO


def current_io() -> DurableIO:
    return _CURRENT_IO


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_host(tree: Any) -> Any:
    """Every tensor leaf copied to the CPU (the device-to-host copy waits
    for the card: the checkpoint's own wait)."""
    return pytree.tree_map(
        lambda v: v.detach().cpu() if isinstance(v, torch.Tensor) else v, tree
    )


class RoundCheckpointer:
    """Saves and restores the round loop's state under ``checkpoint_dir``,
    one directory per step (the round index), the newest ``keep`` kept."""

    def __init__(self, checkpoint_dir: str, keep: int = 3) -> None:
        self.dir = os.path.abspath(checkpoint_dir)
        self.keep = int(keep)
        os.makedirs(self.dir, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, str(int(step)))

    def save(self, round_idx: int, state: Dict[str, Any]) -> None:
        """Publish ``state`` as step ``round_idx``: its tensors copied to
        the host, written and fsynced in a temporary directory, renamed
        into place, the parent directory fsynced; then the steps past
        the newest ``keep`` are removed."""
        host = _to_host(state)
        final = self._step_dir(round_idx)
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {round_idx} exists already: {final}")

        def _publish() -> None:
            tmp = tempfile.mkdtemp(prefix=f"{_TMP_PREFIX}{int(round_idx)}-", dir=self.dir)
            try:
                path = os.path.join(tmp, _STATE_FILE)
                with open(path, "wb") as f:
                    torch.save(host, f)
                    f.flush()
                    os.fsync(f.fileno())
                _fsync_dir(tmp)
                os.replace(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            _fsync_dir(self.dir)

        current_io().ckpt_publish(_publish, step=int(round_idx), dir_path=self.dir)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        logging.info("checkpoint saved at round %d -> %s", round_idx, self.dir)

    def steps(self) -> List[int]:
        """Complete on-disk steps, ascending. A temporary directory left
        by an interrupted publish is not a step."""
        out = []
        for name in os.listdir(self.dir):
            if name.isdigit() and os.path.isfile(os.path.join(self.dir, name, _STATE_FILE)):
                out.append(int(name))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, round_idx: Optional[int] = None,
                target: Optional[Any] = None) -> Optional[Dict[str, Any]]:
        """The latest (or ``round_idx``'s) state, or None when no step
        exists. Without ``target`` every tensor comes back on the CPU.
        With ``target`` (a tree of the state's shape whose tensor leaves
        give each restored tensor's shape, dtype and device), each tensor
        the target names is checked against it and loaded onto its
        device; a mismatch raises ``ValueError``."""
        step = round_idx if round_idx is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                           map_location="cpu", weights_only=True)
        if target is not None:
            state = _onto_target(state, target, "")
        logging.info("checkpoint restored from round %d", step)
        return state

    def close(self) -> None:
        """Nothing to release: every publish completes inside ``save``."""


def _onto_target(value: Any, target: Any, path: str) -> Any:
    """``value`` with every tensor the target names moved onto the target
    tensor's device, after checking its shape and dtype."""
    if isinstance(target, torch.Tensor):
        if not isinstance(value, torch.Tensor):
            raise ValueError(f"restore target names a tensor at {path or '/'}; "
                             f"the step holds {type(value).__name__}")
        if tuple(value.shape) != tuple(target.shape) or value.dtype != target.dtype:
            raise ValueError(
                f"restore target mismatch at {path or '/'}: the step holds "
                f"{tuple(value.shape)} {value.dtype}, the target wants "
                f"{tuple(target.shape)} {target.dtype}")
        return value.to(target.device)
    if isinstance(target, dict):
        if not isinstance(value, dict):
            raise ValueError(f"restore target names a dict at {path or '/'}; "
                             f"the step holds {type(value).__name__}")
        missing = sorted(set(target) - set(value))
        if missing:
            raise ValueError(f"restore target names {missing[:3]} under {path or '/'}, "
                             "which the step does not hold")
        return {k: (_onto_target(v, target[k], f"{path}/{k}") if k in target else v)
                for k, v in value.items()}
    return value


class RoundWAL:
    """Append-only write-ahead log of COMPLETED federation rounds.

    One JSONL record per completed round next to the checkpoint steps:
    ``{"round_idx", "ckpt_step", "cohort", "folded"}`` — which round
    finished, which checkpoint step (if any) carries its aggregated
    params, which client ranks the round was broadcast to, and which
    ranks' uploads were FOLDED into the aggregate (under a quorum or
    deadline close a strict subset of the cohort). ``last()`` after a
    crash names the last round that completed; the folded set is the
    exactly-once ledger a restarted server reads (async publishes carry
    ``[rank, seq]`` pairs and ``kind="publish"``).

    Durability: each append is one ``write + flush + fsync`` through the
    ``DurableIO`` seam; the FIRST append also fsyncs the parent
    directory. ``last`` / ``records`` skip a torn final line (a server
    killed mid-append is a normal event this log exists for).
    """

    FILENAME = "round_wal.jsonl"

    def __init__(self, checkpoint_dir: str) -> None:
        self.dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, self.FILENAME)
        # only the FIRST append of a process can find a torn tail (our
        # own appends always end in a newline); probe once, lazily
        self._tail_checked = False

    def append(
        self,
        round_idx: int,
        ckpt_step: Optional[int],
        cohort: List[int],
        folded: Optional[List] = None,
        kind: Optional[str] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        rec = {
            "round_idx": int(round_idx),
            "ckpt_step": None if ckpt_step is None else int(ckpt_step),
            "cohort": sorted(int(r) for r in cohort),
        }
        if folded is not None:
            # ranks (sync rounds) or [rank, seq] pairs (async publishes)
            rec["folded"] = sorted(
                [int(r[0]), int(r[1])] if isinstance(r, (list, tuple)) else int(r)
                for r in folded
            )
        if kind is not None:
            rec["kind"] = str(kind)
        if extra:
            rec.update(extra)
        # a previous crash mid-append can leave a torn, newline-less final
        # line; start fresh so the new record never concatenates onto it
        torn_tail = False
        created = False
        if not self._tail_checked:
            try:
                with open(self.path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    if f.tell() > 0:
                        f.seek(-1, os.SEEK_END)
                        torn_tail = f.read(1) != b"\n"
            except FileNotFoundError:
                created = True
        io = current_io()
        if created:
            io.wal_create(self.dir, self.path)
        data = (("\n" if torn_tail else "") + json.dumps(rec) + "\n").encode()
        io.wal_append(self.path, data, round_idx=int(round_idx), kind=kind)
        self._tail_checked = True

    def records(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        out: List[Dict[str, Any]] = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    # torn write from a mid-append crash: everything
                    # before it is intact and that's what matters
                    logging.warning(
                        "round WAL %s: skipping torn record %r", self.path, line[:80],
                    )
        return out

    def last(self) -> Optional[Dict[str, Any]]:
        recs = self.records()
        return recs[-1] if recs else None


class CheckpointWatcher:
    """``latest_step()``-driven publish/watch seam over a checkpoint dir.

    The training side "publishes" by saving (the step index IS the
    version); a subscriber — the serving plane's hot-swap loop — polls
    this watcher. Semantics are **latest-wins**: each poll returns the
    NEWEST restorable step newer than the last one published (steps
    superseded between polls are skipped, never delivered).

    Fault contract: a corrupt or partially-written latest step degrades
    the subscriber to the PREVIOUS version, never crashes it; a step that
    fails to restore is remembered as bad and never retried.

    Elastic contract: a restore target that no longer matches the
    published state (the endpoint re-meshed, or the trainer changed the
    state tree) is RELEARNED, not treated as a corrupt step: the poll
    retries the same step target-free, delivers it, and counts
    ``serving_restore_target_relearned_total``. Only a step that fails
    both ways is bad.
    """

    def __init__(
        self,
        checkpoint_dir: str,
        poll_interval_s: float = 1.0,
        restore_target: Any = None,
    ) -> None:
        self.ckpt = RoundCheckpointer(checkpoint_dir)
        self.poll_interval_s = float(poll_interval_s)
        self.published_step: Optional[int] = None
        # restore target (a tree, or a zero-arg callable returning one or
        # None): when set, each poll restores straight onto its devices
        self.restore_target = restore_target
        self._bad: set = set()
        self._closed = threading.Event()  # stops every watch() loop
        self._threads: List[threading.Thread] = []

    def _target(self) -> Any:
        t = self.restore_target
        return t() if callable(t) else t

    def poll(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """The newest restorable step newer than the last published one,
        as ``(step, state)``; None when nothing is new."""
        try:
            steps = self.ckpt.steps()
        except Exception:  # noqa: BLE001 — a listing error is "nothing new"
            logging.exception("checkpoint watcher: step listing failed")
            return None
        floor = -1 if self.published_step is None else self.published_step
        for step in sorted(
            (s for s in steps if s > floor and s not in self._bad), reverse=True,
        ):
            target = None
            try:
                # the target lookup stays INSIDE the try: a target that no
                # longer matches a step degrades like a corrupt step does
                target = self._target()
                state = self.ckpt.restore(step, target=target)
            except Exception:  # noqa: BLE001 — mismatch OR corrupt
                if target is not None:
                    # a shaped target can fail for a reason a raw restore
                    # cannot: the layout it describes is stale. Retry
                    # target-free before declaring the STEP bad
                    try:
                        state = self.ckpt.restore(step, target=None)
                    except Exception:  # noqa: BLE001 — truly corrupt
                        logging.exception(
                            "checkpoint watcher: step %d failed to restore; "
                            "falling back to the previous version", step,
                        )
                        self._bad.add(step)
                        continue
                    from .telemetry import Telemetry

                    Telemetry.get_instance().inc("serving_restore_target_relearned_total")
                    logging.warning(
                        "checkpoint watcher: restore target no longer matches step "
                        "%d; delivered raw for the subscriber to relearn placement",
                        step,
                    )
                else:
                    logging.exception(
                        "checkpoint watcher: step %d failed to restore; falling "
                        "back to the previous version", step,
                    )
                    self._bad.add(step)
                    continue
            if state is None:
                self._bad.add(step)
                continue
            self.published_step = step
            return step, state
        return None

    def watch(
        self,
        callback: Callable[[int, Dict[str, Any]], None],
        stop_event: Optional[threading.Event] = None,
    ) -> threading.Thread:
        """Poll on a daemon thread, invoking ``callback(step, state)`` per
        new version until ``stop_event`` (or ``close()``) fires. A
        callback error is logged, not fatal."""
        stop = stop_event if stop_event is not None else threading.Event()

        def loop() -> None:
            while not stop.is_set() and not self._closed.is_set():
                update = self.poll()
                if update is not None:
                    try:
                        callback(*update)
                    except Exception:  # noqa: BLE001
                        logging.exception("checkpoint watch callback failed")
                stop.wait(self.poll_interval_s)

        thread = threading.Thread(target=loop, daemon=True, name="checkpoint-watcher")
        thread.stop_event = stop  # type: ignore[attr-defined]
        thread.start()
        self._threads.append(thread)
        return thread

    def close(self) -> None:
        # stop the watch loops BEFORE closing the checkpointer they poll
        self._closed.set()
        for t in self._threads:
            t.join(timeout=self.poll_interval_s + 1.0)
        self._threads.clear()
        self.ckpt.close()
