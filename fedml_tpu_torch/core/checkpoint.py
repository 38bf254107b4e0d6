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

``DurableIO`` is the seam under the publish (``install_io_seam`` puts
another in, as the JAX package's chaos plane does). The round WAL and
the checkpoint watcher of the JAX module belong to the elastic and
serving-fleet slices (ROADMAP.md, queue A).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

_STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


class DurableIO:
    """The physical-write seam under every checkpoint publish. Default =
    real IO; a test or a fault injector installs another that can skip,
    delay or corrupt the publish around ``save_fn``."""

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

    def restore(self, round_idx: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The latest (or ``round_idx``'s) state on the CPU, or None when
        no step exists."""
        step = round_idx if round_idx is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                           map_location="cpu", weights_only=True)
        logging.info("checkpoint restored from round %d", step)
        return state

    def close(self) -> None:
        """Nothing to release: every publish completes inside ``save``."""
