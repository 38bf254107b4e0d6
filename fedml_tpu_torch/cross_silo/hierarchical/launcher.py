"""Silo process launcher (port of
``fedml_tpu/cross_silo/hierarchical/launcher.py``).

Parity with ``cross_silo/hierarchical/dist_trainer_launcher.py:23-48``:
the reference spawns per-node ``torchrun --rdzv_backend=c10d``. A silo's
processes here are plain OS processes that meet at a
``torch.distributed`` TCP rendezvous (process 0 hosts the store at the
coordinator address), so the launcher is ``subprocess`` + argv: one
child per silo process, each told its ``proc_rank_in_silo``, the
coordinator and the silo fabric's port block; ``torchrun
--nproc_per_node N`` with the same entry script is the equivalent.
Single host; a multi-host silo runs the same entry script per host with
the same arguments.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence


def launch_silo_processes(
    entry_script: str,
    n_proc_in_silo: int,
    coordinator_port: int,
    silo_grpc_port_base: int,
    extra_argv: Sequence[str] = (),
    env_overrides: Optional[Dict[str, str]] = None,
) -> List[subprocess.Popen]:
    """Spawn ``n_proc_in_silo`` OS processes running ``entry_script``.

    Each child receives ``--proc_rank_in_silo r --n_proc_in_silo N
    --distributed_coordinator 127.0.0.1:<port> --silo_grpc_port_base
    <base>`` plus ``extra_argv``. The caller waits on the returned
    Popens (process 0 is the master and hosts the rendezvous)."""
    procs: List[subprocess.Popen] = []
    for r in range(n_proc_in_silo):
        env = dict(os.environ)
        if env_overrides:
            env.update(env_overrides)
        cmd = [
            sys.executable,
            entry_script,
            "--proc_rank_in_silo", str(r),
            "--n_proc_in_silo", str(n_proc_in_silo),
            "--distributed_coordinator", f"127.0.0.1:{coordinator_port}",
            "--silo_grpc_port_base", str(silo_grpc_port_base),
            *extra_argv,
        ]
        procs.append(subprocess.Popen(cmd, env=env))
    return procs
