"""Run one of the port's example scripts as ``__main__`` on a federation
and initial params carried in from the JAX package.

    python torch_example_harness.py CARRIED.pkl SCRIPT.py --cf fedml_config.yaml [...]

``CARRIED.pkl`` holds ``{"dataset": ..., "params": ...}`` (numpy, the
dataset in ``torch_world._np_dataset``'s form, the params in the port's
names). Before the script runs, ``fedml_tpu_torch.data.load`` returns
that federation on the device asked for and ``FedModel.init`` returns
those params, so that the script's run is held to the JAX package's
example run on the same YAML by rounding alone: the two packages draw
the stand-in's features and the initial weights from different
generators. A cross-silo server's last evaluation (what
``cross_silo.Server.run`` returns) is printed as ``RESULT: <repr>``: the
cross-silo scripts print nothing of their own.
The script sees the rest of the command line as its own. Imports no
JAX, so the child stays small.
"""

from __future__ import annotations

import functools
import os
import pickle
import runpy
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    carried_path, script = sys.argv[1], sys.argv[2]
    with open(carried_path, "rb") as fh:
        carried = pickle.load(fh)
    sys.path.insert(0, TESTS)
    import torch

    from fedml_tpu_torch import data
    from fedml_tpu_torch.cross_silo import Server
    from fedml_tpu_torch.models.spec import FedModel
    from torch_world import _np_dataset

    torch.set_num_threads(1)

    def load(args, device="cuda"):
        ds = _np_dataset(carried["dataset"])
        dev = torch.device(device)
        for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
            b = getattr(ds, split)
            setattr(ds, split, type(b)(x=b.x.to(dev), y=b.y.to(dev), mask=b.mask.to(dev)))
        return ds

    def init(self, generator):
        dev = next(self.module.parameters()).device
        return {k: torch.tensor(v, device=dev) for k, v in carried["params"].items()}

    data.load = load
    FedModel.init = init
    run = Server.run

    @functools.wraps(run)
    def printing(self):
        out = run(self)
        print("RESULT:", repr(out), flush=True)
        return out

    Server.run = printing
    sys.argv = [script, *sys.argv[3:]]
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
