"""In-silo data-parallel trainer (port of
``fedml_tpu/cross_silo/hierarchical/trainer_dist_adapter.py``).

Where the reference wraps the model in ``DistributedDataParallel``
(allreduce per backward, ``trainer_dist_adapter.py:40-141``), each
rank of the silo's process group here takes its share of every batch's
examples (``local_trainer.example_share``: rank r of n holds
``[r * bs // n, (r + 1) * bs // n)``, after the shuffle that every rank
draws alike), differentiates the masked loss SUM of its share, and the
ranks all-reduce the gradient sums and the example counts
(``make_local_train_fn(data_group=...)``): each step is the whole
batch's mean, not a mean of the ranks' means, so a short share weighs
what it holds and hierarchical == horizontal to f32 rounding (asserted
in the tests). A one-rank silo (no group) is the plain trainer.
"""

from __future__ import annotations

from typing import Tuple

from ...core.local_trainer import example_share
from ..horizontal.fedml_client_manager import FedMLTrainer


class TrainerDistAdapter(FedMLTrainer):
    """The horizontal ``FedMLTrainer``'s surface (update_dataset /
    train) over the silo's process group, so the master manager is
    scenario-agnostic; ``participate`` is the slaves' entry."""

    def __init__(self, args, dataset, model, process_group, client_trainer=None) -> None:
        self.pg = process_group
        super().__init__(args, dataset, model, client_trainer=client_trainer,
                         data_group=process_group.group)

    def batch_share(self) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of every batch."""
        bs = self.dataset.packed_train.batch_size
        return example_share(bs, self.pg.n_proc_in_silo, self.pg.proc_rank_in_silo)

    def participate(self, params, round_idx: int) -> None:
        """Slave-side entry (a slave exists only in a silo of several
        ranks): every rank of the group must run the same step for its
        collectives to complete (the ``dist.barrier`` + DDP-step analog,
        trainer_dist_adapter.py:121-127)."""
        self.train(params, round_idx)
