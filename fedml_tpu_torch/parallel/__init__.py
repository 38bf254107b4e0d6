"""The port's parallel planes: the meshes over the process group
(``mesh``: the distributed trainer's and the simulator's, with the
federation's placement), differentiable collectives (``collectives``),
the sequence-sharded attention, ring and Ulysses (``sequence``), the
tensor- and expert-parallel layouts (``tensor``, ``expert``), the GPipe
schedule (``pipeline``), the fed mesh's parameter layout
(``layout``) and elastic preemption (``elastic``)."""
