"""The distributed trainer's parallel planes: the mesh over the process
group (``mesh``), differentiable collectives (``collectives``), the
sequence-sharded attention, ring and Ulysses (``sequence``), and the
tensor- and expert-parallel layouts (``tensor``, ``expert``)."""
