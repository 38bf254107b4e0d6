"""PyTorch/CUDA port of ``fedml_tpu``, for one NVIDIA H100.

A second package beside ``fedml_tpu``: module paths mirror it
(``fedml_tpu_torch/serving/engine.py`` is the port of
``fedml_tpu/serving/engine.py``), it imports ``torch`` and never JAX or
anything of ``fedml_tpu``, and every Pallas kernel on a ported path is a
hand-written Hopper kernel under ``ops/csrc``. Entry points take
``device=`` and default to ``"cuda"``; the CPU runs only when asked for.

Ported so far: the serving path of the flash-attention TransformerLM
(``serving.ServingEngine`` over ``serving.ModelEndpoint``,
``models.create`` and the flash-attention forward kernel). ROADMAP.md
lists the slices still to come.
"""
