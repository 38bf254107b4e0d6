"""The compiled-artifact audit plane of the port: the registry and the
fake-tensor trace under ``python -m fedml_tpu_torch.cli audit`` (port of
``fedml_tpu/analysis/compiled.py``).

``cli lint`` checks what the source says. The audit checks what the hot
executables do when they run, without running them:

- hot-path modules REGISTER their executables with :func:`auditable`,
  either on a module-level function (with an ``abstract_inputs``
  builder of fake-tensor arguments) or on a *provider* that builds the
  executable with the same builder the runtime uses (``build_round_fn``,
  ``build_group_fn``, ``build_forward``, ``build_mesh_forward``) and
  returns :class:`LoweringCase`\\s across the pow2 shape census;
- the auditor (``analysis/audit.py``) traces every case once
  (:func:`lower_case`). Eager PyTorch has no ``jit(...).lower``: its
  counterpart here is a run of the case under ``FakeTensorMode`` on fake
  tensors, with a ``TorchDispatchMode`` recorder inside that sees every
  aten op. **Nothing executes and nothing is allocated**; no card is
  touched. From the recorded ops come the host transfers, the
  constants copied onto the card inside the body, and a static cost
  (FLOPs and bytes) counted by the rules of XLA's cost analysis, so
  that the two packages' reports compare.

The fake tensors stand for the card but sit on the ``meta`` device:
``device="cuda"`` cannot be traced without touching a card. A CPU-only
build has no CUDA device guard, so Python indexing of a fake CUDA
tensor raises; a CUDA build with no card visible fails in autograd,
whose device threads ask for device 0's primary context; with a card
visible, the device guard and those threads set the device, which
creates its context. On ``meta`` the trace is the same on every build.
The hand-written kernels' wrappers see a fake tensor and record one op
under the kernel's name in place of a launch (``ops/_build.py``
``Kernel.trace``), as they would on the card's path.

Import discipline: importing THIS module must not import torch, as
importing the JAX module does not import JAX: ``cli`` builds its parser
from the audit module. torch loads inside :class:`AuditContext`'s
factories and inside :func:`lower_case`; the registered host modules
(which import torch at their top) are imported on demand by
:func:`load_registry`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "AUDITED_MODULES",
    "AuditContext",
    "AuditableSpec",
    "LoweredArtifact",
    "LoweringCase",
    "auditable",
    "load_registry",
    "lower_case",
    "pow2_budget",
]

# the modules that register auditable executables; load_registry()
# imports each so their @auditable declarations run. Growing the hot
# path? Register the executable AND add its module here.
AUDITED_MODULES = (
    "fedml_tpu_torch.core.aggregation",
    "fedml_tpu_torch.simulation.fedavg_api",
    "fedml_tpu_torch.scale.engine",
    "fedml_tpu_torch.serving.endpoint",
    "fedml_tpu_torch.serving.mesh_endpoint",
)

# one line for the report: how the "lowering" was taken
LOWERING = ("a fake-tensor dispatch trace (FakeTensorMode + TorchDispatchMode): "
            "every op recorded, nothing executed or allocated")


def pow2_budget(sizes: Sequence[int]) -> int:
    """How many pow2 shape keys the span [min(sizes), max(sizes)]
    legitimately needs: the census rule's budget (8..512 -> 7)."""
    lo, hi = min(sizes), max(sizes)
    return int(math.log2(max(hi, 1) // max(lo, 1))) + 1


@dataclass
class LoweringCase:
    """One (executable, fake inputs) pair: a single shape key of a
    registered executable's census. ``fn`` is called once under the
    fake trace, never on real tensors."""

    key: str  # census key, e.g. "b8" / "b8xnb4"
    fn: Any
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AuditableSpec:
    """One registered executable: how to build its census cases and
    which contracts it is held to."""

    name: str
    path: str  # repo-relative module path (baseline key namespace)
    provider: Callable[["AuditContext"], List[LoweringCase]]
    # round-shaped executables (carried state in, carried state out):
    # their rows make the report's roofline
    round_shaped: bool = False
    # hot executables must make the card wait for the host nowhere
    hot: bool = True
    # census rule: max traced shape keys (int, or callable(ctx) -> int);
    # None skips the census check for this spec
    census_budget: Any = None
    # aot-constant rule: largest tolerated non-splat host constant
    constant_budget_bytes: int = 64 * 1024


_REGISTRY: Dict[str, AuditableSpec] = {}


def _module_to_path(module: str) -> str:
    return module.replace(".", "/") + ".py"


def auditable(
    name: str,
    abstract_inputs: Optional[Callable[["AuditContext"], List[Tuple]]] = None,
    *,
    round_shaped: bool = False,
    hot: bool = True,
    census_budget: Any = None,
    constant_budget_bytes: int = 64 * 1024,
):
    """Register an executable with the auditor.

    Two application forms, as in the JAX package:

    - on a module-level function, with ``abstract_inputs``: a function
      ``ctx -> [(case_key, args, kwargs), ...]`` of fake-tensor
      arguments (``ctx.sds``); the decorated function itself is traced
      for each tuple;
    - on a *provider* ``ctx -> [LoweringCase, ...]`` (no
      ``abstract_inputs``), for executables the runtime builds per
      instance (the round, the planet group, the served forward): the
      provider builds them through the module-level builders the
      runtime uses.

    The JAX decorator's ``donate`` claim has no counterpart: PyTorch has
    no input-output aliasing contract to check (``analysis/audit.py``).
    Returns the decorated object unchanged: no runtime cost.
    """

    def register(obj):
        if abstract_inputs is not None:
            def provider(ctx, _fn=obj):
                return [
                    LoweringCase(key=k, fn=_fn, args=tuple(a), kwargs=dict(kw))
                    for k, a, kw in abstract_inputs(ctx)
                ]
        else:
            provider = obj
        module = getattr(obj, "__module__", None) or "fedml_tpu_torch"
        _REGISTRY[name] = AuditableSpec(
            name=name,
            path=_module_to_path(module),
            provider=provider,
            round_shaped=round_shaped,
            hot=hot,
            census_budget=census_budget,
            constant_budget_bytes=int(constant_budget_bytes),
        )
        return obj

    return register


def load_registry() -> Dict[str, AuditableSpec]:
    """Import every audited module (running their ``@auditable``
    registrations) and return the registry. torch loads here, never at
    ``fedml_tpu_torch.analysis`` import time."""
    import importlib

    for mod in AUDITED_MODULES:
        importlib.import_module(mod)
    return dict(_REGISTRY)


# ---------------------------------------------------------------------
# audit context: the shared fake world every provider builds from
# ---------------------------------------------------------------------


# the device the fake tensors carry (see the module docstring)
FAKE_DEVICE = "meta"


@dataclass
class AuditContext:
    """The fake (data-free) world the census is traced against: the
    JAX package's sizes and model (logistic regression over
    ``feature_dim`` -> ``class_num``) plus fake-tensor factories. Small
    on purpose: the audit's subject is structure (host transfers,
    constants, shape keys, cost ratios), not model scale. All of a
    context's fake tensors belong to its one ``FakeTensorMode``; the
    mesh providers share its world of one rank (:meth:`mesh`), which
    :meth:`close` takes down."""

    cohort_buckets: Tuple[int, ...] = (8, 32)
    nb_census: Tuple[int, ...] = (2, 4)
    batch_size: int = 4
    feature_dim: int = 8
    class_num: int = 4
    serve_buckets: Tuple[int, ...] = (4, 16)
    edge_num: int = 2
    epochs: int = 1
    learning_rate: float = 0.03

    _model: Any = field(default=None, repr=False)
    _params: Any = field(default=None, repr=False)
    _mode: Any = field(default=None, repr=False)
    _world: bool = field(default=False, repr=False)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "cohort_buckets": list(self.cohort_buckets),
            "nb_census": list(self.nb_census),
            "batch_size": self.batch_size,
            "feature_dim": self.feature_dim,
            "class_num": self.class_num,
            "serve_buckets": list(self.serve_buckets),
            "edge_num": self.edge_num,
            "epochs": self.epochs,
        }

    # -- the fake world ------------------------------------------------
    def fake_mode(self):
        """The context's ``FakeTensorMode``; every factory makes its
        tensors in it."""
        if self._mode is None:
            from torch._subclasses.fake_tensor import FakeTensorMode

            # a tensor made on the meta device is not fake: take it in
            self._mode = FakeTensorMode(allow_non_fake_inputs=True)
        return self._mode

    def mesh(self):
        """The fed ``{data: 1, fsdp: 1}`` ``SimMesh`` of the mesh
        providers, over a world of one rank on torch's ``fake`` backend
        (a process group that moves no data), made here once: no real
        backend ever sees a fake tensor. The audit runs outside any
        process group; ``close`` takes the world down."""
        import torch.distributed as dist

        from ..parallel.layout import build_fed_mesh

        if not self._world:
            if dist.is_initialized():
                raise RuntimeError(
                    "the audit traces the mesh executables over a world of one rank of "
                    "its own; run it outside a torch.distributed process group"
                )
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
            self._world = True
        return build_fed_mesh({"data": 1, "fsdp": 1}, 1, "cpu")

    def close(self) -> None:
        """Take down the world of :meth:`mesh`, if this context made one."""
        if self._world:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._world = False

    # -- model ---------------------------------------------------------
    def model(self):
        """The zoo's logistic regression, its module on the ``meta``
        device (its own weights are never read: every executable takes
        the params as an argument)."""
        if self._model is None:
            import torch

            from ..models.linear import LogisticRegression
            from ..models.spec import FedModel

            with torch.device("meta"):
                module = LogisticRegression(self.feature_dim, self.class_num)
            self._model = FedModel(name="lr", module=module,
                                   example_shape=(self.feature_dim,))
        return self._model

    def abstract_params(self):
        """The model's params dict (``Dense_0/weight`` ...) as fake
        tensors of their shapes and dtypes: nothing initializes."""
        if self._params is None:
            self._params = {
                name.replace(".", "/"): self.sds(tuple(p.shape), p.dtype)
                for name, p in self.model().module.named_parameters()
            }
        return self._params

    def local_train_fn(self):
        """The stock local training over the audit model (plain SGD,
        the shuffle on), built by the factory the runtime uses."""
        from ..core.local_trainer import make_local_train_fn
        from ..core.optimizers import sgd

        model = self.model()
        return make_local_train_fn(model.apply, model.loss_fn, sgd(self.learning_rate),
                                   epochs=self.epochs)

    # -- fake-tensor factories ----------------------------------------
    def sds(self, shape, dtype="float32"):
        """A fake tensor of ``shape`` and ``dtype`` (a torch dtype or its
        name) on the fake device: the counterpart of a
        ``jax.ShapeDtypeStruct``."""
        import torch

        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        with self.fake_mode():
            return torch.empty(tuple(shape), dtype=dt, device=FAKE_DEVICE)

    def abstract_uniforms(self, clients: int, nb: Optional[int] = None):
        """The shuffle's uniforms ``[C, epochs, nb * bs]`` (``nb``
        defaults to the packed federation's): what the port's round
        threads where the JAX round threads a PRNG key."""
        nb = max(self.nb_census) if nb is None else nb
        return self.sds((clients, self.epochs, nb * self.batch_size))

    def abstract_batches(self, *lead: int):
        """A packed ``Batches`` of fake tensors with the given leading
        axes (e.g. the federation's size)."""
        from ..core.types import Batches

        nb, bs, f = max(self.nb_census), self.batch_size, self.feature_dim
        return Batches(
            x=self.sds(tuple(lead) + (nb, bs, f)),
            y=self.sds(tuple(lead) + (nb, bs), "int64"),
            mask=self.sds(tuple(lead) + (nb, bs)),
        )

    def abstract_group_batches(self, clients: int, nb: int):
        """Group-shaped ``Batches`` for the planet engine's (bucket,
        nb) groups."""
        from ..core.types import Batches

        bs, f = self.batch_size, self.feature_dim
        return Batches(
            x=self.sds((clients, nb, bs, f)),
            y=self.sds((clients, nb, bs), "int64"),
            mask=self.sds((clients, nb, bs)),
        )

    def abstract_params_f32(self):
        """The params re-typed to float32: the fold and term currency."""
        return {k: self.sds(tuple(v.shape)) for k, v in self.abstract_params().items()}


# ---------------------------------------------------------------------
# the trace: the recorder and the cost rules
# ---------------------------------------------------------------------

# elementwise arithmetic: one FLOP an output element (XLA's
# HandleElementwiseOp); in-place forms fold onto these names. XLA counts
# transcendentals (exp, log, tanh, ...) apart from FLOPs, so they cost none
_ELEMENTWISE = frozenset((
    "abs", "add", "addcdiv", "addcmul", "bitwise_and", "bitwise_not", "bitwise_or",
    "bitwise_xor", "ceil", "clamp", "clamp_max", "clamp_min", "copysign", "div", "eq",
    "floor", "floor_divide", "fmod", "ge", "gt", "le", "lerp", "logical_and", "logical_not",
    "logical_or", "logical_xor", "lt", "maximum", "minimum", "mul", "ne", "neg", "pow",
    "reciprocal", "relu", "remainder", "round", "rsub", "sgn", "sign", "square", "sub",
    "threshold_backward", "trunc", "where",
))
# reductions: one FLOP an input element
_REDUCTION = frozenset((
    "all", "amax", "amin", "any", "argmax", "argmin", "cumprod", "cumsum", "logsumexp",
    "max", "mean", "min", "nansum", "prod", "std", "sum", "var",
))
# FLOPs an input element of the fused forms XLA lowers as several ops:
# a norm squares and sums; a softmax takes a max, subtracts, sums and
# divides (or subtracts a log); their backwards multiply, sum, subtract
_COMPOSITE = {
    "linalg_vector_norm": 2, "norm": 2,
    "_softmax": 4, "_log_softmax": 4,
    "_softmax_backward_data": 3, "_log_softmax_backward_data": 3,
    "nll_loss_forward": 1, "nll_loss_backward": 1,
}
# products whose torch formula leaves out an elementwise add of the output
_WITH_ADD = frozenset(("addmm", "baddbmm"))
# ops that move no bytes (metadata, allocation, the trace's own plumbing)
_FREE = frozenset((
    "_local_scalar_dense", "alias", "detach", "device", "empty", "empty_like",
    "empty_strided", "lift_fresh", "lift_fresh_copy", "new_empty", "new_empty_strided",
    "resize_", "set_",
))
# ops whose output shape depends on the values: the card must report
# them to the host before anything after them can be sized
_DATA_DEPENDENT = frozenset((
    "_unique2", "masked_select", "nonzero", "unique_consecutive", "unique_dim",
))
_LIFTS = frozenset(("lift_fresh", "lift_fresh_copy"))


@dataclass
class LoweredArtifact:
    """Everything the checkers need from one traced case. The JAX
    donation fields (``aliased_inputs``, ``claimed_donated_leaves``)
    are None: PyTorch has no aliasing contract to read them from."""

    spec_name: str
    case_key: str
    aliased_inputs: Optional[int]
    claimed_donated_leaves: Optional[int]
    host_transfers: List[str]  # the ops that make the card wait for the host
    constants_bytes: List[int]  # NON-SPLAT host data made into tensors, bytes
    flops: Optional[float]
    bytes_accessed: Optional[float]
    kernels: Dict[str, int] = field(default_factory=dict)  # hand kernels traced
    real_inputs: List[str] = field(default_factory=list)  # ops that met a real tensor

    @property
    def max_constant_bytes(self) -> int:
        return max(self.constants_bytes, default=0)


class _Trace:
    """The running record of one case."""

    def __init__(self) -> None:
        self.host: set = set()
        self.constants: List[int] = []
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, int] = {}
        self.real: List[str] = []

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """A hand kernel's wrapper in place of its launch (``ops/_build``)."""
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self.flops += float(flops)
        self.bytes += float(nbytes)


def _leaves(tree) -> List[Any]:
    from torch.utils._pytree import tree_leaves

    return tree_leaves(tree)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensor_leaves(tree) -> list:
    import torch

    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _zero_of(dtype):
    """The recorder's answer to a scalar read: a zero of ``dtype``."""
    import torch

    if dtype == torch.bool:
        return False
    return 0.0 if (dtype.is_floating_point or dtype.is_complex) else 0


def _data_dependent_stand_in(name: str, args, kwargs):
    """Outputs of a data-dependent op at their largest shapes, so that
    the trace goes on past it."""
    import torch

    x = args[0]
    dev = x.device
    n = x.numel()
    if name == "nonzero":
        return torch.empty((n, x.dim()), dtype=torch.int64, device=dev)
    if name == "masked_select":
        n = torch.broadcast_shapes(x.shape, args[1].shape).numel()
        return torch.empty((n,), dtype=x.dtype, device=dev)
    # the unique family: (values, inverse, counts)
    return (torch.empty((n,), dtype=x.dtype, device=dev),
            torch.empty(tuple(x.shape), dtype=torch.int64, device=dev),
            torch.empty((n,), dtype=torch.int64, device=dev))


def _recorder_mode(trace: _Trace):
    """A ``TorchDispatchMode`` that records every op of the case into
    ``trace`` and answers the ops a fake tensor cannot."""
    import torch
    from torch._subclasses.fake_tensor import is_fake
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    scalar_read = torch.ops.aten._local_scalar_dense.default
    implicit = torch._C.DispatchKey.CompositeImplicitAutograd

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace == "aten" and torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), implicit):
                # a composite that reached the mode whole (inference mode
                # skips autograd's decomposition): record its parts
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            packet = func.overloadpacket
            name = packet.__name__
            base = name[:-1] if name.endswith("_") and name != "resize_" else name
            ins = _tensor_leaves((args, kwargs))
            if name not in _LIFTS and any(not is_fake(t) and t.device.type != "meta"
                                          for t in ins):
                trace.real.append(f"aten.{name}")
            if func is scalar_read:  # .item(), float(t), bool(t), int(t)
                trace.host.add("aten._local_scalar_dense")
                return _zero_of(args[0].dtype)
            if name in _DATA_DEPENDENT:
                trace.host.add(f"aten.{name}")
                return _data_dependent_stand_in(name, args, kwargs)
            out = func(*args, **kwargs)
            if name == "_to_copy":
                dst = kwargs.get("device")
                if dst is not None and args[0].device.type != "cpu" \
                        and torch.device(dst).type == "cpu":
                    trace.host.add("aten._to_copy (card to host)")
            elif name == "copy_" and args[1].device.type != "cpu" \
                    and args[0].device.type == "cpu":
                trace.host.add("aten.copy_ (card to host)")
            if func.is_view or name in _FREE:
                return out
            outs = _tensor_leaves(out)
            trace.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            n_out = sum(t.numel() for t in outs)
            n_in = ins[0].numel() if ins else 0
            if packet in flop_registry:
                trace.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
                if base in _WITH_ADD:
                    trace.flops += n_out
            elif base in _ELEMENTWISE:
                trace.flops += n_out
            elif base in _REDUCTION:
                trace.flops += n_in
            elif base in _COMPOSITE:
                trace.flops += _COMPOSITE[base] * n_in
            return out

    return _Recorder()


def _flat_values(data) -> list:
    """The values of host data (a number, a nested list or tuple, or an
    array with ``ravel``) in order."""
    if hasattr(data, "ravel"):
        return list(data.ravel().tolist())
    if isinstance(data, (list, tuple)):
        return [v for item in data for v in _flat_values(item)]
    return [data]


def _is_splat(data) -> bool:
    """True for host data that is one value repeated (XLA's splat): a
    fill, free as in the JAX parser."""
    values = _flat_values(data)
    return len(values) <= 1 or all(v == values[0] for v in values)


def _host_data_mode(trace: _Trace):
    """A ``TorchFunctionMode`` that counts the host data made into a
    tensor inside the body (``torch.tensor`` / ``as_tensor`` /
    ``asarray`` / ``Tensor.new_tensor`` of a list, a number or an array):
    the port's baked-in constant, copied onto the card on every call."""
    import torch
    from torch.overrides import TorchFunctionMode

    makers = {torch.tensor, torch.as_tensor, torch.asarray, torch.Tensor.new_tensor}

    class _HostData(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func in makers:
                data = args[1] if func is torch.Tensor.new_tensor else (
                    args[0] if args else kwargs.get("data"))
                if (not isinstance(data, torch.Tensor) and isinstance(out, torch.Tensor)
                        and not _is_splat(data)):
                    trace.constants.append(_nbytes(out))
            return out

    return _HostData()


def _mode_of(case: LoweringCase):
    """The ``FakeTensorMode`` the case's fake inputs belong to (a new one
    when it has none)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    for t in _leaves((case.args, case.kwargs)):
        if isinstance(t, FakeTensor):
            return t.fake_mode
    return FakeTensorMode()


def lower_case(spec: AuditableSpec, case: LoweringCase) -> LoweredArtifact:
    """Trace one case once under its fake mode (nothing executes) and
    read the contracts and the static cost off the recorded ops."""
    from ..ops import _build

    if not callable(case.fn):
        raise TypeError(f"auditable '{spec.name}' case '{case.key}': fn is not callable")
    trace = _Trace()
    mode = _mode_of(case)
    with _build.tracing(trace.kernel), mode, _host_data_mode(trace), _recorder_mode(trace):
        case.fn(*case.args, **case.kwargs)
    return LoweredArtifact(
        spec_name=spec.name,
        case_key=case.key,
        aliased_inputs=None,
        claimed_donated_leaves=None,
        host_transfers=sorted(trace.host),
        constants_bytes=list(trace.constants),
        flops=trace.flops,
        bytes_accessed=trace.bytes,
        kernels=dict(trace.kernels),
        real_inputs=list(trace.real),
    )
