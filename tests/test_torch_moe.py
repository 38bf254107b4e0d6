"""The Switch-MoE transformer and the expert-parallel plane, port against
the JAX package (``fedml_tpu/models/moe.py``, ``parallel/expert.py``).

The same seeded numpy tokens go through both packages' SwitchFFN and
MoETransformerLM, the JAX weights carried across with
``convert.params_from_flax``: outputs, the sown aux loss and slot
occupancy in f32 to ``ATOL``; in float64 the router still takes an f32
softmax (flax promotes the f32 router input with a float64 kernel to
float64 logits, then the layer casts them to f32), so float64 agrees to
``F64_ATOL``, the f32 rounding of the gates, not to 1e-12. The
ep- and tp x ep-sharded layers run in spawned gloo worlds
(``torch_world.py``) and are held to the same layer in one process: same
logits and gradients to ``SHARD_ATOL`` plus ``SHARD_RTOL`` of the value
(the all-reduces add partial sums in another order: an embedding
gradient of ~12 read 1.9e-5 apart).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from fedml_tpu.models.moe import MoETransformerLM as JaxMoE
from fedml_tpu.models.moe import SwitchFFN as JaxSwitchFFN
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.models.moe import MoETransformerLM, SwitchFFN, collect
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
F64_ATOL = 1e-6
SHARD_ATOL = 1e-5
SHARD_RTOL = 1e-5
GRAD_ATOL = 1e-6


def _switch_pair(E, cf, C=8, seed=0, B=2, T=12, dtype=np.float32):
    """(x, JAX output, aux, occupancy, port SwitchFFN with the JAX weights)."""
    x = np.random.default_rng(seed).normal(size=(B, T, C)).astype(dtype)
    jm = JaxSwitchFFN(num_experts=E, capacity_factor=cf)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    y, mods = jm.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    inter = mods["intermediates"]
    port = SwitchFFN(C, E, cf).to(torch.float64 if dtype == np.float64 else torch.float32)
    named = {k.replace("/", "."): v for k, v in params_from_flax(
        jax.tree.map(np.asarray, params)).items()}
    port.load_state_dict(named)
    return (x, np.asarray(y), float(inter["moe_aux_loss"][0]),
            np.asarray(inter["moe_slot_occupancy"][0]), port)


def _port_switch(port, x):
    with collect(port) as sink, torch.no_grad():
        y = port(torch.tensor(x))
    return y.detach().numpy(), float(sink["moe_aux_loss"][0]), sink["moe_slot_occupancy"][0].numpy()


def test_single_expert_is_the_dense_mlp():
    """E = 1 at full capacity: every token kept, gate 1, so the layer is
    gelu(x wi + bi) wo + bo."""
    x, want, _, _, port = _switch_pair(E=1, cf=1.0)
    got, aux, occ = _port_switch(port, x)
    xt = torch.tensor(x)
    dense = torch.nn.functional.gelu(xt @ port.wi[0] + port.bi[0], approximate="tanh") @ \
        port.wo[0] + port.bo[0]
    np.testing.assert_allclose(got, dense.detach().numpy(), atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(1.0) and occ.sum() == x.shape[0] * x.shape[1]


@pytest.mark.parametrize("E, cf", [(4, 4.0), (4, 0.5), (3, 1.0)])
def test_routing_and_overflow_match_jax(E, cf):
    """Full capacity (cf = E: nothing dropped) and overflow (cf 0.5: the
    tokens past an expert's capacity leave it with zero output), aux loss
    and slot occupancy too."""
    x, want, want_aux, want_occ, port = _switch_pair(E, cf, seed=E)
    got, aux, occ = _port_switch(port, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(want_aux, abs=1e-6)
    np.testing.assert_array_equal(occ, want_occ)
    N = x.shape[0] * x.shape[1]
    dropped = np.abs(got).reshape(N, -1).sum(-1) == 0
    assert dropped.sum() == N - occ.sum()
    if cf >= E:
        assert occ.sum() == N
    if cf < 1:
        assert occ.sum() < N


def test_bf16_dispatch_is_exact_past_256_tokens_an_expert():
    """600 tokens over 2 experts in bf16: capacity positions past 256
    stay exact (the f32 cumsum), every slot holds one token, and the
    routing is the f32 input's."""
    x, want, _, want_occ, port = _switch_pair(E=2, cf=1.0, C=8, B=1, T=600, seed=7)
    bf = port.to(torch.bfloat16)
    with collect(bf) as sink:
        got = bf(torch.tensor(x).to(torch.bfloat16)).float().detach().numpy()
    occ = sink["moe_slot_occupancy"][0].numpy()
    assert set(np.unique(occ)) <= {0.0, 1.0}
    assert occ.sum(-1).max() > 256
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jm = JaxSwitchFFN(num_experts=2, capacity_factor=1.0)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jm.init(jax.random.PRNGKey(7), xb)[
        "params"])
    jy, mods = jm.apply({"params": jparams}, xb, mutable=["intermediates"])
    np.testing.assert_array_equal(occ, np.asarray(mods["intermediates"]["moe_slot_occupancy"][0]))
    np.testing.assert_allclose(got, np.asarray(jy.astype(jnp.float32)), atol=0.05)
    del want, want_occ


def _onehot_switch(layer, x, ep=None):
    """The layer's function by the JAX package's route: 0/1 dispatch and
    gate-weighted combine tensors [N, E, cap] and the dispatch and combine
    einsums, on the layer's own weights (``ep`` = (start, count): those
    experts' slots alone, the partial output)."""
    import math

    B, T, C = x.shape
    N, E = B * T, layer.num_experts
    cap = max(1, math.ceil(N / E * layer.capacity_factor))
    xf = x.reshape(N, C)
    probs = torch.softmax(torch.nn.functional.linear(xf.float(), layer.router.weight.float()), -1)
    onehot = (probs.argmax(-1)[:, None] == torch.arange(E)).float()
    pos = (torch.cumsum(onehot, 0) - 1.0) * onehot
    keep = onehot * (pos < cap)
    disp = (keep[..., None] * (pos.long()[..., None] == torch.arange(cap)).float()).to(x.dtype)
    wi, bi, wo, bo = layer.wi, layer.bi, layer.wo, layer.bo
    if ep is not None:
        e0, n = ep
        disp, wi, bi, wo, bo = (t[..., e0:e0 + n, :] if t is disp else t[e0:e0 + n]
                                for t in (disp, wi, bi, wo, bo))
    combine = disp * probs.amax(-1).to(x.dtype)[:, None, None]
    expert_in = torch.einsum("nec,nd->ecd", disp, xf)
    h = torch.nn.functional.gelu(torch.einsum("ecd,edh->ech", expert_in, wi) + bi[:, None],
                                 approximate="tanh")
    out = torch.einsum("ech,ehd->ecd", h, wo) + bo[:, None]
    return torch.einsum("nec,ecd->nd", combine, out).reshape(B, T, C)


@pytest.mark.parametrize("E, cf", [(4, 0.5), (3, 1.0), (4, 4.0)])
def test_index_routing_is_the_onehot_einsums(E, cf):
    """Routing by index (scatter into [E, cap, C], gather by expert and
    slot) against the one-hot einsums it replaced, on the same weights and
    tokens, with tokens dropped (cf 0.5) and not: the outputs bitwise in
    f32 (each einsum term is one product or a copy), the gradients to
    GRAD_ATOL (the gate's gradient sums its C products in another order);
    then split over two expert shards (``ep``, no group: the ranks' partial
    outputs summed here) to the same."""
    from fedml_tpu_torch.models.moe import ExpertShard

    torch.manual_seed(E)
    layer = SwitchFFN(8, E, cf)
    for p in (layer.wi, layer.wo, layer.bi, layer.bo):
        torch.nn.init.normal_(p, std=0.3)
    x = torch.tensor(np.random.default_rng(E).normal(size=(2, 12, 8)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor(np.random.default_rng(E + 1).normal(size=(2, 12, 8)).astype(np.float32))
    params = [x, *layer.parameters()]

    def value_and_grads(fn):
        y = fn()
        return y.detach(), torch.autograd.grad((y * w).sum(), params, allow_unused=True)

    got, got_g = value_and_grads(lambda: layer(x))
    want, want_g = value_and_grads(lambda: _onehot_switch(layer, x))
    assert torch.equal(got, want)
    if cf < 1:
        assert (got.abs().sum(-1) == 0).any()  # tokens were dropped
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)

    halves = [(0, E // 2), (E // 2, E - E // 2)]

    def sharded():
        ys = []
        for e0, n in halves:
            layer.ep = ExpertShard(None, e0, n)
            local = {k: v[e0:e0 + n] if k in ("wi", "bi", "wo", "bo") else v
                     for k, v in layer.named_parameters()}
            ys.append(torch.func.functional_call(layer, local, (x,)))
        layer.ep = None
        return ys[0] + ys[1]

    got, got_g = value_and_grads(sharded)
    want, want_g = value_and_grads(
        lambda: sum(_onehot_switch(layer, x, ep) for ep in halves))
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


def _lm_pair(dtype=np.float32, **kw):
    cfg = dict(vocab_size=50, num_layers=2, num_heads=2, embed_dim=16, max_len=32,
               num_experts=4, capacity_factor=1.0, moe_every=2)
    cfg.update(kw)
    tokens = np.random.default_rng(1).integers(0, 50, (3, 12)).astype(np.int32)
    jm = JaxMoE(**cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    if dtype == np.float64:
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    port = MoETransformerLM(**cfg)
    named = {k.replace("/", "."): v for k, v in params_from_flax(
        jax.tree.map(np.asarray, params)).items()}
    return tokens, jm, params, port, named


def test_moe_transformer_matches_jax_and_sows_where_jax_does():
    tokens, jm, params, port, named = _lm_pair()
    want, mods = jm.apply({"params": params}, jnp.asarray(tokens), mutable=["intermediates"])
    with collect(port) as sink:
        got = torch.func.functional_call(port, named, (torch.tensor(tokens),))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    jinter = mods["intermediates"]["Block_1"]["SwitchFFN_0"]
    assert len(sink["moe_aux_loss"]) == 1  # moe_every 2: Block_1 only
    assert float(sink["moe_aux_loss"][0]) == pytest.approx(float(jinter["moe_aux_loss"][0]),
                                                          abs=1e-6)


def test_float64_router_promotes_as_flax_does():
    """float64 params: the router's logits are float64, its softmax f32,
    both packages; the rest of the model float64."""
    tokens, jm, params, port, named = _lm_pair(np.float64)
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(tokens))
        assert want.dtype == jnp.float64
    got = torch.func.functional_call(port.double(), named, (torch.tensor(tokens),))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=F64_ATOL)


def test_remat_of_the_moe_transformer_is_bitwise_under_vmap_grad():
    """The FedAvg trainer's vmap(grad) through remat: the same gradients
    as without, and no batching fallback (one-hots are comparisons)."""
    tokens, _, _, port, named = _lm_pair(capacity_factor=2.0)
    remat = MoETransformerLM(vocab_size=50, num_layers=2, num_heads=2, embed_dim=16,
                             max_len=32, num_experts=4, capacity_factor=2.0, remat=True)
    x = torch.tensor(tokens)[None].expand(2, -1, -1)

    def loss(module):
        def f(p, xb):
            logits = torch.func.functional_call(module, p, (xb,))
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, 50), xb.roll(-1, 1).reshape(-1).long())
        return torch.func.vmap(torch.func.grad(f), in_dims=(None, 0))(named, x)

    plain, rematted = loss(port), loss(remat)
    for k in plain:
        assert torch.equal(plain[k], rematted[k]), k


def test_models_create_and_init_draw_flax_distributions():
    a = Arguments()
    for k, v in dict(model="moe_transformer", dataset="shakespeare", embed_dim=64,
                     num_heads=4, num_layers=2, num_experts=8, seq_len=16).items():
        setattr(a, k, v)
    m = models.create(a, 90, device="cpu")
    assert m.name == "moe_transformer_lm" and m.task == "nwp"
    p = m.init(torch.Generator().manual_seed(0))
    wi, wo = p["Block_1/SwitchFFN_0/wi"], p["Block_1/SwitchFFN_0/wo"]
    assert wi.shape == (8, 64, 256) and wo.shape == (8, 256, 64)
    # lecun normal with flax's fan_in over the stack: E * C and E * H
    assert float(wi.std()) == pytest.approx((8 * 64) ** -0.5, rel=0.05)
    assert float(wo.std()) == pytest.approx((8 * 256) ** -0.5, rel=0.05)
    assert not p["Block_1/SwitchFFN_0/bi"].any() and not p["Block_1/SwitchFFN_0/bo"].any()
    assert "Block_0/Dense_2/weight" in p and "Block_1/Dense_2/weight" not in p


# -- the expert- and tensor-parallel planes in gloo worlds -------------------


def _layer_case(mesh_shape, heads=2, E=4, vocab=50, C=16):
    knobs = dict(model="moe_transformer", num_layers=2, num_heads=heads, embed_dim=C,
                 seq_len=12, max_len=32, num_experts=E, capacity_factor=1.0, vocab_size=vocab)
    m = models.create(_args(knobs), vocab, device="cpu")
    params = {k: v.numpy() for k, v in m.init(torch.Generator().manual_seed(3)).items()}
    rng = np.random.default_rng(3)
    x = rng.integers(0, vocab, (2, 12)).astype(np.int64)
    w = rng.normal(size=(2, 12, vocab)).astype(np.float32)
    return {"mesh_shape": mesh_shape, "args": knobs, "vocab": vocab, "params": params,
            "x": x, "w": w}


def _args(knobs):
    a = Arguments()
    for k, v in knobs.items():
        setattr(a, k, v)
    a._validate()
    return a


def _one_process(case):
    """The same layer, logits and gradients, unsharded in this process."""
    m = models.create(_args(case["args"]), case["vocab"], device="cpu")
    p = {k: torch.tensor(v).requires_grad_() for k, v in case["params"].items()}
    with collect(m.module) as sink:
        logits = m.apply(p, torch.tensor(case["x"]))
    loss = (logits * torch.tensor(case["w"])).sum() + sum(sink["moe_aux_loss"], 0.0)
    grads = torch.autograd.grad(loss, list(p.values()))
    return logits.detach().numpy(), {k: g.numpy() for k, g in zip(p, grads)}


def _assert_same(got, case):
    logits, grads = _one_process(case)
    np.testing.assert_allclose(got["logits"], logits, rtol=SHARD_RTOL, atol=SHARD_ATOL)
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=SHARD_RTOL, atol=SHARD_ATOL,
                                   err_msg=k)


def test_ep_sharded_layer_is_the_replicated_one(tmp_path):
    """{ep: 2}: each rank holds 2 of the 4 experts and computes their
    slots; the partial combines are all-reduced."""
    case = _layer_case({"ep": 2})
    (got,) = torch_world.run_world(torch_world.layer, 2, {"cases": [case]}, tmp_path)[0]
    assert got["sharded"] == ["Block_1/SwitchFFN_0/bi", "Block_1/SwitchFFN_0/bo",
                              "Block_1/SwitchFFN_0/wi", "Block_1/SwitchFFN_0/wo"]
    assert got["local_shapes"]["Block_1/SwitchFFN_0/wi"] == (2, 16, 64)
    _assert_same(got, case)


def test_tp_ep_composition_and_the_indivisible_fallback(tmp_path):
    """{tp: 2, ep: 2}: the expert stacks ride ep, the dense layers the
    Megatron rules over tp. Then 3 heads, 3 experts and a vocabulary of
    51: the attention pairs, the experts and the head fall back to
    replicated (the MLP, 4C = 64, stays sharded); the function is the
    same either way."""
    composed = _layer_case({"tp": 2, "ep": 2})
    odd = _layer_case({"tp": 2, "ep": 2}, heads=3, E=3, vocab=51, C=24)
    got, got_odd = torch_world.run_world(torch_world.layer, 4,
                                         {"cases": [composed, odd]}, tmp_path)[0]
    assert "Block_0/Dense_0/weight" in got["sharded"] and "Dense_0/weight" in got["sharded"]
    assert "Block_1/SwitchFFN_0/wi" in got["sharded"]
    assert "Block_1/SwitchFFN_0/router/weight" not in got["sharded"]
    assert got["local_shapes"]["Block_0/Dense_0/weight"] == (24, 16)
    _assert_same(got, composed)
    assert got_odd["sharded"] == ["Block_0/Dense_2/bias", "Block_0/Dense_2/weight",
                                  "Block_0/Dense_3/weight"]
    _assert_same(got_odd, odd)
