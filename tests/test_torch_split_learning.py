"""SplitNN, FedGKT and VFL through the port against the JAX package.

Both packages train on the same packed arrays (the JAX loader's) from
the same initial params (carried across by ``convert.params_from_flax``,
FedGKT's personal nets in its stacked mode), in float64, where they
agree to rounding (1e-10): SplitNN, FedGKT (round 0 without the KD
term, round 1 with it) and VFL for 2 rounds each. Also: SplitNN's
boundary gradient equals joint backprop through bottom and top; the GKT
KL is 0 for equal logits; every VFL party's params move in round 0; VFL
party CSVs are read and split as the JAX package does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import split_learning as jax_split
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.simulation import FedGKTAPI, SplitNNAPI, VFLAPI
from fedml_tpu_torch.simulation.split_learning import kl_loss, masked_ce
from test_torch_hier_decentralized import (
    _f64,
    _set,
    _torch,
    api_pair,
    assert_params_close,
    compare_history,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CIFAR = dict(dataset="cifar10", synthetic_train_size=48, synthetic_test_size=16,
             partition_method="hetero", partition_alpha=0.5, client_num_in_total=3,
             client_num_per_round=2, comm_round=2, epochs=1, batch_size=8,
             learning_rate=0.05, frequency_of_the_test=1, shuffle=False, random_seed=2)


# -- SplitNN ------------------------------------------------------------------


def test_splitnn_two_rounds_match_jax():
    with jax.enable_x64(True):
        japi, tapi, _ = api_pair(jax_split.SplitNNAPI, SplitNNAPI, CIFAR,
                              federated_optimizer="SplitNN", momentum=0.9)
        japi.bottom_params, japi.top_params = _f64(japi.bottom_params), _f64(japi.top_params)
        japi.opt_b_state = japi.opt_b.init(japi.bottom_params)
        japi.opt_t_state = japi.opt_t.init(japi.top_params)
        sb, st = _torch(japi.bottom_params), _torch(japi.top_params)
        japi.train()
        wb, wt = _torch(japi.bottom_params), _torch(japi.top_params)
    tapi.bottom_params, tapi.top_params = dict(sb), dict(st)
    tapi.opt_b_state = tapi.opt_b.init(tapi.bottom_params)
    tapi.opt_t_state = tapi.opt_t.init(tapi.top_params)
    tapi.train()
    assert_params_close(tapi.bottom_params, wb)
    assert_params_close(tapi.top_params, wt)
    # the bottom's own head is off the split path: it never moves
    assert torch.equal(tapi.bottom_params["Dense_0/weight"], sb["Dense_0/weight"])
    compare_history(tapi.history, japi.history, ("train_loss", "test_loss", "test_acc"))


def test_splitnn_boundary_gradient_is_joint_backprop():
    args = _set(Arguments(), **dict(CIFAR, federated_optimizer="SplitNN"))
    ds = fedml_tpu_torch.data.load(args, device="cpu")
    api = SplitNNAPI(args, "cpu", ds)
    b = ds.packed_train
    x, y, m = b.x[0, 0], b.y[0, 0], b.mask[0, 0]
    _, _, g_bottom, g_top, _ = api.boundary_grads(api.bottom_params, api.top_params, x, y, m)

    def joint(pb, pt):
        feats, _ = api.bottom.apply(pb, x)
        return masked_ce(api.top.apply(pt, feats), y, m)[0]

    jb, jt = torch.func.grad(joint, argnums=(0, 1))(api.bottom_params, api.top_params)
    for got, want in ((g_bottom, jb), (g_top, jt)):
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=0)


# -- FedGKT --------------------------------------------------------------------


def test_fedgkt_two_rounds_match_jax():
    kw = dict(federated_optimizer="FedGKT", gkt_server_stages=(1, 1, 1), gkt_alpha=0.5)
    with jax.enable_x64(True):
        japi, tapi, _ = api_pair(jax_split.FedGKTAPI, FedGKTAPI, CIFAR, **kw)
        japi.client_params = _f64(japi.client_params)
        japi.server_params = _f64(japi.server_params)
        japi.opt_c_states = jax.vmap(japi.opt_c.init)(japi.client_params)
        japi.opt_s_state = japi.opt_s.init(japi.server_params)
        japi.server_logits = japi.server_logits.astype(jnp.float64)
        sc = params_from_flax(jax.tree.map(np.asarray, japi.client_params), stacked=True)
        ss = _torch(japi.server_params)
        japi.train()
        wc = params_from_flax(jax.tree.map(np.asarray, japi.client_params), stacked=True)
        ws = _torch(japi.server_params)
        wl = np.asarray(japi.server_logits)
    tapi.client_params, tapi.server_params = dict(sc), dict(ss)
    tapi.opt_c_states = tapi.init_client_states()
    tapi.opt_s_state = tapi.opt_s.init(tapi.server_params)
    tapi.server_logits = tapi.server_logits.to(torch.float64)
    tapi.train()
    assert_params_close(tapi.client_params, wc)
    assert_params_close(tapi.server_params, ws)
    np.testing.assert_allclose(tapi.server_logits.numpy(), wl, atol=1e-10, rtol=0)
    compare_history(tapi.history, japi.history,
                     ("train_loss", "server_loss", "test_loss", "test_acc"))


def test_gkt_kl_is_zero_for_equal_logits():
    z = torch.randn(5, 7, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    m = torch.ones(5, dtype=torch.float64)
    assert abs(float(kl_loss(z, z, m, 3.0))) < 1e-15
    assert float(kl_loss(z, z.flip(0), m, 3.0)) > 0


# -- VFL -----------------------------------------------------------------------------


MNIST = dict(CIFAR, dataset="mnist", model="lr", federated_optimizer="VFL", vfl_parties=3,
             vfl_rep_dim=6)


def test_vfl_two_rounds_match_jax():
    with jax.enable_x64(True):
        japi, tapi, _ = api_pair(jax_split.VFLAPI, VFLAPI, MNIST)
        japi.party_params = [_f64(p) for p in japi.party_params]
        japi.top_params = _f64(japi.top_params)
        japi.opt_states = [japi.opt.init(p) for p in japi.party_params]
        japi.opt_top_state = japi.opt.init(japi.top_params)
        sp = [_torch(p) for p in japi.party_params]
        stop = _torch(japi.top_params)
        japi.train()
        wp = [_torch(p) for p in japi.party_params]
        wtop = _torch(japi.top_params)
    assert tapi.n_parties == 3 and [x.shape[-1] for x in tapi._train[0]] == [262, 261, 261]
    tapi.party_params, tapi.top_params = [dict(p) for p in sp], dict(stop)
    tapi.opt_states = [tapi.opt.init(p) for p in tapi.party_params]
    tapi.opt_top_state = tapi.opt.init(tapi.top_params)
    tapi.run_round(0)
    for k in range(3):  # every party's params move in round 0
        assert all(not torch.equal(tapi.party_params[k][n], sp[k][n]) for n in sp[k]), k
    tapi.history.clear()
    tapi.party_params, tapi.top_params = [dict(p) for p in sp], dict(stop)
    tapi.opt_states = [tapi.opt.init(p) for p in tapi.party_params]
    tapi.opt_top_state = tapi.opt.init(tapi.top_params)
    tapi.train()
    for got, want in zip(tapi.party_params, wp):
        assert_params_close(got, want)
    assert_params_close(tapi.top_params, wtop)
    compare_history(tapi.history, japi.history, ("train_loss", "test_loss", "test_acc"))


def test_vfl_reads_party_csvs_as_jax_does(tmp_path):
    rng = np.random.default_rng(4)
    d = tmp_path / "vflset"
    d.mkdir()
    n = 30
    labels = rng.integers(0, 3, n)
    with open(d / "party_0.csv", "w") as f:
        f.write("id,label,a,b\n")
        for i in range(n):
            f.write(f"{i},{labels[i]},{rng.normal():.4f},{rng.normal():.4f}\n")
    with open(d / "party_1.csv", "w") as f:
        f.write("id,c,d,e\n")
        for i in range(n):
            f.write(f"{i},{rng.normal():.4f},{rng.normal():.4f},{rng.normal():.4f}\n")
    kw = dict(MNIST, data_cache_dir=str(tmp_path), dataset="vflset", client_num_in_total=2,
              client_num_per_round=2)
    args = _set(Arguments(), **kw)
    ds = fedml_tpu_torch.data.load(args, device="cpu")
    api = VFLAPI(args, "cpu", ds)
    jargs = _set(JaxArguments(), **kw)
    japi = jax_split.VFLAPI(jargs, None, jax_load(jargs))
    assert api.n_parties == japi.n_parties == 2
    for (g, w) in ((api._train, japi._train), (api._test, japi._test)):
        for gx, wx in zip(g[0], w[0]):
            assert np.array_equal(gx.numpy(), np.asarray(wx))
        assert np.array_equal(g[1].numpy(), np.asarray(w[1]))
        assert np.array_equal(g[2].numpy(), np.asarray(w[2]))
    assert np.isfinite(api.train()["train_loss"])




def test_splitnn_momentum_fallback_is_unreachable_as_in_jax():
    """A fault of the reference, kept: SplitNN reads ``getattr(args,
    "momentum", 0.9)``, but ``Arguments`` always sets ``momentum`` (0.0),
    so a configuration that does not name it trains without momentum in
    both packages, never at the 0.9 the fallback suggests."""
    kw = dict(CIFAR, federated_optimizer="SplitNN")
    args = _set(Arguments(), **kw)
    api = SplitNNAPI(args, "cpu", fedml_tpu_torch.data.load(args, device="cpu"))
    jargs = _set(JaxArguments(), **kw)
    japi = jax_split.SplitNNAPI(jargs, None, jax_load(jargs))
    assert args.momentum == jargs.momentum == 0.0
    assert jax.tree.leaves(japi.opt_b_state) == []
    assert torch.utils._pytree.tree_leaves(api.opt_b_state) == []
