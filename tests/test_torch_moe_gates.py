"""The port's MoE gate family (`paddle_tpu_torch.models.moe_gate`)
against the JAX package's on the CPU: the factory and the config's top_k
rules; `select_logits` and `keep_round` bit-equal to JAX for the same
key; the gates' behaviour inside the dispatch (Switch is top-1 at eval,
GShard without random routing is top-2, capacity drops, the router's
task gradient for every gate); the model-owned key stream of `MoEMLP`;
and `GPTMoE(gpt_moe_tiny(gate=...))` with JAX weights for every gate in
eval mode.

Tolerances: the hooks are bit-equal (the same threefry bits and f32
arithmetic); the eval-mode logits within 1e-4 (the GPT tolerance of
`test_torch_training.py`); dispatch results inside the port exact where
the routing is the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch.incubate as incubate
from paddle_tpu.models import moe as JM
from paddle_tpu.models import moe_gate as JG
from paddle_tpu_torch import random as R
from paddle_tpu_torch.models import moe as TM
from paddle_tpu_torch.models import state_dict_from_numpy
from paddle_tpu_torch.models.moe_gate import (GShardGate, NaiveTopKGate,
                                              SwitchGate, make_gate)
from paddle_tpu_torch.nn import ClipGradForMOEByGlobalNorm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs. Results do
    not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed):
    return jax.random.key(seed), R.PRNGKey(seed, device="cpu")


def test_gate_factory_and_config_top_k():
    assert TM.gpt_moe_tiny(gate="switch").top_k == 1
    assert TM.gpt_moe_tiny(gate="gshard").top_k == 2
    assert TM.gpt_moe_tiny(gate="topk", top_k=3).top_k == 3
    assert TM.gpt_moe_tiny(gate=SwitchGate()).top_k == 1
    assert TM.gpt_moe_tiny(gate=NaiveTopKGate(3)).top_k == 3
    cfg = TM.gpt_moe_tiny(switch_eps=0.3, random_routing=False)
    assert isinstance(make_gate("topk", cfg), NaiveTopKGate)
    assert make_gate("switch", cfg).switch_eps == 0.3
    assert make_gate("gshard", cfg).random_routing is False
    g = GShardGate()
    assert make_gate(g, cfg) is g
    with pytest.raises(ValueError, match="unknown MoE gate"):
        TM.gpt_moe_tiny(gate="nope")
    with pytest.raises(ValueError, match="unknown MoE gate"):
        make_gate("nope", cfg)
    assert [NaiveTopKGate(1).normalize_combine, SwitchGate().normalize_combine,
            GShardGate().normalize_combine] == [False, False, True]
    assert incubate.moe.SwitchGate is SwitchGate
    assert incubate.moe.ClipGradForMOEByGlobalNorm is \
        ClipGradForMOEByGlobalNorm


@pytest.mark.parametrize("eps", [0.1, 5.0])
def test_switch_select_logits_bit_equal_to_jax(eps):
    logits = np.random.RandomState(0).randn(96, 8).astype("float32")
    jk, tk = _key(11)
    want = np.asarray(JG.SwitchGate(eps).select_logits(
        jnp.asarray(logits), jk, True))
    got = SwitchGate(eps).select_logits(torch.from_numpy(logits), tk, True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, logits)
    np.testing.assert_array_equal(SwitchGate(eps).select_logits(
        torch.from_numpy(logits), None, False).numpy(), logits)


def test_gshard_keep_round_bit_equal_to_jax():
    gate = np.random.RandomState(1).uniform(0, 1, 5000).astype("float32")
    jk, tk = _key(3)
    want = np.asarray(JG.GShardGate().keep_round(1, jnp.asarray(gate), jk,
                                                 True))
    got = GShardGate().keep_round(1, torch.from_numpy(gate), tk, True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1
    full = torch.full((20000,), 0.3)
    assert abs(float(GShardGate().keep_round(1, full, tk, True).float()
                     .mean()) - 0.6) < 0.02
    for k, train, rr in ((0, True, True), (1, False, True),
                         (1, True, False)):
        assert GShardGate(rr).keep_round(k, full, tk, train) is None
    assert NaiveTopKGate().keep_round(1, full, tk, True) is None


def _inputs(T=64, H=32, E=4, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(a) for a in (
        rng.randn(T, H).astype("float32"), rng.randn(H, E).astype("float32"),
        (rng.randn(E, H, 2 * H) * 0.05).astype("float32"),
        np.zeros((E, 2 * H), "float32"),
        (rng.randn(E, 2 * H, H) * 0.05).astype("float32"),
        np.zeros((E, H), "float32"))]


def _dispatch(policy, train=False, key=0, cf=1.25):
    return TM._moe_dispatch(*_inputs(), policy, cf,
                            key=R.PRNGKey(key, device="cpu"), train=train)


def test_gates_inside_the_dispatch():
    """Switch at eval is top-1 routing and deterministic; its training
    jitter changes the routing; GShard without random routing is plain
    top-2, with it some second experts are dropped in training only."""
    y, aux = _dispatch(SwitchGate())
    y1, aux1 = _dispatch(NaiveTopKGate(1), key=7)
    assert torch.equal(y, y1) and torch.equal(aux, aux1) and float(aux) > 0
    yt, _ = _dispatch(SwitchGate(5.0), train=True, key=1)
    assert not torch.allclose(y, yt)
    y_plain, _ = _dispatch(GShardGate(random_routing=False), train=True)
    y_top2, _ = _dispatch(NaiveTopKGate(2), train=True)
    assert torch.equal(y_plain, y_top2)
    y_rand, _ = _dispatch(GShardGate(), train=True)
    assert not torch.allclose(y_plain, y_rand)
    assert torch.equal(_dispatch(GShardGate())[0],
                       _dispatch(GShardGate(False))[0])


def test_capacity_drops_for_every_gate():
    """Identical tokens all route to one expert; capacity factor 0.05
    keeps a few slots, so most rows come back zero."""
    gw = torch.from_numpy(np.random.RandomState(0).randn(32, 4)
                          .astype("float32"))
    for policy in (NaiveTopKGate(2), SwitchGate(), GShardGate()):
        y, _ = TM._moe_dispatch(
            torch.ones(64, 32), gw, torch.ones(4, 32, 64),
            torch.zeros(4, 64), torch.ones(4, 64, 32), torch.zeros(4, 32),
            policy, 0.05, key=R.PRNGKey(0, device="cpu"))
        assert int((y == 0).all(-1).sum()) > 32


def test_router_gets_task_gradient_for_every_gate():
    """Top-1 combine weights are not renormalized, so gate_w gets a
    gradient through the output alone for every gate."""
    args = _inputs(T=32, H=16)
    for policy in (SwitchGate(), NaiveTopKGate(1), NaiveTopKGate(2),
                   GShardGate()):
        gw = args[1].clone().requires_grad_(True)
        y, _ = TM._moe_dispatch(args[0], gw, *args[2:], policy, 2.0,
                                key=R.PRNGKey(0, device="cpu"))
        (g,) = torch.autograd.grad(y.square().sum(), gw)
        assert float(g.abs().max()) > 0, policy.name


def test_moe_mlp_key_stream():
    """In training each forward draws the next key of its stream
    (fold_in(PRNGKey(seed), n)): switch jitter differs from one forward
    to the next and repeats under the same seed; eval uses key(0) and is
    deterministic; GPTMoE gives its layers one stream, which a gate that
    draws nothing still advances."""
    cfg = TM.gpt_moe_tiny(gate=SwitchGate(5.0))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 64)
                         .astype("float32"))

    def run(seed, n, train=True):
        m = TM.MoEMLP(cfg, device="cpu", generator=torch.Generator()
                      .manual_seed(0)).train(train)
        m.keys = TM._KeyStream(seed, "cpu")
        with torch.no_grad():
            return [m(x) for _ in range(n)], m
    (a, b), m = run(4, 2)
    assert not torch.equal(a, b) and m.keys.count == 2
    assert torch.equal(run(4, 2)[0][1], b)
    assert not torch.equal(run(5, 1)[0][0], a)
    e1, e2 = run(4, 2, train=False)[0]
    assert torch.equal(e1, e2)
    model = TM.GPTMoE(TM.gpt_moe_tiny(num_layers=4), device="cpu")
    keys = [m.keys for m in model.moe_layers()]
    assert len(keys) == 2 and keys[0] is keys[1]
    model(torch.zeros(1, 8, dtype=torch.long))
    assert keys[0].count == 2


@pytest.mark.parametrize("gate", ["topk", "switch", "gshard"])
def test_gpt_moe_eval_logits_match_jax(gate):
    paddle.seed(7)
    jm = JM.GPTMoE(JM.gpt_moe_tiny(gate=gate))
    jm.eval()
    model = TM.GPTMoE(TM.gpt_moe_tiny(gate=gate), device="cpu").eval()
    model.load_state_dict(state_dict_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()},
        device="cpu"))
    ids = np.random.RandomState(2).randint(0, 256, (4, 16)).astype("int32")
    jlogits = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
        aux = model.aux_loss()
    np.testing.assert_allclose(logits.numpy(), jlogits.numpy(), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jm.aux_loss().numpy()),
                               atol=1e-5, rtol=0)
