"""Paddle's calling forms in the port: positional parameters in the JAX
package's order, port-only arguments keyword-only, unported options
raising `NotImplementedError`. Each case below is one the port got
wrong before: the clip's `(param, grad)` pairs and `group_name`;
`nn.LayerNorm` / `nn.RMSNorm`'s third positional (`weight_attr`, False:
no weight); `nn.LayerList(sublayers=...)`; `Trainer`'s `mesh` and
`donate` positionals; `ContinuousBatchingEngine`'s `host_sync_s` fifth;
and `Optimizer.apply_gradients(params_grads)`. The signatures are also
held against the JAX classes' by name. Everything runs on the CPU.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.trainer import Trainer as JaxTrainer
from paddle_tpu.nn import clip as JC
from paddle_tpu.optimizer import Optimizer as JaxOptimizer
from paddle_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.models import (GPT, GPTPretrainingCriterion, gpt_tiny,
                                     init_state_dict)
from paddle_tpu_torch.nn import clip as TC
from paddle_tpu_torch.optimizer import SGD, AdamW, Optimizer
from paddle_tpu_torch.serving import ContinuousBatchingEngine, PagedGPTDecoder


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD and p.name != "self"]


SIGNATURES = {
    "LayerNorm": (lambda: nn.LayerNorm, lambda: paddle.nn.LayerNorm),
    "RMSNorm": (lambda: nn.RMSNorm, lambda: paddle.nn.RMSNorm),
    "LayerList": (lambda: nn.LayerList, lambda: paddle.nn.LayerList),
    "Trainer": (lambda: Trainer, lambda: JaxTrainer),
    "ContinuousBatchingEngine": (lambda: ContinuousBatchingEngine,
                                 lambda: JaxEngine),
    "ClipGradByValue": (lambda: TC.ClipGradByValue,
                        lambda: JC.ClipGradByValue),
    "ClipGradByNorm": (lambda: TC.ClipGradByNorm, lambda: JC.ClipGradByNorm),
    "ClipGradByGlobalNorm": (lambda: TC.ClipGradByGlobalNorm,
                             lambda: JC.ClipGradByGlobalNorm),
    "ClipGradForMOEByGlobalNorm": (lambda: TC.ClipGradForMOEByGlobalNorm,
                                   lambda: JC.ClipGradForMOEByGlobalNorm),
    "Optimizer.apply_gradients": (lambda: Optimizer.apply_gradients,
                                  lambda: JaxOptimizer.apply_gradients),
}


@pytest.mark.parametrize("name", list(SIGNATURES))
def test_positional_parameters_follow_jax(name):
    port, ref = (get() for get in SIGNATURES[name])
    assert _positional(port) == _positional(ref)


def test_global_norm_clip_takes_pairs_and_group_name():
    p, q = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(
        torch.zeros(4))
    g = torch.tensor([3.0, 4.0, 0.0])
    out = TC.ClipGradByGlobalNorm(1.0)([(p, g), (q, None)])
    assert out[0][0] is p and out[1] == (q, None)
    assert torch.allclose(out[0][1], torch.tensor([0.6, 0.8, 0.0]))
    clip = TC.ClipGradByGlobalNorm(1.0, "default_group", True)
    assert clip([(p, g)])[0][1].norm() <= 1.0 + 1e-6


def test_norms_take_weight_attr_third():
    x = torch.randn(2, 8)
    ln = nn.LayerNorm(8, 1e-5, False, device="cpu")
    assert ln.weight is None and ln.bias is not None
    assert nn.LayerNorm(8, 1e-5, None, False, device="cpu").bias is None
    ref = torch.nn.functional.layer_norm(x, (8,), None, ln.bias, 1e-5)
    assert torch.allclose(ln(x), ref, atol=1e-6)
    rms = nn.RMSNorm(8, 1e-6, False, device="cpu")
    assert rms.weight is None
    assert torch.allclose(rms(x), x * torch.rsqrt(
        x.square().mean(-1, keepdim=True) + 1e-6), atol=1e-6)
    with pytest.raises(NotImplementedError):
        nn.LayerNorm(8, weight_attr=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        nn.RMSNorm(8, weight_attr=object(), device="cpu")
    with pytest.raises(TypeError):
        nn.LayerNorm(8, 1e-5, None, None, None, "cpu")


def test_layer_list_takes_sublayers():
    layers = nn.LayerList(sublayers=[torch.nn.ReLU(), torch.nn.Tanh()])
    assert len(layers) == 2 and len(nn.LayerList()) == 0


def _gpt():
    torch.manual_seed(0)
    cfg = gpt_tiny(num_layers=1, hidden_size=64, num_heads=2,
                   max_seq_len=16, vocab_size=64, dtype="float32")
    return GPT(cfg, device="cpu"), cfg


def _loss(m, b):
    return GPTPretrainingCriterion()(m(b["ids"]), b["labels"])


def test_trainer_takes_mesh_and_donate_positionals():
    m, _ = _gpt()
    tr = Trainer(m, SGD(0.1), _loss, None, False, device="cpu")
    assert tr.grad_accum_steps == 1
    tr = Trainer(m, SGD(0.1), _loss, None, True, 2, None, ("dp",),
                 device="cpu")
    assert tr.grad_accum_steps == 2
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 9)))
    assert torch.isfinite(tr.step({"ids": ids[:, :-1],
                                   "labels": ids[:, 1:]}))
    with pytest.raises(NotImplementedError):
        Trainer(m, SGD(0.1), _loss, object(), device="cpu")
    with pytest.raises(NotImplementedError):
        Trainer(m, SGD(0.1), _loss, grad_transform=lambda g, s: (g, s),
                device="cpu")
    with pytest.raises(NotImplementedError):
        Trainer(m, SGD(0.1), _loss, dp_overlap="bulk", device="cpu")
    with pytest.raises(ValueError):
        Trainer(m, SGD(0.1), _loss, dp_overlap="nope", device="cpu")


def test_engine_takes_host_sync_s_fifth():
    _, cfg = _gpt()
    dec = PagedGPTDecoder(cfg, init_state_dict(cfg, device="cpu"),
                          num_pages=8, page_size=16, max_batch=2,
                          device="cpu")
    eng = ContinuousBatchingEngine(dec, None, 4, 1, None, True)
    assert eng.cache is not None
    assert ContinuousBatchingEngine(dec, None, 4, 1).cache is None
    # host_sync_s fifth prices K: the dispatch-separate loop's pure decode
    # tick, the ragged scheduler's mixed tick
    from paddle_tpu_torch.cost_model import decode_horizon
    eng = ContinuousBatchingEngine(dec, None, 4, None, 0.01, ragged=False)
    assert eng.k_max == decode_horizon(dec.step_hbm_bytes(),
                                       host_sync_s=0.01, device="cpu")
    cheap = ContinuousBatchingEngine(dec, None, 4, None, 1e-9)
    assert cheap.scheduler.k_max <= \
        ContinuousBatchingEngine(dec, None, 4, None, 0.01).scheduler.k_max
    sched = cheap.scheduler
    eng = ContinuousBatchingEngine(dec, max_new_tokens=4, scheduler=sched)
    assert eng.scheduler is sched and eng.k_max == sched.k_max
    assert not ContinuousBatchingEngine(dec, max_new_tokens=4,
                                        packed=False).packed
    assert ContinuousBatchingEngine(dec, max_new_tokens=4,
                                    trace=True).trace is not None


def test_apply_gradients_takes_pairs():
    p = torch.nn.Parameter(torch.ones(4))
    q = torch.nn.Parameter(torch.ones(2))
    opt = AdamW(0.1, parameters=[p, q],
                grad_clip=TC.ClipGradByGlobalNorm(1.0))
    opt.apply_gradients([(p, torch.full((4,), 2.0)), (q, None)])
    assert not torch.equal(p, torch.ones(4)) and torch.equal(q, torch.ones(2))
    with pytest.raises(TypeError):
        opt.apply_gradients([p], [torch.ones(4)])
