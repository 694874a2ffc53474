"""The port's serving stack (paddle_tpu_torch.serving) against the JAX
package on `gpt_tiny`, with the weights of one JAX `GPT` carried across
through `state_dict_from_numpy`: the packed prefill's first tokens and
the decode logits agree with the JAX `PagedGPTDecoder`, greedy streams
equal the JAX engine's, and inside the port the ragged packed engine
equals the per-tick engine token for token. Plus the port's import
hygiene (no jax, no paddle_tpu) and its refusal to run on a missing
card.

Tolerances: f32 decode logits within atol 1e-4 (the same f32 weights;
the two frameworks sum matmuls in different orders, ~1e-6 relative per
layer). bf16 logits within atol 0.05: activations round to bf16 (8
significant bits, relative step 2^-8) after every matmul, at places
that differ between the frameworks, and the logits (magnitude ~1 here)
sum 128 such products.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedGPTDecoder)

PROMPTS = [[3, 141, 59], [897, 11, 4, 18, 200, 7], [31],
           list(range(100, 140)), [5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9]]
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    """One JAX gpt_tiny, its numpy state dict and the port's tensors of
    the same weights, plus the JAX per-tick engine's greedy streams."""
    paddle.seed(7)
    jcfg = jax_gpt_tiny(max_seq_len=128, dtype="float32", remat=False)
    jmodel = GPT(jcfg)
    jmodel.eval()
    np_state = {k: np.asarray(v._value)
                for k, v in jmodel.state_dict().items()}
    jdec = JaxDecoder(jmodel, num_pages=32, page_size=16, max_batch=2)
    jeng = JaxEngine(jdec, max_new_tokens=MAX_NEW, k_max=1)
    rids = [jeng.submit(np.asarray(p, np.int32)) for p in PROMPTS]
    jout = jeng.run()
    return {"jmodel": jmodel,
            "cfg": gpt_tiny(max_seq_len=128, dtype="float32"),
            "sd": state_dict_from_numpy(np_state, device="cpu"),
            "jax_streams": [jout[r] for r in rids]}


def _decoder(m, **kw):
    kw = {"num_pages": 32, "page_size": 16, "max_batch": 2, **kw}
    return PagedGPTDecoder(m["cfg"], m["sd"], device="cpu", **kw)


def _streams(eng):
    rids = [eng.submit(p) for p in PROMPTS]
    out = eng.run()
    return [out[r] for r in rids]


def _jax_prefill_then_decode(jdec, prompts, pages):
    """JAX decoder: packed prefill of `prompts`, then one decode tick
    fed the first tokens; returns (first tokens, decode logits)."""
    firsts = jdec.prefill_batch(list(zip(prompts, pages)))
    table = np.full((2, jdec.max_pages), jdec.num_pages - 1, np.int32)
    for s, pg in enumerate(pages):
        table[s, :len(pg)] = pg
    lens = np.asarray([len(p) for p in prompts], np.int32)
    _, logits, jdec.k_pages, jdec.v_pages = jdec._decode(
        jdec._w(), jdec.k_pages, jdec.v_pages,
        jnp.asarray(firsts, jnp.int32), jnp.asarray(lens),
        jnp.asarray(table), jnp.asarray(np.arange(2, dtype=np.int32)))
    return firsts, np.asarray(logits, np.float32), table, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_matches_jax_decoder(models, dtype):
    """prefill_batch first tokens equal; the next decode tick's logits
    agree (f32 atol 1e-4, bf16 atol 0.05 — see the module docstring)."""
    prompts = [PROMPTS[1], PROMPTS[3]]
    pages = [[0, 1], [2, 3, 4]]
    jdec = JaxDecoder(models["jmodel"], num_pages=32, page_size=16,
                      max_batch=2, dtype=jnp.dtype(dtype))
    jfirst, jlogits, table, lens = _jax_prefill_then_decode(
        jdec, prompts, pages)
    dec = _decoder(models, dtype=dtype)
    first = dec.prefill_batch(list(zip(prompts, pages)))
    nxt, logits = dec._decode_step(dec._as_i32(first), dec._as_i32(lens),
                                   dec._as_i32(table))
    atol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=atol, rtol=0)
    if dtype == "float32":
        assert first == jfirst
        assert nxt.tolist() == jlogits.argmax(-1).tolist()


def test_engine_streams_equal_jax_engine(models):
    """The port's default engine (ragged, packed; 5 requests through 2
    slots) emits the JAX engine's greedy streams."""
    eng = ContinuousBatchingEngine(_decoder(models), max_new_tokens=MAX_NEW)
    assert eng.ragged and eng.k_max > 1
    assert _streams(eng) == models["jax_streams"]
    assert len(eng._free) == eng.d.num_pages - 1       # every page back


def test_ragged_engine_equals_per_tick_engine(models):
    """Inside the port, schedule independence: the ragged packed engine
    with 8-token prompt chunks and an EOS that freezes a slot mid-horizon
    equals the per-tick engine token for token; the fused decode_multi
    equals per-tick decode ticks."""
    eos = models["jax_streams"][3][2]
    per_tick = ContinuousBatchingEngine(_decoder(models), eos_token_id=eos,
                                        max_new_tokens=MAX_NEW, k_max=1)
    ragged = ContinuousBatchingEngine(_decoder(models), eos_token_id=eos,
                                      max_new_tokens=MAX_NEW, k_max=4,
                                      chunk_tokens=8)
    want = _streams(per_tick)
    assert any(s[-1] == eos and len(s) < MAX_NEW for s in want)
    assert _streams(ragged) == want
    assert ragged.stats.prefill_chunks > len(PROMPTS)   # multi-chunk

    dec = _decoder(models)
    first = dec.prefill_batch([(PROMPTS[0], [0]), (PROMPTS[2], [1])])
    table = np.full((2, dec.max_pages), dec.num_pages - 1, np.int32)
    table[:, 0] = [0, 1]
    lens = np.asarray([3, 1], np.int32)
    multi = dec.decode_multi(first, lens, table, k=3)
    toks, ticks = np.asarray(first, np.int32), []
    for _ in range(3):
        toks = dec.decode(toks, lens, table).numpy()
        lens = lens + 1
        ticks.append(toks)
    assert multi.tokens_block.tolist() == np.stack(ticks).tolist()


def test_unported_options_raise(models):
    with pytest.raises(NotImplementedError):
        _decoder(models, quant="a8w8")
    # sampling is ported (test_torch_serving_sampled.py): it builds with
    # the JAX decoder's sampling tuple and seed
    dec = _decoder(models, temperature=0.7, top_k=5, seed=9)
    assert dec.sampling == (0.7, 5, 1.0) and dec.seed == 9
    # the flight recorder and the dispatch-separate loop are ported
    # (test_torch_trace.py, test_torch_dense_windows.py), and so are LoRA
    # adapters (test_torch_lora.py: without a bank only the base id 0 has
    # a salt, as in JAX); tensor-parallel serving is not
    eng = ContinuousBatchingEngine(_decoder(models), trace=True)
    assert eng.trace is not None and eng.trace.meta["ragged"]
    eng = ContinuousBatchingEngine(_decoder(models), ragged=False, k_max=4)
    assert not eng.ragged and eng.k_max == 4 and eng.scheduler is None
    with pytest.raises(NotImplementedError):
        _decoder(models, mesh=object())
    with pytest.raises(IndexError):
        _decoder(models).adapter_salt(1)


def test_port_imports_no_jax_and_refuses_missing_card():
    """In a fresh interpreter, importing every module of the port pulls
    in neither jax nor paddle_tpu; without CUDA, get_device(), a state
    dict and a PagedKVCache built without device= raise instead of
    running on the CPU."""
    code = """
import sys
import torch
import paddle_tpu_torch
import paddle_tpu_torch.cost_model, paddle_tpu_torch.models
import paddle_tpu_torch.ops.ragged_paged_attention
import paddle_tpu_torch.ops.w4_matmul, paddle_tpu_torch.quantization
import paddle_tpu_torch.serving, paddle_tpu_torch.serving.trace
import paddle_tpu_torch.debug
import paddle_tpu_torch.ops.block_sparse_attention
import paddle_tpu_torch.ops.paged_attention, paddle_tpu_torch.nn.functional
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))
print('BAD', bad)
if not torch.cuda.is_available():
    from paddle_tpu_torch.models import gpt_tiny, init_state_dict
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    for call in (paddle_tpu_torch.get_device,
                 lambda: init_state_dict(gpt_tiny()),
                 lambda: PagedKVCache(4, 2, 1, 8)):
        try:
            call()
            print('RAN')
        except RuntimeError:
            print('RAISED')
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert "RAN" not in res.stdout, res.stdout
