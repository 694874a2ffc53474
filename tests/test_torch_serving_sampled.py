"""Sampled serving in the port (`PagedGPTDecoder(temperature, top_k,
top_p, seed)`, keys fold_in(fold_in(PRNGKey(seed), request id),
position)) against the JAX engine on `gpt_tiny` f32 with the weights of
one JAX `GPT`, and across the port's own paths: the per-tick engine, the
fused `decode_multi`, and the ragged packed horizons at several chunk
and horizon sizes, under churn (more requests than slots, an EOS that
retires streams mid-horizon).

Tolerance: none — tokens equal. The draw is the port's threefry,
bit-equal to jax.random, on f32 logits that agree with JAX's to ~1e-6,
far from the gaps between the winning Gumbel scores on these streams.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import PagedGPTDecoder as JaxDecoder
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.models import gpt_tiny, state_dict_from_numpy
from paddle_tpu_torch.models.generation import mask_logits
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedGPTDecoder)

SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.9, seed=11)
MAX_NEW = 14


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test of this module runs: the suite
    runs in several worker processes beside XLA's thread pools, and
    PyTorch's default of a thread per core then oversubscribes the CPU
    many times over. Results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    rng = np.random.RandomState(7)
    return [list(rng.randint(0, 1024, rng.randint(1, 30)).astype(int))
            for _ in range(6)]


@pytest.fixture(scope="module")
def models():
    """One JAX gpt_tiny and the port's tensors of its weights."""
    paddle.seed(7)
    jmodel = GPT(jax_gpt_tiny(max_seq_len=128, dtype="float32",
                              remat=False))
    jmodel.eval()
    np_state = {k: np.asarray(v._value)
                for k, v in jmodel.state_dict().items()}
    return {"jmodel": jmodel,
            "cfg": gpt_tiny(max_seq_len=128, dtype="float32"),
            "sd": state_dict_from_numpy(np_state, device="cpu")}


def _jax_streams(m, eos):
    """The JAX per-tick engine's sampled streams: 3 slots, 6 requests."""
    dec = JaxDecoder(m["jmodel"], num_pages=40, page_size=16, max_batch=3,
                     **SAMPLING)
    eng = JaxEngine(dec, eos_token_id=eos, max_new_tokens=MAX_NEW, k_max=1)
    rids = [eng.submit(np.asarray(p, np.int32)) for p in _prompts()]
    out = eng.run()
    return [out[r] for r in rids]


def _decoder(m, **kw):
    kw = {"num_pages": 40, "page_size": 16, "max_batch": 3, **SAMPLING,
          **kw}
    return PagedGPTDecoder(m["cfg"], m["sd"], device="cpu", **kw)


class _ReplayEngine(ContinuousBatchingEngine):
    """Gives the k-th submitted request the id `ids[k]`, so requests
    replayed in another order keep their ids (and so their draws, keyed
    by request id)."""

    def __init__(self, *args, ids, **kw):
        super().__init__(*args, **kw)
        self._ids = iter(ids)

    def submit(self, prompt_ids):
        self._next_id = next(self._ids)
        return super().submit(prompt_ids)


def _streams(eng, order=None, prompts=None):
    prompts = prompts or _prompts()
    order = order or range(len(prompts))
    rids = {i: eng.submit(prompts[i]) for i in order}
    out = eng.run()
    return [out[rids[i]] for i in range(len(prompts))]


ENGINES = [dict(k_max=1), dict(k_max=4, chunk_tokens=8),
           dict(k_max=8, chunk_tokens=16), dict(k_max=2, chunk_tokens=4),
           dict()]
# an EOS the free streams emit early (stream 2's 5th token), so that some
# streams retire mid-horizon
EOS_FROM = (2, 4)


@pytest.mark.parametrize("with_eos", [False, True], ids=["free", "eos"])
def test_sampled_streams_equal_jax_engine(models, with_eos):
    """The port's per-tick engine and its ragged packed engines (chunked
    prefill inside the horizon at 4-16 tokens a chunk, horizons of 2-8
    ticks, filler ticks for frozen slots) each emit the JAX per-tick
    engine's sampled streams, token for token."""
    eos = None
    if with_eos:
        free = _streams(ContinuousBatchingEngine(
            _decoder(models), max_new_tokens=MAX_NEW, k_max=1))
        eos = free[EOS_FROM[0]][EOS_FROM[1]]
    want = _jax_streams(models, eos)
    for eng_kw in ENGINES:
        eng = ContinuousBatchingEngine(_decoder(models), eos_token_id=eos,
                                       max_new_tokens=MAX_NEW, **eng_kw)
        assert _streams(eng) == want, eng_kw
        assert len(eng._free) == eng.d.num_pages - 1
    if with_eos:
        assert any(s[-1] == eos and len(s) < MAX_NEW for s in want)


def test_streams_independent_of_submission_order(models):
    """The same requests (same ids) submitted in reversed order land in
    other slots, batches and horizons; their draws, keyed by (seed,
    request id, position), are the same."""
    def run(order):
        eng = _ReplayEngine(_decoder(models), ids=order,
                            max_new_tokens=MAX_NEW, k_max=4, chunk_tokens=8)
        return _streams(eng, order=order)

    n = len(_prompts())
    assert run(range(n - 1, -1, -1)) == run(range(n))


def test_fused_decode_multi_equals_per_tick(models):
    """`decode_multi` draws tick j with the (seed, kid, lens + j) keys the
    per-tick `decode` uses."""
    dec = _decoder(models)
    kids = np.asarray([40, 7, 123], np.int32)
    prompts = [[3, 141, 59], [31], list(range(100, 120))]
    first = dec.prefill_batch([(p, [i]) for i, p in enumerate(prompts)],
                              kids=list(kids))
    table = np.full((3, dec.max_pages), dec.num_pages - 1, np.int32)
    table[:, 0] = [0, 1, 2]
    lens = np.asarray([len(p) for p in prompts], np.int32)
    multi = dec.decode_multi(first, lens, table, k=5, kids=kids)
    toks, ticks = np.asarray(first, np.int32), []
    for _ in range(5):
        toks = dec.decode(toks, lens, table, kids=kids).numpy()
        lens = lens + 1
        ticks.append(toks)
    assert multi.tokens_block.tolist() == np.stack(ticks).tolist()
    assert multi.tokens_block.tolist() != dec.decode_multi(
        first, lens - 5, table, k=5, kids=kids + 1).tokens_block.tolist()


def test_a_draw_is_the_mask_and_threefry_of_its_logits(models):
    """Teacher-forced per-tick logits of one stream, masked and drawn on
    the host with the (seed, request id, position) key, give the stream's
    tokens: the decoder's draw is exactly `mask_logits` + `categorical`."""
    dec = _decoder(models)
    rid, prompt = 5, _prompts()[5]
    eng = _ReplayEngine(_decoder(models), ids=[rid], max_new_tokens=MAX_NEW,
                        k_max=1)
    eng.submit(prompt)
    stream = eng.run()[rid]
    pages = list(range(3))
    tbl = np.full((3, dec.max_pages), dec.num_pages - 1, np.int32)
    tbl[0, :3] = pages
    dec.prefill_batch([(prompt[:-1], pages)])
    toks = [prompt[-1]] + stream[:-1]
    base = prng.PRNGKey(SAMPLING["seed"], device="cpu")
    for j, tok in enumerate(toks):
        pos = len(prompt) - 1 + j
        t = np.zeros(3, np.int32)
        t[0] = tok
        lens = np.asarray([pos, 0, 0], np.int32)
        _, logits = dec._decode_step(dec._as_i32(t), dec._as_i32(lens),
                                     dec._as_i32(tbl))
        key = prng.fold_in(prng.fold_in(base, rid), pos)
        masked = mask_logits(logits[:1], 0.8, 40, 0.9)
        assert int(prng.categorical(key[None], masked)[0]) == stream[j]


def test_seeds_reproduce_and_top_k_one_is_greedy(models):
    """As the JAX `test_sampled_decode_deterministic_and_varied`: a seed
    reproduces, another seed diverges, top_k=1 is greedy."""
    def run(**kw):
        eng = ContinuousBatchingEngine(_decoder(models, **kw),
                                       max_new_tokens=8)
        return _streams(eng, prompts=[[3, 141, 59]])[0]

    a = run(seed=0)
    assert a == run(seed=0)
    assert a != run(seed=123)
    assert run(temperature=1.5, top_k=1, top_p=1.0, seed=7) == \
        run(temperature=0.0)
