#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py          # needs one CUDA card (an H100)

Builds every hand-written kernel from the sources in the checkout, holds
each against its plain PyTorch version at the shapes of the path that
runs it (serving: ragged paged attention over bf16, int8 and int4 pools,
the W4A16 matmul; training: flash attention forward/dQ/dK-dV, LayerNorm
forward and backward, streaming cross-entropy forward/backward) and times
it beside its bound and a library yardstick; serves GPT-1.3B (gpt_1p3b at
full width, random weights from seed 0) through the port's default
engine, profiles a short serving window and checks the streams against
the port's per-tick decoder; serves it again from an int8 pool, an int4 pool and int4
(W4A16) weights, each checked against its per-tick engine and, by the
teacher-forced NLL of the bf16 run's streams, against the bf16 pool;
trains gpt_1p3b (full depth, bf16,
remat 'full', batch 8 x 1024, AdamW + global-norm clip) for 2 warm-up
and 8 timed steps, counts each kernel's launches a step, profiles one
step; checks serving and training on gpt_tiny against the port's CPU
path; holds the flash kernels' per-key bias, full bias and hash-dropout
branches and their keep-mask against the plain versions and times them
at BERT's shape; trains bert_base (MLM + NSP, full width and depth,
bf16, batch 32 x 512 with padding masks, dropout 0.1, AdamW, bench.py's
recipe) for 2 warm-up and 8 timed steps, counts launches by kernel and
branch, splits one profiled step by family, and checks a small BERT's
training with dropout on against the port's CPU path. Both training
paths update every parameter with one launch of the multi-tensor AdamW
kernel a step, held bit-equal to one launch a parameter over each run's
real parameter list and timed against those launches and
`torch._fused_adamw_` over the same lists; the first steps of each run
are replayed with one launch a parameter and must give the same losses
bit for bit. That kernel (in eight variants of dtypes, master copy and
clip scale, beside a copy probe and a cheap-division probe of its loop),
the RMSNorm kernel and the dropout + residual + LayerNorm kernel (a mode
of the norms' row walk) are held against their plain versions and timed
at full width (the latter beside its earlier design's device time), and
the two norm ops are driven through their entry points (nn.RMSNorm
forward and backward, the dropout op in training and eval). F.dropout's
hash dropout kernel is held bit-equal to its plain version, forward and
backward, at BERT's hidden states (f32 and bf16, p 0.1-0.9, both modes;
f16), an odd element count and a view off 16-byte alignment, two
launches bit-equal, the earlier f32-divisor arithmetic rejected, its mask
kernel equal to the plain mask, and timed beside its bound; every BERT
step must take it 25 times forward and 25 backward. The two legacy
kernels, block-sparse attention and paged decode attention, are held
against their plain versions (every block size, head dims 8-256,
count-0 rows, seq_len 0, -1 page ids) and timed at full width, and their
entry points are driven at gpt_1p3b's attention width:
F.sparse_attention forward and backward on a BigBird CSR at L 4096, and
a PagedKVCache of the serving pool's geometry filled with 16 sequences
and read by paged_attention; bf16 block-sparse attention at block sizes
16-128 and head_dim 64 and 128 runs on its tensor-core body (every case
asserts the body it took and two launches bit-equal, a walk with p
rounded to bf16 alone must fall outside the tolerance, and no
tensor-core instantiation may spill). The bf16 W4 matmul and the bf16 flash
forward, dQ and dK/dV run on the tensor cores: the W4 checks hold the
first S rows of x, S in 1, 16, 17, 64 and 300, bit-equal alone and
inside a 2048-row call, and time the kernel and cuBLAS both eagerly and
as device time (CUDA-graph replay), beside the earlier design's time;
the flash checks hold the bf16 forward and backward of every branch
(head_dim 64, 128, 256; causal, GQA, ragged, Lq != Lk, a view off
16-byte alignment) against their plain walks at the same rounding
points, require two backward runs to be bit-equal, and show on walks
with a misplaced rounding point that the tolerances reject them; the
timing phases time dQ + dK/dV together against SDPA's backward; the
training phases check that every forward, dQ and dK/dV took its
tensor-core body. The ragged and paged decode attention (one split page
walk, chunks merged in order) are held on rows across up to eight
chunks, with two launches and the split and unsplit launches bit-equal,
no register spills in any of their bodies, and a chunked-prefill timing
row beside the decode one. The LayerNorm forward and backward and the
RMSNorm forward (one row walk for both forwards) are held against their
plain versions at GPT's, gpt_moe_small's and BERT's rows and at widths
128-8192, ragged row counts and mixed dtypes, the backward at its rounding points with its
bits within LN_BWD_FLIP of the plain version's, two launches bit-equal,
and a control with one rounding point moved rejected; they are timed
eagerly and as device time beside F.layer_norm, aten's LayerNorm backward
and F.rms_norm; the training phases require every LayerNorm backward of a
step to take the kernel. ResNet-50 (bench.py's run_resnet50: NHWC,
bf16, Momentum, batch 128 x 224 x 224, random weights from seed 0; no
kernel of the port on its path) trains for 2 warm-up and 8 timed steps
with finite losses and every BatchNorm buffer moved, one step is
profiled by family (cuDNN convolutions, batch norm, pooling, residual add
+ ReLU, the optimizer), and resnet18 in f32 (TF32 off) is held against
the port's CPU run, with max-pool tie gradients and the bf16 running
statistics' update bit-equal. GPT's own path (no kernel of its own; its
steps run the flash, LayerNorm, cross-entropy and AdamW kernels, its
sampled serving the ragged attention): bench.py's headline variant
(gpt_1p3b, remat 'dots', batch 6 x 1024) trains 2 + 8 steps under
AdamW(LinearWarmup(CosineAnnealingDecay)), every AdamW launch given the
schedule's lr, and again at batch 8 beside the 'full' run; at gpt_1p3b
width and 2 layers one step's loss and gradients under 'dots' are
bit-equal to 'full'; a run resumed after 3 of 6 steps from host numpy
copies of `Trainer.state()` and the optimizer's `state_dict()` is
bit-equal to the uninterrupted one; KV-cache generation (greedy, sampled,
beam search with 4 beams; 4 prompts of 128 tokens, 64 new) has cached
logits within CACHED_LOGIT_TOL of the full forward's; and sampled serving
(temperature 0.8, top_k 50, top_p 0.95) runs the serving traffic beside
the greedy run, its streams against the per-tick engine and against the
same requests in reversed order (a stream may part only on a near-tie),
and, for generation and serving, the card's draws equal the host's
threefry draws from the card's logits. The prefix cache, the host KV
tier and cache persistence serve gpt_1p3b's traffic of 4 groups of 8
requests, each group sharing a 512-token system prompt: with the cache
off and on over bf16, int8 and int4 pools, with a full-prompt hit whose
copy-on-write copy must be bit-equal to its source (scale planes too);
in three waves (A-D, E-H pushing A-D's pages out of the pool, A-D again)
under tier policies restore / recompute / auto beside a capacity-0 twin,
the spilled and restored bytes bit-equal to the pages', the engine's and
a pinned buffer's D2H / H2D rates beside the priced PCIe rate; and from
a cache saved after the first wave and loaded onto a fresh decoder. Every
cached run launches the ragged kernel (plain version never); a kept
attention call of a device hit, a copy-on-write and a restore, on the
real mounted table at start > 0, matches the plain version; the page
audit is empty after each run; and the streams equal their cache-off,
capacity-0 or warm twin's or pass the teacher-forced oracle rule.
GPT-MoE (bench.py's run_gpt_moe: gpt_moe_small, 8 experts with top-2
routing in every 2nd block, bf16, batch 8 x 1024, AdamW with bf16 slots,
loss + aux_loss(); no Pallas kernel on the routing, which runs as eager
PyTorch ops) trains 2 + 8 steps with GPT's kernels launched as many
times a step as a 12-block model without recompute needs, prints every
MoE layer's routing with its invariants (each expert keeps at most C
tokens, a slot holds one token, top-2 weights >= 0 summing to <= 1),
times the routing alone, profiles one step by family (the routing,
gather and scatter kernels as their own), times a step whose top-k gate
derives the keys it never reads (as JAX's dispatch does) against the
gate's own (which derives none), trains the "switch" and
"gshard" gates a few steps each, and holds gpt_moe_tiny's training
(the MoE clip, routing included) against the port's CPU run. Slice 17
holds the ragged kernel's dense form at the verify window (gpt_350m's
16 heads of 64, W = k + 1 = 5) and at every pow2 prefill window 4-1024,
times it at the verify shape, serves the gpt_1p3b traffic traced (streams
byte-identical to an untraced run, a drift line a dispatch shape, a
chrome trace that passes the schema check), as the dense window twin and
through the dispatch-separate loop, and runs bench.py's run_speculative
on gpt_350m (a constructed draft, an unrelated one, and sampled), every
parting from the plain streams held to the teacher-forced oracle rule.
Slice 18 (multi-tenant serving) holds the per-token LoRA delta kernel
against its plain version (T 1-1024, f32 and bf16, 1-8 adapters of mixed
ranks; id-0 rows untouched, a token's bits independent of T) and times it
beside two `torch.bmm`; serves the gpt_1p3b traffic with a bank of 4
rank-16 adapters (every request on id 0 byte-identical to the no-bank
run; mixed ids against per-adapter runs); runs bench.py's multi-tenant
traffic (a throughput flood over 4 adapters, latency arrivals that
preempt) through the class-blind and the tenant engine, then through the
precision-routed engine (int8 latency, int4 throughput pools); and drives
fleets of 1 and 3 replicas (round-robin and threaded) over a shared host
KV tier, with a respawned replica warm-starting from it.
Slice 19 (int8 inference) holds the A8W8 row quantize and int8 GEMM
bit-equal to their plain versions at gpt_1p3b's four products (f32, bf16
and f16, both epilogue orders, dynamic and static scales, zero and +-127
rows, a row's bits independent of T) and times them at T 16 and 1024
beside the bound and `torch._int_mm`; serves the gpt_1p3b traffic with
quant="a8w8" (streams against the bf16 run and the per-tick engine, the
NLL of the bf16 streams); and runs paddle.quantization on gpt_1p3b at 4
x 1024: quantize_model with int8 and int4 weights (the W4 kernel at
4096 rows), PTQ (4 calibration batches) and QAT (3 AdamW steps, remat
'none').
Every phase raises on failure.
The output is one line per phase, then one JSON line with the kernels'
numbers, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Without CUDA, or without the package next
to it, the script exits non-zero and prints no result. Imports only
torch, numpy and the port (never jax or paddle_tpu).
"""
import ctypes
import functools
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

H100_HBM_BYTES_PER_S = 3.35e12      # NVIDIA data sheet, H100 SXM
H100_F32_FLOPS = 67e12              # data sheet, f32 outside tensor cores
H100_BF16_FLOPS = 989e12            # data sheet, bf16 dense tensor cores
SEED = 0


_T0 = time.perf_counter()


def log(phase, **fields):
    """One line a reading; `at_s` is the seconds since the script began,
    the run's timeline."""
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items())
          + f" at_s={time.perf_counter() - _T0:.1f}", flush=True)


def cuda_ms(fn, iters):
    """Mean device time of `fn()` over `iters` calls after a warm-up,
    from CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def cuda_graph_ms(fn, iters):
    """Mean device time of `fn(i)` for i < `iters`, the calls captured
    once in a CUDA graph and replayed: the host's launch gaps, which set
    `cuda_ms` for kernels shorter than their Python wrapper, are out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


def host_us(fn, iters):
    """Mean host time of `fn(i)` per call in microseconds, after a
    warm-up: the Python and the launch, not the device's work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / iters * 1e6


def _bits_equal(x, y):
    """x and y hold the same bits (a NaN equals itself)."""
    it = {1: torch.int8, 2: torch.int16, 4: torch.int32,
          8: torch.int64}[x.element_size()]
    return x.dtype == y.dtype and torch.equal(x.view(it), y.view(it))


def bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|, as f32."""
    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# ---------------------------------------------------------------- phase 1

def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log("env", gpu=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
        build_wall_s=f"{time.perf_counter() - t0:.2f}",
        **{f"build_s[{k}]": f"{v:.2f}" for k, v in secs.items()})
    for name, text in _build.build_logs.items():
        entries = _ptxas_entries(text)
        for fn, regs, spill in entries:
            log("ptxas", kernel=name, fn=repr(fn), info=repr(regs),
                spill=repr(spill))
        if name == "flash_attention":
            _ptxas_bwd(entries)
        if name in DECODE_SOURCES:
            _ptxas_decode(name, entries)
        if name == "block_sparse_attention":
            _ptxas_bsa(entries)
        if name == "layer_norm":
            _ptxas_norm(entries)
        if name == "hash_dropout":
            _ptxas_dropout(entries)
    for name, line in (("flash_attention", "ptxas_bwd"),
                       ("block_sparse_attention", "ptxas_bsa"),
                       ("layer_norm", "ptxas_norm"),
                       ("hash_dropout", "ptxas_dropout")) + tuple(
                           (d, "ptxas_decode") for d in DECODE_SOURCES):
        if name not in _build.build_logs:
            log(line, source=name, checked=False,
                reason="library built before this run")
    return smi


def _ptxas_bsa(entries):
    """One line for the block-sparse tensor-core body (its instantiations
    at block sizes 16-128 and head_dim 64 and 128) and one for the SIMT
    body: registers and spill stores. Raises if a tensor-core
    instantiation is missing from ptxas's report or spills."""
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    want = len(bsa.TC_BLOCK_SIZES) * len(bsa.TC_HEAD_DIMS)
    for kern, tc in (("bsa_fwd_tc_kernel<", True),
                     ("block_sparse_attention_kernel<", False)):
        got = [(_ptxas_number(r"Used (\d+) registers", regs),
                _ptxas_number(r"(\d+) bytes spill stores", spill))
               for fn, regs, spill in entries if fn and fn.startswith(kern)]
        spill = max((b for _, b in got), default=None)
        log("ptxas_bsa", kernel=kern.rstrip("<"), instantiations=len(got),
            registers=(f"{min(r for r, _ in got)}-{max(r for r, _ in got)}"
                       if got else "none"), spill_store_bytes=spill)
        if tc and (len(got) != want or spill):
            raise RuntimeError(f"ptxas: {kern}...> has {len(got)} of its "
                               f"{want} instantiations in the report, spill "
                               f"stores {spill} bytes (0 required)")


# The norm kernels of csrc/layer_norm.cu and their instantiations: the row
# walk for LayerNorm, for RMSNorm and for dropout + residual + LayerNorm
# (modes 0, 1, 2; x f32 and bf16 at 6 lane widths, each with f32 and bf16
# weights), LayerNorm's backward (4 and 2) and its partials' sum (one per
# dtype pair); with the place of x's type among the template arguments.
_NORM_BODIES = (("norm_fwd_kernel<0,", 24, 1), ("norm_fwd_kernel<1,", 24, 1),
                ("norm_fwd_kernel<2,", 24, 1),
                ("layer_norm_bwd_kernel<", 12, 0), ("layer_norm_bwd_finish<", 4, 0))


def _ptxas_norm(entries):
    """One line per norm kernel: instantiations, registers and spill
    stores, over all of them and over those for bf16 x (the training
    paths' bodies). Raises if one is missing from ptxas's report or a
    bf16-x instantiation spills."""
    for kern, want, x_arg in _NORM_BODIES:
        got = [(_ptxas_number(r"Used (\d+) registers", regs),
                _ptxas_number(r"(\d+) bytes spill stores", spill),
                fn.split("<", 1)[1].split(", ")[x_arg].rstrip(">"))
               for fn, regs, spill in entries if fn and fn.startswith(kern)]
        spill = max((b for _, b, _ in got), default=None)
        bf16_spill = max((b for _, b, x in got if x == "__nv_bfloat16"),
                         default=None)
        log("ptxas_norm", kernel=kern.rstrip("<,"), instantiations=len(got),
            registers=(f"{min(r for r, _, _ in got)}-"
                       f"{max(r for r, _, _ in got)}" if got else "none"),
            spill_store_bytes=spill, bf16_x_spill_store_bytes=bf16_spill)
        if len(got) != want or bf16_spill:
            raise RuntimeError(f"ptxas: {kern}...> has {len(got)} of its "
                               f"{want} instantiations in the report, bf16-x "
                               f"spill stores {bf16_spill} bytes (0 "
                               "required)")


# The hash dropout kernels of csrc/hash_dropout.cu: the pass (x f32, bf16,
# f16, each upscaling or not) and the mask.
_DROPOUT_BODIES = (("hash_dropout_kernel<", 6), ("hash_keep_kernel", 1))


def _ptxas_dropout(entries):
    """One line per hash dropout kernel: instantiations, registers and
    spill stores. Raises if one is missing from ptxas's report or
    spills."""
    for kern, want in _DROPOUT_BODIES:
        got = [(_ptxas_number(r"Used (\d+) registers", regs),
                _ptxas_number(r"(\d+) bytes spill stores", spill))
               for fn, regs, spill in entries if fn and fn.startswith(kern)]
        spill = max((b for _, b in got), default=None)
        log("ptxas_dropout", kernel=kern.rstrip("<"), instantiations=len(got),
            registers=(f"{min(r for r, _ in got)}-{max(r for r, _ in got)}"
                       if got else "none"), spill_store_bytes=spill)
        if len(got) != want or spill:
            raise RuntimeError(f"ptxas: {kern}...> has {len(got)} of its "
                               f"{want} instantiations in the report, spill "
                               f"stores {spill} bytes (0 required)")


# The split decode-attention bodies (csrc/decode_attention.cuh) by source:
# the walk and the merge kernel of each.
DECODE_SOURCES = ("ragged_paged_attention", "paged_attention")


def _ptxas_decode(name, entries):
    """One line per kernel of a decode-attention source (the walk over
    every dtype x layout x head_dim x key-tile instantiation, and the
    split merge): instantiations, registers and spill stores. Raises if
    one is missing or any spills."""
    for kern, want in ((f"{name}_kernel<", 48 if name.startswith("ragged")
                        else 16), (f"{name}_merge_kernel<", 8)):
        got = [(_ptxas_number(r"Used (\d+) registers", regs),
                _ptxas_number(r"(\d+) bytes spill stores", spill))
               for fn, regs, spill in entries if fn and fn.startswith(kern)]
        spill = max((b for _, b in got), default=None)
        log("ptxas_decode", kernel=kern.rstrip("<"), instantiations=len(got),
            registers=(f"{min(r for r, _ in got)}-{max(r for r, _ in got)}"
                       if got else "none"),
            spill_store_bytes=spill)
        if len(got) != want or spill:
            raise RuntimeError(f"ptxas: {kern}...> has {len(got)} of its "
                               f"{want} instantiations in the report, spill "
                               f"stores {spill} bytes (0 required)")


# The bf16 backward's bodies by head_dim: the tensor-core dQ and dK/dV at
# 64 and 128, the SIMT bodies at 256 (the bf16 template argument).
_BWD_BODIES = (("flash_dq_tc_kernel<", 64), ("flash_dq_tc_kernel<", 128),
               ("flash_dq_kernel<__nv_bfloat16, 256", 256),
               ("flash_dkv_tc_kernel<", 64), ("flash_dkv_tc_kernel<", 128),
               ("flash_dkv_kernel<__nv_bfloat16, 256", 256))


def _ptxas_number(pattern, text):
    m = re.search(pattern, text)
    return int(m.group(1)) if m else 0


def _ptxas_bwd(entries):
    """One line per bf16 backward body and head_dim: the registers and
    the spill stores (bytes) over its six bias x dropout branches.
    Raises if a tensor-core body (head_dim 64, 128) is missing from
    ptxas's report or spills; the SIMT bodies at 256 are reported
    only."""
    for prefix, d in _BWD_BODIES:
        got = [(_ptxas_number(r"Used (\d+) registers", regs),
                _ptxas_number(r"(\d+) bytes spill stores", spill))
               for fn, regs, spill in entries
               if fn and fn.startswith(prefix) and
               (d == 256 or fn.startswith(f"{prefix}{d},"))]
        tc = "_tc_" in prefix
        spill = max((b for _, b in got), default=None)
        if got:
            log("ptxas_bwd", body=prefix.rstrip("<").split("<")[0],
                head_dim=d, branches=len(got),
                registers=f"{min(r for r, _ in got)}-{max(r for r, _ in got)}",
                spill_store_bytes=spill)
        else:
            log("ptxas_bwd", body=repr(prefix + str(d)), found=0)
        if tc and (len(got) != 6 or spill):
            raise RuntimeError(
                f"ptxas: {prefix}{d},...> has {len(got)} of its 6 branches "
                f"in the report, spill stores {spill} bytes (0 required)")


def _ptxas_entries(text):
    """(kernel function, 'Used N registers, ...', spill line) for each
    function in nvcc's -Xptxas=-v output; names demangled by c++filt
    where the toolkit's host has it, without their argument lists."""
    entries, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            entries.append([fn, line.split(":", 1)[1].strip(), spill])
    names = [e[0] or "" for e in entries]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    for e, n in zip(entries, names):
        n = n.replace("(anonymous namespace)::", "").split("(", 1)[0]
        e[0] = n.removeprefix("void ")
    return entries


# ---------------------------------------------------------------- phase 2

H, D, PS, MP = 16, 128, 16, 64          # gpt_1p3b heads, head_dim; pool


def _pool(gen, P, dtype, layers=1):
    shape = (layers, P, PS, H, D)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def _table(rng, n, P):
    t = rng.randint(0, P - 1, (n, MP)).astype(np.int32)
    t[:, -3:] = P - 1                       # scratch tail
    t[0, -5:-3] = -1                        # -1 entries clamp to page 0
    return torch.from_numpy(t).cuda()


def _check_close(name, got, plain, plain32, tol=1e-5):
    """f32: within atol=rtol=tol (1e-5 by default) of the plain version
    (both accumulate in f32; only summation order differs). bf16: within
    one bf16 ulp of the plain version's f32 result on the same inputs (the
    kernel rounds its f32 result once; the rounding step is half an ulp)
    plus the f32 allowance `tol` (an output near zero is a sum whose terms
    cancel, so the f32 summation-order error is absolute, not relative to
    it)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, plain, atol=tol, rtol=tol)
        return float((got - plain).abs().max())
    err = (got.float() - plain32).abs()
    if not bool((err <= bf16_ulp(plain32) + tol).all()):
        raise AssertionError(f"{name}: bf16 kernel output off by more "
                             "than one ulp of the f32 plain result")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    return float((got.float() - plain.float()).abs().max())


def _quant_pool(gen, P, layout, layers=1):
    """K and V pools of `layers` layers in a quantized layout ("int8" or
    "int4"): random values quantized by the serving decoder's own write-
    time quantizers, one layer at a time. Returns two (pages, scales)
    tuples."""
    from paddle_tpu_torch.serving.decoder import (_quantize_kv,
                                                  _quantize_kv_int4)
    quantize = _quantize_kv_int4 if layout == "int4" else _quantize_kv
    pools = []
    for _ in range(2):
        parts = [quantize(torch.randn((P, PS, H, D), generator=gen,
                                      device="cuda"))
                 for _ in range(layers)]
        pools.append(tuple(torch.stack(x) for x in zip(*parts)))
    return pools


def _layer_pool(pool, l):
    return tuple(x[l] for x in pool) if isinstance(pool, tuple) else pool[l]


def _ref(rpa, q, kpool, vpool, table, start, scale):
    """The plain version on a pool of any layout (not counted: a check's
    call, not the main path's)."""
    kp, vp, ks, vs, int4 = rpa._split_pool(kpool, vpool)
    return rpa._ragged_ref(q, kp, vp, table, start, scale, k_scale=ks,
                           v_scale=vs, int4=int4)


def phase_kernel_checks(rpa, layout="bf16"):
    """The ragged kernel against its plain version on one pool layout
    (bf16: f32 and bf16 pools of q's dtype; int8/int4: quantized pools
    under f32 and bf16 queries), dense windows W = 1, 16, 64 and a packed
    T = 64 chunk mix, and bit-identity across W = 1, a W = 16 window and a
    shuffled packed stream."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    P = 16 * MP + 1
    max_err = 0.0
    qpools = None if layout == "bf16" else \
        [_layer_pool(x, 0) for x in _quant_pool(gen, P, layout)]
    for dtype in (torch.float32, torch.bfloat16):
        if qpools is None:
            kp, vp = (x[0] for x in _pool(gen, P, dtype))
            kp32, vp32 = kp.float(), vp.float()
        else:
            (kp, vp), (kp32, vp32) = qpools, qpools
        pool = {"pool": layout if qpools else str(dtype)[6:],
                "dtype": str(dtype)[6:]}
        n = 16
        table = _table(rng, n, P)
        scale = 1.0 / D ** 0.5
        for W in (1, 16, 64):
            start = torch.from_numpy(rng.randint(
                0, MP * PS - W, n).astype(np.int32)).cuda()
            start[1] = 0                     # a row at start 0
            q = torch.randn((n, W, H, D), generator=gen,
                            device="cuda").to(dtype)
            got = rpa.ragged_paged_attention(q, kp, vp, table, start)
            plain = _ref(rpa, q, kp, vp, table, start, scale)
            plain32 = _ref(rpa, q.float(), kp32, vp32, table, start, scale)
            err = _check_close(f"dense W={W}", got, plain, plain32)
            max_err = max(max_err, err)
            log("kernel", form="dense", **pool, W=W,
                max_abs_err=f"{err:.3e}")
            if W in (16, 64):
                # bit-identity: each query alone (W=1, W 16 only), inside
                # the window (both launch plans at W 64: 4-query tiles),
                # and inside a shuffled packed stream (single queries; an
                # unsplit launch at W 16, a split one at W 64)
                same = [torch.cat([rpa.ragged_paged_attention(
                    q[:, j:j + 1].contiguous(), kp, vp, table, start + j)
                    for j in range(W)], dim=1)] if W == 16 else [
                    rpa._launch(q, kp, vp, table, None, start, scale,
                                split=s) for s in (True, False)]
                rows = torch.arange(n, device="cuda").repeat_interleave(W)
                pos = (start[:, None] + torch.arange(
                    W, device="cuda")).reshape(-1)
                perm = torch.randperm(n * W, generator=gen, device="cuda")
                packed = rpa._launch(
                    q.reshape(n * W, H, D)[perm].contiguous(), kp, vp,
                    table, rows[perm].int().contiguous(),
                    pos[perm].int().contiguous(), scale, split=W == 64)
                unperm = torch.empty_like(packed)
                unperm[perm] = packed
                if not (all(torch.equal(x, got) for x in same) and
                        torch.equal(unperm.reshape(n, W, H, D), got)):
                    raise AssertionError(
                        f"{pool}: a query's output differs between W=1, "
                        f"a W={W} window and a packed stream")
                log("kernel", check=f"bit-identical {'W=1 == ' if W == 16 else ''}"
                    f"W={W} window == shuffled packed stream",
                    launches="split, unsplit stream" if W == 16 else
                    "window split == unsplit, split stream", **pool)
        # packed T=64: 3 rows prefilling 16-token chunks + 16 decode rows
        rows = np.concatenate([np.repeat([2, 5, 9], 16),
                               np.arange(16)]).astype(np.int32)
        pos = np.concatenate([100 + np.arange(16), 0 + np.arange(16),
                              700 + np.arange(16),
                              rng.randint(64, 832, 16)]).astype(np.int32)
        q = torch.randn((64, H, D), generator=gen, device="cuda").to(dtype)
        rows_t = torch.from_numpy(rows).cuda()
        pos_t = torch.from_numpy(pos).cuda()
        got = rpa.ragged_paged_attention_packed(q, kp, vp, table, rows_t,
                                                pos_t)
        ref_args = (table[rows_t.long()], pos_t, scale)
        plain = _ref(rpa, q[:, None], kp, vp, *ref_args)[:, 0]
        plain32 = _ref(rpa, q[:, None].float(), kp32, vp32, *ref_args)[:, 0]
        err = _check_close("packed T=64", got, plain, plain32)
        max_err = max(max_err, err)
        log("kernel", form="packed", **pool, T=64, max_abs_err=f"{err:.3e}")
    torch.cuda.synchronize()
    return max_err


def phase_kernel_long_rows(rpa, layout="bf16"):
    """Rows crossing >= 3 chunks of CHUNK_PAGES pages on one pool layout,
    f32 and bf16 queries: a packed stream whose positions sit on chunk
    boundaries (the first and the last key of a chunk, chunks 0-7) and
    dense W = 3 windows straddling them, each against the plain version
    (which walks the same chunks and merges them the same way); two
    launches bit-equal; the split launch (chunks in blocks of their own,
    merged by a second kernel) bit-equal to the unsplit one (a tile's
    chunks in one block)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rng = np.random.RandomState(SEED + 3)
    P = 16 * MP + 1
    span = rpa.CHUNK_PAGES * PS                 # keys a chunk
    edges = sorted({0, span - 1, span, 3 * span - 1, 3 * span,
                    5 * span + 7, MP * PS - 1})
    qpools = None if layout == "bf16" else \
        [_layer_pool(x, 0) for x in _quant_pool(gen, P, layout)]
    n = len(edges)
    table = _table(rng, n, P)
    scale = 1.0 / D ** 0.5
    max_err, launches = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        if qpools is None:
            kp, vp = (x[0] for x in _pool(gen, P, dtype))
            kp32, vp32 = kp.float(), vp.float()
        else:
            (kp, vp), (kp32, vp32) = qpools, qpools
        pos = torch.tensor(edges, dtype=torch.int32, device="cuda")
        rows = torch.arange(n, dtype=torch.int32, device="cuda")
        q = torch.randn((n, H, D), generator=gen, device="cuda").to(dtype)
        before = rpa.device_launches
        got = rpa._launch(q, kp, vp, table, rows, pos, scale, split=True)
        again = rpa._launch(q, kp, vp, table, rows, pos, scale, split=True)
        launches[str(dtype)[6:]] = (rpa.device_launches - before) // 2
        plain = _ref(rpa, q[:, None], kp, vp, table, pos, scale)[:, 0]
        plain32 = _ref(rpa, q[:, None].float(), kp32, vp32, table, pos,
                       scale)[:, 0]
        max_err = max(max_err, _check_close("long rows packed", got, plain,
                                            plain32))
        # dense windows of 3 straddling each boundary (start = edge - 1)
        start = (pos - 1).clamp(0, MP * PS - 3).contiguous()
        qd = torch.randn((n, 3, H, D), generator=gen, device="cuda").to(dtype)
        dense = rpa.ragged_paged_attention(qd, kp, vp, table, start)
        max_err = max(max_err, _check_close(
            "long rows dense", dense,
            _ref(rpa, qd, kp, vp, table, start, scale),
            _ref(rpa, qd.float(), kp32, vp32, table, start, scale)))
        unsplit = rpa._launch(q, kp, vp, table, rows, pos, scale,
                              split=False)
        if not (torch.equal(got, again) and torch.equal(got, unsplit)):
            raise AssertionError(f"{layout} {dtype}: two launches, or the "
                                 "split and unsplit launches, differ")
    torch.cuda.synchronize()
    log("kernel", check="long rows: two launches bit-equal, split == "
        "unsplit bit-equal", pool=layout, positions=edges,
        chunks_crossed=f"1-{max(edges) // span + 1}", chunk_pages=rpa.CHUNK_PAGES,
        split_launch_device_launches=launches, max_abs_err=f"{max_err:.3e}")
    return max_err


def _pool_token_read_bytes(layout):
    """Bytes one context token's K and V cost a query of all H heads."""
    if layout == "int8":
        return 2 * (H * D + 4)
    if layout == "int4":
        return 2 * (H * D // 2 + 4 * (H * D // 32))
    return 2 * H * D * 2


def _dequantized(rpa, pool, l, table):
    """Layer l's pages of `table` gathered and dequantized to bf16
    [T, MP * PS, H, D] (for the library yardstick only)."""
    if not isinstance(pool, tuple):
        g = pool[l][table.long()]
    elif pool[0].dtype == torch.uint8:
        g = rpa._dequant_page_int4(pool[0][l][table.long()],
                                   pool[1][l][table.long()], (H, D))
    else:
        g = (pool[0][l][table.long()].float()
             * pool[1][l][table.long()][..., None, None])
    return g.to(torch.bfloat16).reshape(table.shape[0], MP * PS, H, D)


# The ragged kernel's eager times before the redesign (H100 80GB HBM3,
# 700 W): serial page walk, one block per (token, head).
RPA_EARLIER_MS = {"bf16": 0.3054, "int8": 0.4731, "int4": 0.4895}
# the chunk-mix shape: one row's 128-token prefill chunk at 512..639
CHUNK_ROW_POS, CHUNK_TOKENS = 512, 128


def _rpa_readings(rpa, kern, plain, library, nbytes, flops, iters):
    """The ragged kernel's time beside its plain version and a library
    yardstick: eager CUDA events around `iters` calls (`ms`, as PRs 1-8
    timed it; a call whose Python outlasts its kernel is host time), the
    same calls replayed from a CUDA graph (`device_ms`: device time
    alone), each side's host time a call, the bound (bytes over 3.35 TB/s
    or f32 flops over 67 TFLOP/s, the larger) and the device launches a
    wrapper call makes."""
    before = (rpa.kernel_launches, rpa.device_launches)
    kern()
    calls = rpa.kernel_launches - before[0]
    launches = rpa.device_launches - before[1]
    r = {"ms": cuda_ms(kern, iters), "device_ms": cuda_graph_ms(kern, iters),
         "plain_ms": cuda_ms(plain, 3),
         "library_ms": cuda_ms(library, iters),
         "library_device_ms": cuda_graph_ms(library, iters)}
    host = {"host_us": host_us(kern, iters),
            "library_host_us": host_us(library, iters)}
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    r["bound_ms"], r["bound_by"] = max((bytes_ms, "bytes"),
                                       (ops_ms, "operations"))
    return r, host, launches / max(calls, 1)


def phase_kernel_timing(rpa, layout="bf16", layers=24):
    """Time the kernel at the serving path's decode shape: one packed
    decode token per slot (T=16), context positions drawn like the
    served requests', bf16 queries over pools of all 24 layers in
    `layout` (each launch reads the next layer's pool, as a serving tick
    does, so the 50 MB L2 does not hold the pages between launches).
    Library: one SDPA call over K/V gathered (and dequantized) to dense
    bf16 with a causal key mask. Goals: below the library on each
    reading; stretch: within 4x the byte bound (25% of its rate)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    P = 16 * MP + 1
    T = 16
    kp, vp = _pool(gen, P, torch.bfloat16, layers=layers) \
        if layout == "bf16" else _quant_pool(gen, P, layout, layers=layers)
    table = torch.from_numpy(
        rng.permutation(P - 1)[:T * MP].reshape(T, MP).astype(np.int32)
    ).cuda()
    pos_np = rng.randint(64, 832, T).astype(np.int32)
    pos = torch.from_numpy(pos_np).cuda()
    rows = torch.arange(T, dtype=torch.int32, device="cuda")
    q = torch.randn((layers, T, H, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    scale = 1.0 / D ** 0.5

    # each layer's views made once: a timed call is the wrapper's alone
    ql = list(q)
    kl = [_layer_pool(kp, l) for l in range(layers)]
    vl = [_layer_pool(vp, l) for l in range(layers)]

    def kern(i=0):
        return rpa.ragged_paged_attention_packed(
            ql[i % layers], kl[i % layers], vl[i % layers], table, rows, pos)

    def plain(i=0):
        return _ref(rpa, ql[i % layers][:, None], kl[i % layers],
                    vl[i % layers], table, pos, scale)

    # yardstick only, never called by the port: one SDPA call over K/V
    # gathered (and dequantized) to dense bf16 [T, H, MP*PS, D] with a
    # causal key mask
    kd = [_dequantized(rpa, kp, l, table).transpose(1, 2) for l in range(2)]
    vd = [_dequantized(rpa, vp, l, table).transpose(1, 2) for l in range(2)]
    mask = (torch.arange(MP * PS, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]

    qd = [x[:, :, None] for x in ql]

    def library(i=0):
        return torch.nn.functional.scaled_dot_product_attention(
            qd[i % layers], kd[i % 2], vd[i % 2], attn_mask=mask,
            scale=scale)

    keys = pos_np.astype(np.int64) + 1
    kv_bytes = int(keys.sum()) * _pool_token_read_bytes(layout)
    io_bytes = 2 * T * H * D * 2 + 4 * (2 * T + int((keys + PS - 1).sum()
                                                    // PS))
    flops = int(keys.sum()) * H * 4 * D                  # q.k and p.v
    r, host, per_call = _rpa_readings(rpa, kern, plain, library,
                                      kv_bytes + io_bytes, flops, 240)
    log("kernel_time", pool=layout, shape=f"packed T={T} H={H} D={D} "
        f"ps={PS} MP={MP} bf16 q mean_ctx={keys.mean():.1f}",
        **{k: f"{v:.4f}" for k, v in r.items() if k != "bound_by"},
        bound_by=r["bound_by"], **{k: f"{v:.2f}" for k, v in host.items()},
        earlier_ms=RPA_EARLIER_MS[layout],
        device_launches_per_call=f"{per_call:g}",
        achieved_GBps=f"{(kv_bytes + io_bytes) / r['device_ms'] / 1e6:.1f}",
        **_rpa_goals(r))
    return r


def _rpa_goals(r):
    """The redesign's goals on both readings: below the library call, and
    the stretch of 25% of the bound's rate (ms <= 4 x bound_ms)."""
    out = {}
    for reading, ms, lib in (("eager", r["ms"], r["library_ms"]),
                             ("device", r["device_ms"],
                              r["library_device_ms"])):
        out[f"goal_below_library_{reading}"] = \
            "met" if ms < lib else "missed"
        out[f"stretch_4x_bound_{reading}"] = \
            "met" if ms <= 4 * r["bound_ms"] else "missed"
    return out


def phase_chunk_mix_timing(rpa, layout="bf16", layers=24):
    """The kernel at a chunked-prefill tick: one row's 128-token prefill
    chunk at positions 512-639, then 16 decode tokens as in the decode
    shape, packed (T 144), bf16 q over 24 rotating layer pools. The
    chunk's 128 queries form tiles that share each page load. Library:
    SDPA over the chunk row's gathered K/V (640 keys) with its causal
    mask, plus the decode shape's SDPA call (two calls). Bound: the K/V
    bytes of the 640 + the decode rows' keys read once, or 4 D f32 flops
    a (query, key) pair, the larger."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.RandomState(SEED + 2)
    T = 16
    P = (T + 1) * MP + 1
    kp, vp = _pool(gen, P, torch.bfloat16, layers=layers) \
        if layout == "bf16" else _quant_pool(gen, P, layout, layers=layers)
    table = torch.from_numpy(rng.permutation(P - 1)[:(T + 1) * MP].reshape(
        T + 1, MP).astype(np.int32)).cuda()
    dpos = rng.randint(64, 832, T).astype(np.int32)
    cpos = CHUNK_ROW_POS + np.arange(CHUNK_TOKENS, dtype=np.int32)
    pos_np = np.concatenate([cpos, dpos])
    rows_np = np.concatenate([np.full(CHUNK_TOKENS, T), np.arange(T)]
                             ).astype(np.int32)
    pos = torch.from_numpy(pos_np).cuda()
    rows = torch.from_numpy(rows_np).cuda()
    n = len(pos_np)
    q = torch.randn((layers, n, H, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    scale = 1.0 / D ** 0.5

    ql = list(q)
    kl = [_layer_pool(kp, l) for l in range(layers)]
    vl = [_layer_pool(vp, l) for l in range(layers)]

    def kern(i=0):
        return rpa.ragged_paged_attention_packed(
            ql[i % layers], kl[i % layers], vl[i % layers], table, rows, pos)

    def plain(i=0):
        return _ref(rpa, ql[i % layers][:, None], kl[i % layers],
                    vl[i % layers], table[rows.long()], pos, scale)

    ckeys = CHUNK_ROW_POS + CHUNK_TOKENS
    kd = [_dequantized(rpa, kp, l, table).transpose(1, 2) for l in range(2)]
    vd = [_dequantized(rpa, vp, l, table).transpose(1, 2) for l in range(2)]
    kc = [x[T:, :, :ckeys].contiguous() for x in kd]     # [1, H, 640, D]
    vc = [x[T:, :, :ckeys].contiguous() for x in vd]
    kdec = [x[:T] for x in kd]
    vdec = [x[:T] for x in vd]
    cmask = (torch.arange(ckeys, device="cuda")[None, :]
             <= torch.from_numpy(cpos).cuda()[:, None].long())
    dmask = (torch.arange(MP * PS, device="cuda")[None, :]
             <= torch.from_numpy(dpos).cuda()[:, None].long()
             )[:, None, None, :]

    qc = [x[:CHUNK_TOKENS].transpose(0, 1)[None] for x in ql]
    qdec = [x[CHUNK_TOKENS:, :, None] for x in ql]

    def library(i=0):
        a = torch.nn.functional.scaled_dot_product_attention(
            qc[i % layers], kc[i % 2], vc[i % 2], attn_mask=cmask,
            scale=scale)
        b = torch.nn.functional.scaled_dot_product_attention(
            qdec[i % layers], kdec[i % 2], vdec[i % 2], attn_mask=dmask,
            scale=scale)
        return a, b

    keys = dpos.astype(np.int64) + 1
    per_tok = _pool_token_read_bytes(layout)
    kv_bytes = (int(keys.sum()) + ckeys) * per_tok
    io_bytes = 2 * n * H * D * 2 + 4 * (2 * n + (T + 1) * MP)
    pairs = int(keys.sum()) + int((cpos.astype(np.int64) + 1).sum())
    flops = pairs * H * 4 * D
    r, host, per_call = _rpa_readings(rpa, kern, plain, library,
                                      kv_bytes + io_bytes, flops, 96)
    log("kernel_time", pool=layout, shape=f"chunk mix packed T={n}: "
        f"{CHUNK_TOKENS} prefill at {CHUNK_ROW_POS}-"
        f"{CHUNK_ROW_POS + CHUNK_TOKENS - 1} + {T} decode, bf16 q",
        **{k: f"{v:.4f}" for k, v in r.items() if k != "bound_by"},
        bound_by=r["bound_by"], **{k: f"{v:.2f}" for k, v in host.items()},
        device_launches_per_call=f"{per_call:g}",
        achieved_GBps=f"{(kv_bytes + io_bytes) / r['device_ms'] / 1e6:.1f}",
        achieved_TFLOPs=f"{flops / r['device_ms'] / 1e9:.2f}")
    return r


# The serving engine's packed ticks by how many of its 16 rows stream a
# 128-token prefill chunk (the others decode a token each): from the decode
# tick (T 16) to the widest (every row prefilling, T 2048)
PLAN_PREFILL_ROWS = (0, 1, 2, 4, 8, 16)


def phase_split_plan_timing(rpa, layout="bf16", layers=24):
    """Both launch plans at the serving engine's packed tick shapes: the
    device time (CUDA graph) of the split launch (a block a chunk, then a
    merge kernel) and of the unsplit one (a tile's chunks in one block,
    merged in shared memory), the two bit-equal, and the plan the wrapper
    picks (`SPLIT_MAX_ROWS`) beside the faster one. Prefill chunks sit at
    multiples of 128 in 0-640, decode tokens at 64-831; bf16 q over 24
    rotating layer pools of `layout`."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rng = np.random.RandomState(SEED + 4)
    S = 16
    P = S * MP + 1
    kp, vp = _pool(gen, P, torch.bfloat16, layers=layers) \
        if layout == "bf16" else _quant_pool(gen, P, layout, layers=layers)
    table = torch.from_numpy(rng.permutation(P - 1)[:S * MP].reshape(
        S, MP).astype(np.int32)).cuda()
    kl = [_layer_pool(kp, l) for l in range(layers)]
    vl = [_layer_pool(vp, l) for l in range(layers)]
    scale = 1.0 / D ** 0.5
    out = []
    for n_pf in PLAN_PREFILL_ROWS:
        rows_np, pos_np = [], []
        for r in range(S):
            if r < n_pf:
                p0 = CHUNK_TOKENS * rng.randint(0, 6)
                rows_np += [r] * CHUNK_TOKENS
                pos_np += list(p0 + np.arange(CHUNK_TOKENS))
            else:
                rows_np.append(r)
                pos_np.append(rng.randint(64, 832))
        T = len(rows_np)
        rows = torch.tensor(rows_np, dtype=torch.int32, device="cuda")
        pos = torch.tensor(pos_np, dtype=torch.int32, device="cuda")
        ql = list(torch.randn((layers, T, H, D), generator=gen,
                              device="cuda").to(torch.bfloat16))

        def run(split):
            return lambda i=0: rpa._launch(
                ql[i % layers], kl[i % layers], vl[i % layers], table, rows,
                pos, scale, split=split)
        if not torch.equal(run(True)(), run(False)()):
            raise AssertionError(f"{layout} T={T}: the split and unsplit "
                                 "launches differ")
        before = rpa.device_launches
        rpa.ragged_paged_attention_packed(ql[0], kl[0], vl[0], table, rows,
                                          pos)
        picked = "split" if rpa.device_launches - before == 2 else "unsplit"
        ms = {name: cuda_graph_ms(run(name == "split"), 24)
              for name in ("split", "unsplit")}
        faster = min(ms, key=ms.get)
        log("kernel_time", check="launch plans", pool=layout, T=T,
            prefill_rows=n_pf, query_heads=T * H,
            split_device_ms=f"{ms['split']:.4f}",
            unsplit_device_ms=f"{ms['unsplit']:.4f}", faster=faster,
            picked=picked, split_max_rows=rpa.SPLIT_MAX_ROWS)
        out.append((T, ms, picked))
    torch.cuda.synchronize()
    return out


# W4A16 matmul: the four products of a gpt_1p3b layer (K, N), and edge
# shapes (S, K, N): one vocab-wide row of odd N, odd K with S off any tile
W4_SHAPES = (("qkv", 2048, 6144), ("proj", 2048, 2048), ("fc1", 2048, 8192),
             ("fc2", 8192, 2048))
W4_EDGES = ((1, 2048, 50257), (37, 97, 50), (130, 2049, 33))
# row counts whose rows must come out with the bits they have inside the
# 2048-row chunk: the decode body (S <= 16) and the prefill body, full and
# ragged tiles
W4_EQUAL_S = (1, 16, 17, 64, 300)


def _w4_weight(gen, w4, K, N, with_float=False):
    """A random [K, N] weight like the model's (std 0.02), int4-packed;
    with `with_float`, also the f32 weight it was quantized from."""
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
    packed, scale = w4.quantize_w4(w)
    return (packed, scale, w) if with_float else (packed, scale)


def phase_w4_checks(w4):
    """The W4 kernel against its plain version `_w4_ref`, f32 and bf16 x,
    at the path's four (K, N) with S = 16 (a decode tick) and S = 2048 (a
    prefill chunk), and at the edge shapes; the first S rows of x, for
    each S of W4_EQUAL_S, give the same bits alone as inside the 2048-row
    chunk (schedule independence: the bodies and tiles differ by S, an
    output's summation tree does not). Tolerance: `_check_close` with the
    f32 allowance 1e-5 * sqrt(K / 128). The kernel sums an output's K
    products in one sequential f32 chain, cuBLAS (the plain version) in
    blocks; the chain's rounding error grows like a random walk, as the
    square root of K, so the allowance of the JAX package's kernel test
    (1e-5 at K = 64..128) grows with it: 8e-5 at K = 8192. And the JAX
    package's accuracy rule for int4 weights (tests/test_w4_quant.py):
    the f32 product tracks the unquantized product within a mean relative
    error of 0.2 (a weight's error is ~scale/sqrt(12), ~12% of its
    spread, and so is the output's)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    max_err = 0.0
    cases = [(name, S, K, N) for name, K, N in W4_SHAPES
             for S in (16, 2048)] + [("edge", *e) for e in W4_EDGES]
    for dtype in (torch.float32, torch.bfloat16):
        for name, S, K, N in cases:
            packed, scale, w = _w4_weight(gen, w4, K, N, with_float=True)
            x = _rand(gen, (S, K), dtype)
            got = w4.w4_matmul(x, packed, scale, K)
            fp = x.float() @ w
            rel = float((got.float() - fp).abs().mean() / fp.abs().mean())
            if rel >= 0.2:
                raise AssertionError(f"w4 {name}: relative error {rel:.3f} "
                                     "against the unquantized product")
            plain32 = w4._w4_ref(x.float(), packed, scale, K)
            err = _check_close(f"w4 {name} S={S}", got, plain32.to(dtype),
                               plain32, tol=1e-5 * max(1.0, (K / 128) ** 0.5))
            max_err = max(max_err, err)
            for s_alone in (W4_EQUAL_S if S == 2048 else ()):
                if not torch.equal(w4.w4_matmul(x[:s_alone].contiguous(),
                                                packed, scale, K),
                                   got[:s_alone]):
                    raise AssertionError(
                        f"w4 {name} {dtype}: rows :{s_alone} differ alone "
                        "and inside the 2048-row chunk")
            log("kernel", form=f"w4_matmul {name} S={S} K={K} N={N}",
                dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}",
                rel_err_vs_unquantized=f"{rel:.4f}",
                bit_equal_alone=(f"S in {W4_EQUAL_S}" if S == 2048
                                 else "-"))
            del packed, scale, w, x, got, plain32, fp
    torch.cuda.synchronize()
    log("kernel", form="w4_matmul bodies run by the checks",
        **dict(sorted(w4.branch_launches.items())))
    return max_err


# The earlier (SIMT f32 FMA) design's times at the same shapes, as this
# script measured them (PERF.md kernel table row 11; NVIDIA H100 80GB
# HBM3, 700 W): the tensor-core design is reported against them.
W4_EARLIER_MS = {("qkv", 16): 0.0813, ("proj", 16): 0.0714,
                 ("fc1", 16): 0.0866, ("fc2", 16): 0.2750,
                 ("qkv", 2048): 1.988, ("proj", 2048): 0.704,
                 ("fc1", 2048): 2.645, ("fc2", 2048): 2.855}


def phase_w4_timing(w4):
    """The W4 kernel at each product of a layer, bf16 x, S = 16 and 2048,
    against its plain version and cuBLAS on the dequantized bf16 weight
    (`x @ w`, a yardstick the port never calls). Each call reads the next
    of enough weight copies to exceed the 50 MB L2, as a tick's 96
    products do. Two readings of each side: `ms` and `library_ms` from
    CUDA events around eager calls (`cuda_ms`, as the earlier design and
    its cuBLAS yardstick were timed; at S 16 it includes the host's
    launch gaps where a call's Python takes longer than its kernel), and
    `device_ms` and `library_device_ms` from the same calls replayed
    from a CUDA graph (`cuda_graph_ms`: device time alone); at S 16 also
    each side's host time a call (`host_us`). Bound: bytes
    (x, the packed weight and scales, out) over 3.35 TB/s or 2*S*K*N
    over 989 TFLOP/s, the larger. Each row reports the earlier design's
    (eager) time and the redesign's goal (S 16: the layer no slower than
    cuBLAS; S 2048: each product within 2x cuBLAS) as met or missed on
    both readings; nothing is asserted on time. Returns the sum of the
    rows over one layer's four products at S = 16 (a decode tick's share
    of one layer)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    bf = torch.bfloat16
    rows = {}
    for name, K, N in W4_SHAPES:
        copies = max(2, -(-120 * 2 ** 20 // (K * N // 2)))
        ws = [_w4_weight(gen, w4, K, N) for _ in range(copies)]
        deq = [(w4._unpack_w4(p, K).float() * s).to(bf) for p, s in ws[:2]]
        for S in (16, 2048):
            x = _rand(gen, (S, K), bf)
            iters = 96 if S == 16 else 10

            def kern(i=0):
                p, s = ws[i % copies]
                return w4.w4_matmul(x, p, s, K)

            def plain(i=0):
                p, s = ws[i % copies]
                return w4._w4_ref(x, p, s, K)

            def library(i=0):
                return x @ deq[i % 2]

            r = {"ms": cuda_ms(kern, iters),
                 "device_ms": cuda_graph_ms(kern, iters),
                 "plain_ms": cuda_ms(plain, 3),
                 "library_ms": cuda_ms(library, iters),
                 "library_device_ms": cuda_graph_ms(library, iters)}
            host = {} if S != 16 else {
                "host_us": f"{host_us(kern, iters):.2f}",
                "library_host_us": f"{host_us(library, iters):.2f}"}
            nbytes = S * K * 2 + K * N // 2 + 4 * N + S * N * 2
            flops = 2 * S * K * N
            r["bound_ms"], r["bound_by"] = _bound(nbytes, flops)
            rows[(name, S)] = r
            dev = r["device_ms"]
            goal = {} if S == 16 else _w4_goals(
                "goal_2x_library", r, lambda ms, lib: ms <= 2 * lib)
            log("kernel_time", kernel="w4_matmul", shape=f"{name} S={S} "
                f"K={K} N={N} bf16",
                **{k: f"{v:.4f}" for k, v in r.items() if k != "bound_by"},
                bound_by=r["bound_by"],
                earlier_ms=W4_EARLIER_MS[(name, S)],
                achieved_TFLOPs=f"{flops / dev / 1e9:.2f}",
                achieved_GBps=f"{nbytes / dev / 1e6:.1f}",
                hbm_share=f"{nbytes / dev * 1e3 / H100_HBM_BYTES_PER_S:.3f}",
                **host, **goal)
        del ws, deq
    layer = {k: sum(rows[(n, 16)][k] for n, _, _ in W4_SHAPES)
             for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                       "library_ms", "library_device_ms")}
    layer["bound_by"] = max(
        ("bytes", "operations"), key=lambda by: sum(
            r["bound_ms"] for (_, S), r in rows.items()
            if S == 16 and r["bound_by"] == by))
    earlier = sum(W4_EARLIER_MS[(n, 16)] for n, _, _ in W4_SHAPES)
    log("kernel_time", kernel="w4_matmul", shape="one layer's 4 products, "
        "S=16", **{k: f"{v:.4f}" for k, v in layer.items() if k !=
                   "bound_by"},
        earlier_ms=f"{earlier:.4f}",
        bound_share=f"{layer['bound_ms'] / layer['device_ms']:.3f}",
        **_w4_goals("goal_no_slower_than_library", layer,
                    lambda ms, lib: ms <= lib))
    return layer


def _w4_goals(goal, r, met):
    """A W4 goal on both readings: eager (`ms` against `library_ms`) and
    device time (`device_ms` against `library_device_ms`)."""
    return {f"{goal}_eager": "met" if met(r["ms"], r["library_ms"])
            else "missed",
            f"{goal}_device": "met" if met(r["device_ms"],
                                           r["library_device_ms"])
            else "missed"}


# ---------------------------------------------------------------- phase 3

N_REQ, MAX_NEW, K_MAX = 32, 64, 8


def _serve_run(dec, prompts, mods, **eng_kw):
    """The main serving run: a warm-up request, then the 32 prompts x 64
    new tokens through the default (ragged, packed) engine with k_max 8,
    or the engine `eng_kw` asks for (the warm-up takes them too). Every
    kernel count of `mods` is set to 0 just before the run and read just
    after. Returns (engine, streams, wall seconds, {module: (kernel
    launches, plain launches)}, with the ragged kernel's device launches
    under "device")."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    # warm-up (cuBLAS handles, allocator): one short request
    warm = ContinuousBatchingEngine(dec, max_new_tokens=4, k_max=K_MAX,
                                    **{k: v for k, v in eng_kw.items()
                                       if k != "trace"})
    warm.submit(prompts[0][:64])
    warm.run()
    eng = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW, k_max=K_MAX,
                                   **eng_kw)
    rids = [eng.submit(p) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods:
        mod.reset_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {mod.__name__.rsplit(".", 1)[1]: (mod.kernel_launches,
                                                 mod.plain_launches)
                for mod in mods}
    # device launches of the ragged kernel (a split call is two)
    launches["device"] = (mods[0].device_launches, 0)
    streams = [out[r] for r in rids]
    if any(len(s) != MAX_NEW for s in streams):
        raise AssertionError("a request did not return 64 tokens")
    if not all(0 <= t < dec.cfg.vocab_size for s in streams for t in s):
        raise AssertionError("a token id is out of the vocabulary")
    return eng, streams, wall, launches


def _serve_fields(eng, wall):
    st = eng.stats.summary()
    return dict(
        wall_s=f"{wall:.3f}", gen_tok_per_s=f"{N_REQ * MAX_NEW / wall:.1f}",
        ttft_p50_ms=st.get("ttft_p50_ms"), ttft_p99_ms=st.get("ttft_p99_ms"),
        token_p50_ms=st.get("token_p50_ms"),
        token_p99_ms=st.get("token_p99_ms"), horizons=st["decode_syncs"],
        ticks=st["ticks"], pad_fraction=st.get("pad_fraction"))


def phase_serving(rpa):
    from paddle_tpu_torch.models import gpt_1p3b, init_state_dict
    from paddle_tpu_torch.serving import PagedGPTDecoder
    from paddle_tpu_torch.serving.scheduler import RaggedScheduler
    cfg = gpt_1p3b()
    t0 = time.perf_counter()
    sd = init_state_dict(cfg, seed=SEED)
    dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                          max_batch=16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # the quantized runs build their decoders from the same weights; they
    # wait in host memory, so this run's peak device memory holds only
    # its own decoder
    sd = {k: v.cpu() for k, v in sd.items()}
    rng = np.random.RandomState(SEED)
    lengths = rng.randint(64, 769, N_REQ)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    priced_k = RaggedScheduler(dec).k_max
    eng, streams, wall, counts = _serve_run(dec, prompts, (rpa,))
    launches = dict(zip(("kernel", "plain"),
                        counts["ragged_paged_attention"]))
    if launches["kernel"] <= 0 or launches["plain"] != 0:
        raise AssertionError(f"attention launches on the card: {launches}")
    device = counts["device"][0]
    fields = _serve_fields(eng, wall)
    log("serve", model="gpt_1p3b", layers=cfg.num_layers,
        hidden=cfg.hidden_size, requests=N_REQ, max_new=MAX_NEW,
        max_batch=16, k_max=K_MAX, priced_k_max=priced_k,
        chunk_tokens=eng.scheduler.chunk_tokens, setup_s=f"{setup_s:.2f}",
        **fields,
        kernel_launches=launches["kernel"],
        plain_launches=launches["plain"], device_launches=device,
        device_launches_per_call=f"{device / launches['kernel']:.3f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return sd, dec, prompts, streams, launches, fields


def phase_profile(dec, prompts, **tags):
    """Where a serving window's time goes: 16 requests (128-token
    prompts, 32 new tokens) through the default engine under
    torch.profiler. Device time is summed by kernel family; the busy
    share is device kernel time over the window's wall time (one stream,
    so kernels do not overlap). Also counts the window's device kernels
    a tick, the host's dispatch load."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(dec, max_new_tokens=32, k_max=K_MAX)
    for p in prompts[:16]:
        eng.submit(p[:128])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = {"attention": 0.0, "w4_matmul": 0.0, "a8w8": 0.0, "gemm": 0.0,
           "other": 0.0}
    kernels = []
    n_launch = 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        name = ev.key
        kernels.append((us, name))
        n_launch += ev.count
        if "ragged_paged_attention" in name:
            fam["attention"] += us
        elif "w4_matmul" in name:
            fam["w4_matmul"] += us
        elif "a8w8" in name:
            fam["a8w8"] += us
        elif any(t in name.lower() for t in ("gemm", "nvjet", "cutlass",
                                             "xmma")):
            fam["gemm"] += us                # cuBLAS / cuBLASLt kernels
        else:
            fam["other"] += us
    ticks = eng.stats.ticks
    busy = sum(fam.values()) / 1e6
    if busy <= 0:
        log("profile", **tags, device_time="not measured (the profiler "
            "saw no device kernels)", wall_s=f"{wall:.3f}", ticks=ticks)
        return
    log("profile", **tags, window="16 req x (128 prompt + 32 new)",
        ticks=ticks, wall_ms_per_tick=f"{wall / ticks * 1e3:.3f}",
        device_ms_per_tick=f"{busy / ticks * 1e3:.3f}",
        device_busy_share=f"{busy / wall:.3f}",
        device_kernels_per_tick=f"{n_launch / ticks:.0f}",
        **{f"{k}_ms_per_tick": f"{v / 1e3 / ticks:.3f}"
           for k, v in fam.items()})
    for us, name in sorted(kernels, reverse=True)[:6]:
        log("profile_top", **tags, kernel=repr(name[:90]),
            ms_per_tick=f"{us / 1e3 / ticks:.3f}")


# ---------------------------------------------------------------- phase 4

N_ORACLE = 4
# A token of the ragged packed engine must score within LOGIT_TOL of the
# per-tick decoder's best logit at the same position (teacher-forced on
# the engine's own tokens). The two paths run the same kernel math per
# token; they differ only where cuBLAS picks another matmul algorithm for
# another row count (M = tokens in the packed stream vs slots per tick),
# which moves a bf16 activation by about one rounding step (2^-8
# relative) here and there; logits of magnitude ~1-10 then move by a few
# hundredths.
LOGIT_TOL = 0.1


def _teacher_force(dec, prompts, streams, aids=None):
    """Teacher-force the per-tick decoder (`_decode_step`) with each
    request's prompt and then `streams` (all of one length), each request
    on its adapter (`aids`, a bank attached). Overwrites the pool's first
    pages. Returns (the largest gap between a tick's best logit and the
    stream token's, the mean NLL of the stream tokens)."""
    n = len(streams)
    new = len(streams[0])
    ps = dec.page_size
    tbl = np.full((n, dec.max_pages), dec.num_pages - 1, np.int32)
    nxt_page = 0
    for r in range(n):
        need = (len(prompts[r]) + new + ps - 1) // ps
        tbl[r, :need] = np.arange(nxt_page, nxt_page + need)
        nxt_page += need
    dec.prefill_suffix_batch(
        [(prompts[r][:-1], 0, tbl[r][tbl[r] < dec.num_pages - 1].tolist())
         for r in range(n)], aids=aids)
    table = dec._as_i32(tbl)
    aids = dec._aids([0] * n if aids is None else list(aids))
    gap, nll = 0.0, []
    for i in range(new):
        toks = [prompts[r][-1] if i == 0 else streams[r][i - 1]
                for r in range(n)]
        lens = [len(prompts[r]) - 1 + i for r in range(n)]
        _, logits = dec._decode_step(dec._as_i32(toks), dec._as_i32(lens),
                                     table, aids=aids)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite per-tick logits")
        chosen = logits[torch.arange(n, device=logits.device),
                        torch.as_tensor([s[i] for s in streams],
                                        device=logits.device)]
        gap = max(gap, float((logits.max(-1).values - chosen).max()))
        nll.append(torch.logsumexp(logits, -1) - chosen)
    return gap, float(torch.stack(nll).mean())


def _kv_bytes(dec, pages):
    """One sequence's K and V pool leaves (payload, and the scales of a
    quantized pool), pages in block order: copies [L, positions, ...]."""
    idx = torch.as_tensor(pages, dtype=torch.long, device=dec.device)
    leaves = []
    for pool in (dec.k_pages, dec.v_pages):
        for x in (pool if isinstance(pool, tuple) else (pool,)):
            g = x[:, idx]
            leaves.append(g.reshape(g.shape[0], -1, *g.shape[3:]))
    return leaves


class _AttnTap:
    """Stands in for the decoder module's `rpa` during a replay: passes
    every call to the kernel's wrappers and keeps, layer by layer, the q
    row and the output row of one query a request (`want`: request id ->
    position), found by its table row's first page and its position. The
    last call holding it wins (a pad query of the packed stream can sit at
    a row's future position before that position is real)."""

    def __init__(self, rpa, dec, want):
        self.rpa, self.want, self.eng, self.rows = rpa, want, None, {}
        leaf = dec.k_pages[0] if isinstance(dec.k_pages, tuple) \
            else dec.k_pages
        self.layer = {leaf[l].data_ptr(): l for l in range(leaf.shape[0])}

    def _keep(self, q, out, kp, table, rows, pos):
        first = {self.eng._slot_pages[s][0]: rid
                 for s, rid in enumerate(self.eng._slot_req)
                 if rid in self.want and self.eng._slot_pages[s]}
        if not first:
            return
        leaf = kp[0] if isinstance(kp, tuple) else kp
        layer = self.layer[leaf.data_ptr()]
        heads = table[:, 0][rows.long()].tolist()
        for t, (pg, x) in enumerate(zip(heads, pos.tolist())):
            rid = first.get(pg)
            if rid is not None and x == self.want[rid]:
                self.rows.setdefault(rid, {})[layer] = (q[t].clone(),
                                                        out[t].clone())

    def ragged_paged_attention(self, q, kp, vp, table, start):
        out = self.rpa.ragged_paged_attention(q, kp, vp, table, start)
        rows = torch.arange(q.shape[0], device=q.device)
        self._keep(q[:, 0], out[:, 0], kp, table, rows, start)
        return out

    def ragged_paged_attention_packed(self, q, kp, vp, table, rows, pos):
        out = self.rpa.ragged_paged_attention_packed(q, kp, vp, table, rows,
                                                     pos)
        self._keep(q, out, kp, table, rows, pos)
        return out


def _replay(rpa, dec, prompts, want, k_max, kv_want):
    """One engine run of `prompts` (k_max 1: the per-tick engine; else the
    ragged one), keeping the K/V pool bytes of the requests in `kv_want`
    and, through `_AttnTap`, the attention q and output rows of `want`
    (request id -> position). Returns (streams, K/V bytes, tapped rows)."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.serving import decoder as dec_module

    class Capture(ContinuousBatchingEngine):
        def _retire(self, slot):         # copy before the pages are freed
            if self._slot_req[slot] in kv_want:
                self.kv[self._slot_req[slot]] = _kv_bytes(
                    self.d, self._slot_pages[slot])
            super()._retire(slot)

    eng = Capture(dec, max_new_tokens=MAX_NEW, k_max=k_max)
    eng.kv = {}
    tap = _AttnTap(rpa, dec, want)
    tap.eng = eng
    rids = [eng.submit(p) for p in prompts]
    dec_module.rpa = tap
    try:
        out = eng.run()
    finally:
        dec_module.rpa = rpa
    return [out[r] for r in rids], eng.kv, tap.rows


def _rows_depend_on_count(dec):
    """Layer 0's four cuBLAS products (qkv, proj, fc1, fc2) on 2048 random
    bf16 rows: the products whose first M rows, M in 16, 144, 512, differ
    in bits from the same rows inside the 2048-row product."""
    from paddle_tpu_torch.serving.decoder import _at, _mm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = []
    for name in ("qkv", "proj", "fc1", "fc2"):
        w, b = _at(dec.weights[f"{name}_w"], 0), _at(dec.weights[f"{name}_b"],
                                                     0)
        if isinstance(w, tuple):
            continue                        # W4: rows fixed by its kernel
        x = torch.randn((2048, w.shape[0]), generator=gen,
                        device="cuda").to(dec.compute_dtype)
        full = _mm(x, w, b)
        if any(not torch.equal(_mm(x[:m], w, b), full[:m])
               for m in (16, 144, 512)):
            out.append(name)
    return out


def _oracle_kv(rpa, dec, prompts, streams, per_tick, diverged, label,
               **tags):
    """Where the engines' streams diverge: both engines replayed (the
    per-tick one on the oracle's requests, the ragged one on all prompts
    as in the main run), each keeping the diverging requests' K/V pool
    bytes: the first position whose K/V differ in any layer, up to the
    diverging token's. Replayed again, they keep there, layer by layer,
    the attention's q and output rows. Layer 0's K/V come from the
    embedding, LayerNorm and the qkv product alone; equal layer-0 K/V, q
    and attention output at that position put the first differing bits
    after the attention kernel, in layer 0's later products
    (`cublas_rows_depend_on_count`: the products whose rows change with
    the row count)."""
    pt_streams, pt_kv, _ = _replay(rpa, dec, prompts[:N_ORACLE], {}, 1,
                                   diverged)
    rg_streams, rg_kv, _ = _replay(rpa, dec, prompts, {}, K_MAX, diverged)
    rows, first = {}, {}
    for i, j in sorted(diverged.items()):
        upto = len(prompts[i]) + j
        diff = None
        for x, y in zip(pt_kv[i], rg_kv[i]):
            d = (x[:, :upto] != y[:, :upto]).reshape(
                x.shape[0], upto, -1).any(-1)                # [L, upto]
            diff = d if diff is None else diff | d
        at = diff.any(0).nonzero().flatten()
        if len(at):
            first[i] = int(at[0])
        rows[i] = dict(
            request=i, first_divergence=j, positions_compared=upto,
            replays_match_runs=(pt_streams[i] == per_tick[i] and
                                rg_streams[i] == streams[i]),
            positions_differing=len(at), first_differing_pos=first.get(i),
            layers_differing_there=(diff[:, first[i]].nonzero().flatten()
                                    .tolist() if i in first else []),
            layer0_positions_differing=int(diff[0].sum()))
    del pt_kv, rg_kv
    _, _, pt_rows = _replay(rpa, dec, prompts[:N_ORACLE], first, 1, ())
    _, _, rg_rows = _replay(rpa, dec, prompts, first, K_MAX, ())
    products = _rows_depend_on_count(dec)
    for i in sorted(diverged):
        a, b = pt_rows.get(i, {}), rg_rows.get(i, {})
        layers = [l for l in sorted(a) if l in b]
        q_eq = [torch.equal(a[l][0], b[l][0]) for l in layers]
        o_eq = [torch.equal(a[l][1], b[l][1]) for l in layers]
        at0 = bool(layers) and layers[0] == 0
        log(f"{label}_kv", **tags, **rows[i], tapped_layers=len(layers),
            layer0_q_equal=q_eq[0] if at0 else None,
            layer0_attention_out_equal=o_eq[0] if at0 else None,
            first_q_diff_layer=next(
                (l for l, e in zip(layers, q_eq) if not e), None),
            first_out_diff_layer=next(
                (l for l, e in zip(layers, o_eq) if not e), None),
            cublas_rows_depend_on_count=products)


def phase_oracle(rpa, dec, prompts, streams, label="oracle", **tags):
    """The first 4 requests through the per-tick engine (k_max 1) against
    the ragged engine's streams (at a divergence, the two engines' K/V
    pool bytes compared: `_oracle_kv`); then the per-tick decoder
    teacher-forced on the ragged engine's tokens, each within LOGIT_TOL of
    its tick's best logit. Returns the mean NLL of those tokens."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW, k_max=1)
    rids = [eng.submit(p) for p in prompts[:N_ORACLE]]
    out = eng.run()
    per_tick = [out[r] for r in rids]
    agree = sum(a == b for a, b in zip(per_tick, streams))
    diverged = {}
    for i, (a, b) in enumerate(zip(per_tick, streams)):
        if a != b:
            j = next(t for t, (x, y) in enumerate(zip(a, b)) if x != y)
            diverged[i] = j
            log(label, **tags, request=i, first_divergence=j,
                prompt_len=len(prompts[i]), per_tick_token=a[j],
                engine_token=b[j])
    if diverged:
        _oracle_kv(rpa, dec, prompts, streams, per_tick, diverged, label,
                   **tags)
        torch.cuda.empty_cache()
    gap, nll = _teacher_force(dec, prompts[:N_ORACLE], streams[:N_ORACLE])
    if gap > LOGIT_TOL:
        raise AssertionError(f"an engine token scores {gap:.4f} below the "
                             f"per-tick best logit (tolerance {LOGIT_TOL})")
    log(label, **tags, streams_agree=f"{agree}/{N_ORACLE}",
        max_logit_gap=f"{gap:.5f}", tolerance=LOGIT_TOL,
        mean_nll=f"{nll:.5f}")
    return nll


# ---------------------------------------------------------------- phase 4b
# Quantized serving: gpt_1p3b from an int8 pool, an int4 pool and int4
# weights (on a bf16 pool), each with the bf16 run's traffic.

QUANT_MODES = (("int8", {"kv_quant": "int8"}), ("int4", {"kv_quant": "int4"}),
               ("w4a16", {"quant": "w4a16"}))
# The JAX package's accuracy gate for quantized KV pools
# (tests/test_kv_quant.py): an int8 or int4 pool may move the mean
# teacher-forced NLL of the bf16 run's streams by at most 0.05 nats
# against the bf16 pool. It commits no such bound for int4 weights: its
# W4 rule is the product's relative error (tests/test_w4_quant.py), which
# phase_w4_checks holds; w4a16's NLL delta is measured and reported.
NLL_TOL = 0.05


def phase_serve_quant(sd, prompts, ref_streams, nll_bf16, rpa, w4):
    """Each quantized configuration served with the bf16 run's traffic:
    tok/s, TTFT, per-token latency, peak memory, KV bytes per token,
    launches of each kernel (plain 0; the W4 kernel runs only under w4a16), a
    profiled window, the 4 oracle streams against its per-tick engine,
    and the NLL delta of the bf16 streams (gated at NLL_TOL for the
    pools). Returns {mode: {kernel: launches}}."""
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import PagedGPTDecoder
    cfg = gpt_1p3b()
    out = {}
    for name, mode in QUANT_MODES:
        t0 = time.perf_counter()
        dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                              max_batch=16, **mode)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        eng, streams, wall, counts = _serve_run(dec, prompts, (rpa, w4))
        device = counts.pop("device")[0]
        kern = {k: v[0] for k, v in counts.items()}
        plain = sum(v[1] for v in counts.values())
        if kern["ragged_paged_attention"] <= 0 or plain or \
                (kern["w4_matmul"] > 0) != (name == "w4a16"):
            raise AssertionError(f"{name}: launches on the card {counts}")
        # the bf16 products take the tensor-core bodies, every one
        w4_routes = dict(sorted(w4.branch_launches.items()))
        if sum(v for r, v in w4_routes.items() if "[tc_" in r) != \
                kern["w4_matmul"]:
            raise AssertionError(f"{name}: W4 launches by body {w4_routes}")
        log("serve_quant", mode=name, model="gpt_1p3b",
            layers=cfg.num_layers, hidden=cfg.hidden_size, requests=N_REQ,
            max_new=MAX_NEW, max_batch=16, k_max=K_MAX,
            chunk_tokens=eng.scheduler.chunk_tokens, setup_s=f"{setup_s:.2f}",
            **_serve_fields(eng, wall),
            kv_bytes_per_token=eng.stats.kv_bytes_per_token,
            rpa_launches=kern["ragged_paged_attention"],
            rpa_device_launches=device,
            rpa_device_launches_per_call=(
                f"{device / kern['ragged_paged_attention']:.3f}"),
            w4_launches=kern["w4_matmul"], **w4_routes, plain_launches=plain,
            peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        phase_profile(dec, prompts, mode=name)
        phase_oracle(rpa, dec, prompts, streams, label="serve_quant_oracle",
                     mode=name)
        _, nll = _teacher_force(dec, prompts[:N_ORACLE],
                                ref_streams[:N_ORACLE])
        delta = nll - nll_bf16
        gated = "kv_quant" in mode
        log("serve_quant_nll", mode=name, nll=f"{nll:.5f}",
            nll_bf16=f"{nll_bf16:.5f}", delta=f"{delta:.5f}",
            tolerance=NLL_TOL if gated else "none (int4 weights)")
        if gated and abs(delta) > NLL_TOL:
            raise AssertionError(f"{name}: mean NLL moved {delta:.4f} nats "
                                 f"from the bf16 pool's (bound {NLL_TOL})")
        out[name] = kern
        del dec, eng
        torch.cuda.empty_cache()
    return out


def phase_small_reference():
    """gpt_tiny in f32: the card's path (kernels) against the port's CPU
    path (plain versions) on the same weights, for the bf16-path pool and
    each quantized mode — decode logits within 1e-4, ragged engine
    streams equal."""
    from paddle_tpu_torch.models import gpt_tiny, init_state_dict
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder)
    cfg = gpt_tiny(max_seq_len=128, dtype="float32")
    sd = init_state_dict(cfg, seed=SEED, device="cpu")
    rng = np.random.RandomState(SEED + 2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 17, 90, 1, 33)]
    for name, mode in (("plain", {}),) + QUANT_MODES:
        outs, logits = [], []
        for device in ("cuda", "cpu"):
            dec = PagedGPTDecoder(cfg, {k: v.to(device)
                                        for k, v in sd.items()},
                                  num_pages=48, page_size=16, max_batch=4,
                                  device=device, **mode)
            eng = ContinuousBatchingEngine(dec, max_new_tokens=12, k_max=4,
                                           chunk_tokens=16)
            rids = [eng.submit(p) for p in prompts]
            res = eng.run()
            outs.append([res[r] for r in rids])
            first = dec.prefill_batch([(prompts[1], [0, 1, 2])])
            _, lg = dec._decode_step(dec._as_i32(first), dec._as_i32([40]),
                                     dec._as_i32([[0, 1, 2] + [47] * 5]))
            logits.append(lg.cpu())
        torch.testing.assert_close(logits[0], logits[1], atol=1e-4, rtol=0)
        if outs[0] != outs[1]:
            raise AssertionError(f"gpt_tiny f32 {name}: streams differ card "
                                 "vs CPU")
        err = float((logits[0] - logits[1]).abs().max())
        log("small_ref", model="gpt_tiny f32", mode=name,
            streams="equal card vs cpu", logit_max_abs_err=f"{err:.3e}")


# ---------------------------------------------------------------- phase 5
# The training path's kernels at the gpt_1p3b training shapes.

TB, TL, TH, TD = 8, 1024, 16, 128           # batch, seq, heads, head_dim
TN, TV, THID = TB * TL, 50304, 2048          # rows, vocab, hidden

# Tolerance of a training kernel against its plain version on the same
# inputs: `_check_close` (f32 within atol = rtol = 1e-5; bf16 within one
# bf16 ulp of the plain version's f32 result plus 1e-5).


def _rand(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


# (name, B, L, Hq, Hkv, D, causal): the training shape, gpt_moe_small's
# (16 heads of 64), a small GQA case with a ragged length, a non-causal
# case, head_dim 256 with GQA and a ragged length, and q, k, v as views at
# an odd storage offset (not 16-byte aligned; the bf16 wrapper copies them
# for the tensor-core body)
FLASH_CASES = [("train", TB, TL, TH, TH, TD, True),
               ("moe", TB, TL, 16, 16, 64, True),
               ("gqa", 2, 200, 4, 2, 64, True),
               ("noncausal", 2, 256, 2, 2, 128, False),
               ("d256", 2, 200, 4, 2, 256, True),
               ("offset", 2, 200, 4, 2, 128, True)]


def _rand_at_offset(gen, shape, dtype):
    """A contiguous view one element into a fresh buffer: its data
    pointer is not 16-byte aligned."""
    n = int(np.prod(shape))
    return _rand(gen, (n + 1,), dtype)[1:].view(shape)


# Share of a bf16 forward's rows that may leave one ulp of the plain walk
# because a probability rounds to the other bf16 neighbour (see
# `_check_fwd`): measured 0-1.4% at std-1 inputs (head_dim 64-256; the
# small cases' few rows make it jumpy), 0 at std 0.1. A misplaced
# rounding point moves nearly every row: `_fwd_controls` shows it at the
# GPT and BERT shapes on every run.
FLIP_ROWS = 0.05


def _points_gap(out, at_points, w, flip_rows=FLIP_ROWS, c=1.0):
    """bf16 `out` against the plain walk at the rounding points
    (`at_points`, f32 before its cast; `w` the weight of the p rounding,
    for the forward sum_k (p_use_k / l) |v_k|): (max abs err, share of
    rows with an element beyond one bf16 ulp of |out| plus 1e-5, max of
    err / (ulp + 1e-5 + c 2^-7 w), whether that is at most 1 with at
    most `flip_rows` of the rows beyond)."""
    err = (out.float() - at_points).abs()
    tight = bf16_ulp(at_points) + 1e-5
    beyond = float((err > tight).any(-1).float().mean())
    ratio = float((err / (tight + c * 2 ** -7 * w)).max())
    within = ratio <= 1.0 and beyond <= flip_rows and \
        bool(torch.isfinite(out).all())
    return float(err.max()), beyond, ratio, within


def _walk_weights(A, q, k, v, causal, sc, ex):
    """The plain walk at the rounding points (f32 before its cast) and
    W = sum_k (p_use_k / l) |v_k| from the f32 walk."""
    f32 = tuple(t.float() for t in (q, k, v))
    at_points, _ = A._fwd_ref(q, k, v, causal, sc, ex, f32_out=True)
    w, _ = A._fwd_ref(f32[0], f32[1], f32[2].abs(), causal, sc, ex)
    return at_points, w


def _check_fwd(A, name, q, k, v, causal, sc, ex, out, lse):
    """The forward's out and lse against the plain version on the card.
    f32: `_check_close` against the f32 walk. bf16 (the tensor-core
    body): against the plain walk at the same rounding points
    (`_fwd_ref` on the bf16 inputs: (q.k) * scale, p rounded to bf16
    before P.V, 64-key tiles), in f32 before its cast, out within one
    bf16 ulp of |out| plus 1e-5 on all but FLIP_ROWS of the rows, and
    every element within that plus 2^-7 * W, W = sum_k (p_use_k / l)
    |v_k| (`_points_gap`). The kernel's f32 p differs from the walk's by
    the order of q.k's f32 sum (and expf's last bit); where a p lies
    that close to a bf16 rounding tie the two round it to neighbours one
    bf16 step (<= 2^-7 p) apart, which moves the whole row of out by up
    to 2^-7 p |v| / l. lse within 1e-5 relative (atol = rtol = 1e-5) of
    the f32 plain version (no rounding point touches it). Returns the
    max abs errors of out and lse, the share of rows beyond one ulp and
    the max err / (ulp + 1e-5 + 2^-7 W)."""
    f32 = tuple(t.float() for t in (q, k, v))
    out32, lse32 = A._fwd_ref(*f32, causal, sc, ex)
    if q.dtype == torch.float32:
        return (_check_close(f"{name} out", out, out32, out32),
                _check_close(f"{name} lse", lse, lse32, lse32), 0.0, 0.0)
    err, beyond, ratio, within = _points_gap(
        out, *_walk_weights(A, q, k, v, causal, sc, ex))
    if not within:
        raise AssertionError(
            f"{name}: bf16 out off the plain walk at the rounding points "
            f"(max err {err:.3e}, rows beyond one ulp {beyond:.4f}, max "
            f"err / (ulp + 1e-5 + 2^-7 W) {ratio:.3f})")
    torch.testing.assert_close(lse, lse32, atol=1e-5, rtol=1e-5)
    return err, float((lse - lse32).abs().max()), beyond, ratio


def _fwd_controls(A, name, q, k, v, causal, sc, ex):
    """Controls of `_check_fwd`'s bf16 tolerance: the plain walk with one
    rounding point misplaced, held against the sound walk as a kernel's
    bf16 out would be, must be rejected. "p_unrounded": p_use not
    rounded before P.V (the f32 walk, its out cast to bf16).
    "qscale_bf16": q * scale rounded to bf16 before q.k (the walk on
    bf16(q * scale) with scale 1); at a power-of-two scale (head_dim 64,
    256) that rounding is exact and the walk is the sound one, so it
    must then pass. Logs each control's share of rows beyond one ulp and
    max err / (ulp + 1e-5 + 2^-7 W); raises if the check mistakes one."""
    at_points, w = _walk_weights(A, q, k, v, causal, sc, ex)
    f32 = tuple(t.float() for t in (q, k, v))
    walks = {"p_unrounded": lambda: A._fwd_ref(*f32, causal, sc, ex)[0],
             "qscale_bf16": lambda: A._fwd_ref(
                 (f32[0] * sc).to(q.dtype), k, v, causal, 1.0, ex)[0]}
    exact_scale = float(np.log2(sc)).is_integer()
    for control, walk in walks.items():
        _, beyond, ratio, within = _points_gap(walk().to(q.dtype),
                                               at_points, w)
        sound = control == "qscale_bf16" and exact_scale
        if within != sound:
            raise AssertionError(
                f"{name}: control {control} {'failed' if sound else 'passed'}"
                f" the bf16 forward's check (rows beyond one ulp "
                f"{beyond:.4f}, max err / bound {ratio:.3f})")
        log("kernel", form=f"control {name}", control=control,
            rows_beyond_ulp=f"{beyond:.4f}", err_over_bound=f"{ratio:.3f}",
            rejected=not within)


# The bf16 backward (the tensor-core dQ and dK/dV) against its plain walk
# at the rounding points (`_check_bwd`): an element bound of one bf16 ulp
# + 1e-5 + BWD_C 2^-7 W, and at most BWD_FLIP_ROWS of the rows of each
# gradient beyond one ulp + 1e-5. The kernel's f32 s and dp differ from
# the walk's by the order of their f32 sums; where a dS (or p_use) lies
# that close to a bf16 rounding tie, the two round it to neighbours one
# bf16 step (<= 2^-7 |dS|) apart, which moves dQ by up to 2^-7 |dS_k|
# |K_k| (dK, dV alike): c = 1 is that bound. Measured on an H100 over
# every case of both check phases: at most 0.78% of rows beyond one ulp
# and err / bound <= 0.52; a misplaced rounding point puts 85-100% of
# rows beyond (`_bwd_controls`), so the cap of 5% separates the two.
BWD_C = 1.0
BWD_FLIP_ROWS = 0.05
GRADS = ("dq", "dk", "dv")


def _bwd_weights(A, q, k, v, do, lse, delta, causal, sc, ex):
    """((W_dq, W_dk, W_dv), (dq, dk) of a misplaced walk), f32 and shaped
    as dq, dk, dv. W: sum_k |dS_k| |K_k|, sum_q |dS_q| |Q_q| over the
    group's heads and sum_q |p_use_q| |dO_q|, from the f32 walk's p and
    dS over key tiles. The misplaced walk (`_bwd_controls`) applies the
    scale after dS's rounding: bf16(p (dp - delta)) scale."""
    qh, kh, vh = A._heads(q, k, v)
    doh = do.float().transpose(1, 2)
    B, H, Lq, D = qh.shape
    Lk, Hkv = kh.shape[2], k.shape[2]
    wq, sq = torch.zeros_like(qh), torch.zeros_like(qh)
    wk, wv, sk = (torch.zeros_like(kh) for _ in range(3))
    for k0 in range(0, Lk, A._BLOCK):
        k1 = min(k0 + A._BLOCK, Lk)
        s = (qh @ kh[:, :, k0:k1].transpose(-1, -2)) * sc
        bias = ex.bias(k0, k1)
        if bias is not None:
            s = s + bias
        keep = A._tile_mask(Lq, k0, k1, causal, q.device)
        if keep is not None:
            s = torch.where(keep, s, A._NEG)
        p = torch.exp(s - lse[..., None])
        dp = doh @ vh[:, :, k0:k1].transpose(-1, -2)
        pu = p
        drop = ex.drop(q, k, k0, k1)
        if drop is not None:
            pu, dp = p * drop, dp * drop
        ds_late = A._bf16(p * (dp - delta[..., None])) * sc
        sq += ds_late @ kh[:, :, k0:k1]
        sk[:, :, k0:k1] = ds_late.transpose(-1, -2) @ qh
        ds = (p * (dp - delta[..., None]) * sc).abs()
        wq += ds @ kh[:, :, k0:k1].abs()
        wk[:, :, k0:k1] = ds.transpose(-1, -2) @ qh.abs()
        wv[:, :, k0:k1] = pu.transpose(-1, -2) @ doh.abs()
        del s, p, dp, pu, ds, ds_late
    fold = lambda x: x.reshape(B, Hkv, H // Hkv, Lk, D).sum(2).transpose(1, 2)
    return ((wq.transpose(1, 2), fold(wk), fold(wv)),
            (sq.transpose(1, 2), fold(sk)))


def _bwd_routes(A, run):
    """run() under a look at the launch counters: its result and, for dQ
    and dK/dV, whether the launch took a tensor-core body."""
    before = dict(A.branch_launches)
    res = run()
    new = [key for key, n in A.branch_launches.items()
           if n != before.get(key, 0) and key.startswith("flash_bwd")]
    return res, {name: f"{name}[tc," in "".join(new)
                 for name in ("flash_bwd_dq", "flash_bwd_dkv")}


def _check_bwd(A, name, q, k, v, do, causal, sc, ex, out, lse):
    """dQ, dK, dV of the card's backward against the plain version on the
    same inputs, and a second run bit-equal to the first. f32 and the
    SIMT bodies (bf16 at head_dim 256): `_check_close` against the f32
    walk. bf16 on the tensor-core bodies: against `_bwd_ref`'s walk at
    the rounding points (f32 before its cast), `_points_gap` with
    BWD_FLIP_ROWS and BWD_C, W from `_bwd_weights`. Raises unless both
    launches took the tensor-core bodies exactly where they are due
    (bf16 at `_TC_BWD_HEAD_DIMS`). Returns ({grad: max abs err}, max
    share of rows beyond one ulp, max err / bound)."""
    grads, tc = _bwd_routes(A, lambda: A._bwd(q, k, v, out, lse, do, causal,
                                              sc, ex))
    want_tc = (q.dtype == torch.bfloat16 and
               q.shape[3] in A._TC_BWD_HEAD_DIMS)
    if any(t != want_tc for t in tc.values()):
        raise AssertionError(
            f"{name}: backward bodies {tc}, expected tensor-core bodies "
            f"{want_tc} for {q.dtype} at head_dim {q.shape[3]}")
    again = A._bwd(q, k, v, out, lse, do, causal, sc, ex)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{name}: two backward runs differ")
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if not want_tc:
        r32 = A._bwd_ref(q.float(), k.float(), v.float(), do.float(), lse,
                         delta, causal, sc, ex)
        return ({g: _check_close(f"{name} {g}", x, r.to(q.dtype), r)
                 for g, x, r in zip(GRADS, grads, r32)}, 0.0, 0.0)
    at_points = A._bwd_ref(q, k, v, do, lse, delta, causal, sc, ex,
                           f32_out=True)
    w, _ = _bwd_weights(A, q, k, v, do, lse, delta, causal, sc, ex)
    errs, beyond, ratio = {}, 0.0, 0.0
    for g, x, at, wg in zip(GRADS, grads, at_points, w):
        e, b, r, within = _points_gap(x, at, wg, BWD_FLIP_ROWS, BWD_C)
        if not within:
            raise AssertionError(
                f"{name} {g}: bf16 gradient off the plain walk at the "
                f"rounding points (max err {e:.3e}, rows beyond one ulp "
                f"{b:.4f}, max err / (ulp + 1e-5 + {BWD_C} 2^-7 W) "
                f"{r:.3f})")
        errs[g], beyond, ratio = e, max(beyond, b), max(ratio, r)
    return errs, beyond, ratio


def _bwd_controls(A, name, q, k, v, do, causal, sc, ex, out, lse):
    """Controls of `_check_bwd`'s bf16 tolerance: the plain walk with one
    rounding point misplaced, held against the sound walk as a kernel's
    bf16 gradients would be, must be rejected in the gradients that
    point moves: dS left unrounded (dQ, dK) and p_use left unrounded
    (dV), both the f32 walk on the same bf16 values; the scale applied
    after dS's rounding (dQ, dK; from `_bwd_weights`' tile walk).
    At a power-of-two scale (head_dim 64) the scale's place is exact and
    that walk is the sound one, so it must then pass. Logs each
    control's largest share of rows beyond one ulp and max err / bound;
    raises if the check mistakes one."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (lse, delta, causal, sc, ex)
    at_points = A._bwd_ref(q, k, v, do, *args, f32_out=True)
    w, scale_walk = _bwd_weights(A, q, k, v, do, *args)
    f32_walk = A._bwd_ref(*(t.float() for t in (q, k, v, do)), *args)
    exact_scale = float(np.log2(sc)).is_integer()
    for control, walk, moved in (("ds_unrounded", f32_walk, (0, 1)),
                                 ("p_unrounded", f32_walk, (2,)),
                                 ("scale_after_ds_rounding", scale_walk,
                                  (0, 1))):
        gaps = [_points_gap(walk[i].to(q.dtype), at_points[i], w[i],
                            BWD_FLIP_ROWS, BWD_C) for i in moved]
        within = all(gp[3] for gp in gaps)
        beyond = max(gp[1] for gp in gaps)
        ratio = max(gp[2] for gp in gaps)
        sound = control == "scale_after_ds_rounding" and exact_scale
        if within != sound:
            raise AssertionError(
                f"{name}: control {control} {'failed' if sound else 'passed'}"
                f" the bf16 backward's check (rows beyond one ulp "
                f"{beyond:.4f}, max err / bound {ratio:.3f})")
        log("kernel", form=f"control {name}", control=control,
            grads="/".join(GRADS[i] for i in moved),
            rows_beyond_ulp=f"{beyond:.4f}", err_over_bound=f"{ratio:.3f}",
            rejected=not within)


def phase_train_kernel_checks(A, LN, X):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    err = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "layer_norm", "xent_fwd", "xent_bwd"), 0.0)

    def check(name, got, plain, plain32):
        err[name] = max(err[name], _check_close(name, got, plain, plain32))

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for case, B, L, Hq, Hkv, D, causal in FLASH_CASES:
            make = _rand_at_offset if case == "offset" else _rand
            q = make(gen, (B, L, Hq, D), dtype)
            k = make(gen, (B, L, Hkv, D), dtype)
            v = make(gen, (B, L, Hkv, D), dtype)
            do = make(gen, (B, L, Hq, D), dtype)
            sc = D ** -0.5
            out, lse = A._fwd(q, k, v, causal, sc)
            e_out, e_lse, beyond, ratio = _check_fwd(
                A, f"flash {case} {dt}", q, k, v, causal, sc, A._NONE, out,
                lse)
            if case == "train" and dtype == torch.bfloat16:
                _fwd_controls(A, f"flash {case} D={D}", q, k, v, causal, sc,
                              A._NONE)
            err["flash_fwd"] = max(err["flash_fwd"], e_out, e_lse)
            be, b_beyond, b_ratio = _check_bwd(
                A, f"flash {case} {dt}", q, k, v, do, causal, sc, A._NONE,
                out, lse)
            if case == "train" and dtype == torch.bfloat16:
                _bwd_controls(A, f"flash {case} D={D}", q, k, v, do, causal,
                              sc, A._NONE, out, lse)
            err["flash_bwd_dq"] = max(err["flash_bwd_dq"], be["dq"])
            err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"], be["dk"],
                                       be["dv"])
            log("kernel", form=f"flash {case} B={B} L={L} Hq={Hq} Hkv={Hkv} "
                f"D={D} causal={causal}", dtype=dt,
                fwd_err=f"{err['flash_fwd']:.3e}",
                fwd_rows_beyond_ulp=f"{beyond:.4f}",
                fwd_err_over_bound=f"{ratio:.3f}",
                dq_err=f"{err['flash_bwd_dq']:.3e}",
                dkv_err=f"{err['flash_bwd_dkv']:.3e}",
                bwd_rows_beyond_ulp=f"{b_beyond:.4f}",
                bwd_err_over_bound=f"{b_ratio:.3f}", bwd_bit_equal=True)
            del q, k, v, do, out, lse
        x = _rand(gen, (TN, THID), dtype, 2.0)
        w, b = _rand(gen, (THID,), dtype), _rand(gen, (THID,), dtype)
        plain32 = LN._ln_kernel_ref(x.float(), w.float(), b.float(), 1e-5)
        check("layer_norm", LN._launch(x, w, b, 1e-5)[0], plain32.to(dtype),
              plain32)
        del x, plain32
        logits = _rand(gen, (TN, TV), dtype, 3.0)
        labels = torch.randint(0, TV, (TN,), generator=gen, device="cuda",
                               dtype=torch.int32)
        g = _rand(gen, (TN,), torch.float32)
        loss, lse = X._fwd(logits, labels)
        rl, rlse = X._xent_fwd_ref(logits, labels)
        check("xent_fwd", loss, rl, rl)
        check("xent_fwd", lse, rlse, rlse)
        dx32 = X._xent_bwd_ref(logits.float(), labels, lse, g)
        check("xent_bwd", X._bwd(logits, labels, lse, g), dx32.to(dtype),
              dx32)
        log("kernel", form=f"layer_norm [{TN}, {THID}] + xent [{TN}, {TV}]",
            dtype=dt, ln_err=f"{err['layer_norm']:.3e}",
            xent_fwd_err=f"{err['xent_fwd']:.3e}",
            xent_bwd_err=f"{err['xent_bwd']:.3e}")
        del logits, dx32
    torch.cuda.synchronize()
    return err


def _bound(nbytes, flops, peak=H100_BF16_FLOPS):
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return max((bytes_ms, "bytes"), (ops_ms, "operations"))


def phase_train_kernel_timing(A, X):
    """Each training kernel at the main path's shape and dtype (bf16
    attention, f32 logits), against its plain version and one PyTorch
    call computing the same function (never called by the port): SDPA's
    flash backend forward and backward, F.cross_entropy forward and
    backward (LayerNorm: `phase_norm_timing`). Bounds: bytes over 3.35
    TB/s or flops over 989 TFLOP/s (bf16 dense), the larger."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    bf = torch.bfloat16
    out = {}
    q, k, v, do = (_rand(gen, (TB, TL, TH, TD), bf) for _ in range(4))
    sc = TD ** -0.5
    o, lse = A._fwd(q, k, v, True, sc)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    pairs = TB * TH * TL * (TL + 1) // 2            # causal (q, k) pairs
    io = TB * TL * TH * TD * 2                      # one bf16 [B, L, H, D]
    rows = TB * TH * TL * 4                         # one f32 [B, H, L]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        so = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        sdpa_fwd = cuda_ms(lambda i=0: torch.nn.functional.
                           scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=True), 20)
        dot = do.transpose(1, 2)
        sdpa_bwd = cuda_ms(lambda i=0: torch.autograd.grad(
            so, (qt, kt, vt), dot, retain_graph=True), 20)
    dq_run, dkv_run = _bwd_raw(A, q, k, v, do, lse, delta, A._tail(
        (TB, TL, TL, TH, TH, TD), True, sc, q))
    specs = {
        "flash_fwd": (lambda i=0: A._fwd(q, k, v, True, sc),
                      lambda i=0: A._fwd_ref(q, k, v, True, sc),
                      sdpa_fwd, 4 * io + rows, 4 * TD * pairs),
        "flash_bwd_dq": (
            dq_run, lambda i=0: A._bwd_ref(q, k, v, do, lse, delta, True, sc),
            sdpa_bwd, 5 * io + 2 * rows, 6 * TD * pairs),
        "flash_bwd_dkv": (
            dkv_run, lambda i=0: A._bwd_ref(q, k, v, do, lse, delta, True,
                                            sc),
            sdpa_bwd, 6 * io + 2 * rows, 8 * TD * pairs),
    }
    logits = _rand(gen, (TN, TV), torch.float32, 3.0)
    labels = torch.randint(0, TV, (TN,), generator=gen, device="cuda",
                           dtype=torch.int32)
    g = _rand(gen, (TN,), torch.float32)
    _, xlse = X._fwd(logits, labels)
    lg = logits.detach().requires_grad_()
    ce = torch.nn.functional.cross_entropy(lg, labels.long(),
                                           reduction="none")
    specs["xent_fwd"] = (
        lambda i=0: X._fwd(logits, labels),
        lambda i=0: X._xent_fwd_ref(logits, labels),
        cuda_ms(lambda i=0: torch.nn.functional.cross_entropy(
            logits, labels.long(), reduction="none"), 10),
        TN * TV * 4 + TN * 12, 4 * TN * TV)
    specs["xent_bwd"] = (
        lambda i=0: X._bwd(logits, labels, xlse, g),
        lambda i=0: X._xent_bwd_ref(logits, labels, xlse, g),
        cuda_ms(lambda i=0: torch.autograd.grad(ce, lg, g,
                                                retain_graph=True), 10),
        2 * TN * TV * 4 + TN * 12, 4 * TN * TV)
    for name, (kern, plain, library_ms, nbytes, flops) in specs.items():
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        log("kernel_time", kernel=name, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            achieved_TFLOPs=f"{flops / ms / 1e9:.2f}",
            achieved_GBps=f"{nbytes / ms / 1e6:.1f}",
            **_goal(name, "gpt", ms, library_ms))
    _bwd_pair(out, "gpt", f"B={TB} L={TL} H={TH} D={TD} causal bf16",
              dq_run, dkv_run, 7 * io + 2 * rows, pairs, TD)
    return out


# The SIMT bodies' times at GPT's shape and at BERT's kvb + dropout, as
# this script measured them (PERF.md kernel table rows 2-4; NVIDIA H100
# 80GB HBM3, 700 W), against which the tensor-core bodies are reported,
# with the goals: the forward within 2x the library call, dQ + dK/dV
# together within 3x SDPA's whole backward.
EARLIER_MS = {"gpt": {"flash_fwd": 1.8524, "flash_bwd_dq": 3.2571,
                      "flash_bwd_dkv": 3.5654},
              "bert": {"flash_fwd": 1.3089, "flash_bwd_dq": 1.7991,
                       "flash_bwd_dkv": 2.2088}}


def _goal(name, shape, ms, library_ms):
    if name not in EARLIER_MS[shape]:
        return {}
    goal = {"earlier_ms": EARLIER_MS[shape][name]}
    if name == "flash_fwd":
        goal["goal_2x_library"] = "met" if ms <= 2 * library_ms else "missed"
    return goal


def _bwd_pair(out, shape, label, dq_run, dkv_run, nbytes, pairs, d):
    """The dQ + dK/dV pair, run back to back, against SDPA's whole
    backward (dQ, dK, dV in one call), the goal within 3x the library
    call. Its bound is that of the function both compute: `nbytes` (q,
    k, v, dO and the bias read once, lse and delta, dq, dk, dv written
    once) and 10 D flops a (query, key) pair (S, dP, dV, dK, dQ). The
    two kernels do 14 D (`work_flops`): dQ recomputes S and dP, the
    price of summing without atomics, not work the function needs."""
    rows = [out[n if shape == "gpt" else f"{n}[{MASKED}]"]
            for n in ("flash_bwd_dq", "flash_bwd_dkv")]
    ms = cuda_ms(lambda i=0: (dq_run(), dkv_run()), 10)
    library_ms = rows[0]["library_ms"]
    flops = 10 * d * pairs
    bound_ms, bound_by = _bound(nbytes, flops)
    earlier = sum(EARLIER_MS[shape][n] for n in ("flash_bwd_dq",
                                                  "flash_bwd_dkv"))
    log("kernel_time", kernel="flash_bwd_pair", shape=label, ms=f"{ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, achieved_TFLOPs=f"{flops / ms / 1e9:.2f}",
        work_flops=14 * d * pairs,
        work_TFLOPs=f"{14 * d * pairs / ms / 1e9:.2f}",
        over_library=f"{ms / library_ms:.2f}", earlier_ms=f"{earlier:.4f}",
        goal_3x_library="met" if ms <= 3 * library_ms else "missed")


def _ok(rc, route=None):
    """A raw kernel call (timed alone, so not counted) that must launch,
    and, given its `route`, on a tensor-core body."""
    if rc:
        raise RuntimeError(f"kernel launch failed ({rc})")
    if route is not None and route.value != 1:
        raise RuntimeError("the timed launch took a SIMT body")


def _bwd_raw(A, q, k, v, do, lse, delta, tail, kvb=None, fb=None):
    """Raw dQ and dK/dV launches into buffers made once (timed alone, so
    not counted), each required to take its tensor-core body."""
    lib = A._kernel_lib()
    ptrs = _flash_ptrs(q, k, v, do, lse, delta, kvb, fb)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    route = ctypes.c_int(-1)

    def dq_run(i=0):
        _ok(lib.flash_bwd_dq(*ptrs, dq.data_ptr(), ctypes.byref(route),
                             *tail), route)

    def dkv_run(i=0):
        _ok(lib.flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                              ctypes.byref(route), *tail), route)
    return dq_run, dkv_run


def _flash_ptrs(q, k, v, do, lse, delta, kvb=None, fb=None):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if kvb is None else kvb.data_ptr(),
            None if fb is None else fb.data_ptr())


# ---------------------------------------------------------------- phase 6

TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# a training step of gpt_1p3b under remat 'full' launches: 24 attention
# forwards + 24 recomputed, one dQ and one dK/dV per layer, 2 LayerNorms
# per block twice + ln_f, one LayerNorm backward for each LayerNorm of the
# recomputed blocks and ln_f, one cross-entropy forward and backward per
# step, and the multi-tensor AdamW launches (`adamw` is set by the phase);
# the norm kernels of slice 5 run on neither training path
EXPECTED_PER_STEP = {"flash_fwd": 48, "flash_bwd_dq": 24,
                     "flash_bwd_dkv": 24, "layer_norm": 97,
                     "layer_norm_bwd": 49, "rms_norm": 0,
                     "xent_fwd": 1, "xent_bwd": 1,
                     "dropout_residual_layer_norm": 0, "hash_dropout": 0,
                     "hash_dropout_bwd": 0, "hash_dropout_mask": 0}


def _train_counts(A, LN, X):
    from paddle_tpu_torch.ops import dropout as D
    k = {**A.kernel_launches, "layer_norm": LN.kernel_launches,
         "layer_norm_bwd": LN.bwd_kernel_launches,
         "rms_norm": LN.rms_kernel_launches, **X.kernel_launches,
         "adamw": X.adamw_kernel_launches,
         "dropout_residual_layer_norm": X.drln_kernel_launches,
         **D.dropout_kernel_launches}
    p = {**A.plain_launches, "layer_norm": LN.plain_launches,
         "layer_norm_bwd": LN.bwd_plain_launches,
         "rms_norm": LN.rms_plain_launches, **X.plain_launches,
         "adamw": X.adamw_plain_launches,
         "dropout_residual_layer_norm": X.drln_plain_launches,
         **D.dropout_plain_launches}
    return k, p


def _reset_train_counts(A, LN, X):
    from paddle_tpu_torch.ops import dropout as D
    for mod in (A, LN, X, D):
        mod.reset_counts()


def _adamw_launches_expected(trainer, X):
    """Launches of the multi-tensor AdamW kernel an optimizer step makes:
    one per group of parameters sharing their dtypes (and master copy)
    and `adamw_capacity()` tensors."""
    opt = trainer.optimizer
    groups = {}
    for p in trainer.params:
        slots = opt._slots(p)
        key = (p.dtype, slots["moment1"].dtype, "master" in slots)
        groups[key] = groups.get(key, 0) + 1
    cap = X.adamw_capacity()
    return sum(-(-n // cap) for n in groups.values())


def _trainer(cfg, device=None, lr=2e-4, acc_dtype="bfloat16", bf16=True,
             state=None, opt_cls=None):
    """The bench.py recipe: GPT(cfg) (seed 0, or the weights `state`)
    [.bfloat16()], the pretraining criterion, AdamW(lr, weight_decay
    0.1, ClipGradByGlobalNorm(1.0), bf16 moment slots), Trainer;
    `opt_cls` in place of AdamW where given."""
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.models import GPT, GPTPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    model = GPT(cfg, device=device, seed=SEED)
    if state is not None:
        model.load_state_dict(state)
    if bf16:
        model.bfloat16()
    crit = GPTPretrainingCriterion()
    opt = (opt_cls or AdamW)(learning_rate=lr, weight_decay=0.1,
                             grad_clip=ClipGradByGlobalNorm(1.0),
                             accumulator_dtype=acc_dtype)
    return Trainer(model, opt,
                   lambda m, b: crit(m(b["input_ids"]), b["labels"]),
                   device=device)


def _batch(cfg, B, L, seed=SEED):
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, L + 1))
    return {"input_ids": ids[:, :-1].astype("int32"),
            "labels": ids[:, 1:].astype("int32")}


def _gpt_train_cfg():
    from paddle_tpu_torch.models import gpt_1p3b
    return gpt_1p3b(max_seq_len=TL, remat_policy="full")


def phase_training(A, LN, X, smi):
    from paddle_tpu_torch.distributed import LossBuffer
    cfg = _gpt_train_cfg()
    t0 = time.perf_counter()
    trainer = _trainer(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _batch(cfg, TB, TL).items()}
    buf = LossBuffer(drain_every=TRAIN_WARMUP + TRAIN_STEPS)
    for _ in range(TRAIN_WARMUP):
        buf.append(trainer.step(batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts(A, LN, X)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        buf.append(trainer.step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern, plain = _train_counts(A, LN, X)
    losses = buf.losses
    if len(losses) != TRAIN_WARMUP + TRAIN_STEPS or buf.fetches != 1:
        raise AssertionError(f"losses fetched {buf.fetches} times: {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    per_step = {k: v / TRAIN_STEPS for k, v in kern.items()}
    expected = {**EXPECTED_PER_STEP,
                "adamw": _adamw_launches_expected(trainer, X)}
    branches = dict(A.branch_launches)
    if per_step != expected or any(plain.values()) or any(
            branches.get(f"{name}[tc,none]") != kern[name]
            for name in A.KERNELS):
        raise AssertionError(f"launches a step {per_step} (expected "
                             f"{expected}), by body and branch {branches}, "
                             f"plain {plain}")
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = TB * TL / (step_ms / 1e3)
    mfu = 6 * cfg.num_params() * tok_s / H100_BF16_FLOPS
    log("train", model="gpt_1p3b", layers=cfg.num_layers,
        hidden=cfg.hidden_size, params_M=f"{cfg.num_params() / 1e6:.1f}",
        batch=f"{TB}x{TL}", remat="full", dtype="bfloat16",
        gpu=repr(smi), setup_s=f"{setup_s:.2f}", steps=TRAIN_STEPS,
        step_ms=f"{step_ms:.2f}", tokens_per_s=f"{tok_s:.1f}",
        mfu=f"{mfu:.4f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}")
    log("train_launches", **{f"{k}_per_step": v for k, v in
                             per_step.items()},
        adamw_tensors_per_launch=len(trainer.params) / per_step["adamw"],
        **branches, plain=sum(plain.values()))
    summary = {"step_ms": round(step_ms, 2),
               "peak_mem_GB": round(torch.cuda.max_memory_allocated() / 1e9,
                                    2)}
    return trainer, batch, kern, losses, summary


# kernel families by name: the LayerNorm forward is the norm row walk's
# LayerNorm instantiation, `norm_fwd_kernel<0, ...>`
_FAMILIES = (("flash_attention", ("flash_fwd", "flash_dq", "flash_dkv")),
             ("layer_norm", ("norm_fwd_kernel<0,",)),
             ("layer_norm_bwd", ("layer_norm_bwd",)),
             ("xent", ("xent_fwd", "xent_bwd")),
             ("adamw", ("adamw_kernel",)),
             ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")))


def phase_train_profile(trainer, batch, label="train_profile",
                        families=_FAMILIES):
    """Where one training step's time goes: device time by kernel family
    under torch.profiler, the device's busy share (device kernel time
    over the step's wall time; one stream, so kernels do not overlap)
    and the step's device launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = dict.fromkeys([f for f, _ in families] + ["other"], 0.0)
    kernels, launches = [], 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        kernels.append((us, ev.key))
        launches += ev.count
        name = ev.key.lower()
        for f, keys in families:
            if any(t in name for t in keys):
                fam[f] += us
                break
        else:
            fam["other"] += us
    busy = sum(fam.values()) / 1e6
    if busy <= 0:
        log(label, device_time="not measured (the profiler saw "
            "no device kernels)", wall_ms=f"{wall * 1e3:.2f}")
        return prof
    log(label, wall_ms=f"{wall * 1e3:.2f}",
        device_ms=f"{busy * 1e3:.2f}", device_busy_share=f"{busy / wall:.3f}",
        device_launches=launches,
        **{f"{k}_ms": f"{v / 1e3:.2f}" for k, v in fam.items()})
    for us, name in sorted(kernels, reverse=True)[:8]:
        log(f"{label}_top", kernel=repr(name[:90]), ms=f"{us / 1e3:.3f}")
    return prof


def phase_train_split(trainer, batch):
    """One more step timed in two parts with CUDA events: forward and
    backward (loss and gradients), then the clip and the optimizer
    update."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    _, grads = trainer._loss_and_grads(batch)
    ev[1].record()
    trainer._update(grads)
    ev[2].record()
    torch.cuda.synchronize()
    log("train_split", fwd_bwd_ms=f"{ev[0].elapsed_time(ev[1]):.2f}",
        clip_optimizer_ms=f"{ev[1].elapsed_time(ev[2]):.2f}")


# ---------------------------------------------------------------- phase 7

# gpt_tiny (2 heads: head_dim 64 takes the flash kernel), f32, 3 steps of
# the training recipe with lr 1e-3 and f32 slots, card against CPU on the
# same weights. Losses within 1e-4: the same f32 math, with the kernels'
# and cuBLAS's sums in other orders than the CPU's (~1e-6 relative a
# layer, loss ~7). Parameters within 1e-4, a tenth of lr: Adam moves an
# entry whose gradient cancels to ~1e-8 (its epsilon, and the f32 noise
# of the sum) by a part of lr that the noise decides.
TRAIN_REF_TOL = 1e-4


def phase_train_small_reference():
    from paddle_tpu_torch.models import gpt_tiny, init_state_dict
    cfg = gpt_tiny(num_heads=2, max_seq_len=128, dtype="float32")
    batch = _batch(cfg, 2, 128, seed=SEED + 5)
    state = init_state_dict(cfg, seed=SEED, device="cpu")
    runs = []
    for device in ("cuda", "cpu"):
        tr = _trainer(cfg, device=device, lr=1e-3, acc_dtype=None,
                      bf16=False, state=state)
        losses = [float(tr.step(batch)) for _ in range(3)]
        runs.append((losses, {k: v.detach().cpu() for k, v in
                              tr.model.state_dict().items()}))
    (lc, pc), (lh, ph) = runs
    loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    param_err = max(float((pc[k] - ph[k]).abs().max()) for k in ph)
    if loss_err > TRAIN_REF_TOL or param_err > TRAIN_REF_TOL:
        raise AssertionError(f"gpt_tiny training card vs CPU: loss err "
                             f"{loss_err:.3e}, param err {param_err:.3e} "
                             f"(tolerance {TRAIN_REF_TOL})")
    log("train_small_ref", model="gpt_tiny f32 heads=2", steps=3,
        losses_card=[round(x, 6) for x in lc],
        loss_max_abs_err=f"{loss_err:.3e}",
        param_max_abs_err=f"{param_err:.3e}", tolerance=TRAIN_REF_TOL)


# ---------------------------------------------------------------- phase 8

# bert_base (bench.py's run_bert_base): batch 32 x 512, 12 heads of 64,
# hidden 768, padding lengths 384-512, dropout 0.1 on the hidden states
# and the attention probabilities
BB, BL, BH, BD, BHID, BV = 32, 512, 12, 64, 768, 30522
BERT_RATE = 0.1
MASKED = "kvb+dropout"           # the branch every BERT attention call takes
# (name, B, L, Hq, Hkv, D, causal, mask kind): the BERT shape with its
# padding bias, a full bias per (batch, head), a bool mask, GQA with a
# per-key bias, a ragged length; then the branches not covered yet at
# each head_dim (no mask at 64, 128, 256; kvb at 256; fb at 128 and 256),
# ragged, GQA, causal and not; and a full bias with Lq != Lk both ways
# (L is then (Lq, Lk): a backward that swapped the query and key of the
# transposed dK/dV tiles would read fb off its [qpos, kpos] there). With
# rates 0 and 0.1 every branch runs with and without dropout at head_dim
# 64, 128 and 256.
MASKED_CASES = [("bert", BB, BL, BH, BH, BD, False, "kvb"),
                ("fb", 2, 256, 4, 4, 64, False, "fb"),
                ("bool", 2, 256, 2, 2, 64, False, "bool"),
                ("gqa", 2, 256, 4, 2, 128, True, "kvb"),
                ("ragged", 2, 500, 4, 4, 64, False, "kvb"),
                ("none64", 2, 200, 4, 2, 64, True, "none"),
                ("none128", 2, 256, 2, 2, 128, False, "none"),
                ("none256", 2, 200, 4, 2, 256, True, "none"),
                ("kvb256", 2, 256, 2, 2, 256, False, "kvb"),
                ("fb128", 2, 200, 4, 2, 128, True, "fb"),
                ("fb256", 2, 200, 2, 1, 256, True, "fb"),
                ("fb_rect", 2, (200, 328), 4, 2, 64, False, "fb"),
                ("fb_rect128", 2, (328, 200), 4, 2, 128, True, "fb")]
KEEP_FRACTION_TOL = 0.005


def _padding_bias(rng, B, L):
    """BERT's additive padding bias (1 - m) * -1e4 [B, 1, 1, L] from
    bench.py's lengths, 3/4 L to L."""
    lengths = rng.randint(int(L * 0.75), L + 1, (B,))
    m = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    return torch.from_numpy((1.0 - m) * -1e4)[:, None, None, :].cuda()


def _masked_mask(kind, gen, rng, B, Lq, Lk, Hq):
    if kind == "none":
        return None
    if kind == "kvb":
        return _padding_bias(rng, B, Lk)
    if kind == "fb":
        return torch.randn((B, Hq, Lq, Lk), generator=gen, device="cuda") * 2
    return torch.rand((B, 1, 1, Lk), generator=gen, device="cuda") > 0.25


def phase_bert_kernel_checks(A, LN):
    """Every branch of the three flash kernels (none, kvb, fb, each with
    and without dropout, at head_dim 64, 128 and 256) against their
    plain versions (the same inputs, biases and seeds; f32 and bf16;
    rates 0 and 0.1), the card's keep-mask against the plain version's
    (exact) and its kept fraction at the BERT shape, and LayerNorm at the
    BERT width with both of BERT's epsilons. Tolerance: `_check_fwd` for
    the forward, `_check_bwd` for dQ and dK/dV (with its controls at the
    BERT shape), `_check_close` for the rest."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rng = np.random.RandomState(SEED + 6)
    err = {k: 0.0 for k in A.KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for rate in (0.0, BERT_RATE):
            for case, B, L, Hq, Hkv, D, causal, kind in MASKED_CASES:
                Lq, Lk = L if isinstance(L, tuple) else (L, L)
                q = _rand(gen, (B, Lq, Hq, D), dtype)
                k = _rand(gen, (B, Lk, Hkv, D), dtype)
                v = _rand(gen, (B, Lk, Hkv, D), dtype)
                do = _rand(gen, (B, Lq, Hq, D), dtype)
                mask = _masked_mask(kind, gen, rng, B, Lq, Lk, Hq)
                kvb, fb = ((None, None) if mask is None else
                           A._normalize_mask(mask, B, Hq, Lq, Lk))
                ex = A._Extras(kvb, fb, rate, int(rng.randint(1 << 24)))
                sc = D ** -0.5
                out, lse = A._fwd(q, k, v, causal, sc, ex)
                e_out, e_lse, beyond, ratio = _check_fwd(
                    A, f"flash[{ex.branch}] {case} {dt}", q, k, v, causal,
                    sc, ex, out, lse)
                if case == "bert" and dtype == torch.bfloat16:
                    _fwd_controls(A, f"flash[{ex.branch}] {case} D={D}", q,
                                  k, v, causal, sc, ex)
                be, b_beyond, b_ratio = _check_bwd(
                    A, f"flash[{ex.branch}] {case} {dt}", q, k, v, do,
                    causal, sc, ex, out, lse)
                if case == "bert" and dtype == torch.bfloat16:
                    _bwd_controls(A, f"flash[{ex.branch}] {case} D={D}", q,
                                  k, v, do, causal, sc, ex, out, lse)
                e = {"flash_fwd": max(e_out, e_lse),
                     "flash_bwd_dq": be["dq"],
                     "flash_bwd_dkv": max(be["dk"], be["dv"])}
                for name, x in e.items():
                    err[name] = max(err[name], x)
                log("kernel", form=f"flash[{ex.branch}] {case} B={B} "
                    f"Lq={Lq} Lk={Lk} Hq={Hq} Hkv={Hkv} D={D} "
                    f"causal={causal}", dtype=dt,
                    fwd_err=f"{e['flash_fwd']:.3e}",
                    fwd_rows_beyond_ulp=f"{beyond:.4f}",
                    fwd_err_over_bound=f"{ratio:.3f}",
                    dq_err=f"{e['flash_bwd_dq']:.3e}",
                    dkv_err=f"{e['flash_bwd_dkv']:.3e}",
                    bwd_rows_beyond_ulp=f"{b_beyond:.4f}",
                    bwd_err_over_bound=f"{b_ratio:.3f}", bwd_bit_equal=True)
                del q, k, v, do, out, lse, kvb, fb, mask
    for seed, (B, Hq, Hkv, L) in ((SEED + 7, (BB, BH, BH, BL)),
                                  (SEED + 8, (2, 4, 2, 500))):
        keep = A.dropout_keep_on_card(seed, B, Hq, Hkv, L, L, BERT_RATE,
                                      torch.device("cuda"))
        plain = A._keep_mask(seed, B, Hq, Hkv, L, 0, L, BERT_RATE, "cuda")
        if not torch.equal(keep.bool(), plain):
            raise AssertionError(f"card keep-mask differs from the plain "
                                 f"version's at {(B, Hq, Hkv, L)}")
        kept = float(keep.float().mean())
        if (B, L) == (BB, BL) and abs(kept - (1 - BERT_RATE)) > \
                KEEP_FRACTION_TOL:
            raise AssertionError(f"kept fraction {kept} vs {1 - BERT_RATE}")
        log("kernel", form=f"dropout keep-mask B={B} Hq={Hq} Hkv={Hkv} "
            f"L={L} rate={BERT_RATE}", equal_to_plain=True,
            kept_fraction=f"{kept:.6f}")
        del keep, plain
    ln_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = _rand(gen, (BB * BL, BHID), dtype, 2.0)
        w, b = _rand(gen, (BHID,), dtype), _rand(gen, (BHID,), dtype)
        for eps in (1e-5, 1e-12):
            plain32 = LN._ln_kernel_ref(x.float(), w.float(), b.float(), eps)
            ln_err = max(ln_err, _check_close(
                "layer_norm", LN._launch(x, w, b, eps)[0], plain32.to(dtype),
                plain32))
        log("kernel", form=f"layer_norm [{BB * BL}, {BHID}] eps 1e-5, 1e-12",
            dtype=str(dtype)[6:], ln_err=f"{ln_err:.3e}")
    torch.cuda.synchronize()
    return err, ln_err


# bf16 [B, L, H, D] tensors and f32 [B, H, L] rows of the BERT shape
_BIO = BB * BL * BH * BD * 2
_BROWS = BB * BH * BL * 4
_BPAIRS = BB * BH * BL * BL


def phase_bert_kernel_timing(A):
    """Each masked branch of the three flash kernels at the BERT shape in
    bf16 (kvb, fb, dropout, kvb+dropout — the last is BERT's), against
    its plain version and one PyTorch call with the same additive mask
    and rate (SDPA forward, and its backward for dQ, dK and dV together;
    timed only, never called by the port).
    Bytes: each input read once, each output written once (q, k, v, dO,
    out, dq, dk, dv bf16; lse, delta f32 rows; the bias f32); operations:
    4, 6 and 8 x D a (query, key) pair for the forward, dQ and dK/dV (no
    causal skip)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rng = np.random.RandomState(SEED + 9)
    bf = torch.bfloat16
    q, k, v, do = (_rand(gen, (BB, BL, BH, BD), bf) for _ in range(4))
    sc = BD ** -0.5
    pad = _padding_bias(rng, BB, BL)
    full = torch.randn((BB, BH, BL, BL), generator=gen, device="cuda")
    branches = {"kvb": (pad, 0.0), "fb": (full, 0.0),
                "dropout": (None, BERT_RATE), MASKED: (pad, BERT_RATE)}
    out = {}
    for branch, (mask, rate) in branches.items():
        kvb, fb = ((None, None) if mask is None else
                   A._normalize_mask(mask, BB, BH, BL, BL))
        ex = A._Extras(kvb, fb, rate, 1234)
        bias_bytes = sum(t.numel() * 4 for t in (kvb, fb) if t is not None)
        o, lse = A._fwd(q, k, v, False, sc, ex)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq_run, dkv_run = _bwd_raw(
            A, q, k, v, do, lse, delta,
            A._tail((BB, BL, BL, BH, BH, BD), False, sc, q, ex), kvb, fb)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lib_mask = None if mask is None else mask.to(bf)
        so = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=lib_mask, dropout_p=rate)
        sdpa_fwd = cuda_ms(lambda i=0: torch.nn.functional.
                           scaled_dot_product_attention(
                               qt, kt, vt, attn_mask=lib_mask,
                               dropout_p=rate), 10)
        dot = do.transpose(1, 2)
        sdpa_bwd = cuda_ms(lambda i=0: torch.autograd.grad(
            so, (qt, kt, vt), dot, retain_graph=True), 10)
        specs = {
            "flash_fwd": (lambda i=0: A._fwd(q, k, v, False, sc, ex),
                          lambda i=0: A._fwd_ref(q, k, v, False, sc, ex),
                          sdpa_fwd, 4 * _BIO + _BROWS + bias_bytes,
                          4 * BD * _BPAIRS),
            "flash_bwd_dq": (
                dq_run,
                lambda i=0: A._bwd_ref(q, k, v, do, lse, delta, False, sc,
                                       ex),
                sdpa_bwd, 5 * _BIO + 2 * _BROWS + bias_bytes,
                6 * BD * _BPAIRS),
            "flash_bwd_dkv": (
                dkv_run,
                lambda i=0: A._bwd_ref(q, k, v, do, lse, delta, False, sc,
                                       ex),
                sdpa_bwd, 6 * _BIO + 2 * _BROWS + bias_bytes,
                8 * BD * _BPAIRS),
        }
        for name, (kern, plain, library_ms, nbytes, flops) in specs.items():
            ms = cuda_ms(kern, 10)
            plain_ms = cuda_ms(plain, 2)
            bound_ms, bound_by = _bound(nbytes, flops)
            out[f"{name}[{branch}]"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}
            log("kernel_time", kernel=f"{name}[{branch}]",
                shape=f"B={BB} L={BL} H={BH} D={BD} bf16", ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
                bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                achieved_TFLOPs=f"{flops / ms / 1e9:.2f}",
                **(_goal(name, "bert", ms, library_ms)
                   if branch == MASKED else {}))
        if branch == MASKED:
            _bwd_pair(out, "bert", f"B={BB} L={BL} H={BH} D={BD} bf16 "
                      f"{MASKED}", dq_run, dkv_run,
                      7 * _BIO + 2 * _BROWS + bias_bytes, _BPAIRS, BD)
        del o, lse, delta, so, qt, kt, vt, kvb, fb, dq_run, dkv_run
    return out


# a bert_base training step launches, per layer, one attention forward,
# dQ and dK/dV (kvb + dropout), two LayerNorms, forward and backward, and
# two hidden dropouts (after attention and after the feed-forward),
# forward and backward, plus the embeddings' and the MLM head's LayerNorm
# and the embeddings' dropout; the vocabulary (30522) has no 128-multiple
# block, so the criterion takes F.cross_entropy, not the xent kernels
BERT_EXPECTED_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12,
                          "flash_bwd_dkv": 12, "layer_norm": 26,
                          "layer_norm_bwd": 26, "rms_norm": 0, "xent_fwd": 0, "xent_bwd": 0,
                          "dropout_residual_layer_norm": 0,
                          "hash_dropout": 25, "hash_dropout_bwd": 25,
                          "hash_dropout_mask": 0}


def _bert_batch(cfg, seed=0):
    """bench.py's run_bert_base batch, drawn the same way from
    RandomState(seed)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.vocab_size, (BB, BL))
    labels[rng.rand(BB, BL) > 0.15] = -100
    lengths = rng.randint(int(BL * 0.75), BL + 1, (BB,))
    mask = np.arange(BL)[None, :] < lengths[:, None]
    return {"input_ids": rng.randint(0, cfg.vocab_size,
                                     (BB, BL)).astype("int32"),
            "attention_mask": mask.astype("int32"),
            "mlm_labels": labels.astype("int32"),
            "nsp_labels": rng.randint(0, 2, (BB,)).astype("int64")}


def _bert_trainer(cfg, device=None, lr=1e-4, acc_dtype="bfloat16",
                  state=None, opt_cls=None):
    """bench.py's recipe: BertForPretraining(cfg) (seed 0, or the weights
    `state`), train mode, BertPretrainingCriterion, AdamW(lr,
    weight_decay 0.01, no clip, moment slots in `acc_dtype`), Trainer;
    `opt_cls` in place of AdamW where given."""
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    model = BertForPretraining(cfg, device=device, seed=SEED)
    if state is not None:
        model.load_state_dict(state)
    model.train()
    crit = BertPretrainingCriterion(cfg.vocab_size)
    opt = (opt_cls or AdamW)(learning_rate=lr, weight_decay=0.01,
                             accumulator_dtype=acc_dtype)

    def loss_fn(m, b):
        mlm, nsp = m(b["input_ids"], attention_mask=b["attention_mask"])
        return crit(mlm, nsp, b["mlm_labels"], b["nsp_labels"])

    return Trainer(model, opt, loss_fn, device=device)


def _branch_key(name):
    """`branch_launches`' key of a bf16 BERT launch: the forward, dQ and
    dK/dV all run their tensor-core bodies."""
    return f"{name}[tc,{MASKED}]"


def _bert_train_cfg():
    from paddle_tpu_torch.models import bert_base
    return bert_base(dtype="bfloat16")


def phase_bert_training(A, LN, X, smi):
    from paddle_tpu_torch.distributed import LossBuffer
    cfg = _bert_train_cfg()
    t0 = time.perf_counter()
    trainer = _bert_trainer(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _bert_batch(cfg).items()}
    buf = LossBuffer(drain_every=TRAIN_WARMUP + TRAIN_STEPS)
    for _ in range(TRAIN_WARMUP):
        buf.append(trainer.step(batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts(A, LN, X)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        buf.append(trainer.step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern, plain = _train_counts(A, LN, X)
    branches = dict(A.branch_launches)
    losses = buf.losses
    if len(losses) != TRAIN_WARMUP + TRAIN_STEPS or buf.fetches != 1:
        raise AssertionError(f"losses fetched {buf.fetches} times: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bert_base losses not finite: {losses}")
    per_step = {k: v / TRAIN_STEPS for k, v in kern.items()}
    expected = {**BERT_EXPECTED_PER_STEP,
                "adamw": _adamw_launches_expected(trainer, X)}
    masked = {k: branches.get(_branch_key(k), 0) for k in A.KERNELS}
    if per_step != expected or any(plain.values()) or \
            masked != {k: kern[k] for k in A.KERNELS}:
        raise AssertionError(f"launches a step {per_step} (expected "
                             f"{expected}), by branch "
                             f"{branches}, plain {plain}")
    step_ms = wall / TRAIN_STEPS * 1e3
    seqs_s = BB / (step_ms / 1e3)
    mfu = 6 * n_params * seqs_s * BL / H100_BF16_FLOPS
    log("bert_train", model="bert_base", layers=cfg.num_layers,
        hidden=cfg.hidden_size, params_M=f"{n_params / 1e6:.3f}",
        batch=f"{BB}x{BL}", dtype="bfloat16", dropout=BERT_RATE,
        gpu=repr(smi), setup_s=f"{setup_s:.2f}", steps=TRAIN_STEPS,
        step_ms=f"{step_ms:.2f}", seqs_per_s=f"{seqs_s:.2f}",
        mfu=f"{mfu:.4f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}")
    log("bert_launches", **{f"{k}_per_step": v for k, v in
                            per_step.items()},
        adamw_tensors_per_launch=len(trainer.params) / per_step["adamw"],
        **{_branch_key(k): v for k, v in masked.items()},
        plain=sum(plain.values()))
    return trainer, batch, kern, losses


_BERT_FAMILIES = ("flash_attention", "cublas", "layer_norm", "layer_norm_bwd",
                  "dropout_hash", "xent_logits", "optimizer", "other")


def _bert_family(ev):
    """The family of a CPU op's own device kernels: its range or its
    nearest enclosing one (the optimizer's, the hash's), or the shapes it
    read (the [16384, 30522] f32 logits and their [32, 512, 30522] view
    are the criterion's log-softmax and gather, forward and backward)."""
    e = ev
    while e is not None:
        if e.name == "bert_optimizer":
            return "optimizer"
        if e.name == "dropout_hash":
            return "dropout_hash"
        for shape in (e.input_shapes or []):
            if list(shape)[-1:] == [BV] and len(shape) >= 2:
                return "xent_logits"
        e = e.cpu_parent
    return "other"


def phase_bert_split(trainer, batch):
    """Where one bert_base step's device time goes, by family: kernels are
    named for the flash kernels, cuBLAS, LayerNorm's forward and backward
    and the hash dropout (forward and backward: the `dropout_hash`
    family); the rest are
    priced by the op that launched them (the hash ranges of F.dropout,
    the optimizer's range, the ops on the [16384, 30522] f32 logits);
    the device's busy share (device time over the step's wall time); and
    the step's peak device memory."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        _, grads = trainer._loss_and_grads(batch)
        with torch.profiler.record_function("bert_optimizer"):
            trainer._update(grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = dict.fromkeys(_BERT_FAMILIES, 0.0)
    named = {"flash_attention": ("flash_fwd", "flash_dq", "flash_dkv"),
             "layer_norm": ("norm_fwd_kernel<0,",),
             "layer_norm_bwd": ("layer_norm_bwd",),
             "dropout_hash": ("hash_dropout_kernel",),
             "optimizer": ("adamw_kernel",),
             "cublas": ("gemm", "nvjet", "cutlass", "xmma", "cublas")}

    def by_name(name):
        low = name.lower()
        for f, keys in named.items():
            if any(t in low for t in keys):
                return f
        return None

    total = 0.0
    for ev in prof.events():
        # device-side spans of the named ranges cover kernels counted on
        # their own
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not ev.is_user_annotation:
            total += ev.time_range.elapsed_us()
            f = by_name(ev.name)
            if f:
                fam[f] += ev.time_range.elapsed_us()
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        for kern in getattr(ev, "kernels", []):
            if by_name(kern.name) is None:
                fam[_bert_family(ev)] += kern.duration
    if total <= 0:
        raise AssertionError("the profiler saw no device kernels in a "
                             "bert_base step")
    fam["other"] += total - sum(fam.values())
    log("bert_split", wall_ms=f"{wall * 1e3:.2f}",
        device_ms=f"{total / 1e3:.2f}",
        device_busy_share=f"{total / 1e6 / wall:.3f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        **{f"{k}_ms": f"{v / 1e3:.2f}" for k, v in fam.items()})


# bert_tiny with head_dim 64 (hidden 128, 2 heads: the flash route), f32,
# dropout 0.1 on, padding masks; 3 steps of AdamW(1e-3, weight_decay
# 0.01), card against CPU from the same weights, and the same salts and
# seeds (both models draw them from CPU generators seeded alike).
# Tolerance TRAIN_REF_TOL (1e-4), as for gpt_tiny. The key projections'
# biases have a gradient of 0 in exact arithmetic (softmax ignores a
# per-row shift), so Adam moves them by about lr a step in a direction
# the rounding noise decides: they are held within 3 lr of their start.
def phase_bert_small_reference():
    from paddle_tpu_torch.models import BertForPretraining, bert_tiny
    cfg = bert_tiny(hidden_size=128, num_heads=2)
    rng = np.random.RandomState(SEED + 10)
    B, L = 2, 128
    lengths = rng.randint(96, L + 1, (B,))
    labels = rng.randint(0, cfg.vocab_size, (B, L))
    labels[rng.rand(B, L) > 0.15] = -100
    batch = {"input_ids": rng.randint(1, cfg.vocab_size,
                                      (B, L)).astype("int32"),
             "attention_mask": (np.arange(L)[None] < lengths[:, None])
             .astype("int32"),
             "mlm_labels": labels.astype("int32"),
             "nsp_labels": rng.randint(0, 2, (B,)).astype("int64")}
    state = BertForPretraining(cfg, device="cpu", seed=SEED).state_dict()
    runs = []
    for device in ("cuda", "cpu"):
        tr = _bert_trainer(cfg, device=device, lr=1e-3, acc_dtype=None,
                           state=state)
        losses = [float(tr.step(batch)) for _ in range(3)]
        runs.append((losses, {k: v.detach().cpu() for k, v in
                              tr.model.state_dict().items()}))
    (lc, pc), (lh, ph) = runs
    loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    param_err = max(float((pc[k] - ph[k]).abs().max()) for k in ph
                    if not k.endswith("k_proj.bias"))
    kb_move = max(float((p[k] - state[k]).abs().max()) for p in (pc, ph)
                  for k in ph if k.endswith("k_proj.bias"))
    if loss_err > TRAIN_REF_TOL or param_err > TRAIN_REF_TOL or \
            kb_move > 3 * 1e-3 * 1.01 or not all(np.isfinite(lc)):
        raise AssertionError(f"bert_tiny training card vs CPU: loss err "
                             f"{loss_err:.3e}, param err {param_err:.3e} "
                             f"(tolerance {TRAIN_REF_TOL}), k_proj.bias "
                             f"moved {kb_move:.3e}")
    log("bert_small_ref", model="bert_tiny f32 hidden=128 heads=2",
        dropout=0.1, steps=3, losses_card=[round(x, 6) for x in lc],
        loss_max_abs_err=f"{loss_err:.3e}",
        param_max_abs_err=f"{param_err:.3e}",
        k_proj_bias_max_move=f"{kb_move:.3e}", tolerance=TRAIN_REF_TOL)


# ---------------------------------------------------------------- phase 9

# The AdamW update at one gpt_1p3b fc1 weight [2048, 8192] (16.8M
# elements) with the GPT recipe's hyper-parameters (lr 2e-4, wd 0.1) at
# step 10; RMSNorm and dropout + residual + LayerNorm at the GPT width
# ([8192, 2048]) and the BERT width ([16384, 768]).
ADAMW_SHAPE = (THID, 4 * THID)
ADAMW_HYPER = (2e-4, 0.9, 0.999, 1e-8, 0.1)       # lr, b1, b2, eps, wd
ADAMW_STEP = 10
# the per-tensor AdamW kernel's time at ADAMW_SHAPE before the
# multi-tensor loop (a grid-stride loop of 8 elements a thread over 132 x
# 16 blocks), on these inputs, timed by tools/kernel_ab.py on the tree
# before it (H100 80GB HBM3, 700 W); the [kernel_time] line only
ADAMW_EARLIER_MS = 0.0974
# the dropout + residual + LayerNorm kernel's device time (CUDA graph) in
# its earlier design (a block of 256 threads a row, scalar loads), on these
# inputs, timed by tools/kernel_ab.py on the tree before the row walk took
# it (median of 6 runs, NVIDIA H100 80GB HBM3, 700 W); the [kernel_time]
# lines only
DRLN_EARLIER_DEVICE_MS = {
    "dropout_residual_layer_norm[8192x2048]": 0.1117,
    "dropout_residual_layer_norm[16384x768]": 0.0759,
    "dropout_residual_layer_norm[16384x768, host bits]": 0.0943}
NORM_SHAPES = ((TN, THID), (BB * BL, BHID))
# the dropout op's checks also at the widest row (8 warps a row, 8
# vectors a lane in f32) and at a width whose vectors leave lanes idle
DRLN_EXTRA_SHAPES = ((64, 8192), (333, 640))
RMS_EPS, DRLN_RATE, DRLN_SEED = 1e-6, 0.1, 1234
# AdamW variants: (name, p dtype, g dtype, slot dtype, f32 master, clip)
_F32, _BF16 = torch.float32, torch.bfloat16
ADAMW_CASES = [(f"{name}{'+clip' if clip else ''}", pd, gd, sd, ma, clip)
               for name, pd, gd, sd, ma in (
                   ("bf16", _BF16, _BF16, _BF16, False),
                   ("f32", _F32, _F32, _F32, False),
                   ("bf16+master", _BF16, _BF16, _F32, True),
                   ("f32_grad+bf16", _BF16, _F32, _BF16, False))
               for clip in (False, True)]


def _adamw_bc(step):
    """AdamW's f32 bias corrections (the port's optimizer's rule)."""
    b1, b2 = ADAMW_HYPER[1:3]
    return tuple(float(np.float32(1) - np.float32(b) ** np.float32(step))
                 for b in (b1, b2))


def _adamw_close(name, got, plain32, before=None):
    """f32: within 1e-6 relative to |p'| + |p' - p| (the new value and,
    for a parameter given its value `before`, the step it took: the last
    subtraction rounds relative to both); bf16: within one bf16 ulp of the
    plain version's f32 value."""
    if got.dtype == torch.float32:
        err = (got - plain32).abs()
        bound = 1e-6 * plain32.abs()
        if before is not None:
            bound += 1e-6 * (plain32 - before.float()).abs()
    else:
        err = (got.float() - plain32).abs()
        bound = bf16_ulp(plain32)
    if not bool((err <= bound).all()) or not torch.isfinite(got).all():
        raise AssertionError(f"adamw {name}: off by {float(err.max()):.3e}")
    return float((got.float() - plain32.to(got.dtype).float()).abs().max())


def _adamw_tensors(gen, pd, gd, sd, master, clip):
    """A state as Adam leaves it: p ~ N(0, 0.02), g ~ N(0, 1e-3), m ~
    N(0, 1e-4), v = 4 m^2 + N(0, 1e-4)^2 (so |m| < sqrt(v) and the step
    is about lr at most), the master p in f32, clip scale 0.37."""
    p32 = _rand(gen, ADAMW_SHAPE, _F32, 0.02)
    m = _rand(gen, ADAMW_SHAPE, _F32, 1e-4)
    v = 4 * m.square() + _rand(gen, ADAMW_SHAPE, _F32, 1e-4).square()
    return (p32.to(pd), _rand(gen, ADAMW_SHAPE, gd, 1e-3), m.to(sd),
            v.to(sd), p32.clone() if master else None,
            torch.full((), 0.37, device="cuda") if clip else None)


def phase_slice5_kernel_checks(LN, X):
    """The AdamW kernel in every variant against its plain version (one
    update, in place, compared with the plain f32 results); the RMSNorm
    kernel and the dropout + residual + LayerNorm kernel against theirs
    in f32 and bf16 at both widths and at DRLN_EXTRA_SHAPES, the latter
    with its keep-mask equal to the plain hash mask, its kept fraction
    near 1 - p, and caller bits equal to its own hash giving bit-equal
    outputs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    err = dict.fromkeys(("adamw", "rms_norm", "dropout_residual_layer_norm"),
                        0.0)
    bc = _adamw_bc(ADAMW_STEP)
    for name, pd, gd, sd, master, clip in ADAMW_CASES:
        p, g, m, v, ms, scale = _adamw_tensors(gen, pd, gd, sd, master,
                                               clip)
        before = (ms if master else p).clone()
        pp, pm, pv = X._adamw_kernel_ref(before, g, m, v, *ADAMW_HYPER,
                                         *bc, scale=scale)
        X._adamw_launch(p, g, m, v, ms, scale, (*ADAMW_HYPER, *bc))
        e = max(_adamw_close(name, p, pp, before),
                _adamw_close(name, m, pm), _adamw_close(name, v, pv))
        if master:
            e = max(e, _adamw_close(name, ms, pp, before))
        err["adamw"] = max(err["adamw"], e)
        log("kernel", form=f"adamw {list(ADAMW_SHAPE)} {name}",
            p=str(pd)[6:], g=str(gd)[6:], slots=str(sd)[6:],
            max_err=f"{e:.3e}")
        del p, g, m, v, ms, before, pp, pm, pv
    for dtype in (_F32, _BF16):
        for n, h in NORM_SHAPES + DRLN_EXTRA_SHAPES:
            x = _rand(gen, (n, h), dtype, 2.0)
            w = _rand(gen, (h,), dtype)
            plain32 = LN._rms_kernel_ref(x.float(), w.float(), RMS_EPS)
            e = _check_close("rms_norm", LN._rms_launch(x, w, RMS_EPS),
                             plain32.to(dtype), plain32)
            err["rms_norm"] = max(err["rms_norm"], e)
            r = _rand(gen, (n, h), dtype)
            b = _rand(gen, (h,), dtype)
            out, hv = X._drln_launch(x, r, w, b, DRLN_RATE, 1e-5, DRLN_SEED,
                                     None)
            o32, h32 = X._dropout_res_ln_kernel_ref(
                x.float(), r.float(), w.float(), b.float(), DRLN_RATE, 1e-5,
                DRLN_SEED)
            e2 = max(_check_close("drln out", out, o32.to(dtype), o32),
                     _check_close("drln h", hv, h32.to(dtype), h32))
            err["dropout_residual_layer_norm"] = max(
                err["dropout_residual_layer_norm"], e2)
            # the keep-mask: with x != 0 and r = 0, h != 0 exactly where kept
            _, hk = X._drln_launch(x.abs() + 1, torch.zeros_like(r), w, b,
                                   DRLN_RATE, 1e-5, DRLN_SEED, None)
            bits = X._hash_bits(DRLN_SEED, (n, h), "cuda")
            keep = bits <= X._keep_thresh(DRLN_RATE)
            if not torch.equal(hk != 0, keep):
                raise AssertionError("dropout_residual_layer_norm: keep-mask"
                                     " differs from the plain hash mask")
            kept = float(keep.float().mean())
            if abs(kept - (1 - DRLN_RATE)) > KEEP_FRACTION_TOL:
                raise AssertionError(f"kept fraction {kept}")
            # the caller's bits (the same hash, as int32) give the same
            # outputs, bit for bit
            host = torch.where(bits >= 2 ** 31, bits - 2 ** 32,
                               bits).to(torch.int32)
            out2, hv2 = X._drln_launch(x, r, w, b, DRLN_RATE, 1e-5, 0, host)
            if not (torch.equal(out, out2) and torch.equal(hv, hv2)):
                raise AssertionError("dropout_residual_layer_norm: host bits"
                                     " and in-kernel bits disagree")
            log("kernel", form=f"rms_norm + dropout_residual_layer_norm "
                f"[{n}, {h}] p={DRLN_RATE}", dtype=str(dtype)[6:],
                rms_err=f"{e:.3e}", drln_err=f"{e2:.3e}", keep_mask="equal",
                kept=f"{kept:.6f}", host_bits="equal")
            del x, r, out, hv, hk, o32, h32, bits, keep, host, out2, hv2
    torch.cuda.synchronize()
    return err


_probe_lib = None


def _adamw_probe(mode, p, g, m, v, scale, hyper):
    """A measurement probe of the AdamW kernel's loop on one bf16 tensor
    (`csrc/adamw_probe.cu`, never used for results and never loaded by
    the port): mode 1 with cheap approximate divisions, mode 2 a copy of
    the same traffic."""
    global _probe_lib
    from paddle_tpu_torch.ops import _build
    if _probe_lib is None:
        _probe_lib = _build.load("adamw_probe")
        _probe_lib.adamw_probe.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
            + [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p])
        _probe_lib.adamw_probe.restype = ctypes.c_int
        _probe_lib.adamw_probe_error_string.argtypes = [ctypes.c_int]
        _probe_lib.adamw_probe_error_string.restype = ctypes.c_char_p
    lr, b1, b2, eps, wd, bc1, bc2 = hyper
    rc = _probe_lib.adamw_probe(
        mode, p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        None if scale is None else scale.data_ptr(), p.numel(), lr, b1,
        1.0 - b1, b2, 1.0 - b2, eps, wd, bc1, bc2, p.device.index or 0,
        torch.cuda.current_stream(p.device).cuda_stream)
    if rc:
        raise RuntimeError("adamw probe launch failed: "
                           f"{_probe_lib.adamw_probe_error_string(rc)}")


def phase_slice5_kernel_timing(X):
    """AdamW and the dropout + residual + LayerNorm kernel at the main
    paths' shapes (bf16), beside their plain versions and one PyTorch call
    computing the same function (never called by the port):
    `torch._fused_adamw_` on the same tensors (without the clip scale);
    no single PyTorch call computes dropout + residual + LayerNorm and the
    pre-LN sum (RMSNorm: `phase_norm_timing`). Bounds: each input read
    once and each output written once over 3.35 TB/s, or the f32 flops
    over 67 TFLOP/s, the larger. The JSON row of the dropout op takes the
    BERT width, the shape of the norm entry-point phase."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    out = {}
    bc = _adamw_bc(ADAMW_STEP)
    p, g, m, v, _, scale = _adamw_tensors(gen, _BF16, _BF16, _BF16, False,
                                          True)
    lr, b1, b2, eps, wd = ADAMW_HYPER
    steps = torch.full((), float(ADAMW_STEP), device="cuda")

    def plain(i=0):
        pp, pm, pv = X._adamw_kernel_ref(p, g, m, v, *ADAMW_HYPER, *bc,
                                         scale=scale)
        p.copy_(pp)
        m.copy_(pm)
        v.copy_(pv)

    numel = p.numel()
    specs = {"adamw": (
        lambda i=0: X._adamw_launch(p, g, m, v, None, scale,
                                    (*ADAMW_HYPER, *bc)),
        plain,
        lambda i=0: torch._fused_adamw_(
            [p], [g], [m], [v], [], [steps], lr=lr, beta1=b1, beta2=b2,
            weight_decay=wd, eps=eps, amsgrad=False, maximize=False),
        14 * numel + 4, 16 * numel, f"{list(ADAMW_SHAPE)} bf16 p/g/m/v, "
        f"clip scale")}
    for n, h in NORM_SHAPES:
        x = _rand(gen, (n, h), _BF16, 2.0)
        w, b = _rand(gen, (h,), _BF16), _rand(gen, (h,), _BF16)
        r = _rand(gen, (n, h), _BF16)
        specs[f"dropout_residual_layer_norm[{n}x{h}]"] = (
            lambda i=0, x=x, r=r, w=w, b=b: X._drln_launch(
                x, r, w, b, DRLN_RATE, 1e-5, DRLN_SEED, None),
            lambda i=0, x=x, r=r, w=w, b=b: X._dropout_res_ln_kernel_ref(
                x, r, w, b, DRLN_RATE, 1e-5, DRLN_SEED),
            None, 8 * n * h + 4 * h, 15 * n * h,
            f"[{n}, {h}] bf16 p={DRLN_RATE}, in-kernel hash bits")
    bits = torch.zeros(NORM_SHAPES[1], dtype=torch.int32, device="cuda")
    x, r = (_rand(gen, NORM_SHAPES[1], _BF16) for _ in range(2))
    w, b = (_rand(gen, NORM_SHAPES[1][1:], _BF16) for _ in range(2))
    n, h = NORM_SHAPES[1]
    specs[f"dropout_residual_layer_norm[{n}x{h}, host bits]"] = (
        lambda i=0: X._drln_launch(x, r, w, b, DRLN_RATE, 1e-5, 0, bits),
        lambda i=0: X._dropout_res_ln_kernel_ref(x, r, w, b, DRLN_RATE,
                                                 1e-5, 0, bits),
        None, 12 * n * h + 4 * h, 15 * n * h,
        f"[{n}, {h}] bf16 p={DRLN_RATE}, caller's int32 bits")
    for name, (kern, plain_fn, library, nbytes, flops, form) in \
            specs.items():
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain_fn, 3)
        library_ms = cuda_ms(library, 20) if library else None
        bound_ms, bound_by = _bound(nbytes, flops, H100_F32_FLOPS)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        extra = {}
        if name == "adamw":
            # the loop's ceilings, from the same loop (never results): the
            # update with cheap approximate divisions, and a copy of the
            # same traffic, on copies of the state (the copy probe
            # scrambles its operands)
            hyper = (*ADAMW_HYPER, *bc)
            st = [t.clone() for t in (p, g, m, v)]
            out[name]["cheap_div_ms"] = cuda_ms(
                lambda i=0: _adamw_probe(1, *st, scale, hyper), 20)
            out[name]["copy_ceiling_ms"] = cuda_ms(
                lambda i=0: _adamw_probe(2, *st, scale, hyper), 20)
            del st
            extra = {k: f"{out[name][k]:.4f}" for k in
                     ("copy_ceiling_ms", "cheap_div_ms")}
            extra.update(earlier_ms=ADAMW_EARLIER_MS,
                         goal_no_slower_than_library="met" if
                         ms <= library_ms else "missed")
        else:
            # the row walk's device time (CUDA graph), beside the earlier
            # design's on the same inputs and its 70% goal
            dev = out[name]["device_ms"] = cuda_graph_ms(kern, 20)
            extra = {"device_ms": f"{dev:.4f}",
                     "bound_share_device": f"{bound_ms / dev:.3f}",
                     "earlier_device_ms": DRLN_EARLIER_DEVICE_MS[name],
                     "goal_70pct_of_bound": "met" if bound_ms / dev >= 0.7
                     else "missed"}
        log("kernel_time", kernel=name, form=repr(form), ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}",
            library_ms="none (no single PyTorch call)" if library is None
            else f"{library_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            achieved_GBps=f"{nbytes / ms / 1e6:.1f}", **extra)
    return out


# Steps of a training run replayed with one AdamW launch a parameter
# (the route the multi-tensor launch replaced): their losses must equal
# the run's bit for bit.
ROUTE_STEPS = 3


def phase_adamw_list(trainer, batch, X, label):
    """The multi-tensor AdamW launch over a training run's real parameter
    list (`trainer.params`, the gradients of one more step, the
    optimizer's moment slots and, for GPT, the clip scale), on copies
    of the state: bit-equal to one `adamw_update_` launch a parameter.
    Then the whole list timed three ways on the same copies: the
    multi-tensor launch, the per-tensor launches, and
    `torch._fused_adamw_` over the same lists (PyTorch's multi-tensor
    form, without the clip scale; never called by the port); bound: the
    list's p, g, m, v read once and p, m, v written once over 3.35 TB/s
    (the f32 flops, ~16 an element over 67 TFLOP/s, are below it)."""
    opt = trainer.optimizer
    _, grads = trainer._loss_and_grads(batch)
    clip = opt._grad_clip
    scale = clip.scale(list(grads)) if clip is not None else None
    params = list(trainer.params)
    slots = [opt._slots(p) for p in params]
    if any("master" in st for st in slots):
        raise AssertionError(f"{label}: a master copy in the list")
    hyper = (opt.get_lr(), opt._beta1, opt._beta2, opt._epsilon, opt._wd,
             *opt._bias_corrections(opt._step_count + 1))

    def state():
        return ([p.detach().clone() for p in params],
                [st["moment1"].clone() for st in slots],
                [st["moment2"].clone() for st in slots])

    a, b = state(), state()
    X.reset_counts()
    X.adamw_update_multi(a[0], grads, a[1], a[2], *hyper, scale=scale)
    multi_launches = X.adamw_kernel_launches
    for p, g, m, v in zip(b[0], grads, b[1], b[2]):
        X.adamw_update_(p, g, m, v, *hyper, scale=scale)
    torch.cuda.synchronize()
    equal = all(_bits_equal(x, y) for la, lb in zip(a, b)
                for x, y in zip(la, lb))
    if not equal:
        raise AssertionError(f"{label}: the multi-tensor AdamW launch and "
                             "the per-tensor launches differ")
    numel = sum(p.numel() for p in params)
    nbytes = sum(p.numel() * (2 * p.element_size() + g.element_size() +
                              2 * st["moment1"].element_size() * 2)
                 for p, g, st in zip(params, grads, slots))
    steps = [torch.full((), float(opt._step_count + 1), device="cuda")
             for _ in params]
    lr, b1, b2, eps, wd = hyper[:5]
    routes = {
        "": lambda i=0: X.adamw_update_multi(a[0], grads, a[1], a[2],
                                             *hyper, scale=scale),
        "per_tensor_": lambda i=0: [
            X.adamw_update_(p, g, m, v, *hyper, scale=scale)
            for p, g, m, v in zip(b[0], grads, b[1], b[2])],
        "library_": lambda i=0: torch._fused_adamw_(
            b[0], list(grads), b[1], b[2], [], steps, lr=lr, beta1=b1,
            beta2=b2, weight_decay=wd, eps=eps, amsgrad=False,
            maximize=False)}
    # eager (CUDA events around calls, host-paced where the Python of a
    # call outlasts its device work), device time (the calls replayed
    # from a CUDA graph) and host time a call
    out = {}
    for key, fn in routes.items():
        out[f"{key}ms"] = cuda_ms(fn, 5)
        out[f"{key}device_ms"] = cuda_graph_ms(fn, 5)
        out[f"{key}host_us"] = host_us(fn, 5)
    bound_ms, bound_by = _bound(nbytes, 16 * numel, H100_F32_FLOPS)
    out.update(bound_ms=bound_ms, launches=multi_launches)
    log("adamw_list", model=label, tensors=len(params),
        elements=numel, launches=multi_launches,
        clip_scale=scale is not None, bit_equal_to_per_tensor=equal,
        **{k: f"{v:.4f}" if k.endswith("ms") else f"{v:.1f}"
           for k, v in out.items() if k.endswith(("ms", "us"))},
        per_tensor_launches=len(params), bound_by=bound_by,
        device_share_of_bound=f"{bound_ms / out['device_ms']:.3f}",
        goal_below_library_device="met" if out["device_ms"] <=
        out["library_device_ms"] else "missed")
    del a, b, grads
    torch.cuda.empty_cache()
    return out


def phase_train_route(label, make_trainer, batch, losses):
    """A fresh trainer of the same recipe with one AdamW launch a
    parameter (`testing.PerTensorAdamW`) runs the first ROUTE_STEPS steps
    of the run: its losses must equal the run's (the multi-tensor
    launch) bit for bit."""
    from paddle_tpu_torch.distributed import LossBuffer
    from paddle_tpu_torch.ops import fused_ops as X
    from paddle_tpu_torch.testing import PerTensorAdamW
    trainer = make_trainer(PerTensorAdamW)
    buf = LossBuffer(drain_every=ROUTE_STEPS)
    X.reset_counts()
    for _ in range(ROUTE_STEPS):
        buf.append(trainer.step(batch))
    got = buf.losses
    launches = X.adamw_kernel_launches
    del trainer
    torch.cuda.empty_cache()
    if got != list(losses[:ROUTE_STEPS]):
        raise AssertionError(f"{label}: losses with one AdamW launch a "
                             f"parameter {got} differ from the run's "
                             f"{list(losses[:ROUTE_STEPS])}")
    log("train_route", model=label, steps=ROUTE_STEPS,
        per_tensor_launches_per_step=launches / ROUTE_STEPS,
        losses=",".join(f"{x:.9g}" for x in got), bit_equal_to_run=True)


def phase_norm_entry_points(LN, X):
    """The two norm ops through the entry points a user calls, at full
    width on the card: nn.RMSNorm(2048) forward and backward on [8, 1024,
    2048] bf16, its output held against the kernel's plain version and
    its input and weight gradients against autograd of the plain
    `_rms_ref`; fused_dropout_residual_layer_norm at [16384, 768] bf16, p
    0.1, in training and in eval, each held against its plain version.
    Counts are read over the entry-point calls alone."""
    from paddle_tpu_torch import nn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    layer = nn.RMSNorm(THID)
    x = _rand(gen, (TB, TL, THID), _BF16, 2.0).requires_grad_()
    dy = _rand(gen, (TB, TL, THID), _BF16)
    n, h = NORM_SHAPES[1]
    xd, rd = _rand(gen, (n, h), _BF16), _rand(gen, (n, h), _BF16)
    wd, bd = _rand(gen, (h,), _BF16), _rand(gen, (h,), _BF16)
    torch.cuda.synchronize()
    LN.reset_counts()
    X.reset_counts()
    y = layer(x)
    y.backward(dy)
    train = X.fused_dropout_residual_layer_norm(xd, rd, wd, bd, p=DRLN_RATE,
                                                seed=DRLN_SEED)
    evl = X.fused_dropout_residual_layer_norm(xd, rd, wd, bd, p=DRLN_RATE,
                                              seed=DRLN_SEED,
                                              training=False)
    torch.cuda.synchronize()
    launches = {"rms_norm": LN.rms_kernel_launches,
                "dropout_residual_layer_norm": X.drln_kernel_launches}
    plain = LN.rms_plain_launches + X.drln_plain_launches
    if launches != {"rms_norm": 1, "dropout_residual_layer_norm": 2} or \
            plain:
        raise AssertionError(f"norm entry points launched {launches}, "
                             f"plain {plain}")
    w32 = layer.weight.detach()
    y32 = LN._rms_kernel_ref(x.detach().float(), w32, RMS_EPS)
    err = _check_close("RMSNorm", y.detach(), y32.to(_BF16), y32)
    with torch.enable_grad():
        xs, ws = x.detach().requires_grad_(), w32.clone().requires_grad_()
        dx, dw = torch.autograd.grad(LN._rms_ref(xs, ws, RMS_EPS), (xs, ws),
                                     dy)
    gerr = max(_check_close("RMSNorm dx", x.grad, dx, dx.float()),
               _check_close("RMSNorm dw", layer.weight.grad, dw, dw))
    derr = 0.0
    for (out, hv), rate in ((train, DRLN_RATE), (evl, 0.0)):
        o32, h32 = X._dropout_res_ln_kernel_ref(
            xd.float(), rd.float(), wd.float(), bd.float(), rate, 1e-5,
            DRLN_SEED)
        derr = max(derr, _check_close("drln out", out, o32.to(_BF16), o32),
                   _check_close("drln h", hv, h32.to(_BF16), h32))
    log("norm_entry", rms_norm=f"nn.RMSNorm({THID}) [{TB}, {TL}, {THID}] "
        "bf16 fwd+bwd", rms_fwd_err=f"{err:.3e}", rms_grad_err=f"{gerr:.3e}",
        drln=f"[{n}, {h}] bf16 p={DRLN_RATE} train+eval",
        drln_err=f"{derr:.3e}",
        **{f"{k}_launches": v for k, v in launches.items()}, plain=plain)
    return launches


# ---------------------------------------------------------------- phase 9b

# The LayerNorm and RMSNorm kernels' checks: (label, rows, width, x dtype,
# weight dtype, eps, control). GPT's, gpt_moe_small's and BERT's rows at
# full width (the control run there), width 128 and 8192, 8 rows, row counts that are no
# multiple of the rows a block takes, widths whose vectors leave lanes
# idle (640) or need 3 warps a row (6144), and mixed x and weight dtypes
# (the 64 KB of f32 w and b at 8192 take the opt-in shared memory).
NORM_CASES = (("gpt", TN, THID, _BF16, _BF16, 1e-5, True),
              ("gpt_moe", TN, 1024, _BF16, _BF16, 1e-5, True),
              ("gpt f32", TN, THID, _F32, _F32, 1e-5, False),
              ("bert", BB * BL, BHID, _BF16, _BF16, 1e-12, True),
              ("h128", 1024, 128, _BF16, _BF16, 1e-5, False),
              ("h8192", 512, 8192, _BF16, _BF16, 1e-5, False),
              ("h8192 f32", 512, 8192, _F32, _F32, 1e-5, False),
              ("h8192 f32 w", 64, 8192, _BF16, _F32, 1e-5, False),
              ("n8", 8, THID, _BF16, _BF16, 1e-5, False),
              ("ragged", 1001, BHID, _BF16, _BF16, 1e-12, False),
              ("ragged f32 w", 1001, BHID, _BF16, _F32, 1e-12, False),
              ("ragged bf16 w", 999, THID, _F32, _BF16, 1e-5, False),
              ("h640", 333, 640, _BF16, _BF16, 1e-5, False),
              ("h6144", 96, 6144, _BF16, _BF16, 1e-5, False),
              ("h6144 f32", 96, 6144, _F32, _F32, 1e-5, False))


def phase_norm_checks(LN):
    """At every NORM_CASES shape: the LayerNorm forward kernel against its
    plain version (`_check_close`), its saved mean and rstd against
    `_mean_rstd` (atol 1e-6, rtol 1e-5: f32 sums in another order), the
    RMSNorm forward against its plain version, and LayerNorm's backward
    kernel against its plain version on the kernel's own mean and rstd
    (`testing.check_ln_bwd`), launched twice, bit-equal. Where a case
    says so, the control (dw from f32 xhat, `testing.ln_bwd_control`)
    must fail that check."""
    from paddle_tpu_torch import testing
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    err = dict.fromkeys(("layer_norm", "layer_norm_bwd", "rms_norm"), 0.0)
    for label, n, h, dt, wd, eps, control in NORM_CASES:
        x = _rand(gen, (n, h), dt, 2.0)
        w, b = _rand(gen, (h,), wd), _rand(gen, (h,), wd)
        g = _rand(gen, (n, h), dt)
        out, mean, rstd = LN._launch(x, w, b, eps)
        plain32, _, _ = LN._ln_fwd_ref(x.float(), w.float(), b.float(), eps)
        e_fwd = _check_close(f"layer_norm {label}", out, plain32.to(dt),
                             plain32)
        mu, rs = LN._mean_rstd(x.float(), eps)
        torch.testing.assert_close(mean, mu.reshape(-1), atol=1e-6,
                                   rtol=1e-5)
        torch.testing.assert_close(rstd, rs.reshape(-1), atol=1e-6,
                                   rtol=1e-5)
        rms32 = LN._rms_kernel_ref(x.float(), w.float(), RMS_EPS)
        e_rms = _check_close(f"rms_norm {label}",
                             LN._rms_launch(x, w, RMS_EPS), rms32.to(dt),
                             rms32)
        got = LN._bwd_launch(x, g, w, mean, rstd)
        again = LN._bwd_launch(x, g, w, mean, rstd)
        if not all(_bits_equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"layer_norm_bwd {label}: two launches "
                                 "differ")
        e_bwd, flips = testing.check_ln_bwd(f"layer_norm_bwd {label}", got,
                                            x, g, w, mean, rstd)
        rejected = None
        if control:
            try:
                testing.check_ln_bwd("control", testing.ln_bwd_control(
                    x, g, w, mean, rstd), x, g, w, mean, rstd)
                rejected = False
            except AssertionError:
                rejected = True
            if not rejected:
                raise AssertionError(f"layer_norm_bwd {label}: the control "
                                     "(dw from f32 xhat) passed the check")
        for name, e in (("layer_norm", e_fwd), ("layer_norm_bwd", e_bwd),
                        ("rms_norm", e_rms)):
            err[name] = max(err[name], e)
        log("kernel", form=f"norms {label} [{n}, {h}] eps {eps}",
            dtype=str(dt)[6:], weights=str(wd)[6:], ln_err=f"{e_fwd:.3e}",
            rms_err=f"{e_rms:.3e}", ln_bwd_err=f"{e_bwd:.3e}",
            ln_bwd_bits_off_plain=f"{flips:.5f}", bwd_bit_equal=True,
            **({} if rejected is None else {"control_rejected": rejected}))
        del x, g, out, plain32, got, again
    torch.cuda.synchronize()
    return err


# The norm kernels' device times (CUDA graph) before this design, at GPT's
# and BERT's rows (bf16): the 256-threads-a-row forwards and, for the
# backward, autograd of `_ln_ref` (the route the kernel replaced), timed by
# tools/kernel_ab.py on the tree before it (NVIDIA H100 80GB HBM3, 700 W;
# the [kernel_time] lines only).
NORM_EARLIER_DEVICE_MS = {
    "layer_norm": {THID: 0.0293, BHID: 0.0319},
    "layer_norm_bwd": {THID: 1.3459, BHID: 1.0642},
    "rms_norm": {THID: 0.0267, BHID: 0.0258}}


def phase_norm_timing(LN):
    """The LayerNorm forward and backward and the RMSNorm forward at GPT's
    and BERT's rows in bf16, each eager (CUDA events around a loop of
    calls, Python wrapper included) and as device time (CUDA-graph
    replay), beside the plain version (eager) and one PyTorch call
    computing the same function (never called by the port), timed both
    ways: F.layer_norm, aten's native_layer_norm_backward, F.rms_norm.
    Bound: each input read once and each output written once over 3.35
    TB/s, or the f32 operations over 67 TFLOP/s, the larger; the
    backward's line also gives its f32 partials (2 x grid x h, written
    and read once) and the bound with them."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    out = {}
    for n, h in NORM_SHAPES:
        eps = 1e-5 if h == THID else 1e-12
        x = _rand(gen, (n, h), _BF16, 2.0)
        w, b = _rand(gen, (h,), _BF16), _rand(gen, (h,), _BF16)
        g = _rand(gen, (n, h), _BF16)
        _, mean, rstd = LN._launch(x, w, b, eps)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], w, b, eps)
        grid = LN._bwd_grid(n, h, 1, 1, torch.cuda.current_device())
        part_bytes = 2 * grid * h * 4
        io, wb = n * h * 2, h * 2
        specs = {
            "layer_norm": (
                lambda i=0: LN._launch(x, w, b, eps),
                lambda i=0: LN._ln_fwd_ref(x, w, b, eps),
                lambda i=0: F.layer_norm(x, (h,), w, b, eps),
                2 * io + 2 * wb + 8 * n, 8 * n * h, {}),
            "layer_norm_bwd": (
                lambda i=0: LN._bwd_launch(x, g, w, mean, rstd),
                lambda i=0: LN._ln_bwd_kernel_ref(x, g, w, mean, rstd),
                lambda i=0: torch.ops.aten.native_layer_norm_backward(
                    g, x, [h], lmean, lrstd, w, b, [True, True, True]),
                3 * io + 3 * wb + 8 * n, 15 * n * h,
                {"grid": grid, "partial_MB": f"{part_bytes / 1e6:.2f}"}),
            "rms_norm": (
                lambda i=0: LN._rms_launch(x, w, RMS_EPS),
                lambda i=0: LN._rms_kernel_ref(x, w, RMS_EPS),
                lambda i=0: F.rms_norm(x, (h,), w, RMS_EPS),
                2 * io + wb, 4 * n * h, {}),
        }
        for name, (kern, plain, library, nbytes, flops, extra) in \
                specs.items():
            row = {"ms": cuda_ms(kern, 20), "device_ms": cuda_graph_ms(kern, 20),
                   "plain_ms": cuda_ms(plain, 3),
                   "library_ms": cuda_ms(library, 20),
                   "library_device_ms": cuda_graph_ms(library, 20)}
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops,
                                                      H100_F32_FLOPS)
            out[f"{name}[{n}x{h}]"] = row
            if name == "layer_norm_bwd":
                extra["bound_with_partials_ms"] = (
                    f"{_bound(nbytes + 2 * part_bytes, flops, H100_F32_FLOPS)[0]:.4f}")
            earlier = NORM_EARLIER_DEVICE_MS[name][h]
            share = row["bound_ms"] / row["device_ms"]
            goal = {"layer_norm": ("goal_70pct_of_bound", share >= 0.7),
                    "rms_norm": ("goal_no_slower_than_library_device",
                                 row["device_ms"] <= row["library_device_ms"]),
                    "layer_norm_bwd": ("goal_below_library_device",
                                       row["device_ms"]
                                       <= row["library_device_ms"])}[name]
            log("kernel_time", kernel=name, shape=f"[{n}, {h}] bf16",
                **{k: f"{v:.4f}" if isinstance(v, float) else v
                   for k, v in row.items()},
                bound_share_device=f"{share:.3f}",
                earlier_device_ms=earlier,
                achieved_GBps_device=f"{nbytes / row['device_ms'] / 1e6:.1f}",
                **extra, **{goal[0]: "met" if goal[1] else "missed"})
        del x, g, mean, rstd, lmean, lrstd, specs
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 9c

# F.dropout's hash dropout kernel (csrc/hash_dropout.cu): BERT's hidden
# states [32, 512, 768] at every rate of the checks, the timing at the same
# elements as [16384, 768] bf16 (BERT's rate 0.1), one salt.
DROP_SHAPE = (BB, BL, BHID)
DROP_RATES = (0.1, 0.3, 0.5, 0.9)
DROP_SALT = 123456789


def phase_dropout_checks(D):
    """The hash dropout kernel against its plain version on the card, bits
    compared exactly, forward (x) and backward (a gradient g: the same
    function of g): f32 and bf16 at BERT's [32, 512, 768] at p 0.1, 0.3,
    0.5 and 0.9 in both modes, f16 at p 0.1, an element count that is no
    multiple of a vector (1,000,003 bf16) and a view one element off
    16-byte alignment (the scalar path); each case launched twice, bits
    equal, and its kept fraction near 1 - p; the `axis` form's mask kernel
    against the plain mask. The control, the earlier arithmetic (a bf16 x
    divided by f32(1 - p), not by f32(bf16(1 - p))), must differ from
    the kernel at bf16, p 0.1."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    cases = [(f"bert {str(dt)[6:]}", DROP_SHAPE, dt, p, up, 0)
             for dt in (_F32, _BF16) for p in DROP_RATES
             for up in (True, False)]
    cases += [("bert float16", DROP_SHAPE, torch.float16, 0.1, True, 0),
              ("odd n", (1_000_003,), _BF16, 0.1, True, 0),
              ("offset view", (1_000_000,), _BF16, 0.1, True, 1)]
    err = 0.0
    for label, shape, dt, p, up, off in cases:
        n = int(np.prod(shape))
        x = _rand(gen, (n + off,), dt, 2.0)[off:].view(shape)
        g = _rand(gen, shape, dt)
        y = D._launch("hash_dropout", x, DROP_SALT, p, up)
        again = D._launch("hash_dropout", x, DROP_SALT, p, up)
        dx = D._launch("hash_dropout_bwd", g, DROP_SALT, p, up)
        py = D._hash_dropout_ref(x, DROP_SALT, p, up)
        pdx = D._hash_dropout_ref(g, DROP_SALT, p, up)
        if not (_bits_equal(y, py) and _bits_equal(dx, pdx)
                and _bits_equal(y, again)):
            raise AssertionError(
                f"hash_dropout {label} p={p} upscale={up}: kernel and plain "
                f"version differ (forward {not _bits_equal(y, py)}, backward "
                f"{not _bits_equal(dx, pdx)}, two launches "
                f"{not _bits_equal(y, again)})")
        kept = float(D._hash_keep_ref(DROP_SALT, shape, p, "cuda")
                     .float().mean())
        if abs(kept - (1 - p)) > (KEEP_FRACTION_TOL if n > 10 ** 7
                                  else 0.01):
            raise AssertionError(f"hash_dropout {label}: kept {kept}")
        err = max(err, float((y.float() - py.float()).abs().max()),
                  float((dx.float() - pdx.float()).abs().max()))
        extra = {}
        if label == "bert bfloat16" and p == 0.1 and up:
            keep = D._hash_keep_ref(DROP_SALT, shape, p, "cuda")
            div = torch.full((), np.float32(1.0 - p), device="cuda")
            control = torch.where(keep, (x.float() / div).to(dt),
                                  torch.zeros((), dtype=dt, device="cuda"))
            differ = int((control != y).sum())
            if not differ:
                raise AssertionError("hash_dropout: the control (divide by "
                                     "f32(1 - p)) equals the kernel")
            extra = {"control_rejected": True,
                     "control_elements_differing": differ}
        log("kernel", form=f"hash_dropout {label} {list(shape)} p={p}",
            dtype=str(dt)[6:], mode="upscale_in_train" if up else
            "downscale_in_infer", aligned=x.data_ptr() % 16 == 0,
            fwd_bits_equal=True, bwd_bits_equal=True, two_launches_equal=True,
            kept=f"{kept:.6f}", **extra)
        del x, g, y, again, dx, py, pdx
    for shape in ((BB, 1, BHID), (7, 1, 33)):
        keep = D.hash_keep_mask(DROP_SALT, shape, 0.1, "cuda")
        if not torch.equal(keep, D._hash_keep_ref(DROP_SALT, shape, 0.1,
                                                  "cuda")):
            raise AssertionError(f"hash_dropout_mask {shape}: differs from "
                                 "the plain mask")
        log("kernel", form=f"hash_dropout_mask {list(shape)} p=0.1",
            mask_equal=True)
    torch.cuda.synchronize()
    return err


def phase_dropout_timing(D):
    """The hash dropout forward and backward at [16384, 768] bf16, p 0.1:
    eager (CUDA events around a loop of calls, the wrapper included) and
    device time (CUDA-graph replay), beside the plain version (the eager
    int64 chain of the earlier F.dropout, eager). No PyTorch call computes
    this function (`F.dropout` draws a Philox mask): library none; the
    line gives F.dropout's time as another function, for scale. Bound:
    x (or g) read once and the output written once, 2 x 2 bytes an
    element over 3.35 TB/s (one f32 divide an element over 67 TFLOP/s is
    far below it)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    shape, p = (BB * BL, BHID), BERT_RATE
    x, g = _rand(gen, shape, _BF16), _rand(gen, shape, _BF16)
    n = x.numel()
    out = {}
    for name, t in (("hash_dropout", x), ("hash_dropout_bwd", g)):
        def kern(i=0, t=t, name=name):
            return D._launch(name, t, DROP_SALT, p, True)

        def plain(i=0, t=t):
            return D._hash_dropout_ref(t, DROP_SALT, p, True)

        row = {"ms": cuda_ms(kern, 20), "device_ms": cuda_graph_ms(kern, 20),
               "plain_ms": cuda_ms(plain, 3), "library_ms": None}
        row["bound_ms"], row["bound_by"] = _bound(4 * n, n, H100_F32_FLOPS)
        out[name] = row
        other = {}
        if name == "hash_dropout":
            philox = torch.nn.functional.dropout
            other = {"other_function_torch_F_dropout_philox_ms":
                     f"{cuda_ms(lambda i=0: philox(x, p), 20):.4f}",
                     "other_function_torch_F_dropout_philox_device_ms":
                     f"{cuda_graph_ms(lambda i=0: philox(x, p), 20):.4f}"}
        log("kernel_time", kernel=name, shape=f"{list(shape)} bf16 p={p}",
            ms=f"{row['ms']:.4f}", device_ms=f"{row['device_ms']:.4f}",
            plain_ms=f"{row['plain_ms']:.4f}",
            library_ms="none (no PyTorch call computes this mask)",
            bound_ms=f"{row['bound_ms']:.4f}", bound_by=row["bound_by"],
            MB_moved=f"{4 * n / 1e6:.1f}",
            bound_share_device=f"{row['bound_ms'] / row['device_ms']:.3f}",
            achieved_GBps_device=f"{4 * n / row['device_ms'] / 1e6:.1f}",
            goal_60pct_of_bound="met" if row["bound_ms"] / row["device_ms"]
            >= 0.6 else "missed", **other)
    del x, g
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 10

# Block-sparse attention at gpt_1p3b's attention width (H 16, D 128),
# L 4096 in blocks of 128: an element-level BigBird-style CSR, drawn per
# head from a numpy generator seeded with SEED — each q-block row holds
# block 0 (global), the window i-1..i+1 and 2 random blocks (at most 6 of
# 32, uneven counts). The legacy paged cache at the serving pool's
# geometry (1025 pages of 16 tokens, 16 x 128) with 16 sequences of
# 64-832 tokens.
SB, SL, SBS = 1, 4096, 128                  # batch, length, block size
SB_TIME = 4                                 # batch of the timing run
PA_PAGES, PA_SEQS, PA_MAX_LEN = 1025, 16, 832
BS_SMALL_D = (8, 16, 40, 64, 128, 256)
PA_SMALL = ((8, 4), (16, 16), (64, 5), (128, 16), (256, 32))   # (D, ps)
# the paged kernel's eager time before the redesign (H100 80GB HBM3,
# 700 W): one block per (b, h), a serial page walk
PA_EARLIER_MS = 0.3248
# the block-sparse kernel's time at the timing shape on its SIMT f32 body
# before the tensor-core body, on these inputs (one pattern per (b, h)),
# timed by tools/kernel_ab.py on the tree before it (H100 80GB HBM3, 700
# W; the [kernel_time] line only), and the goals of the redesign: below
# SDPA with the dense mask, stretch 0.8 ms
BS_EARLIER_MS = 4.3281
BS_STRETCH_MS = 0.8


def _bigbird_blocks(rng, nb, n_random=2):
    """[nb, nb] bool: block 0, the window i-1..i+1, n_random random
    blocks per row."""
    bm = np.zeros((nb, nb), bool)
    for i in range(nb):
        bm[i, 0] = True
        bm[i, max(i - 1, 0):i + 2] = True
        bm[i, rng.choice(nb, n_random, replace=False)] = True
    return bm


def _bigbird_csr(seed, B, Hh, L, bs):
    """The element-level CSR (offset [B, H, L+1], columns [B, H, nnz],
    int32) of a per-head BigBird block pattern; heads of unequal nnz pad
    their columns with 0 past offset[L] (entries the reference ignores).
    Also returns the [H, nb, nb] block masks."""
    rng = np.random.RandomState(seed)
    nb = L // bs
    masks = np.stack([_bigbird_blocks(rng, nb) for _ in range(Hh)])
    offs, cols = [], []
    for h in range(Hh):
        counts = np.repeat(masks[h].sum(-1) * bs, bs)        # per row
        offs.append(np.concatenate([[0], np.cumsum(counts)]))
        cols.append((np.nonzero(masks[h])[1] * bs)[:, None]
                    + np.arange(bs))                         # [blocks, bs]
    # rows of block row i: the columns of its blocks, ascending
    per_head = []
    for h in range(Hh):
        c = cols[h].reshape(-1)
        starts = np.concatenate([[0], np.cumsum(masks[h].sum(-1))]) * bs
        rows = [np.tile(c[starts[i]:starts[i + 1]], bs) for i in range(nb)]
        per_head.append(np.concatenate(rows))
    nnz = max(len(c) for c in per_head)
    offset = np.zeros((B, Hh, L + 1), np.int32)
    columns = np.zeros((B, Hh, nnz), np.int32)
    for h in range(Hh):
        offset[:, h] = offs[h]
        columns[:, h, :len(per_head[h])] = per_head[h]
    return offset, columns, masks


def _bs_layout(gen, G, nq, empty=True):
    """A random blocked-CSR layout on the card: per row 1..nq blocks in
    ascending order, padded past the count with arbitrary ids; row 1 of
    pattern 0 empty (count 0) when `empty`."""
    keys = torch.rand((G, nq, nq), generator=gen, device="cuda")
    keep = keys < 0.4
    keep[..., 0] = True
    if empty:
        keep[0, min(1, nq - 1)] = False
    counts = keep.sum(-1).int()
    max_nnz = int(counts.max()) + 1                 # always one pad slot
    order = torch.argsort((~keep).int(), dim=-1, stable=True)
    order = torch.cat([order, order[..., :1]], dim=-1)[..., :max_nnz]
    pad = torch.randint(0, nq, order.shape, generator=gen, device="cuda")
    slot = torch.arange(max_nnz, device="cuda")
    cols = torch.where(slot < counts[..., None], order, pad)
    return cols.int().contiguous(), counts.contiguous()


def _bs_route(bsa, dtype, bs, d):
    """The body a launch must take: the tensor cores for bf16 at the
    block sizes and head dims they cover, SIMT otherwise."""
    tc = dtype == torch.bfloat16 and bs in bsa.TC_BLOCK_SIZES and \
        d in bsa.TC_HEAD_DIMS
    return f"{'tc' if tc else 'simt'},bs{bs},d{d}"


def _bs_check(bsa, name, q, k, v, cols, counts, bs, control=False):
    """The block-sparse kernel against its plain version `_bs_fwd_ref`
    (f32: within 1e-5; bf16: one ulp of the plain version's f32 result
    plus 1e-5), two launches bit-equal, both on the body the route rule
    names. With `control`, the tensor-core rounding points with p
    rounded to bf16 alone (`testing.bs_tc_walk(p_split=False)`) are held
    to the same tolerance; returns (max err, whether the control was
    rejected, None without one)."""
    from paddle_tpu_torch.testing import bs_tc_walk
    scale = 1.0 / q.shape[-1] ** 0.5
    bsa.reset_counts()
    got = bsa._launch(q, k, v, cols, counts, bs, scale)
    again = bsa._launch(q, k, v, cols, counts, bs, scale)
    want = {_bs_route(bsa, q.dtype, bs, q.shape[-1]): 2}
    if bsa.route_launches != want:
        raise AssertionError(f"{name}: launches by body "
                             f"{bsa.route_launches}, expected {want}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    plain32 = bsa._bs_fwd_ref(q.float(), k.float(), v.float(), cols, counts,
                              bs, scale)
    err = _check_close(name, got, plain32.to(q.dtype), plain32)
    rejected = None
    if control:
        ctrl = bs_tc_walk(q, k, v, cols, counts, bs, scale,
                          p_split=False).to(q.dtype).float()
        rejected = bool(((ctrl - plain32).abs() >
                         bf16_ulp(plain32) + 1e-5).any())
    return err, rejected


def _pa_check(pa, name, q, kp, vp, table, lens):
    """The paged kernel against its plain version, and the plain version
    against the gather reference in f32 (both within 1e-5)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    got = pa._launch(q, kp, vp, table, lens, scale)
    args = (q.float(), kp.float(), vp.float(), table, lens, scale)
    plain32 = pa._paged_ref(*args)
    torch.testing.assert_close(pa._paged_attention_ref(*args), plain32,
                               atol=1e-5, rtol=1e-5)
    return _check_close(name, got, plain32.to(q.dtype), plain32)


def _pa_identity(pa, q, kp, vp, table, lens):
    """Two launches of the paged kernel bit-equal, and the split launch
    bit-equal to the unsplit one."""
    scale = 1.0 / q.shape[-1] ** 0.5
    a = pa._launch(q, kp, vp, table, lens, scale, split=True)
    b = pa._launch(q, kp, vp, table, lens, scale, split=True)
    c = pa._launch(q, kp, vp, table, lens, scale, split=False)
    if not (torch.equal(a, b) and torch.equal(a, c)):
        raise AssertionError("paged: two launches, or the split and "
                             "unsplit launches, differ")
    log("kernel", check="paged two launches bit-equal, split == unsplit "
        "bit-equal", dtype=str(q.dtype)[6:], max_pages=table.shape[1])


def _pa_fill(gen, dtype, lens):
    """A PagedKVCache(PA_PAGES, PS, H, D) on the card filled by `append`,
    one token at a time, for sequences 0..len(lens)-1; returns (cache,
    page table, seq lens)."""
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    cache = PagedKVCache(PA_PAGES, PS, H, D, dtype=dtype)
    for sid, n in enumerate(lens):
        cache.new_seq(sid)
        kv = torch.randn((2, n, 1, H, D), generator=gen, device="cuda")
        for t in range(n):
            cache.append(sid, kv[0, t], kv[1, t])
    return (cache,) + cache.batch_view(list(range(len(lens))))


def _pa_lens(rng):
    lens = rng.randint(64, PA_MAX_LEN + 1, PA_SEQS)
    lens[0] = PA_MAX_LEN                      # the table is 52 pages wide
    return lens


def phase_slice6_kernel_checks(bsa, pa):
    """Both legacy kernels against their plain versions in f32 and bf16:
    block-sparse attention at every block size (8-128) and head dims 8 to
    256, per-head and shared layouts, a count-0 row and padded slots in
    every layout; paged attention at head dims 8-256 and page sizes 4-32
    with a seq_len-0 row (the uniform mean), -1 table entries and an id
    past the pool (both clamped); then both at full width."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    rng = np.random.RandomState(SEED + 30)
    err = {"block_sparse_attention": 0.0, "paged_attention": 0.0}
    routes, controls = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for n, (bs, d) in enumerate((bs, d) for bs in bsa.BLOCK_SIZES
                                    for d in BS_SMALL_D):
            B, Hh, L = 2, 2, max(4 * bs, 64)
            G = B * Hh if n % 2 == 0 else 1
            cols, counts = _bs_layout(gen, G, L // bs)
            q, k, v = (_rand(gen, (B, Hh, L, d), dtype) for _ in range(3))
            route = _bs_route(bsa, dtype, bs, d)
            e, rejected = _bs_check(bsa, f"bsa bs={bs} D={d}", q, k, v,
                                    cols, counts, bs,
                                    control=route.startswith("tc"))
            routes[route] = routes.get(route, 0) + 1
            if rejected is not None:
                controls.append(rejected)
            err["block_sparse_attention"] = max(
                err["block_sparse_attention"], e)
        log("kernel", form="block_sparse_attention small", dtype=str(dtype)[6:],
            block_sizes=list(bsa.BLOCK_SIZES), head_dims=list(BS_SMALL_D),
            layouts="per-head+shared, count-0 row, padded slots",
            max_abs_err=f"{err['block_sparse_attention']:.3e}",
            cases_by_body=";".join(f"{k}:{v}" for k, v in routes.items()),
            run_to_run="bit-equal",
            p_alone_control_rejected=f"{sum(controls)}/{len(controls)}")
        routes.clear()
        for (d, ps), MP in ((x, mp) for x in PA_SMALL for mp in (8, 40)):
            # MP 40: 5 chunks of 8 pages; seq_len 0 over the whole table
            P, Bq = 60, 7
            lens = torch.tensor([0, 1, ps, 3 * ps + 1, 7 * ps, 5,
                                 (MP - 7) * ps], dtype=torch.int32,
                                device="cuda")
            table = torch.randint(0, P, (Bq, MP), generator=gen,
                                  device="cuda", dtype=torch.int32)
            table[2, 1:] = -1                   # ids past the sequence
            table[5, 0] = P + 3                 # past the pool: clamped
            kp, vp = (_rand(gen, (P, ps, 3, d), dtype) for _ in range(2))
            q = _rand(gen, (Bq, 1, 3, d), dtype)
            e = _pa_check(pa, f"paged D={d} ps={ps}", q, kp, vp, table, lens)
            err["paged_attention"] = max(err["paged_attention"], e)
        log("kernel", form="paged_attention small", dtype=str(dtype)[6:],
            D_ps=list(PA_SMALL), max_pages="8 and 40 (1 and 5 chunks)",
            rows="seq_len 0, -1 ids, id past the pool",
            max_abs_err=f"{err['paged_attention']:.3e}")
    # full width
    offset, columns, _ = _bigbird_csr(SEED, SB, H, SL, SBS)
    _, bcols, bcounts = bsa.csr_to_block_layout(offset, columns, SL)
    bcols, bcounts = (torch.from_numpy(a).cuda() for a in (bcols, bcounts))
    lens = _pa_lens(rng)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_rand(gen, (SB, H, SL, D), dtype) for _ in range(3))
        e, rejected = _bs_check(bsa, "bsa full width", q, k, v, bcols,
                                bcounts, SBS, control=dtype == _BF16)
        if rejected is False:
            raise AssertionError("block-sparse: the p-rounded-alone control "
                                 "passed the bf16 tolerance at full width")
        err["block_sparse_attention"] = max(err["block_sparse_attention"], e)
        cache, table, seq_lens = _pa_fill(gen, dtype, lens)
        qd = _rand(gen, (PA_SEQS, 1, H, D), dtype)
        e2 = _pa_check(pa, "paged full width", qd, cache.k_pages,
                       cache.v_pages, table, seq_lens)
        err["paged_attention"] = max(err["paged_attention"], e2)
        _pa_identity(pa, qd, cache.k_pages, cache.v_pages, table, seq_lens)
        log("kernel", form=f"block_sparse_attention [{SB}, {H}, {SL}, {D}] "
            f"bs {SBS} BigBird + paged_attention pool {PA_PAGES}x{PS}x{H}x"
            f"{D} B {PA_SEQS} max_pages {table.shape[1]}",
            dtype=str(dtype)[6:], bsa_err=f"{e:.3e}", paged_err=f"{e2:.3e}",
            bsa_body=_bs_route(bsa, dtype, SBS, D),
            bsa_p_alone_control_rejected=rejected)
        del q, k, v, cache, qd
    torch.cuda.synchronize()
    return err


def _bs_timing_inputs(bsa, gen):
    """The block-sparse timing inputs, bf16 at B 4 x 16 x 4096 x 128, bs
    128 (also drawn by tools/kernel_ab.py): (q, k, v, block_cols,
    block_counts, visited blocks, the equivalent dense mask [1, H, L,
    L]). One pattern per (b, h): each head's BigBird pattern in every
    batch row, as the dense mask gives SDPA (a [H, ..] layout would be
    read as one shared pattern)."""
    offset, columns, masks = _bigbird_csr(SEED, 1, H, SL, SBS)
    _, bcols, bcounts = bsa.csr_to_block_layout(offset, columns, SL)
    bcols, bcounts = (np.tile(a, (SB_TIME,) + (1,) * (a.ndim - 1))
                      for a in (bcols, bcounts))
    visited = int(bcounts.sum())
    bcols, bcounts = (torch.from_numpy(a).cuda() for a in (bcols, bcounts))
    q, k, v = (_rand(gen, (SB_TIME, H, SL, D), _BF16) for _ in range(3))
    dense = torch.from_numpy(np.kron(masks, np.ones((SBS, SBS), bool))
                             ).cuda()[None]
    return q, k, v, bcols, bcounts, visited, dense


def phase_slice6_kernel_timing(bsa, pa):
    """Both kernels at full width, bf16, beside their plain versions,
    bounds and a PyTorch yardstick (never called by the port): block-
    sparse at B 4 x 16 x 4096 x 128 against SDPA with the equivalent
    dense boolean mask; paged at the entry-point shape against SDPA over
    the gathered K/V with a length mask. Bounds: block-sparse, the larger
    of 4*bs*bs*D flops per visited block over 989 TFLOP/s and the q, k,
    v, out bytes over 3.35 TB/s; paged, the K/V bytes of sum(seq_lens)
    tokens (plus q, out, table, lens) over 3.35 TB/s."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    out = {}
    q, k, v, bcols, bcounts, visited, dense = _bs_timing_inputs(bsa, gen)
    bsa.reset_counts()
    scale = 1.0 / D ** 0.5
    specs = {"block_sparse_attention": (
        lambda i=0: bsa._launch(q, k, v, bcols, bcounts, SBS, scale),
        lambda i=0: bsa._bs_fwd_ref(q, k, v, bcols, bcounts, SBS, scale),
        lambda i=0: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=dense, scale=scale),
        4 * SB_TIME * H * SL * D * 2, 4 * SBS * SBS * D * visited,
        f"[{SB_TIME}, {H}, {SL}, {D}] bf16 bs {SBS}, "
        f"{visited / (SB_TIME * H * SL // SBS):.2f} blocks a row")}
    lens = _pa_lens(np.random.RandomState(SEED + 33))   # [paged_entry]'s
    cache, table, seq_lens = _pa_fill(gen, _BF16, lens)
    qd = _rand(gen, (PA_SEQS, 1, H, D), _BF16)
    MPc = table.shape[1]
    safe = table.long().clamp_min(0)
    kg = cache.k_pages[safe].reshape(PA_SEQS, MPc * PS, H, D).transpose(1, 2)
    vg = cache.v_pages[safe].reshape(PA_SEQS, MPc * PS, H, D).transpose(1, 2)
    lmask = (torch.arange(MPc * PS, device="cuda")[None, :]
             < seq_lens[:, None].long())[:, None, None, :]
    qt = qd.transpose(1, 2)                             # [B, H, 1, D]
    kv_bytes = int(lens.sum()) * H * D * 2 * 2
    io_bytes = 2 * PA_SEQS * H * D * 2 + 4 * (PA_SEQS * MPc + PA_SEQS)
    specs["paged_attention"] = (
        lambda i=0: pa._launch(qd, cache.k_pages, cache.v_pages, table,
                               seq_lens, scale),
        lambda i=0: pa._paged_ref(qd, cache.k_pages, cache.v_pages, table,
                                  seq_lens, scale),
        lambda i=0: torch.nn.functional.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=lmask, scale=scale),
        kv_bytes + io_bytes, 4 * int(lens.sum()) * H * D,
        f"pool {PA_PAGES}x{PS}x{H}x{D} bf16, B {PA_SEQS}, max_pages {MPc},"
        f" mean seq_len {lens.mean():.1f}")
    for name, (kern, plain_fn, library, nbytes, flops, form) in \
            specs.items():
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain_fn, 3)
        library_ms = cuda_ms(library, 20)
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        extra = {}
        if name == "block_sparse_attention":
            # the tensor-core body issues 6 bs^2 D flops a visited block
            # (P.V twice: p_hi and p_lo) to the function's 4
            # the body is "body" in the kernels line, whose "route" is
            # the language ("cuda")
            out[name].update(body=",".join(bsa.route_launches),
                             work_TFLOPs=1.5 * flops / ms / 1e9)
            extra = dict(route=out[name]["body"],
                         work_TFLOPs=f"{1.5 * flops / ms / 1e9:.2f}",
                         earlier_ms=BS_EARLIER_MS,
                         goal_below_library="met" if ms < library_ms
                         else "missed",
                         stretch_0p8_ms="met" if ms <= BS_STRETCH_MS
                         else "missed")
        if name == "paged_attention":
            # a launch shorter than its Python: device time from a CUDA
            # graph and each side's host time a call, beside the eager ms
            out[name]["device_ms"] = cuda_graph_ms(kern, 20)
            out[name]["library_device_ms"] = cuda_graph_ms(library, 20)
            extra = {k: f"{out[name][k]:.4f}"
                     for k in ("device_ms", "library_device_ms")}
            extra.update(host_us=f"{host_us(kern, 20):.2f}",
                         library_host_us=f"{host_us(library, 20):.2f}",
                         earlier_ms=PA_EARLIER_MS,
                         goal_below_library_eager="met" if ms < library_ms
                         else "missed",
                         goal_below_library_device="met" if
                         out[name]["device_ms"] <
                         out[name]["library_device_ms"] else "missed")
        log("kernel_time", kernel=name, form=repr(form), ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            achieved_GBps=f"{nbytes / ms / 1e6:.1f}",
            achieved_TFLOPs=f"{flops / ms / 1e9:.2f}", **extra)
    del q, k, v, dense, cache, kg, vg
    return out


def phase_sparse_entry(bsa):
    """F.sparse_attention at full width (B 1 x 16 x 4096 x 128, bf16) on
    the BigBird CSR: forward and backward (loss = sum) through the kernel
    route, counted alone (1 kernel launch, 0 plain); the output held
    against the kernel's plain version, the gradients against autograd of
    the dense masked path on the element mask of the same CSR. Then a
    second call (a hit of the layout cache) and the dense path with a
    key_padding_mask (no kernel launch), held against SDPA with the same
    boolean mask."""
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    offset, columns, _ = _bigbird_csr(SEED, SB, H, SL, SBS)
    off_t, col_t = torch.from_numpy(offset).cuda(), torch.from_numpy(
        columns).cuda()
    q, k, v = (_rand(gen, (SB, H, SL, D), _BF16).requires_grad_()
               for _ in range(3))
    F._cached_block_layout.cache_clear()
    torch.cuda.synchronize()
    bsa.reset_counts()
    out = F.sparse_attention(q, k, v, off_t, col_t)
    out.float().sum().backward()
    torch.cuda.synchronize()
    launches, plain = bsa.kernel_launches, bsa.plain_launches
    routes = dict(bsa.route_launches)
    if (launches, plain) != (1, 0) or \
            routes != {_bs_route(bsa, _BF16, SBS, D): 1}:
        raise AssertionError(f"sparse_attention launched {launches} "
                             f"({routes}), plain {plain}")
    _, bc, bn = F._cached_block_layout(
        offset.tobytes(), offset.shape, columns.tobytes(), columns.shape, SL,
        str(q.device))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    plain32 = bsa._bs_fwd_ref(qd.float(), kd.float(), vd.float(), bc, bn,
                              SBS, 1.0 / D ** 0.5)
    ferr = _check_close("sparse_attention fwd", out.detach(),
                        plain32.to(_BF16), plain32)
    mask = bsa.csr_element_mask(off_t, col_t, SL)
    with torch.enable_grad():
        qkv = [t.float().requires_grad_() for t in (qd, kd, vd)]
        ref = bsa.dense_mask_sparse_attention(*qkv, mask)
        grads = torch.autograd.grad(ref.sum(), qkv)
    gerr = max(_check_close("sparse_attention grad", t.grad, g.to(_BF16), g,
                            tol=1e-4)
               for t, g in zip((q, k, v), grads))
    del ref, grads, qkv
    hits = F._cached_block_layout.cache_info().hits
    F.sparse_attention(qd, kd, vd, off_t, col_t)
    hit = F._cached_block_layout.cache_info().hits - hits
    kpm = (torch.arange(SL, device="cuda") < SL - 300)[None].float()
    before = bsa.kernel_launches
    dense_out = F.sparse_attention(qd, kd, vd, off_t, col_t,
                                   key_padding_mask=kpm)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qd.float(), kd.float(), vd.float(),
        attn_mask=mask & (kpm[:, None, None, :] != 0))
    derr = float((dense_out.float() - sdpa).abs().max())
    if bsa.kernel_launches != before or derr > 2e-2 or \
            not torch.isfinite(dense_out).all():
        raise AssertionError(f"sparse_attention dense path: err {derr}")
    torch.cuda.synchronize()
    log("sparse_entry", shape=f"[{SB}, {H}, {SL}, {D}] bf16 bs {SBS}",
        blocks_a_row=f"{float(bn.float().mean()):.3f}",
        max_nnz=bc.shape[-1], kernel_launches=launches,
        body=",".join(routes), plain=plain,
        fwd_err=f"{ferr:.3e}", grad_err=f"{gerr:.3e}",
        layout_cache_hit=hit, dense_kpm_err_vs_sdpa=f"{derr:.3e}",
        dense_kernel_launches=bsa.kernel_launches - before)
    del q, k, v, out, mask, dense_out, sdpa
    torch.cuda.empty_cache()
    return launches


def phase_paged_entry(pa):
    """PagedKVCache(1025, 16, 16, 128, bf16) filled by `append` for 16
    sequences of 64-832 tokens, `batch_view`, one `paged_attention` call
    (counted alone: 1 kernel launch, 0 plain), held against the plain
    version and against the gather reference."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    rng = np.random.RandomState(SEED + 33)
    lens = _pa_lens(rng)
    t0 = time.perf_counter()
    cache, table, seq_lens = _pa_fill(gen, _BF16, lens)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    q = _rand(gen, (PA_SEQS, 1, H, D), _BF16)
    pa.reset_counts()
    got = pa.paged_attention(q, cache.k_pages, cache.v_pages, table,
                             seq_lens)
    torch.cuda.synchronize()
    launches, plain = pa.kernel_launches, pa.plain_launches
    if (launches, plain) != (1, 0):
        raise AssertionError(f"paged_attention launched {launches}, plain "
                             f"{plain}")
    args = (q.float(), cache.k_pages.float(), cache.v_pages.float(), table,
            seq_lens, 1.0 / D ** 0.5)
    plain32 = pa._paged_ref(*args)
    err = _check_close("paged entry", got, plain32.to(_BF16), plain32)
    ref_err = float((pa._paged_attention_ref(*args) - plain32).abs().max())
    if ref_err > 1e-5:
        raise AssertionError(f"paged plain vs gather reference {ref_err}")
    log("paged_entry", pool=f"PagedKVCache({PA_PAGES}, {PS}, {H}, {D}, "
        "bf16)", seqs=PA_SEQS, tokens=int(lens.sum()),
        mean_len=f"{lens.mean():.1f}", max_pages=table.shape[1],
        unused_ids=int((table < 0).sum()), fill_s=f"{fill_s:.2f}",
        kernel_launches=launches, plain=plain, max_abs_err=f"{err:.3e}",
        ref_err=f"{ref_err:.3e}")
    return launches


SERVE_KERNELS = {   # name: (source, TPU kernel it replaces, pool layout)
    "ragged_paged_attention": (
        "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "paddle_tpu/ops/ragged_paged_attention.py:229", "bf16"),
    "ragged_paged_attention_int8": (
        "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "paddle_tpu/ops/ragged_paged_attention.py:229", "int8"),
    "ragged_paged_attention_int4": (
        "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "paddle_tpu/ops/ragged_paged_attention.py:229", "int4"),
}
TRAIN_KERNELS = {   # name: (source, TPU kernel it replaces)
    "flash_fwd": ("paddle_tpu_torch/ops/csrc/flash_attention.cu",
                  "paddle_tpu/ops/attention.py:193"),
    "flash_bwd_dq": ("paddle_tpu_torch/ops/csrc/flash_attention.cu",
                     "paddle_tpu/ops/attention.py:262"),
    "flash_bwd_dkv": ("paddle_tpu_torch/ops/csrc/flash_attention.cu",
                      "paddle_tpu/ops/attention.py:322"),
    "layer_norm": ("paddle_tpu_torch/ops/csrc/layer_norm.cu",
                   "paddle_tpu/ops/layer_norm.py:20"),
    # no Pallas kernel: the counterpart of the XLA-fused custom VJP
    # `_ln_bwd` (layer_norm.py:91), the vjp of `_ln_ref`
    "layer_norm_bwd": ("paddle_tpu_torch/ops/csrc/layer_norm.cu",
                       "paddle_tpu/ops/layer_norm.py:91"),
    "xent_fwd": ("paddle_tpu_torch/ops/csrc/softmax_cross_entropy.cu",
                 "paddle_tpu/ops/fused_ops.py:65"),
    "xent_bwd": ("paddle_tpu_torch/ops/csrc/softmax_cross_entropy.cu",
                 "paddle_tpu/ops/fused_ops.py:99"),
}


# the training kernels whose rows come from `phase_norm_timing`, at GPT's
# rows and, as `<name>[h768]`, at BERT's
NORM_KERNELS = ("layer_norm", "layer_norm_bwd")


# ---------------------------------------------------------------- phase 12

# ResNet-50 (bench.py's run_resnet50, the BASELINE imgs/s metric):
# resnet50(num_classes 1000, NHWC) in bf16, training mode,
# Momentum(0.1, 0.9, weight_decay 1e-4), F.cross_entropy, batch 128 x
# 224 x 224 x 3 f32 images and labels from seed 0; 2 warm-up and 8 timed
# steps. MFU: bench.py's count, 3 x 8.2 GFLOP an image (4.09e9 MACs
# forward), over the H100's dense bf16 peak. No kernel of the port lies
# on this path (the JAX package's conv, batch norm and pooling are XLA
# code): convolutions are cuDNN's, the rest eager PyTorch.
RB, RS, RC = 128, 224, 1000
RESNET_FWD_FLOPS = 8.2e9


def _resnet_trainer(model, lr=0.1, weight_decay=1e-4):
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    opt = Momentum(learning_rate=lr, momentum=0.9, weight_decay=weight_decay)
    return Trainer(model, opt,
                   lambda m, b: F.cross_entropy(m(b["image"]), b["label"]),
                   device=next(model.parameters()).device)


def _resnet_batch(B, S, classes, seed=SEED):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(B, S, S, 3).astype("float32"),
            "label": rng.randint(0, classes, (B,)).astype("int64")}


def phase_resnet_training(smi):
    from paddle_tpu_torch.distributed import LossBuffer
    from paddle_tpu_torch.vision.models import resnet50
    t0 = time.perf_counter()
    model = resnet50(num_classes=RC, data_format="NHWC", seed=SEED)
    model.bfloat16().train()
    trainer = _resnet_trainer(model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _resnet_batch(RB, RS, RC).items()}
    start = {k: b.clone() for k, b in model.named_buffers()}
    buf = LossBuffer(drain_every=TRAIN_WARMUP + TRAIN_STEPS)
    for _ in range(TRAIN_WARMUP):
        buf.append(trainer.step(batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        buf.append(trainer.step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = buf.losses
    if len(losses) != TRAIN_WARMUP + TRAIN_STEPS or buf.fetches != 1:
        raise AssertionError(f"losses fetched {buf.fetches} times: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet50 losses not finite: {losses}")
    still = [k for k, b in model.named_buffers()
             if torch.equal(b, start[k])]
    if still or len(start) != 106:
        raise AssertionError(f"BatchNorm buffers that did not move: {still} "
                             f"(of {len(start)})")
    if any(b.dtype != torch.bfloat16 for b in model.buffers()):
        raise AssertionError("a bf16 model's buffers are not bf16")
    step_ms = wall / TRAIN_STEPS * 1e3
    imgs_s = RB / (step_ms / 1e3)
    mfu = 3 * RESNET_FWD_FLOPS * imgs_s / H100_BF16_FLOPS
    log("resnet_train", model="resnet50", layout="NHWC", dtype="bfloat16",
        params_M=f"{n_params / 1e6:.3f}", batch=f"{RB}x{RS}x{RS}x3",
        optimizer="Momentum(0.1, 0.9, wd 1e-4)", gpu=repr(smi),
        setup_s=f"{setup_s:.2f}", steps=TRAIN_STEPS,
        step_ms=f"{step_ms:.2f}", imgs_per_s=f"{imgs_s:.2f}",
        mfu=f"{mfu:.4f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        losses=[round(x, 5) for x in losses],
        bn_buffers_moved=f"{len(start) - len(still)}/{len(start)}")
    return trainer, batch


# profile families of a ResNet step: a CPU op's own device kernels go to
# the family of its nearest enclosing match (named ranges of the port's
# functionals, the optimizer's range, autograd's backward nodes)
_RESNET_FAMILIES = (
    ("optimizer", ("resnet_optimizer",)),
    ("batch_norm", ("batch_norm", "_BatchStatsNorm")),
    ("pooling", ("pooling", "MaxPool2DWithIndicesBackward")),
    ("residual_add_relu", ("residual_add_relu", "ReluBackward",
                           "ThresholdBackward")),
    ("conv", ("convolution", "Convolution")))


def _resnet_family(ev):
    e = ev
    while e is not None:
        for fam, keys in _RESNET_FAMILIES:
            if any(k in e.name for k in keys):
                return fam
        e = e.cpu_parent
    return "other"


def phase_resnet_profile(trainer, batch):
    """Where one ResNet-50 step's device time goes, by family: cuDNN
    convolutions (forward and both backward products), batch norm (its
    eager chain with the JAX rounding points, forward and backward, the
    affine's backward aside), pooling, the residual add + ReLU (forward,
    and ReLU's backward), the Momentum update, and the other elementwise
    ops (casts, the affine's and the add's backward, the loss); the busy
    share (device time over the step's wall time); the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads = trainer._loss_and_grads(batch)
        with torch.profiler.record_function("resnet_optimizer"):
            trainer._update(grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = dict.fromkeys([f for f, _ in _RESNET_FAMILIES] + ["other"], 0.0)
    launches = dict.fromkeys(fam, 0)
    total, kernels = 0.0, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        for kern in getattr(ev, "kernels", []):
            f = _resnet_family(ev)
            fam[f] += kern.duration
            launches[f] += 1
            total += kern.duration
            kernels[kern.name] = kernels.get(kern.name, 0.0) + kern.duration
    if total <= 0:
        raise AssertionError("the profiler saw no device kernels in a "
                             "resnet50 step")
    log("resnet_profile", wall_ms=f"{wall * 1e3:.2f}",
        device_ms=f"{total / 1e3:.2f}",
        device_busy_share=f"{total / 1e6 / wall:.3f}",
        **{f"{k}_ms": f"{v / 1e3:.2f}" for k, v in fam.items()},
        **{f"{k}_launches": v for k, v in launches.items()})
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log("resnet_profile_top", kernel=repr(name[:90]),
            ms=f"{us / 1e3:.3f}")


# ResNet-18, f32, TF32 off (the port's get_device sets it), card against
# the port's CPU run on the same weights (seed 0), NHWC:
#  * eval mode at 2 x 32 x 32: logits and every gradient within
#    RESNET_EVAL_TOL of (1 + magnitude): the same f32 math, cuDNN's and
#    the CPU's sums in other orders (the CPU tests hold the CPU run within
#    1e-5 of the JAX package);
#  * 2 steps of Trainer + Momentum(0.01, 0.9, wd 1e-4) in training mode at
#    4 x 64 x 64: losses within 1e-4, buffers and parameters within
#    RESNET_TRAIN_TOL (1e-3, a tenth of lr: batch statistics over few
#    values make the f32 gradients ill-conditioned, a few % apart between
#    two f32 evaluations on some parameters; tests/test_torch_resnet.py);
#  * max pooling on tie windows (a post-ReLU map) and the bf16 running
#    statistics' update on exact statistics: bit-equal to the CPU.
RESNET_EVAL_TOL, RESNET_TRAIN_TOL = 1e-4, 1e-3


def _close_rel(got, want, tol):
    err = float((got.double() - want.double()).abs().max())
    return err, err <= tol * (1 + float(want.double().abs().max()))


def phase_resnet_small_reference():
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet18
    state = resnet18(num_classes=10, data_format="NHWC", device="cpu",
                     seed=SEED).state_dict()
    eval_b = _resnet_batch(2, 32, 10, seed=SEED + 1)
    train_b = _resnet_batch(4, 64, 10, seed=SEED + 2)
    runs = {}
    for device in ("cuda", "cpu"):
        m = resnet18(num_classes=10, data_format="NHWC", device=device)
        m.load_state_dict(state)
        m.eval()
        x = torch.from_numpy(eval_b["image"]).to(device)
        logits = m(x)
        F.cross_entropy(logits, torch.from_numpy(eval_b["label"])
                        .to(device)).backward()
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
        m.train()
        tr = _resnet_trainer(m, lr=0.01)
        b = {k: torch.from_numpy(v).to(device) for k, v in train_b.items()}
        losses = [float(tr.step(b)) for _ in range(2)]
        runs[device] = (logits.detach().cpu(), grads, losses,
                        {k: v.detach().cpu() for k, v in
                         m.state_dict().items()})
    (lc, gc, tc, sc), (lh, gh, th, sh) = runs["cuda"], runs["cpu"]
    checks = [("logits", *_close_rel(lc, lh, RESNET_EVAL_TOL))]
    checks += [(f"grad {k}", *_close_rel(gc[k], gh[k], RESNET_EVAL_TOL))
               for k in gh]
    checks += [(f"state {k}", *_close_rel(sc[k], sh[k], RESNET_TRAIN_TOL))
               for k in sh]
    loss_err = max(abs(a - b) for a, b in zip(tc, th))
    checks.append(("train losses", loss_err, loss_err <= 1e-4))
    # tie windows: zeros and a few values, as after a ReLU
    rng = np.random.RandomState(SEED + 3)
    ties = np.maximum(rng.randint(-3, 2, (2, 56, 56, 64)), 0).astype(
        "float32")
    g = rng.randn(2, 28, 28, 64).astype("float32")
    pool = []
    for device in ("cuda", "cpu"):
        x = torch.from_numpy(ties).to(device).requires_grad_()
        out = F.max_pool2d(x, 3, 2, 1, data_format="NHWC")
        out.backward(torch.from_numpy(g).to(device))
        pool.append((out.detach().cpu(), x.grad.cpu()))
    pool_equal = all(torch.equal(a, b) for a, b in zip(*pool))
    # bf16 running statistics from exact batch statistics (multiples of
    # 1/16 over 32 values a channel): the update's bits alone
    xb = torch.from_numpy(rng.randint(-8, 9, (2, 4, 4, 4096)) / 16.0)
    rm0 = torch.from_numpy(rng.randn(4096)).bfloat16()
    bufs = []
    for device in ("cuda", "cpu"):
        rm = rm0.to(device)
        rv = torch.ones(4096, dtype=torch.bfloat16).to(device)
        F.batch_norm(xb.bfloat16().to(device), rm, rv, training=True,
                     data_format="NHWC")
        bufs.append((rm.cpu(), rv.cpu()))
    bn_equal = all(_bits_equal(a, b) for a, b in zip(*bufs))
    worst = max(checks, key=lambda c: c[1])
    bad = [c[0] for c in checks if not c[2]]
    if bad or not pool_equal or not bn_equal:
        raise AssertionError(f"resnet18 card vs CPU: failed {bad[:8]}, "
                             f"max-pool ties equal {pool_equal}, bf16 "
                             f"running stats equal {bn_equal}")
    log("resnet_small_ref", model="resnet18 f32 NHWC",
        eval_batch="2x32x32", train_batch="4x64x64", steps=2,
        losses_card=[round(x, 6) for x in tc],
        train_loss_max_abs_err=f"{loss_err:.3e}",
        worst=repr(worst[0]), worst_abs_err=f"{worst[1]:.3e}",
        eval_tolerance=RESNET_EVAL_TOL, train_tolerance=RESNET_TRAIN_TOL,
        maxpool_ties_bit_equal=pool_equal,
        bf16_running_stats_bit_equal=bn_equal,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)


# ---------------------------------------------------------------- slice 14
# GPT's own path: bench.py's headline variant (gpt_1p3b, remat 'dots',
# batch 6 x 1024) under a warmup + cosine LR schedule, 'dots' against
# 'full', checkpoint and resume, KV-cache generation and beam search, and
# sampled serving.

DOTS_B = 6                                  # bench.py's headline batch
# the schedule, shortened to the smoke's 2 + 8 steps so that both its
# warmup and its decay fall inside the run: LinearWarmup(CosineAnnealing
# Decay(2e-4, T_max 7), 3 warmup steps from 0 to 2e-4)
SCHED_PEAK, SCHED_WARMUP, SCHED_T_MAX = 2e-4, 3, 7
RESUME_STEPS = 6
GEN_B, GEN_PROMPT, GEN_NEW, GEN_BEAMS = 4, 128, 64, 4
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 0}
# The cached forward (f32 attention over the bf16 K/V buffer) against the
# full forward (the bf16 flash kernel) on the same tokens: bf16
# activations rounded at other places move logits of magnitude ~1-10 by
# a few hundredths, as between the serving engines (LOGIT_TOL).
CACHED_LOGIT_TOL = LOGIT_TOL
# Draws the smoke re-draws on the host from the card's logits and keys.
REDRAW_CALLS = 32


def _schedule():
    from paddle_tpu_torch.optimizer import lr
    return lr.LinearWarmup(
        lr.CosineAnnealingDecay(SCHED_PEAK, T_max=SCHED_T_MAX),
        warmup_steps=SCHED_WARMUP, start_lr=0.0, end_lr=SCHED_PEAK)


def _schedule_values(n):
    """The schedule's first n values, from an instance of its own."""
    s, out = _schedule(), []
    for _ in range(n):
        out.append(s())
        s.step()
    return out


def _dots_cfg(**kw):
    from paddle_tpu_torch.models import gpt_1p3b
    return gpt_1p3b(max_seq_len=TL, remat_policy="dots", **kw)


class _LrTap:
    """Stands in for the optimizer module's `adamw_update_multi` while
    installed: passes every call through and keeps the lr each AdamW
    launch was given."""

    def __init__(self):
        from paddle_tpu_torch.optimizer import optimizer as opt_module
        self.mod, self.lrs = opt_module, []
        self.fn = opt_module.adamw_update_multi

    def __call__(self, *args, **kw):
        self.lrs.append(args[4])
        return self.fn(*args, **kw)

    def __enter__(self):
        self.mod.adamw_update_multi = self
        return self

    def __exit__(self, *exc):
        self.mod.adamw_update_multi = self.fn


def _steps(trainer, batches, A, LN, X):
    """TRAIN_WARMUP then TRAIN_STEPS timed training steps over `batches`
    (cycled); the counts are zeroed before the timed steps. Returns
    (losses, step ms, peak GB, kernel launches, plain launches, the lr of
    every AdamW launch)."""
    from paddle_tpu_torch.distributed import LossBuffer
    warmup, steps = TRAIN_WARMUP, TRAIN_STEPS
    buf = LossBuffer(drain_every=warmup + steps)
    with _LrTap() as tap:
        for i in range(warmup):
            buf.append(trainer.step(batches[i % len(batches)]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_train_counts(A, LN, X)
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            buf.append(trainer.step(batches[i % len(batches)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern, plain = _train_counts(A, LN, X)
    if buf.fetches != 1 or not all(np.isfinite(buf.losses)):
        raise AssertionError(f"losses: {buf.losses} ({buf.fetches} fetches)")
    return (buf.losses, wall / steps * 1e3,
            torch.cuda.max_memory_allocated() / 1e9, kern, plain, tap.lrs)


def _device_batches(cfg, B, n):
    return [{k: torch.from_numpy(v).cuda() for k, v in
             _batch(cfg, B, TL, seed=SEED + i).items()} for i in range(n)]


def phase_train_dots(A, LN, X, smi, full_bs8):
    """bench.py's headline variant: gpt_1p3b, bf16, remat 'dots', batch 6
    x 1024, AdamW(LinearWarmup(CosineAnnealingDecay)) with weight decay
    0.1, clip 1.0 and bf16 slots, 2 + 8 steps: the lr of every step's
    AdamW launch equals the schedule's values, and the kernels launch as
    under 'full' (the attention and both LayerNorms are recomputed; only
    the Linear products a backward reads are kept). Then 'dots' at batch
    8 beside the bs 8 'full' run of `phase_training`. 'full' at batch 6
    under the same schedule gives the same 10 losses bit for bit (the
    step time beside it), one 'dots' step is profiled by kernel family,
    and `phase_dots_host` splits its host time."""
    from paddle_tpu_torch.models import gpt_1p3b
    cfg = _dots_cfg()
    batches = _device_batches(cfg, DOTS_B, 1)
    trainer = _trainer(gpt_1p3b(max_seq_len=TL, remat_policy="full"),
                       lr=_schedule())
    full_losses, full_ms, full_peak, _, _, _ = _steps(trainer, batches, A,
                                                      LN, X)
    del trainer
    torch.cuda.empty_cache()
    trainer = _trainer(cfg, lr=_schedule())
    losses, step_ms, peak, kern, plain, lrs = _steps(trainer, batches, A,
                                                     LN, X)
    if losses != full_losses:
        raise AssertionError(f"'dots' losses {losses} != 'full' losses "
                             f"{full_losses} at batch {DOTS_B}")
    want = _schedule_values(TRAIN_WARMUP + TRAIN_STEPS)
    if lrs != want:
        raise AssertionError(f"AdamW lrs {lrs} != the schedule's {want}")
    if trainer.optimizer._lr_scheduler.last_epoch != len(want):
        raise AssertionError("the scheduler did not advance once a step")
    per_step = {k: v / TRAIN_STEPS for k, v in kern.items()}
    expected = {**EXPECTED_PER_STEP,
                "adamw": _adamw_launches_expected(trainer, X)}
    if per_step != expected or any(plain.values()):
        raise AssertionError(f"'dots' launches a step {per_step} (expected "
                             f"{expected}), plain {plain}")
    tok_s = DOTS_B * TL / (step_ms / 1e3)
    log("train_dots", model="gpt_1p3b", layers=cfg.num_layers,
        batch=f"{DOTS_B}x{TL}", remat="dots", dtype="bfloat16",
        schedule=f"LinearWarmup(CosineAnnealingDecay({SCHED_PEAK}, "
                 f"T_max={SCHED_T_MAX}), warmup={SCHED_WARMUP})",
        gpu=repr(smi), steps=TRAIN_STEPS, step_ms=f"{step_ms:.2f}",
        tokens_per_s=f"{tok_s:.1f}",
        mfu=f"{6 * cfg.num_params() * tok_s / H100_BF16_FLOPS:.4f}",
        peak_mem_GB=f"{peak:.2f}", lrs=[float(f"{x:.6g}") for x in lrs],
        lrs_equal_schedule=True, losses=[round(x, 5) for x in losses],
        losses_equal_full=True, full_step_ms=f"{full_ms:.2f}",
        full_peak_mem_GB=f"{full_peak:.2f}")
    log("train_dots_launches", **{f"{k}_per_step": v for k, v in
                                  per_step.items()},
        plain=sum(plain.values()))
    phase_train_profile(trainer, batches[0], label="train_dots_profile")
    phase_dots_host(trainer, batches[0])
    del trainer, batches
    torch.cuda.empty_cache()
    trainer = _trainer(cfg)
    batches = _device_batches(cfg, TB, 1)
    _, ms8, peak8, _, _, _ = _steps(trainer, batches, A, LN, X)
    log("train_dots_bs8", batch=f"{TB}x{TL}", gpu=repr(smi),
        dots_step_ms=f"{ms8:.2f}", dots_peak_mem_GB=f"{peak8:.2f}",
        full_step_ms=full_bs8["step_ms"],
        full_peak_mem_GB=full_bs8["peak_mem_GB"],
        dots_tokens_per_s=f"{TB * TL / (ms8 / 1e3):.1f}")
    del trainer, batches
    torch.cuda.empty_cache()


DOTS_HOST_STEPS = 4                         # timed steps a variant a round


def _profiled_step(trainer, batch):
    """One profiled training step: (wall ms, device ms, recorded CPU ops,
    their summed self CPU ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cpu_ops = cpu_us = dev_us = 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            dev_us += ev.self_cuda_time_total if us is None else us
        else:
            cpu_ops += ev.count
            cpu_us += ev.self_cpu_time_total
    return wall, dev_us / 1e3, cpu_ops, cpu_us / 1e3


def phase_dots_host(trainer, batch):
    """Where 'dots' spends its extra host time, on one trainer whose remat
    is switched between steps: 'full'; 'sac_all' (the selective
    checkpoint's dispatch mode with a policy that saves nothing: the
    compute of 'full' plus the mode's own cost); 'dots'; and 'dots_fc2'
    (fc2's product cached too, the policy before fc2 was left out). Two
    rounds in mirrored order, DOTS_HOST_STEPS steps each after one
    untimed step: wall ms a step and peak memory. Then one profiled step
    of each: device ms, busy share, and the CPU side of the profile — the
    recorded ops and their summed self CPU time (a `__torch_dispatch__`
    mode runs inside each op's record, so the mode's Python cost lands
    there)."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    from paddle_tpu_torch.models import gpt as gpt_mod
    cfg, real = trainer.model.cfg, gpt_mod._dots_context

    def save_all_dots(ctx, op, *args, **kwargs):
        if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    variants = {
        "full": ("full", real),
        "sac_all": ("dots", functools.partial(
            create_selective_checkpoint_contexts,
            lambda ctx, op, *a, **k: CheckpointPolicy.PREFER_RECOMPUTE)),
        "dots": ("dots", real),
        "dots_fc2": ("dots", functools.partial(
            create_selective_checkpoint_contexts, save_all_dots))}

    def use(name):
        cfg.remat_policy, gpt_mod._dots_context = variants[name]

    times = {k: [] for k in variants}
    peak = {}
    try:
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                use(name)
                trainer.step(batch)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(DOTS_HOST_STEPS):
                    trainer.step(batch)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3
                                   / DOTS_HOST_STEPS)
                peak[name] = torch.cuda.max_memory_allocated() / 1e9
        for name in variants:
            use(name)
            wall, dev_ms, cpu_ops, cpu_ms = _profiled_step(trainer, batch)
            log("train_dots_host", variant=name,
                step_ms=[f"{t:.2f}" for t in times[name]],
                peak_mem_GB=f"{peak[name]:.2f}",
                profiled_wall_ms=f"{wall:.2f}", device_ms=f"{dev_ms:.2f}",
                device_busy_share=f"{dev_ms / wall:.3f}", cpu_ops=cpu_ops,
                cpu_self_ms=f"{cpu_ms:.2f}")
    finally:
        cfg.remat_policy, gpt_mod._dots_context = "dots", real


def phase_dots_equal():
    """At gpt_1p3b width and 2 layers, bf16, batch 6 x 1024: one step's
    loss and every gradient under 'dots' bit-equal to 'full' (the same
    weights, batch and deterministic kernels; 'dots' hands the backward
    the forward's own products where 'full' recomputes them)."""
    from paddle_tpu_torch.models import gpt_1p3b
    batch = _device_batches(gpt_1p3b(), DOTS_B, 1)[0]
    runs = {}
    for policy in ("full", "dots"):
        cfg = gpt_1p3b(max_seq_len=TL, num_layers=2, remat_policy=policy)
        tr = _trainer(cfg)
        loss, grads = tr._loss_and_grads(batch)
        names = [n for n, p in tr.model.named_parameters()]
        runs[policy] = (loss, dict(zip(names, grads)))
        del tr
    (lf, gf), (ld, gd) = runs["full"], runs["dots"]
    bad = [n for n in gf if not torch.equal(gf[n], gd[n])]
    if not torch.equal(lf, ld) or bad:
        raise AssertionError(f"'dots' vs 'full': loss {float(ld)} vs "
                             f"{float(lf)}, gradients differing: {bad}")
    log("dots_equal", model="gpt_1p3b width, 2 layers", batch=f"{DOTS_B}x"
        f"{TL}", dtype="bfloat16", loss=f"{float(lf):.6f}",
        gradients=len(gf), bit_equal=True)
    del runs
    torch.cuda.empty_cache()


def _host_tree(tree):
    """A state tree with every tensor leaf as a numpy array (bf16 widened
    to f32 on the host, exactly): what a user saves."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().float().numpy()
    return tree


def phase_resume():
    """gpt_1p3b bf16 (remat 'dots', batch 6 x 1024) under the schedule.
    Run A takes 6 steps. Run B takes 3, saves `Trainer.state()` and the
    optimizer's `state_dict()` to host numpy; a fresh model, optimizer and
    trainer load them and take 3 more. Losses, parameters, slots and the
    scheduler's position after step 6 are bit-equal between A and B."""
    cfg = _dots_cfg()
    batches = _device_batches(cfg, DOTS_B, RESUME_STEPS)
    a = _trainer(cfg, lr=_schedule())
    la = [float(a.step(b)) for b in batches]
    b1 = _trainer(cfg, lr=_schedule())
    lb = [float(b1.step(b)) for b in batches[:3]]
    t0 = time.perf_counter()
    state = _host_tree(b1.state())
    opt_sd = _host_tree(b1.optimizer.state_dict())
    save_s = time.perf_counter() - t0
    del b1
    torch.cuda.empty_cache()
    b2 = _trainer(cfg, lr=_schedule())
    t0 = time.perf_counter()
    b2.optimizer.set_state_dict(opt_sd)
    b2.load_state(state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del state, opt_sd
    lb += [float(b2.step(b)) for b in batches[3:]]
    params = [n for n, (p, q) in enumerate(zip(a.params, b2.params))
              if not torch.equal(p, q)]
    slots = [(n, k) for n, (p, q) in enumerate(zip(a.params, b2.params))
             for k in a.optimizer._state[p]
             if not torch.equal(a.optimizer._state[p][k],
                                b2.optimizer._state[q][k])]
    sched = (a.optimizer._lr_scheduler.last_epoch,
             b2.optimizer._lr_scheduler.last_epoch)
    if la != lb or params or slots or sched != (6, 6):
        raise AssertionError(f"resume: losses {lb} vs {la}, parameters "
                             f"differing {params}, slots {slots}, "
                             f"scheduler {sched}")
    log("resume", model="gpt_1p3b", batch=f"{DOTS_B}x{TL}", remat="dots",
        steps=f"3 + save/load + 3 vs {RESUME_STEPS}",
        losses=[round(x, 5) for x in la], bit_equal=True,
        parameters=len(a.params), save_to_host_s=f"{save_s:.2f}",
        load_s=f"{load_s:.2f}", last_epoch=sched[0])
    del a, b2, batches
    torch.cuda.empty_cache()


class _DrawTap:
    """Stands in for a module's sampling function (`generation._sample`
    or `decoder._sample_tokens`) while installed: passes every call
    through and keeps host copies of the logits, the key(s) and the
    token(s) drawn on the card (of the first `limit` calls; None: all)."""

    def __init__(self, module, name, limit=None):
        self.mod, self.name, self.limit = module, name, limit
        self.fn, self.calls = getattr(module, name), []

    def __call__(self, logits, *args):
        out = self.fn(logits, *args)
        if self.limit is None or len(self.calls) < self.limit:
            key = args[0] if self.name == "_sample" else args[1]
            self.calls.append((logits.float().cpu(), key.cpu(), out.cpu()))
        return out

    def __enter__(self):
        setattr(self.mod, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)

    def redraw_mismatches(self, sampling, calls=None):
        """Draws (of the first `calls` recorded calls) whose host re-draw
        (`mask_logits` + `random.categorical` on the CPU, from the card's
        logits and keys) differs from the card's."""
        from paddle_tpu_torch import random as prng
        from paddle_tpu_torch.models.generation import mask_logits
        t, k, p = sampling
        bad = 0
        for logits, key, out in self.calls[:calls]:
            host = prng.categorical(key, mask_logits(logits, t, k, p))
            bad += int((host.to(out.dtype) != out).sum())
        return bad

    def logits_of(self, key, token):
        """The logits row a recorded draw under `key` (a host key [2])
        drew `token` from (the first such row), or None."""
        for logits, keys, out in self.calls:
            hit = ((keys == key).all(-1) & (out == token)).nonzero()
            if len(hit):
                return logits[int(hit[0, 0])]
        return None


def _sampled_launches(fn):
    """Device kernels one call of `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if getattr(ev, "device_type", None)
               == torch.autograd.DeviceType.CUDA)


def phase_generate(sd, smi):
    """KV-cache generation on gpt_1p3b bf16 (the serving run's weights):
    4 prompts of 128 tokens, 64 new tokens, greedy, then sampled
    (temperature 0.8, top_k 50, top_p 0.95, seed 0), then beam search
    with 4 beams. The cached forward's logits match the full forward's on
    the same tokens within CACHED_LOGIT_TOL; every sampled token of a
    recorded run equals the host's draw (`random` + `mask_logits` on the
    CPU) from the card's logits and keys, and that run's tokens equal the
    timed run's."""
    from paddle_tpu_torch.models import GPT, generation, gpt_1p3b
    from paddle_tpu_torch import random as prng
    cfg = gpt_1p3b()
    model = GPT(cfg, seed=SEED)
    model.load_state_dict(sd)
    model.bfloat16().eval()
    rng = np.random.RandomState(SEED + 14)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (GEN_B, GEN_PROMPT))).cuda()
    runs = {}
    for name, kw in (("greedy", {"temperature": 0.0}),
                     ("sampled", SAMPLING),
                     ("beam", {"num_beams": GEN_BEAMS,
                               "temperature": 0.0})):
        generation.generate(model, ids[:, :16], max_new_tokens=4, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generation.generate(model, ids, max_new_tokens=GEN_NEW, **kw)
        torch.cuda.synchronize()
        runs[name] = (out, time.perf_counter() - t0)
        if out.shape != (GEN_B, GEN_PROMPT + GEN_NEW) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"{name}: ids {tuple(out.shape)} out of "
                                 "range")
    greedy = runs["greedy"][0]
    # cached against full forward on the greedy tokens
    with torch.no_grad():
        full = model(greedy[:, :-1])
        cache = model.init_cache(GEN_B, GEN_PROMPT + GEN_NEW)
        pre, cache = model(greedy[:, :GEN_PROMPT], cache=cache, pos=0)
        gap = float((pre - full[:, :GEN_PROMPT]).abs().max())
        for t in range(GEN_PROMPT, min(GEN_PROMPT + 8, full.shape[1])):
            step, cache = model(greedy[:, t:t + 1], cache=cache, pos=t)
            gap = max(gap, float((step[:, 0] - full[:, t]).abs().max()))
    if not torch.isfinite(full).all() or gap > CACHED_LOGIT_TOL:
        raise AssertionError(f"cached vs full logits differ by {gap:.4f} "
                             f"(tolerance {CACHED_LOGIT_TOL})")
    # the sampled run, recorded: host re-draws from the card's logits
    prng.reset_counts()
    with _DrawTap(generation, "_sample") as tap:
        again = generation.generate(model, ids, max_new_tokens=GEN_NEW,
                                    **SAMPLING)
    sampling = (SAMPLING["temperature"], SAMPLING["top_k"],
                SAMPLING["top_p"])
    draws = dict(prng.draws)
    bad = tap.redraw_mismatches(sampling)
    if bad or not torch.equal(again, runs["sampled"][0]):
        raise AssertionError(f"sampled draws: {bad} differ from the host's "
                             "draw, or the recorded run differs from the "
                             "timed one")
    # the eager cost of one sampled decode step: device kernels of the
    # forward and of the draw (mask + threefry)
    tok = greedy[:, GEN_PROMPT:GEN_PROMPT + 1]
    key = prng.PRNGKey(0, device=tok.device)
    with torch.no_grad():
        logits, _ = model(tok, cache=cache, pos=GEN_PROMPT + 8)
        fwd_k = _sampled_launches(
            lambda: model(tok, cache=cache, pos=GEN_PROMPT + 8))
    draw_k = _sampled_launches(lambda: generation._sample(
        logits[:, -1], key, *sampling))
    greedy_k = _sampled_launches(lambda: generation._sample(
        logits[:, -1], key, 0.0, 0, 1.0))
    beam_ids = runs["beam"][0]
    log("generate", model="gpt_1p3b", dtype="bfloat16", gpu=repr(smi),
        prompts=f"{GEN_B}x{GEN_PROMPT}", new_tokens=GEN_NEW,
        **{f"{n}_tok_per_s": f"{GEN_B * GEN_NEW / w:.1f}"
           for n, (_, w) in runs.items()},
        **{f"{n}_s": f"{w:.3f}" for n, (_, w) in runs.items()},
        cached_vs_full_max_logit_gap=f"{gap:.5f}",
        tolerance=CACHED_LOGIT_TOL, sampled_draws_checked=len(tap.calls),
        sampled_draws_off_host=bad, prng_calls=draws,
        forward_launches_per_step=fwd_k, sample_launches_per_step=draw_k,
        greedy_pick_launches_per_step=greedy_k,
        beam_equals_greedy=bool(torch.equal(beam_ids, greedy)),
        sampled_equals_greedy=bool(torch.equal(runs["sampled"][0], greedy)))
    del model, cache, runs
    torch.cuda.empty_cache()


def _partings(dec, prompts, tap_want, want, tap_got, got):
    """For each stream of `got` that parts from `want` (request i =
    request id i): the first differing position, the two runs' logits
    there (found in their recorded draws by the (seed, id, position) key
    and the token each drew), their largest difference, each token's
    margin x_a - x_b (x = logits / temperature + Gumbel noise, in logit
    units) under each run's logits, and whether each run's mask kept
    both tokens."""
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.models.generation import mask_logits
    t, k, p = dec.sampling
    base = prng.PRNGKey(dec.seed, device="cpu")
    out = {}
    for i, (w, g) in enumerate(zip(want, got)):
        if w == g:
            continue
        j = next(n for n, (x, y) in enumerate(zip(w, g)) if x != y)
        pos = len(prompts[i]) - 1 + j
        key = prng.fold_in(prng.fold_in(base, i), pos)
        la, lb = tap_want.logits_of(key, w[j]), tap_got.logits_of(key, g[j])
        row = dict(first_divergence=j, tokens=(w[j], g[j]))
        if la is None or lb is None:
            out[i] = dict(row, logit_diff=None)
            continue
        noise = prng.gumbel(key, (la.shape[-1],))
        margins, kept = [], []
        for lg in (la, lb):
            x = lg / t + noise
            margins.append(round(float(x[w[j]] - x[g[j]]) * t, 5))
            m = mask_logits(lg[None], t, k, p)[0] > -1e29
            kept.append((bool(m[w[j]]), bool(m[g[j]])))
        out[i] = dict(row, logit_diff=round(float((la - lb).abs().max()), 5),
                      margin_a_minus_b=margins, kept=kept)
    return out


def phase_serve_sampled(sd, prompts, greedy_fields, rpa):
    """The serving run's configuration (gpt_1p3b bf16 pool, 32 requests of
    64-768 prompt tokens, 64 new tokens, k_max 8) at temperature 0.8,
    top_k 50, top_p 0.95, seed 0: tok/s, TTFT and per-token latency
    beside the greedy run. Then recorded runs (every draw's logits, keys
    and token kept on the host): the same traffic again (equal to the
    timed run), whose first REDRAW_CALLS draws must equal the host's
    draw from the card's logits and keys; the per-tick oracle engine on
    the first 4 requests; and the 32 requests submitted in reversed order
    with the same request ids. A stream that parts must part on a near
    tie: the two runs' logits at that position within LOGIT_TOL (the
    bf16 noise of another row count in cuBLAS); the other streams must
    be equal."""
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder)
    from paddle_tpu_torch.serving import decoder as dec_module
    from paddle_tpu_torch.models import gpt_1p3b
    cfg = gpt_1p3b()
    dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                          max_batch=16, **SAMPLING)
    prng.reset_counts()
    eng, streams, wall, counts = _serve_run(dec, prompts, (rpa,))
    draws = dict(prng.draws)
    phase_profile(dec, prompts, mode="sampled")
    if counts["ragged_paged_attention"][0] <= 0 or \
            counts["ragged_paged_attention"][1]:
        raise AssertionError(f"attention launches: {counts}")
    log("serve_sampled", model="gpt_1p3b", requests=N_REQ, max_new=MAX_NEW,
        k_max=K_MAX, **SAMPLING, **_serve_fields(eng, wall),
        prng_calls=draws,
        **{f"greedy_{k}": v for k, v in greedy_fields.items()})
    rids = list(range(len(prompts)))

    class Replay(ContinuousBatchingEngine):
        """Gives the k-th submitted request the id `ids[k]`: requests
        replayed in another order keep their ids, and so their draws."""

        def __init__(self, *args, ids, **kw):
            super().__init__(*args, **kw)
            self._ids = iter(ids)

        def submit(self, prompt_ids):
            self._next_id = next(self._ids)
            return super().submit(prompt_ids)

    def recorded(order, k_max):
        with _DrawTap(dec_module, "_sample_tokens") as tap:
            e = Replay(dec, ids=order, max_new_tokens=MAX_NEW, k_max=k_max)
            for r in order:
                e.submit(prompts[r])
            res = e.run()
        return [res[r] for r in sorted(order)], tap

    fwd, tap_fwd = recorded(rids, K_MAX)
    bad = tap_fwd.redraw_mismatches(dec.sampling, REDRAW_CALLS)
    per_tick, tap_pt = recorded(rids[:N_ORACLE], 1)
    rev, tap_rev = recorded(rids[::-1], K_MAX)
    parted = {"oracle": _partings(dec, prompts, tap_fwd, fwd[:N_ORACLE],
                                  tap_pt, per_tick),
              "reversed": _partings(dec, prompts, tap_fwd, fwd, tap_rev,
                                    rev)}
    wide = []
    for label, p in parted.items():
        for i, row in sorted(p.items()):
            log("serve_sampled_parting", run=label, request=i, **row,
                tolerance=LOGIT_TOL)
            if row["logit_diff"] is None or row["logit_diff"] > LOGIT_TOL:
                wide.append((label, i))
    log("serve_sampled_checks",
        recorded_streams_equal=f"{sum(a == b for a, b in zip(fwd, streams))}"
                               f"/{N_REQ}",
        oracle_streams_agree=f"{N_ORACLE - len(parted['oracle'])}/"
                             f"{N_ORACLE}",
        reversed_streams_equal=f"{N_REQ - len(parted['reversed'])}/{N_REQ}",
        draws_checked=sum(len(c[2]) for c in tap_fwd.calls[:REDRAW_CALLS]),
        draws_off_host=bad, partings_beyond_tolerance=wide)
    if bad or wide or fwd != streams:
        raise AssertionError(f"sampled serving: {bad} draws off the host's, "
                             f"partings beyond LOGIT_TOL {wide}, or the "
                             "recorded run differs from the timed one")
    del dec, eng, tap_fwd, tap_pt, tap_rev
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4c
# The prefix cache, the host KV tier and cache persistence on gpt_1p3b
# serving, in the serving configuration (bf16 pool of 1025 pages,
# max_batch 16, page_size 16, greedy, k_max 8): 4 groups of 8 requests,
# each group sharing a 512-token system prompt (32 pages) followed by a
# unique 32-256-token suffix. Every cached admission prefills its suffix
# from start > 0 through the ragged paged attention kernel, over mounted,
# copied (copy-on-write) or restored pages.

GROUPS, GROUP_SIZE, SYS_LEN = 4, 8, 512
TIER_NEW = 16           # new tokens a request of the tier and persistence waves
TIER_BYTES = 2 << 30    # the host tier's capacity
TAP_LAYER = 12          # the layer whose attention call the suffix check keeps
PERSIST_DIR = "_archive/prefix_persist"    # under the checkout, gitignored


def _group_traffic(vocab, seed, size=GROUP_SIZE):
    """GROUPS x `size` prompts, group-major: a SYS_LEN-token system prompt
    a group, then a unique suffix of 32-256 tokens a request."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(GROUPS):
        system = rng.randint(0, vocab, SYS_LEN).tolist()
        out += [system + rng.randint(0, vocab, rng.randint(32, 257)).tolist()
                for _ in range(size)]
    return out


def _serve_groups(eng, prompts, rpa):
    """Serve group-major `prompts` as arriving traffic: each group's
    first request is submitted first, the others at the first host sync
    after every leader has its first token (its blocks then published).
    The ragged kernel's counts are set to 0 just before the run and read
    just after; it must launch, and its plain version never. Returns
    (streams, wall seconds, [kernel, plain, device launches])."""
    lead = list(range(0, len(prompts), max(len(prompts) // GROUPS, 1)))
    rest = [i for i in range(len(prompts)) if i not in lead]
    rids = {i: eng.submit(prompts[i]) for i in lead}

    def arrive(e):
        if rest and all(e._outputs.get(rids[i]) for i in lead):
            for i in rest:
                rids[i] = e.submit(prompts[i])
            rest.clear()
    torch.cuda.synchronize()
    rpa.reset_counts()
    t0 = time.perf_counter()
    out = eng.run(on_sync=arrive)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [rpa.kernel_launches, rpa.plain_launches, rpa.device_launches]
    if launches[0] <= 0 or launches[1]:
        raise AssertionError(f"cached serving: attention launches "
                             f"{launches[:2]} (kernel, plain)")
    return [out[rids[i]] for i in range(len(prompts))], wall, launches


_COUNTERS = ("prefill_chunk_tokens", "prefix_hits", "prefix_misses",
             "prefix_cow", "prefix_evictions", "tier_spills", "tier_restores",
             "tier_recomputes")


def _mark(eng):
    """The engine's counters and TTFT count now: `_cache_fields` reports
    one run as the difference."""
    return ({k: getattr(eng.stats, k) for k in _COUNTERS},
            len(eng.stats.ttft_s))


def _cache_fields(eng, mark, wall, n_new, n_req):
    """One run's tok/s, TTFT p50/p99, hit rate, prompt tokens computed and
    cache (and tier) counters, from the engine's stats since `mark`."""
    st = eng.stats
    d = {k: getattr(st, k) - mark[0][k] for k in _COUNTERS}
    ttft = np.asarray(list(st.ttft_s)[mark[1]:]) * 1e3
    looked = d["prefix_hits"] + d["prefix_misses"]
    out = dict(wall_s=f"{wall:.3f}",
               gen_tok_per_s=f"{n_req * n_new / wall:.1f}",
               ttft_p50_ms=f"{np.percentile(ttft, 50):.1f}",
               ttft_p99_ms=f"{np.percentile(ttft, 99):.1f}",
               prefix_hit_rate=f"{d['prefix_hits'] / max(looked, 1):.4f}",
               prompt_tokens_computed=d["prefill_chunk_tokens"],
               **{k: d[k] for k in _COUNTERS[1:5]})
    if eng.tier is not None:
        out.update({k: d[k] for k in _COUNTERS[5:]},
                   host_tier_MB=f"{st.host_tier_bytes / 1e6:.1f}")
    return out


def _oracle_rule(dec, prompts, streams, ref, also=(), aids=None):
    """The oracle rule for the streams of a cached run: a stream equal to
    its twin's (`ref`: the same traffic without the cache, or with a
    capacity-0 tier) passes; each stream that parts, and each of `also`,
    is teacher-forced through the per-tick decoder (on its adapter,
    `aids`), and its every token must score within LOGIT_TOL of the tick's
    best logit. Overwrites the pool's first pages: run it after the
    decoder's engines are done. Returns (streams equal, streams forced,
    the largest gap)."""
    check = sorted({i for i, (a, b) in enumerate(zip(streams, ref))
                    if a != b} | set(also))
    gap = 0.0
    for lo in range(0, len(check), 8):
        idx = check[lo:lo + 8]
        g, _ = _teacher_force(dec, [prompts[i] for i in idx],
                              [streams[i] for i in idx],
                              aids=None if aids is None
                              else [aids[i] for i in idx])
        gap = max(gap, g)
    if gap > LOGIT_TOL:
        raise AssertionError(f"a cached stream's token scores {gap:.4f} "
                             f"below the per-tick best logit (tolerance "
                             f"{LOGIT_TOL})")
    return sum(a == b for a, b in zip(streams, ref)), len(check), gap


class _SuffixTap:
    """Stands in for the decoder module's `rpa` during a cached run:
    passes every call to the kernel's wrappers and keeps, at layer
    TAP_LAYER, the first packed call made while request `rid` holds a slot
    and has not had its first token processed (its prefix mounted, copied
    or restored, its suffix at start > 0): copies of the call's q, that
    layer's K/V pools, the table, rows, positions and the kernel's output,
    with the slot's pages, the shared ones and the restored ones."""

    def __init__(self, rpa, dec, eng, rid):
        self.rpa, self.eng, self.rid, self.got = rpa, eng, rid, None
        leaf = dec.k_pages[0] if isinstance(dec.k_pages, tuple) \
            else dec.k_pages
        self.layer = leaf[TAP_LAYER].data_ptr()

    def ragged_paged_attention(self, *args):
        return self.rpa.ragged_paged_attention(*args)

    def ragged_paged_attention_packed(self, q, kp, vp, table, rows, pos):
        out = self.rpa.ragged_paged_attention_packed(q, kp, vp, table, rows,
                                                     pos)
        leaf = kp[0] if isinstance(kp, tuple) else kp
        eng = self.eng
        if self.got is None and leaf.data_ptr() == self.layer and \
                self.rid in eng._cache_meta:
            def copy(x):
                return tuple(t.clone() for t in x) if isinstance(x, tuple) \
                    else x.clone()
            slot = eng._slot_req.index(self.rid)
            twins = ({e["page"] for e in eng.tier.ledger().values()}
                     if eng.tier is not None else set())
            pages = list(eng._slot_pages[slot])
            start, _, n_hit = eng._cache_meta[self.rid]
            self.got = dict(
                q=q.clone(), kp=copy(kp), vp=copy(vp), table=table.clone(),
                rows=rows.clone(), pos=pos.clone(), out=out.clone(),
                slot=slot, start=start, n_hit=n_hit, pages=pages,
                shared=sorted(eng._slot_shared[slot]),
                restored=[p for p in pages if p in twins])
        return out


def _tapped(rpa, dec, eng, rid, fn):
    """Run `fn()` with a `_SuffixTap` for request `rid` in place of the
    decoder module's `rpa`; returns (fn's result, the kept call)."""
    from paddle_tpu_torch.serving import decoder as dec_module
    tap = _SuffixTap(rpa, dec, eng, rid)
    dec_module.rpa = tap
    try:
        res = fn()
    finally:
        dec_module.rpa = rpa
    if tap.got is None:
        raise AssertionError(f"request {rid}: no cached attention call kept")
    return res, tap.got


def _suffix_check(rpa, got, kind, layout, **fields):
    """One cached admission's suffix attention, as the main path ran it:
    the kept call's kernel output against the plain version on the same
    inputs — the real table, whose row holds the mounted, copied or
    restored pages — at the kernel checks' tolerances (`_check_close`).
    The request's rows must sit at start > 0. Returns the max abs error."""
    rows, pos, slot = got["rows"].long(), got["pos"], got["slot"]
    mine = int(((rows == slot) & (pos >= got["start"])).sum())
    width = got["table"].shape[1]
    held = got["table"][slot, :min(len(got["pages"]), width)].tolist()
    if got["start"] <= 0 or got["n_hit"] <= 0 or mine == 0 or \
            held != got["pages"][:len(held)]:
        raise AssertionError(f"{kind}: the kept call is not a cached "
                             f"admission's (start {got['start']}, hit "
                             f"{got['n_hit']}, rows {mine})")
    q = got["q"][:, None]
    args = (got["table"][rows], pos, 1.0 / q.shape[-1] ** 0.5)
    kp32, vp32 = got["kp"], got["vp"]
    if not isinstance(kp32, tuple):
        kp32, vp32 = kp32.float(), vp32.float()
    plain = _ref(rpa, q, got["kp"], got["vp"], *args)[:, 0]
    plain32 = _ref(rpa, q.float(), kp32, vp32, *args)[:, 0]
    err = _check_close(f"cached suffix ({kind})", got["out"], plain, plain32)
    copied = [p for p in got["pages"][:got["n_hit"]]
              if p not in got["shared"] and p not in got["restored"]]
    log("prefix_suffix_check", kind=kind, pool=layout, layer=TAP_LAYER,
        start=got["start"], hit_blocks=got["n_hit"],
        stream_tokens=len(rows), request_rows=mine,
        pages_shared=len(got["shared"]), pages_restored=len(got["restored"]),
        pages_copied=len(copied), **fields, max_abs_err=f"{err:.3e}",
        tolerance="f32 1e-5, bf16 one ulp of the f32 plain + 1e-5")
    return err


def _copy_spy(dec):
    """Wraps `dec.copy_page`: after each copy, every pool leaf (page bytes
    and scale planes) at the copy must be bit-equal to its source's.
    Returns the list of (src, dst, bit-equal) it fills."""
    copies = []
    orig = dec.copy_page

    def spy(src, dst):
        orig(src, dst)
        copies.append((src, dst, all(_bits_equal(leaf[:, dst], leaf[:, src])
                                     for _, _, leaf in dec._leaves())))
    dec.copy_page = spy
    return copies


def _full_hit(eng, dec, rpa, prompt, layout):
    """One full-prompt hit on a warm engine: every block of `prompt` is
    cached, so its last token is re-consumed into a copy of the final
    page (copy-on-write). The copy must be bit-equal to its source, every
    pool leaf; the re-consumed token's attention runs at start L - 1 over
    the mounted pages and the copy. Returns the kernel launches."""
    copies = _copy_spy(dec)
    rid = eng._next_id
    (streams, _, launches), got = _tapped(
        rpa, dec, eng, rid, lambda: _serve_groups(eng, [prompt], rpa))
    del dec.copy_page
    if len(copies) != 1 or not copies[0][2]:
        raise AssertionError(f"{layout}: copy-on-write copies {copies}")
    err = _suffix_check(rpa, got, "copy-on-write", layout,
                        copy_bits_equal=copies[0][2])
    return launches[0], err


def phase_prefix_serving(sd, rpa):
    """[serve_prefix] and [serve_prefix_quant]: the group traffic (64 new
    tokens) through the default engine without and with the prefix cache,
    on the bf16 pool and on int8 and int4 pools: tok/s, TTFT p50/p99,
    prefix hit rate, prompt tokens computed, copy-on-write copies and the
    ragged kernel's launches (plain 0) of each run; then one full-prompt
    hit per pool. The cached streams are held to the cache-off run's under
    the oracle rule; the page audit (scale planes included) must be empty
    after each cached run; the kept suffix calls (a device hit at bf16, a
    copy-on-write per pool) match the plain version. Returns ({layout:
    ragged kernel launches}, {layout: max suffix error})."""
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder)
    cfg = gpt_1p3b()
    prompts = _group_traffic(cfg.vocab_size, SEED + 11)
    launches, errs = {}, {}
    for layout, mode in (("bf16", {}), ("int8", {"kv_quant": "int8"}),
                         ("int4", {"kv_quant": "int4"})):
        label = "serve_prefix" if layout == "bf16" else "serve_prefix_quant"
        dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                              max_batch=16, **mode)
        off = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW,
                                       k_max=K_MAX)
        mark = _mark(off)
        ref, wall, l_off = _serve_groups(off, prompts, rpa)
        log(label, pool=layout, cache="off", requests=len(prompts),
            max_new=MAX_NEW, **_cache_fields(off, mark, wall, MAX_NEW,
                                             len(prompts)),
            rpa_launches=l_off[0], rpa_device_launches=l_off[2],
            plain_launches=l_off[1])
        del off
        eng = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW,
                                       k_max=K_MAX, prefix_cache=True)
        run = functools.partial(_serve_groups, eng, prompts, rpa)
        mark = _mark(eng)
        if layout == "bf16":     # a device hit: the second request of A
            (streams, wall, l_on), got = _tapped(rpa, dec, eng,
                                                 eng._next_id + GROUPS, run)
            errs[layout] = _suffix_check(rpa, got, "device hit", layout)
        else:
            streams, wall, l_on = run()
        findings = eng.audit_pages()
        log(label, pool=layout, cache="on", requests=len(prompts),
            max_new=MAX_NEW, **_cache_fields(eng, mark, wall, MAX_NEW,
                                             len(prompts)),
            rpa_launches=l_on[0], rpa_device_launches=l_on[2],
            plain_launches=l_on[1], audit_findings=len(findings))
        if findings or eng.stats.prefix_hits <= 0:
            raise AssertionError(f"{layout}: hits {eng.stats.prefix_hits}, "
                                 f"audit {[str(f) for f in findings[:3]]}")
        hit_launches, err = _full_hit(eng, dec, rpa, prompts[0][:SYS_LEN],
                                      layout)
        errs[layout] = max(errs.get(layout, 0.0), err)
        findings = eng.audit_pages()
        if findings or eng.stats.prefix_cow != 1:
            raise AssertionError(f"{layout}: after the full hit, cow "
                                 f"{eng.stats.prefix_cow}, audit "
                                 f"{[str(f) for f in findings[:3]]}")
        launches[layout] = l_off[0] + l_on[0] + hit_launches
        del eng
        equal, forced, gap = _oracle_rule(
            dec, prompts, streams, ref,
            also=[g * GROUP_SIZE + 1 for g in range(GROUPS)])
        log(f"{label}_oracle", pool=layout,
            streams_equal_cache_off=f"{equal}/{len(prompts)}",
            teacher_forced=forced, max_logit_gap=f"{gap:.5f}",
            tolerance=LOGIT_TOL)
        del dec
        torch.cuda.empty_cache()
    return launches, errs


class _TransferSpy:
    """Wraps a decoder's spill and restore primitives for one engine:
    each call runs between two synchronizes and is timed, and its bytes
    are checked — every spilled payload bit-equal to its device page at
    the spill, every restored page bit-equal to its payload after the
    restore. The synchronizes cost the run some overlap."""

    def __init__(self, dec):
        self.dec, self.d2h, self.h2d = dec, [0, 0.0], [0, 0.0]
        self.spilled = self.restored = 0
        fetch, mount = dec.fetch_page_payloads, dec.mount_page_payloads

        def timed(fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        def spill(pages):
            out, dt = timed(fetch, pages)
            self.d2h[0] += len(pages) * dec.kv_page_bytes
            self.d2h[1] += dt
            for p, payload in zip(pages, out):
                self._same(p, payload, "spilled")
            self.spilled += len(pages)
            return out

        def restore(pages, payloads):
            _, dt = timed(mount, pages, payloads)
            self.h2d[0] += len(pages) * dec.kv_page_bytes
            self.h2d[1] += dt
            for p, payload in zip(pages, payloads):
                self._same(p, payload, "restored")
            self.restored += len(pages)
        dec.fetch_page_payloads, dec.mount_page_payloads = spill, restore

    def _same(self, page, payload, what):
        leaves = payload["k"] + payload["v"]
        for (_, _, leaf), host in zip(self.dec._leaves(), leaves):
            if not _bits_equal(leaf[:, page], host.to(leaf.device)):
                raise AssertionError(f"page {page}: {what} bytes differ")

    def close(self):
        del self.dec.fetch_page_payloads, self.dec.mount_page_payloads

    def rates(self):
        return {f"{k}_GB_per_s": (f"{n / t / 1e9:.2f}" if t else None)
                for k, (n, t) in (("d2h", self.d2h), ("h2d", self.h2d))}


def _pinned_rates(nbytes):
    """Pinned host <-> card copy rates (GB/s) of one `nbytes` buffer, CUDA
    events around 5 copies each way after a warm-up."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    h2d = cuda_ms(lambda i=0: dev.copy_(host, non_blocking=True), 5)
    d2h = cuda_ms(lambda i=0: host.copy_(dev, non_blocking=True), 5)
    return nbytes / h2d / 1e6, nbytes / d2h / 1e6


def _transfer_breakdown(dec, payloads):
    """Where the engine's spill and restore copies spend their time, one
    step at a time between synchronizes (host clock), for one pool leaf
    (K) and `len(payloads)` pages of the tier: the spill's gather on the
    card, pinned allocation (a wave's buffer stays with the tier, so
    every wave allocates anew) and D2H copy; the restore's pinned staging
    allocation, host stack of the payloads, H2D copy and `index_copy_`
    (into a scratch tensor, not the pool). Returns {step: ms} and the
    leaf's MB."""
    leaf = next(x for _, _, x in dec._leaves())
    n = len(payloads)
    idx = torch.arange(n, device=leaf.device)
    ms = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = f"{(time.perf_counter() - t0) * 1e3:.2f}"
        return out
    g = step("d2h_gather", lambda: leaf.index_select(1, idx))
    buf = step("d2h_pin_alloc", lambda: torch.empty(
        g.shape, dtype=g.dtype, pin_memory=True))
    step("d2h_copy", lambda: buf.copy_(g))
    srcs = [p["k"][0] for p in payloads]
    stage = step("h2d_pin_alloc", lambda: torch.empty(
        g.shape, dtype=g.dtype, pin_memory=True))
    step("h2d_host_stack", lambda: torch.stack(srcs, dim=1, out=stage))
    dev = step("h2d_copy", lambda: stage.to(leaf.device, non_blocking=True))
    scratch = torch.empty_like(g)
    step("h2d_index_copy", lambda: scratch.index_copy_(1, idx, dev))
    return ms, g.numel() * g.element_size() / 1e6


def phase_serve_tier(sd, rpa):
    """[serve_tier] and [prefix_persist]. Three waves of the group traffic
    (TIER_NEW new tokens): groups A-D, four new groups E-H whose pages
    push A-D's parked pages out of the pool, then A-D again; with a 2 GiB
    host tier under tier_policy "restore", "recompute" and "auto", beside
    the capacity-0 twin. Prints spills, restores, recomputes, the D2H and
    H2D rates measured around the engine's own copies and of a pinned
    buffer, beside the priced `host_bw`, and the decision "auto" took.
    Spilled and restored bytes must be bit-equal to the pages', restores
    at least 32 blocks under "restore", the audit empty, the streams
    equal to the twin's under the oracle rule, and the first restored
    admission's suffix attention (the real table over restored pages)
    equal to the plain version's. Then the "restore" engine's cache,
    saved after wave 1, is loaded onto a fresh decoder of the same
    weights, whose fresh engine serves wave 3's traffic: hits from its
    first request, streams held to the warm engine's wave 3 under the
    oracle rule. Returns (ragged kernel launches, max suffix error)."""
    import os
    from paddle_tpu_torch.cost_model import H100_SXM, kv_restore_s
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          HostKVTier, PagedGPTDecoder,
                                          PrefixCache)
    cfg = gpt_1p3b()
    dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                          max_batch=16)
    first = _group_traffic(cfg.vocab_size, SEED + 21)       # groups A-D
    # groups E-H, 16 requests each: their published pages outgrow the
    # pool's free pages beside A-D's parked ones, so admissions evict A-D
    second = _group_traffic(cfg.vocab_size, SEED + 22, 2 * GROUP_SIZE)
    waves = (first, second, first)
    prompts = [p for w in waves for p in w]
    here = os.path.dirname(os.path.abspath(__file__))
    save_dir = os.path.join(here, PERSIST_DIR)
    total_launches, err = 0, 0.0
    runs = {}

    def serve(policy, capacity):
        nonlocal total_launches, err
        eng = ContinuousBatchingEngine(
            dec, max_new_tokens=TIER_NEW, k_max=K_MAX, prefix_cache=True,
            host_tier=HostKVTier(capacity), tier_policy=policy)
        spy = _TransferSpy(dec) if capacity and policy == "restore" else None
        streams = []
        for w, traffic in enumerate(waves):
            run = functools.partial(_serve_groups, eng, traffic, rpa)
            mark = _mark(eng)
            if spy is not None and w == 2:   # the first restored admission
                (out, wall, launches), got = _tapped(rpa, dec, eng,
                                                     eng._next_id, run)
                if not got["restored"]:
                    raise AssertionError("wave 3's first request restored "
                                         "no page")
                err = max(err, _suffix_check(rpa, got, "restored", "bf16"))
            else:
                out, wall, launches = run()
            total_launches += launches[0]
            streams += out
            findings = eng.audit_pages()
            log("serve_tier", policy=policy, tier_bytes=capacity, wave=w + 1,
                groups="ABCD"[:GROUPS] if w != 1 else "EFGH"[:GROUPS],
                requests=len(traffic), max_new=TIER_NEW,
                **_cache_fields(eng, mark, wall, TIER_NEW, len(traffic)),
                rpa_launches=launches[0], plain_launches=launches[1],
                audit_findings=len(findings))
            if findings:
                raise AssertionError(f"{policy}: audit "
                                     f"{[str(f) for f in findings[:3]]}")
            if spy is not None and w == 0:
                shutil.rmtree(save_dir, ignore_errors=True)
                t0 = time.perf_counter()
                eng.cache.save(save_dir)
                runs["save_s"] = time.perf_counter() - t0
                runs["save_MB"] = sum(
                    os.path.getsize(os.path.join(save_dir, f))
                    for f in os.listdir(save_dir)) / 1e6
        if spy is not None:
            spy.close()
            runs["rates"] = spy.rates()
            runs["checked"] = (spy.spilled, spy.restored)
            runs["payloads"] = [e.payload for _, e in eng.tier.items()][:32]
        runs[policy if capacity else "cap0"] = (streams, eng.stats)
        return streams

    try:
        ref = serve("restore", 0)
        for policy in ("restore", "recompute", "auto"):
            serve(policy, TIER_BYTES)
        h2d, d2h = _pinned_rates(32 * dec.kv_page_bytes)
        steps, leaf_MB = _transfer_breakdown(dec, runs.pop("payloads"))
        st = runs["restore"][1]
        if st.tier_restores < SYS_LEN // PS:
            raise AssertionError(f"restore: {st.tier_restores} blocks "
                                 f"restored (at least {SYS_LEN // PS})")
        auto = runs["auto"][1]
        log("serve_tier_summary", page_MB=f"{dec.kv_page_bytes / 1e6:.3f}",
            priced_host_GB_per_s=f"{H100_SXM.host_bw / 1e9:.1f}",
            priced_restore_us_a_page=f"{kv_restore_s(dec.kv_page_bytes) * 1e6:.1f}",
            engine_copies=runs["rates"],
            pinned_h2d_GB_per_s=f"{h2d:.2f}", pinned_d2h_GB_per_s=f"{d2h:.2f}",
            pinned_buffer_MB=f"{32 * dec.kv_page_bytes / 1e6:.1f}",
            breakdown_ms=steps, breakdown_leaf_MB=f"{leaf_MB:.1f}",
            pages_checked_spilled_restored=runs["checked"],
            bits_equal=True,
            auto_decision=("restore" if auto.tier_restores and not
                           auto.tier_recomputes else "recompute"
                           if auto.tier_recomputes and not auto.tier_restores
                           else "mixed"),
            auto_restores=auto.tier_restores,
            auto_recomputes=auto.tier_recomputes)
        for policy in ("restore", "recompute", "auto"):
            equal, forced, gap = _oracle_rule(dec, prompts, runs[policy][0],
                                              ref)
            log("serve_tier_oracle", policy=policy,
                streams_equal_capacity0=f"{equal}/{len(prompts)}",
                teacher_forced=forced, max_logit_gap=f"{gap:.5f}",
                tolerance=LOGIT_TOL)
        warm = runs["restore"][0][-len(first):]
        del dec
        torch.cuda.empty_cache()
        # [prefix_persist]: the cache saved after wave 1, on a fresh decoder
        dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                              max_batch=16)
        t0 = time.perf_counter()
        cache = PrefixCache.load(save_dir, dec)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        eng = ContinuousBatchingEngine(dec, max_new_tokens=TIER_NEW,
                                       k_max=K_MAX, prefix_cache=cache)
        # the first request admitted (A's leader) mounts what it matches
        first_hit = len(cache.match(cache.block_keys(first[0])))
        mark = _mark(eng)
        streams, wall, launches = _serve_groups(eng, first, rpa)
        total_launches += launches[0]
        findings = eng.audit_pages()
        log("prefix_persist", pages_saved=cache.n_pages,
            save_s=f"{runs['save_s']:.2f}", save_MB=f"{runs['save_MB']:.1f}",
            load_s=f"{load_s:.2f}", first_request_hit_blocks=first_hit,
            requests=len(first), max_new=TIER_NEW,
            **_cache_fields(eng, mark, wall, TIER_NEW, len(first)),
            rpa_launches=launches[0], plain_launches=launches[1],
            audit_findings=len(findings))
        if first_hit <= 0 or findings:
            raise AssertionError(f"warm start: the first request mounts "
                                 f"{first_hit} blocks, audit {findings[:3]}")
        del eng
        equal, forced, gap = _oracle_rule(dec, first, streams, warm)
        log("prefix_persist_oracle",
            streams_equal_warm_engine=f"{equal}/{len(first)}",
            teacher_forced=forced, max_logit_gap=f"{gap:.5f}",
            tolerance=LOGIT_TOL)
        del dec
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    return total_launches, err


# ---------------------------------------------------------------- slice 16
# GPT-MoE training (bench.py's run_gpt_moe, BASELINE config 5):
# gpt_moe_small (h 1024, 12 layers, 16 heads of 64, 8 experts with top-2
# routing in every 2nd block, capacity factor 1.25) in bf16, batch 8 x
# 1024 from seed 0, AdamW(2e-4, weight decay 0.01, bf16 moment slots, no
# clip), loss = the pretraining criterion + aux_loss(); 2 warm-up and 8
# timed steps. MFU counts the activated parameters (bench.py's formula).
# No Pallas kernel lies on the routing (XLA einsums in the JAX package):
# it runs as eager PyTorch ops, and the step's kernels are GPT's — flash
# forward / dQ / dK-dV a block (no recompute), the LayerNorm forward and
# backward, the cross-entropy and AdamW.

MOE_EXPECTED_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12,
                         "flash_bwd_dkv": 12, "layer_norm": 25,
                         "layer_norm_bwd": 25, "rms_norm": 0,
                         "xent_fwd": 1, "xent_bwd": 1,
                         "dropout_residual_layer_norm": 0,
                         "hash_dropout": 0, "hash_dropout_bwd": 0,
                         "hash_dropout_mask": 0}
MOE_GATE_STEPS = 3                 # timed steps of each stochastic gate
MOE_KEY_STEPS = 4                  # timed steps a round in [moe_keys]
# routing, gather and scatter kernels by name (argmax, one_hot's scatter,
# cumsum, gather, index_select and its index_add backward, the router's
# softmax); the routing's elementwise ops fall under "other"
_MOE_FAMILIES = _FAMILIES + (
    ("routing", ("argmax", "scatter", "gather", "scan", "cumsum",
                 "indexselect", "indexfunc", "index_", "softmax")),)


def _moe_trainer(cfg, device=None, lr=2e-4, acc_dtype="bfloat16", bf16=True,
                 state=None, clip=None):
    """bench.py's run_gpt_moe recipe: GPTMoE(cfg) (seed 0, or the
    weights `state`) [.bfloat16()], AdamW(lr, default weight decay 0.01,
    bf16 moment slots, `clip`), loss = criterion + aux_loss()."""
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.models import GPTMoE, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTMoE(cfg, device=device, seed=SEED)
    if state is not None:
        model.load_state_dict(state)
    if bf16:
        model.bfloat16()
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=lr, accumulator_dtype=acc_dtype,
                grad_clip=clip)
    return Trainer(model, opt, lambda m, b: crit(m(b["input_ids"]),
                                                 b["labels"]) + m.aux_loss(),
                   device=device)


def _moe_cfg(**kw):
    from paddle_tpu_torch.models import gpt_moe_small
    return gpt_moe_small(max_seq_len=TL, **kw)


def phase_moe_training(A, LN, X, smi):
    cfg = _moe_cfg()
    t0 = time.perf_counter()
    trainer = _moe_trainer(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batches = _device_batches(cfg, TB, 1)
    losses, step_ms, peak, kern, plain, _ = _steps(trainer, batches, A, LN,
                                                   X)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"MoE losses not falling: {losses}")
    per_step = {k: v / TRAIN_STEPS for k, v in kern.items()}
    expected = {**MOE_EXPECTED_PER_STEP,
                "adamw": _adamw_launches_expected(trainer, X)}
    branches = dict(A.branch_launches)
    if per_step != expected or any(plain.values()) or any(
            branches.get(f"{name}[tc,none]") != kern[name]
            for name in A.KERNELS):
        raise AssertionError(f"MoE launches a step {per_step} (expected "
                             f"{expected}), by body and branch {branches}, "
                             f"plain {plain}")
    tok_s = TB * TL / (step_ms / 1e3)
    active = cfg.num_active_params()
    log("moe_train", model="gpt_moe_small", layers=cfg.num_layers,
        hidden=cfg.hidden_size, experts=cfg.num_experts, top_k=cfg.top_k,
        gate=cfg.gate, capacity_factor=cfg.capacity_factor,
        params_M=f"{cfg.num_params() / 1e6:.1f}",
        active_params_M=f"{active / 1e6:.1f}", batch=f"{TB}x{TL}",
        dtype="bfloat16", gpu=repr(smi), setup_s=f"{setup_s:.2f}",
        steps=TRAIN_STEPS, step_ms=f"{step_ms:.2f}",
        tokens_per_s=f"{tok_s:.1f}",
        mfu_active=f"{6 * active * tok_s / H100_BF16_FLOPS:.4f}",
        peak_mem_GB=f"{peak:.2f}", loss_first=f"{losses[0]:.5f}",
        loss_last=f"{losses[-1]:.5f}",
        aux_last=f"{float(trainer.model.aux_loss().detach()):.6f}")
    log("moe_launches", **{f"{k}_per_step": v for k, v in per_step.items()},
        adamw_tensors_per_launch=len(trainer.params) / per_step["adamw"],
        **branches, plain=sum(plain.values()))
    return trainer, batches[0], kern, step_ms


def _routing_invariants(label, r, num_experts, top_k):
    """A dispatch's routing: every expert keeps at most C tokens, each
    slot holds one token, the combine weights are >= 0 and each token's
    sum to at most 1 (+1e-6) under top-2. Returns its numbers."""
    C, E = r.capacity, num_experts
    kept = r.slots[r.keep]
    per_slot = torch.bincount(kept, minlength=E * C)
    per_expert = torch.bincount(kept // C, minlength=E)
    demand = torch.bincount(r.experts[r.selected], minlength=E)
    w = r.weights
    bad = []
    if int(per_expert.max()) > C:
        bad.append(f"an expert keeps {int(per_expert.max())} > C {C}")
    if int(per_slot.max()) > 1:
        bad.append("a slot holds more than one token")
    if float(w.min()) < 0 or (top_k > 1 and float(w.sum(1).max()) >
                              1 + 1e-6):
        bad.append(f"combine weights min {float(w.min())}, largest sum "
                   f"{float(w.sum(1).max())}")
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    T = r.experts.shape[0]
    return {"capacity": C,
            "kept_per_round": ",".join(str(int(n)) for n in r.keep.sum(0)),
            "selected_per_round": ",".join(str(int(n))
                                           for n in r.selected.sum(0)),
            "drop_fraction": f"{1 - int(r.keep.sum()) / int(r.selected.sum()):.4f}",
            "max_demand_over_C": f"{int(demand.max()) / C:.3f}",
            "max_kept_over_C": f"{int(per_expert.max()) / C:.3f}",
            "tokens": T, "aux": f"{float(r.aux):.6f}"}


def phase_moe_routing(trainer, smi):
    """Per MoE layer of the run's last step: tokens kept per round, the
    share of selections dropped by capacity, the largest expert demand
    and load over C, the layer's aux loss, and the invariants. Then the
    routing and the whole dispatch timed alone at the step's shape."""
    from paddle_tpu_torch.models import moe as TM
    model, cfg = trainer.model, trainer.model.cfg
    for i, m in enumerate(model.moe_layers()):
        log("moe_routing", layer=2 * i + 1, **_routing_invariants(
            f"layer {2 * i + 1}", m.last_routing, cfg.num_experts,
            cfg.top_k))
    m = model.moe_layers()[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(TB * TL, cfg.hidden_size, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    args = (x, m.gate_w, m.w1, m.b1, m.w2, m.b2, m.gate_policy,
            cfg.capacity_factor)
    with torch.no_grad():
        route_ms = cuda_ms(lambda i=0: TM._route(
            x, m.gate_w, cfg.num_experts, m.gate_policy,
            cfg.capacity_factor), 20)
        dispatch_ms = cuda_ms(lambda i=0: TM._moe_dispatch(*args), 20)
        C = max(1, int(cfg.capacity_factor * TB * TL * cfg.top_k
                       / cfg.num_experts))
        xin = torch.randn(cfg.num_experts, C, cfg.hidden_size,
                          device="cuda", generator=gen, dtype=torch.bfloat16)
        experts_ms = cuda_ms(lambda i=0: torch.bmm(torch.nn.functional.gelu(
            torch.bmm(xin, m.w1) + m.b1[:, None], approximate="tanh"),
            m.w2) + m.b2[:, None], 20)
    flops = 2 * 2 * cfg.num_experts * C * cfg.hidden_size * cfg.ffn_hidden
    log("moe_routing_time", tokens=TB * TL, capacity=C,
        route_fwd_ms=f"{route_ms:.4f}", dispatch_fwd_ms=f"{dispatch_ms:.4f}",
        experts_bmm_ms=f"{experts_ms:.4f}",
        experts_TFLOP_s=f"{flops / experts_ms / 1e9:.1f}",
        routing_and_gather_share=f"{1 - experts_ms / dispatch_ms:.3f}",
        gpu=repr(smi))


def phase_moe_profile(trainer, batch, step_ms):
    """Where one MoE step's time goes: device ms by family (cuBLAS,
    flash, LN, xent, AdamW, the routing / gather / scatter kernels, other
    elementwise), busy share and device launches a step; then the host
    side of the same profile (the recorded CPU ops, their summed self
    CPU ms, the largest by self time) and the device ms over the
    unprofiled step's wall time (`[moe_train]`'s step_ms)."""
    prof = phase_train_profile(trainer, batch, label="moe_profile",
                               families=_MOE_FAMILIES)
    cpu, dev_us = [], 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            dev_us += ev.self_cuda_time_total if us is None else us
        else:
            cpu.append((ev.self_cpu_time_total, ev.count, ev.key))
    log("moe_profile_host", cpu_ops=sum(c for _, c, _ in cpu),
        cpu_self_ms=f"{sum(u for u, _, _ in cpu) / 1e3:.2f}",
        unprofiled_step_ms=f"{step_ms:.2f}",
        device_share_of_step=f"{dev_us / 1e3 / step_ms:.3f}",
        top=";".join(f"{k[:40]}:{c}:{u / 1e3:.2f}ms"
                     for u, c, k in sorted(cpu, reverse=True)[:6]))


def phase_moe_keys(trainer, batch, smi):
    """What the gate protocol's `draws_random` saves on the "topk" path:
    the [moe_train] trainer's MoE layers switched between their own gate
    ("no_keys": it derives no key) and the same top-k gate made to derive
    its keys as JAX's dispatch does ("keys": the stream's draw,
    fold_in(key, T), split and fold_in(routing key, k) a round, read by
    nothing). Two rounds in mirrored order, MOE_KEY_STEPS steps each
    after one untimed step: wall ms a step; then one profiled step of
    each: device ms, recorded CPU ops and their self CPU ms."""
    from paddle_tpu_torch.models.moe_gate import NaiveTopKGate

    class KeyedTopK(NaiveTopKGate):
        def draws_random(self, train):
            return True

    layers = trainer.model.moe_layers()
    own = layers[0].gate_policy
    variants = {"no_keys": own, "keys": KeyedTopK(own.top_k)}

    def use(name):
        for m in layers:
            m.gate_policy = variants[name]

    times = {k: [] for k in variants}
    prof = {}
    try:
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                use(name)
                trainer.step(batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(MOE_KEY_STEPS):
                    trainer.step(batch)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3
                                   / MOE_KEY_STEPS)
        for name in variants:
            use(name)
            prof[name] = _profiled_step(trainer, batch)
            wall, dev_ms, cpu_ops, cpu_ms = prof[name]
            log("moe_keys", variant=name, gpu=repr(smi),
                step_ms=[f"{t:.2f}" for t in times[name]],
                profiled_wall_ms=f"{wall:.2f}", device_ms=f"{dev_ms:.2f}",
                cpu_ops=cpu_ops, cpu_self_ms=f"{cpu_ms:.2f}")
    finally:
        use("no_keys")
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    log("moe_keys_saving", step_ms=f"{mean['keys'] - mean['no_keys']:.2f}",
        cpu_ops=prof["keys"][2] - prof["no_keys"][2],
        cpu_self_ms=f"{prof['keys'][3] - prof['no_keys'][3]:.2f}",
        device_ms=f"{prof['keys'][1] - prof['no_keys'][1]:.2f}")


def phase_moe_gates(smi):
    """"switch" and "gshard" at gpt_moe_small's width: 1 warm-up and
    MOE_GATE_STEPS steps each; finite losses, the routing invariants in
    every MoE layer, and GShard's random second-expert keep fraction."""
    from paddle_tpu_torch.distributed import LossBuffer
    for gate in ("switch", "gshard"):
        cfg = _moe_cfg(gate=gate)
        trainer = _moe_trainer(cfg)
        batch = _device_batches(cfg, TB, 1)[0]
        buf = LossBuffer(drain_every=1 + MOE_GATE_STEPS)
        buf.append(trainer.step(batch))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MOE_GATE_STEPS):
            buf.append(trainer.step(batch))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / MOE_GATE_STEPS * 1e3
        losses = buf.losses
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{gate}: losses {losses}")
        layers = trainer.model.moe_layers()
        stats = [_routing_invariants(f"{gate} layer {2 * i + 1}",
                                     m.last_routing, cfg.num_experts,
                                     cfg.top_k)
                 for i, m in enumerate(layers)]
        extra = {}
        if gate == "gshard":
            extra["round2_keep_fraction"] = ",".join(
                f"{float(m.last_routing.selected[:, 1].float().mean()):.4f}"
                for m in layers)
        log("moe_gates", gate=gate, top_k=cfg.top_k, gpu=repr(smi),
            step_ms=f"{step_ms:.2f}",
            losses=",".join(f"{x:.5f}" for x in losses),
            drop_fraction=",".join(s["drop_fraction"] for s in stats),
            max_demand_over_C=",".join(s["max_demand_over_C"]
                                       for s in stats),
            key_draws=layers[0].keys.count, **extra)
        del trainer, batch
        torch.cuda.empty_cache()


def phase_moe_small_reference():
    """gpt_moe_tiny in f32: 3 Trainer steps (AdamW lr 1e-3, f32 slots,
    the MoE clip with expert parameters picked by name) on the card
    against the port on the CPU from the same weights: losses and
    parameters within TRAIN_REF_TOL, and every MoE layer's routing of
    every step equal."""
    from paddle_tpu_torch.models import GPTMoE, gpt_moe_tiny
    from paddle_tpu_torch.nn import ClipGradForMOEByGlobalNorm
    cfg = gpt_moe_tiny()
    batch = _batch(cfg, 4, 64, seed=SEED + 6)
    state = {k: v.detach() for k, v in GPTMoE(cfg, device="cpu",
                                              seed=SEED).state_dict().items()}
    runs = []
    for device in ("cuda", "cpu"):
        tr = _moe_trainer(cfg, device=device, lr=1e-3, acc_dtype=None,
                          bf16=False, state=state,
                          clip=ClipGradForMOEByGlobalNorm(
                              1.0, lambda n: ".moe.w" in n or ".moe.b" in n))
        losses, routes = [], []
        for _ in range(3):
            losses.append(float(tr.step(batch)))
            routes.append([(r.experts.cpu(), r.keep.cpu(), r.slots.cpu())
                           for r in (m.last_routing
                                     for m in tr.model.moe_layers())])
        runs.append((losses, routes, {k: v.detach().cpu() for k, v in
                                      tr.model.state_dict().items()}))
    (lc, rc, pc), (lh, rh, ph) = runs
    loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    param_err = max(float((pc[k] - ph[k]).abs().max()) for k in ph)
    routing_equal = all(torch.equal(a, b) for sc, sh in zip(rc, rh)
                        for lc_, lh_ in zip(sc, sh)
                        for a, b in zip(lc_, lh_))
    if loss_err > TRAIN_REF_TOL or param_err > TRAIN_REF_TOL or \
            not routing_equal:
        raise AssertionError(f"gpt_moe_tiny card vs CPU: loss err "
                             f"{loss_err:.3e}, param err {param_err:.3e} "
                             f"(tolerance {TRAIN_REF_TOL}), routing equal "
                             f"{routing_equal}")
    log("moe_small_ref", model="gpt_moe_tiny f32", steps=3,
        losses_card=[round(x, 6) for x in lc],
        loss_max_abs_err=f"{loss_err:.3e}",
        param_max_abs_err=f"{param_err:.3e}", tolerance=TRAIN_REF_TOL,
        routing_equal=routing_equal)


# ---------------------------------------------------------------- slice 17
# The serving engine's flight recorder, the dense window layout, the
# dispatch-separate loop and speculative decoding, all over the ragged
# kernel's dense form (q [n, W, H, D]) or its packed stream.

SPEC_B, SPEC_PROMPT, SPEC_NEW, SPEC_K = 4, 64, 64, 4   # run_speculative's
SPEC_PAGES = SPEC_B * ((SPEC_PROMPT + SPEC_NEW + SPEC_K + PS - 1) // PS) + 2
SPEC_H, SPEC_D, SPEC_MP = 16, 64, 16        # gpt_350m: 16 x 64, 256 tokens
SPEC_SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
# an acceptance draw u within TIE_TOL of min(1, p/q) is a tie: p and q
# from bf16 logits move by more than that across row counts
TIE_TOL = 1e-4
# the dense prefill windows: every pow2 width up to the longest suffix
# (768 tokens -> 1024), rows as many as keep a window call at 4096 tokens
DENSE_WIDTHS = tuple(4 << i for i in range(9))


def _d64_cases(rng):
    """The forms slice 17's gpt_350m paths launch at head_dim 64 (16
    heads, a pool of SPEC_PAGES pages, table width 16): (name, table
    rows, q shape, row ids or None, start / positions). The verify
    window (n 4, W 5, positions 64-127); the draft's decode_multi ticks
    (dense W 1, n 4, positions 64-127); the packed prefill of 4 rows x
    64 prompt tokens; the plain engine's ragged ticks: 4 decode rows
    alone and 2 decode rows beside 2 rows prefilling 64-token chunks."""
    n, hd = SPEC_B, (SPEC_H, SPEC_D)

    def decode(k):
        return rng.randint(SPEC_PROMPT, SPEC_PROMPT + SPEC_NEW, k)
    mix_rows = np.concatenate([[0, 1], np.repeat([2, 3], SPEC_PROMPT)])
    mix_pos = np.concatenate([decode(2), np.tile(np.arange(SPEC_PROMPT), 2)])
    return [
        ("verify", (n, SPEC_K + 1, *hd), None, decode(n)),
        ("decode", (n, 1, *hd), None, decode(n)),
        ("packed_prefill", (n * SPEC_PROMPT, *hd),
         np.repeat(np.arange(n), SPEC_PROMPT),
         np.tile(np.arange(SPEC_PROMPT), n)),
        ("packed_decode", (n, *hd), np.arange(n), decode(n)),
        ("packed_mix", (len(mix_rows), *hd), mix_rows, mix_pos)]


def phase_dense_window_checks(rpa):
    """The kernel at slice 17's shapes against its plain version, f32 and
    bf16 (`_check_close`: f32 1e-5; bf16 one ulp of the f32 plain result
    + 1e-5). At head_dim 64 (gpt_350m, `_d64_cases`): every form the
    speculative phases launch, each through the wrapper and with both
    launch plans forced (split and unsplit), since the plan the path
    takes depends on its row count. At head_dim 128 (gpt_1p3b's pool,
    table width 64): the dense prefill windows at every pow2 width
    4-1024, a row from start 0 and the others from a cached start.
    Returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    rng = np.random.RandomState(SEED + 17)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        kp, vp = (torch.randn((SPEC_PAGES, PS, SPEC_H, SPEC_D),
                              generator=gen, device="cuda").to(dtype)
                  for _ in "kv")
        table = torch.from_numpy(rng.randint(
            0, SPEC_PAGES - 1, (SPEC_B, SPEC_MP)).astype(np.int32)).cuda()
        scale = 1.0 / SPEC_D ** 0.5
        for form, shape, rows, pos in _d64_cases(rng):
            q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            pos = torch.from_numpy(pos.astype(np.int32)).cuda()
            if rows is None:
                ref_args = (table, pos, scale)
                plain = _ref(rpa, q, kp, vp, *ref_args)
                plain32 = _ref(rpa, q.float(), kp.float(), vp.float(),
                               *ref_args)
                row_of = None
                got = rpa.ragged_paged_attention(q, kp, vp, table, pos)
            else:
                row_of = torch.from_numpy(rows.astype(np.int32)).cuda()
                ref_args = (table[row_of.long()], pos, scale)
                plain = _ref(rpa, q[:, None], kp, vp, *ref_args)[:, 0]
                plain32 = _ref(rpa, q[:, None].float(), kp.float(),
                               vp.float(), *ref_args)[:, 0]
                got = rpa.ragged_paged_attention_packed(q, kp, vp, table,
                                                        row_of, pos)
            for plan in ("wrapper", "split", "unsplit"):
                if plan != "wrapper":
                    got = rpa._launch(q, kp, vp, table, row_of, pos, scale,
                                      split=plan == "split")
                e = _check_close(f"{form} D=64 {plan}", got, plain, plain32)
                err = max(err, e)
                log("kernel", form=f"d64_{form}", plan=plan,
                    dtype=str(dtype)[6:], tokens=q.shape[0] * (
                        q.shape[1] if q.dim() == 4 else 1),
                    heads=SPEC_H, head_dim=SPEC_D, pages=SPEC_PAGES,
                    table=SPEC_MP, max_abs_err=f"{e:.3e}")
        for W in DENSE_WIDTHS:
            n, P = max(2, min(16, 4096 // W)), 16 * MP + 1
            kp, vp = (torch.randn((P, PS, H, D), generator=gen,
                                  device="cuda").to(dtype) for _ in "kv")
            table = torch.from_numpy(rng.randint(
                0, P - 1, (n, MP)).astype(np.int32)).cuda()
            start = rng.randint(0, MP * PS - W + 1, n)
            start[0] = 0
            start = torch.from_numpy(start.astype(np.int32)).cuda()
            q = torch.randn((n, W, H, D), generator=gen,
                            device="cuda").to(dtype)
            scale = 1.0 / D ** 0.5
            got = rpa.ragged_paged_attention(q, kp, vp, table, start)
            plain = _ref(rpa, q, kp, vp, table, start, scale)
            plain32 = _ref(rpa, q.float(), kp.float(), vp.float(), table,
                           start, scale)
            e = _check_close(f"dense prefill W={W}", got, plain, plain32)
            err = max(err, e)
            log("kernel", form="dense_prefill", dtype=str(dtype)[6:], n=n,
                W=W, heads=H, head_dim=D, pages=P, table=MP,
                max_abs_err=f"{e:.3e}")
    torch.cuda.synchronize()
    return err


def phase_verify_timing(rpa, layers=24):
    """The kernel at the verify window's shape (n 4, W 5, 16 heads of 64,
    table width 16, positions 64-127, bf16), each launch on the next of
    24 layer pools as the verify forward does: eager and CUDA-graph device
    time beside the plain version, SDPA over K/V gathered to dense bf16
    with the window's causal mask (never called by the port) and the
    bound (bytes: each row's K/V prefix and the window's q and output)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    rng = np.random.RandomState(SEED + 18)
    n, W, P, mp = SPEC_B, SPEC_K + 1, SPEC_PAGES, SPEC_MP
    kp, vp = (torch.randn((layers, P, PS, SPEC_H, SPEC_D), generator=gen,
                          device="cuda").to(torch.bfloat16) for _ in "kv")
    # each row's 9 pages as the engine allots them, the rest scratch
    per = P // n
    table_np = np.full((n, mp), P - 1, np.int32)
    for r, row in enumerate(rng.permutation(n * per).reshape(n, per)):
        table_np[r, :per] = row
    table = torch.from_numpy(table_np).cuda()
    start_np = rng.randint(SPEC_PROMPT, SPEC_PROMPT + SPEC_NEW, n)
    start = torch.from_numpy(start_np.astype(np.int32)).cuda()
    q = torch.randn((layers, n, W, SPEC_H, SPEC_D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    scale = 1.0 / SPEC_D ** 0.5
    ql, kl, vl = list(q), list(kp), list(vp)

    def kern(i=0):
        return rpa.ragged_paged_attention(ql[i % layers], kl[i % layers],
                                          vl[i % layers], table, start)

    def plain(i=0):
        return _ref(rpa, ql[i % layers], kl[i % layers], vl[i % layers],
                    table, start, scale)

    keys = mp * PS
    kd = [kl[l][table.long()].reshape(n, keys, SPEC_H, SPEC_D)
          .transpose(1, 2) for l in range(2)]
    vd = [vl[l][table.long()].reshape(n, keys, SPEC_H, SPEC_D)
          .transpose(1, 2) for l in range(2)]
    qpos = start.long()[:, None] + torch.arange(W, device="cuda")
    mask = (torch.arange(keys, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    qd = [x.transpose(1, 2) for x in ql]

    def library(i=0):
        return torch.nn.functional.scaled_dot_product_attention(
            qd[i % layers], kd[i % 2], vd[i % 2], attn_mask=mask,
            scale=scale)

    seen = start_np.astype(np.int64) + W            # keys of a row
    nbytes = int(seen.sum()) * 2 * SPEC_H * SPEC_D * 2 + \
        2 * n * W * SPEC_H * SPEC_D * 2 + 4 * (n * mp + n)
    flops = int(sum((s + j + 1) for s in start_np for j in range(W))) * \
        SPEC_H * 4 * SPEC_D
    r, host, per_call = _rpa_readings(rpa, kern, plain, library, nbytes,
                                      flops, 240)
    got, want = kern(), plain()
    r["max_abs_err"] = float((got.float() - want.float()).abs().max())
    log("kernel_time", pool="bf16", shape=f"verify n={n} W={W} H={SPEC_H} "
        f"D={SPEC_D} ps={PS} MP={mp} mean_ctx={seen.mean():.1f}",
        **{k: f"{v:.4f}" for k, v in r.items()
           if k not in ("bound_by", "max_abs_err")},
        bound_by=r["bound_by"], max_abs_err=f"{r['max_abs_err']:.3e}",
        **{k: f"{v:.2f}" for k, v in host.items()},
        device_launches_per_call=f"{per_call:g}")
    return r


def _counted(rpa, fn):
    """fn() with the ragged kernel's counts set to 0 just before and read
    just after; a plain launch is a failure. Returns (fn's result,
    kernel launches)."""
    rpa.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    if rpa.kernel_launches <= 0 or rpa.plain_launches:
        raise AssertionError(f"ragged attention: {rpa.kernel_launches} "
                             f"kernel, {rpa.plain_launches} plain launches")
    return out, rpa.kernel_launches


def _spec_models():
    """bench.py's run_speculative models: gpt_350m (bf16, 24 layers,
    random weights from SEED) with blocks 6-23's proj and fc2 zeroed —
    their products still run, their residual adds nothing — and the
    draft, its first 6 layers. Returns (cfg, state, draft cfg, draft
    state)."""
    from paddle_tpu_torch.models import gpt_350m, init_state_dict
    cfg = gpt_350m(max_seq_len=max(256, SPEC_PROMPT + SPEC_NEW + SPEC_K + 8))
    sd = init_state_dict(cfg, seed=SEED)
    n_draft = max(1, cfg.num_layers // 4)
    for i in range(n_draft, cfg.num_layers):
        for name in ("proj", "fc2"):
            for part in ("weight", "bias"):
                sd[f"blocks.{i}.{name}.{part}"].zero_()
    dcfg = gpt_350m(max_seq_len=cfg.max_seq_len, num_layers=n_draft)
    dsd = {k: v for k, v in sd.items() if not k.startswith("blocks.")
           or int(k.split(".")[1]) < n_draft}
    return cfg, sd, dcfg, dsd


def _spec_run(rpa, build, prompts):
    """One drain of `prompts` through `build()` (built before the clock
    starts), the ragged kernel counted over the run. Returns (engine,
    streams, wall seconds, kernel launches)."""
    eng = build()
    rids = [eng.submit(p) for p in prompts]
    torch.cuda.synchronize()

    def drain():
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (out, wall), launches = _counted(rpa, drain)
    streams = [out[r] for r in rids]
    if any(len(s) != SPEC_NEW for s in streams):
        raise AssertionError("a speculative request did not return "
                             f"{SPEC_NEW} tokens")
    return eng, streams, wall, launches


def _accepted_share(eng):
    """Drafts accepted over drafts judged: each verify of a slot emits the
    accepted drafts plus one token (the first token comes from the
    prefill; acceptance is capped at k - 1)."""
    calls = round(sum(eng.stats.occupancy) * eng.d.max_batch)
    accepted = eng.stats.tokens - SPEC_B - calls
    return max(accepted, 0) / max(calls * (eng.k - 1), 1)


def _verify_ms(dec):
    """(eager ms, device ms) of one verify forward (`_verify_step`, W =
    k + 1) of the target at the run's batch, rows at position 120 of their
    pages: CUDA events around eager calls (the host's dispatch sets it),
    and around the calls replayed from a CUDA graph (None when the forward
    cannot be captured)."""
    per = SPEC_PAGES // SPEC_B
    table = np.full((SPEC_B, dec.max_pages), dec.num_pages - 1, np.int32)
    for r in range(SPEC_B):
        table[r, :per] = np.arange(r * per, (r + 1) * per)
    win = dec._as_i32(np.random.RandomState(SEED).randint(
        0, dec.cfg.vocab_size, (SPEC_B, SPEC_K + 1)))
    lens = dec._as_i32(np.full(SPEC_B, 120, np.int32))
    tbl = dec._as_i32(table)

    def verify(i=0):
        return dec._verify_step(win, lens, tbl)

    eager = cuda_ms(verify, 10)
    try:
        device = cuda_graph_ms(verify, 10)
    except RuntimeError as e:                  # capture refused
        log("spec_verify_graph", captured=False, reason=repr(str(e)[:120]))
        device = None
    return eager, device


def phase_speculative(rpa, smi):
    """`[spec]`, `[spec_weak]`, `[spec_sampled]`: bench.py's
    run_speculative at its size (batch 4, 64-token prompts, 64 new, k 4,
    page_size 16, seed 0) on the card. The plain engine (default ragged)
    and `SpeculativeEngine` each drain once to warm up and once timed;
    partings from the plain streams are held to the oracle rule
    (`_oracle_rule`: teacher-forced per-tick target, LOGIT_TOL). The weak
    draft is an unrelated 6-layer model (seed 1). Sampled: both decoders
    at temperature 0.8, top_k 50, top_p 0.95, target seed 0, draft seed 1
    — two runs must be equal, acceptance decisions within TIE_TOL of the
    draw are counted as ties, and at temperature 1e-4 the streams must
    pass the oracle rule against the greedy ones. Returns the ragged
    kernel's launches over every driven run."""
    import paddle_tpu_torch.serving.engine as engine_module
    from paddle_tpu_torch.models import init_state_dict
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder, SpeculativeEngine)
    t_phase = time.perf_counter()
    cfg, sd, dcfg, dsd = _spec_models()
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, SPEC_PROMPT).tolist()
               for _ in range(SPEC_B)]

    def make(c, state, **kw):
        return PagedGPTDecoder(c, state, num_pages=SPEC_PAGES, page_size=PS,
                               max_batch=SPEC_B, **kw)

    def plain():
        return ContinuousBatchingEngine(make(cfg, sd),
                                        max_new_tokens=SPEC_NEW)

    def spec(draft_state=dsd, **kw):
        return SpeculativeEngine(make(cfg, sd, **kw),
                                 make(dcfg, draft_state, **{
                                     **kw, "seed": kw.get("seed", 0) + 1}),
                                 max_new_tokens=SPEC_NEW, k=SPEC_K)

    launches = 0
    runs = {}
    for name, build in (("plain", plain), ("spec", spec)):
        _spec_run(rpa, build, prompts)                   # warm-up
        runs[name] = _spec_run(rpa, build, prompts)
        launches += runs[name][3]
    eng_p, plain_streams, plain_s, _ = runs["plain"]
    eng, got, spec_s, spec_launches = runs["spec"]
    verify_ms, verify_device = _verify_ms(eng.d)
    equal, forced, gap = _oracle_rule(eng.d, prompts, got, plain_streams)
    log("spec", target=f"gpt_350m L{cfg.num_layers} h{cfg.hidden_size}",
        draft_layers=dcfg.num_layers, dtype="bfloat16", batch=SPEC_B,
        prompt=SPEC_PROMPT, new=SPEC_NEW, k=SPEC_K, page_size=PS,
        plain_s=f"{plain_s:.3f}", spec_s=f"{spec_s:.3f}",
        speedup=f"{plain_s / spec_s:.3f}", plain_k_max=eng_p.k_max,
        target_calls=eng.target_calls,
        accepted_share=f"{_accepted_share(eng):.4f}",
        streams_equal=f"{equal}/{SPEC_B}", oracle_forced=forced,
        max_logit_gap=f"{gap:.5f}", tolerance=LOGIT_TOL,
        verify_ms=f"{verify_ms:.4f}",
        verify_device_ms="not measured" if verify_device is None
        else f"{verify_device:.4f}", kernel_launches=spec_launches,
        gpu=repr(smi))

    weak_state = init_state_dict(dcfg, seed=1)
    eng, weak, wall, n = _spec_run(rpa, lambda: spec(weak_state), prompts)
    launches += n
    equal, forced, gap = _oracle_rule(eng.d, prompts, weak, plain_streams)
    log("spec_weak", draft="unrelated gpt_350m L6 (seed 1)", k=SPEC_K,
        spec_s=f"{wall:.3f}", target_calls=eng.target_calls,
        accepted_share=f"{_accepted_share(eng):.4f}",
        streams_equal=f"{equal}/{SPEC_B}", oracle_forced=forced,
        max_logit_gap=f"{gap:.5f}", kernel_launches=n, gpu=repr(smi))
    del weak_state

    margins = []
    accept = engine_module._spec_accept

    def tap(p_rows, q_rows, drafts, gen_):
        replay = np.random.default_rng()
        replay.bit_generator.state = gen_.bit_generator.state
        out = accept(p_rows, q_rows, drafts, gen_)
        for j in range(min(out[0] + 1, len(drafts))):
            d = int(drafts[j])
            if q_rows[j, d] > 0:
                margins.append(abs(replay.random() - min(
                    1.0, float(p_rows[j, d]) / float(q_rows[j, d]))))
        return out

    engine_module._spec_accept = tap
    try:
        sampled = []
        for _ in range(2):
            eng, s, wall, n = _spec_run(
                rpa, lambda: spec(**SPEC_SAMPLING, seed=0), prompts)
            sampled.append(s)
            launches += n
        n_margins, ties = len(margins), sum(m <= TIE_TOL for m in margins)
    finally:
        engine_module._spec_accept = accept
    if sampled[0] != sampled[1]:
        raise AssertionError("two sampled speculative runs differ")
    cold_kw = dict(SPEC_SAMPLING, temperature=1e-4, seed=0)
    eng_c, cold, _, n = _spec_run(rpa, lambda: spec(**cold_kw), prompts)
    launches += n
    equal, forced, gap = _oracle_rule(eng_c.d, prompts, cold, plain_streams)
    log("spec_sampled", **SPEC_SAMPLING, target_seed=0, draft_seed=1,
        spec_s=f"{wall:.3f}", target_calls=eng.target_calls,
        accepted_share=f"{_accepted_share(eng):.4f}",
        runs_equal=True, decisions=n_margins, ties=ties, tie_tol=TIE_TOL,
        min_margin=f"{min(margins, default=1.0):.3e}",
        cold_streams_equal_greedy=f"{equal}/{SPEC_B}",
        cold_oracle_forced=forced, cold_max_logit_gap=f"{gap:.5f}",
        gpu=repr(smi))
    log("spec_phases", total_s=f"{time.perf_counter() - t_phase:.1f}",
        kernel_launches=launches)
    return launches


TRACE_PAIRS = 3       # (untraced, traced) pairs of [serve_trace], order alternating


def phase_serve_trace(rpa, dec, prompts, streams, smi):
    """`[serve_trace]`: the serving traffic in TRACE_PAIRS pairs of one
    untraced run (no recorder event may be recorded) and one run with
    `trace=FlightRecorder()`, the order alternating from pair to pair
    (untraced first, then traced first, ...): every traced run's streams
    must equal the untraced ones byte for byte. The wall times of every
    run, the recorder's overhead (traced / untraced - 1) of each pair and
    their median; from the last traced run, the events, the drift of each
    dispatch shape against the H100's priced roofline
    (`[serve_trace_drift]`), a chrome trace written under a temporary
    directory that must pass `validate_chrome_trace`, and
    `debug.serving_report()`'s schedule and pad fields. Returns the
    kernel launches of every run."""
    import os
    import tempfile

    from paddle_tpu_torch import debug
    from paddle_tpu_torch.serving import (FlightRecorder, export_chrome_trace,
                                          validate_chrome_trace)
    walls = {"untraced": [], "traced": []}
    plain, launches = None, 0
    for pair in range(TRACE_PAIRS):
        for traced in ((False, True) if pair % 2 == 0 else (True, False)):
            before = FlightRecorder.total_events
            kw = {"trace": FlightRecorder()} if traced else {}
            eng_r, got, wall, counts = _serve_run(dec, prompts, (rpa,), **kw)
            if not traced and FlightRecorder.total_events != before:
                raise AssertionError("an untraced run recorded trace events")
            if plain is None:
                plain = got
            elif got != plain:
                raise AssertionError("a traced and an untraced run's streams "
                                     "differ")
            if counts["ragged_paged_attention"][1]:
                raise AssertionError("a serving run took the plain version")
            launches += counts["ragged_paged_attention"][0]
            walls["traced" if traced else "untraced"].append(wall)
            if traced:
                eng, rec = eng_r, kw["trace"]
    overheads = [t / u - 1 for t, u in zip(walls["traced"],
                                           walls["untraced"])]
    drift = rec.drift_report()
    for d in drift:
        log("serve_trace_drift", shape="x".join(map(str, d["shape"])),
            n=d["n"], predicted_ms=f"{d['predicted_s'] * 1e3:.3f}",
            measured_ms=f"{d['measured_s'] * 1e3:.3f}",
            ratio=f"{d['ratio']:.2f}",
            predicted_serial_ms=f"{d.get('predicted_serial_s', 0) * 1e3:.3f}",
            drifting=d["drifting"], verdict=d.get("verdict", "-"),
            gpu=repr(smi))
    with tempfile.TemporaryDirectory() as td:
        path = export_chrome_trace(os.path.join(td, "serve.json"),
                                   recorders=rec)
        problems = validate_chrome_trace(path)
        with open(path) as f:
            n_chrome = len(json.load(f)["traceEvents"])
    if problems:
        raise AssertionError(f"chrome trace: {problems[:3]}")
    entry = next(e for e in debug.serving_report()
                 if e["stats"]["engine_id"] == eng.stats.engine_id)
    kinds = rec.summary()["kinds"]
    log("serve_trace", model="gpt_1p3b", requests=N_REQ, max_new=MAX_NEW,
        k_max=K_MAX, pairs=TRACE_PAIRS, order="alternating, untraced first",
        streams_equal_untraced=f"{N_REQ}/{N_REQ}",
        streams_equal_serve_run=f"{sum(a == b for a, b in zip(plain, streams))}"
        f"/{N_REQ}",
        wall_traced_s=[f"{w:.3f}" for w in walls["traced"]],
        wall_untraced_s=[f"{w:.3f}" for w in walls["untraced"]],
        overhead_per_pair=[f"{o:+.4f}" for o in overheads],
        overhead_median=f"{float(np.median(overheads)):+.4f}",
        overhead_spread=f"{min(overheads):+.4f}..{max(overheads):+.4f}",
        events=len(rec.events), kinds=kinds, drift_shapes=len(drift),
        drifting_shapes=len(entry["drifting_shapes"]),
        chrome_events=n_chrome, chrome_problems=0,
        schedule=entry.get("schedule"), pad=entry.get("pad"),
        kernel_launches=launches, gpu=repr(smi))
    return launches


def phase_serve_dense(rpa, dec, prompts, streams, fields, smi):
    """`[serve_dense]`: the serving traffic through the dense window twin
    (`packed=False`: [16, w] windows a tick, through the kernel's dense
    form) beside the packed run's tok/s; streams equal to the packed
    run's, partings held to the oracle rule. Returns its launches."""
    eng, got, wall, counts = _serve_run(dec, prompts, (rpa,), packed=False)
    launches, plain = counts["ragged_paged_attention"]
    if launches <= 0 or plain:
        raise AssertionError(f"dense serving launches: {launches}, {plain}")
    equal, forced, gap = _oracle_rule(dec, prompts, got, streams)
    f = _serve_fields(eng, wall)
    log("serve_dense", model="gpt_1p3b", packed=False, **f,
        packed_gen_tok_per_s=fields["gen_tok_per_s"],
        packed_pad_fraction=fields["pad_fraction"],
        streams_equal=f"{equal}/{N_REQ}", oracle_forced=forced,
        max_logit_gap=f"{gap:.5f}", tolerance=LOGIT_TOL,
        kernel_launches=launches, gpu=repr(smi))
    return launches


def phase_serve_multi(rpa, dec, prompts, streams, smi):
    """`[serve_multi]`: the serving traffic through the dispatch-separate
    loop (`ragged=False`, k_max 8: a blocking prefill at each admission,
    then decode-only horizons), once in each layout: packed (the packed
    prefill) and `packed=False` (the dense prefill entry,
    `prefill_suffix_batch(packed=False)`: prompts grouped by pow2 width
    into [n, w] windows, which must be the only prefill entry the run
    takes). Each: tok/s, `serve_schedule()`'s prefill syncs and the
    decode rows they stalled, streams equal to the ragged run's, partings
    held to the oracle rule. Returns the launches of both runs."""
    total = 0
    for packed in (True, False):
        calls = {"_prefill_dense_batch": 0, "_prefill_packed_batch": 0}

        def spy(name):
            fn = getattr(dec, name)

            def counted(*args, **kw):
                calls[name] += 1
                return fn(*args, **kw)
            return counted
        for name in calls:
            setattr(dec, name, spy(name))
        try:
            eng, got, wall, counts = _serve_run(dec, prompts, (rpa,),
                                                ragged=False, packed=packed)
        finally:
            for name in calls:
                delattr(dec, name)
        launches, plain = counts["ragged_paged_attention"]
        if launches <= 0 or plain:
            raise AssertionError(f"multi serving launches: {launches}, "
                                 f"{plain}")
        took = calls["_prefill_packed_batch" if packed
                     else "_prefill_dense_batch"]
        if not took or calls["_prefill_dense_batch" if packed
                             else "_prefill_packed_batch"]:
            raise AssertionError(f"packed={packed}: prefill entries {calls}")
        syncs = [ev for ev in eng.serve_schedule()
                 if ev["kind"] == "prefill_sync"]
        equal, forced, gap = _oracle_rule(dec, prompts, got, streams)
        log("serve_multi", model="gpt_1p3b", ragged=False, packed=packed,
            k_max=eng.k_max, **_serve_fields(eng, wall),
            prefill_syncs=len(syncs),
            stalled_prefill_syncs=sum(ev["decode_active"] > 0
                                      for ev in syncs),
            stalled_decode_rows=sum(ev["decode_active"] for ev in syncs),
            prefill_entry_calls=took,
            streams_equal=f"{equal}/{N_REQ}", oracle_forced=forced,
            max_logit_gap=f"{gap:.5f}", tolerance=LOGIT_TOL,
            kernel_launches=launches, gpu=repr(smi))
        total += launches
    return total


# ------------------------------------------------------------- slice 18

LORA_N, LORA_RANK, LORA_SEED = 4, 16, 9     # the serving bank
LORA_TOL = 1e-5
# [lora_kernel] cases: (T, dtype, adapters, ranks); the ragged mix is 4
# decode rows beside 2 x 256-token chunks
LORA_CASES = [(T, dt, n, r) for T in (1, 16, 516, 1024)
              for dt in (torch.float32, torch.bfloat16)
              for n, r in ((1, (4,)), (4, (16, 4, 16, 8)),
                           (8, (16, 4, 12, 16, 2, 16, 8, 16)))]
TEN_FLOOD, TEN_FLOOD_LEN, TEN_LAT, TEN_LAT_LEN = 32, 256, 8, 384
TEN_BATCH = 16
# the resident flood fills the pool: 16 slots x ceil((256 + 64) / 16)
TEN_PAGES = TEN_BATCH * ((TEN_FLOOD_LEN + MAX_NEW + PS - 1) // PS) + 1
FLEET_TEMPLATES, FLEET_TEMPLATE_LEN, FLEET_SUFFIX = 8, 512, 64
# 3 waves (bench.py's run_fleet runs 5): two warm the caches and fill the
# shared tier (with 2, too few templates reach it before the respawn), the
# third is timed
FLEET_REQ, FLEET_WAVES, FLEET_BATCH, FLEET_ZIPF = 48, 3, 8, 0.7
FLEET_REPLICAS = 3
# the fleet runs gpt_1p3b's width at 4 of its 24 layers, so that its 10
# waves (3 fleets x 3, 1 respawn) fit the smoke's time limit (at 8 layers
# the phase took ~105 s of a 1023 s run on the H100)
FLEET_LAYERS = 4
# one replica's cliff: one full batch of private-template requests
FLEET_PAGES = FLEET_BATCH * (
    (FLEET_TEMPLATE_LEN + FLEET_SUFFIX + MAX_NEW + PS - 1) // PS) + 1
FLEET_TIER_BYTES = 4 << 30
FLEET_DIR = "_archive/fleet_tier"          # under the checkout, gitignored
TRACE_DIR = "_archive/slice18_traces"


def _lora_bank(dec, ranks, seed):
    """One layer's f32 bank [n+1, h, R] / [n+1, R, N] of adapters with
    `ranks` (`make_lora_bank`'s draws), packed as serving packs it:
    `attach_adapters` on the 1-layer decoder `dec` (mixed ranks
    zero-padded, id 0 the zero bank)."""
    from paddle_tpu_torch.serving import make_lora_bank
    dec.attach_adapters([ab for i, r in enumerate(ranks)
                         for ab in make_lora_bank(dec.cfg, 1, rank=r,
                                                  seed=seed + i)])
    return dec.lora["lora_A"][0], dec.lora["lora_B"][0]


def _lora_inputs(cfg, T, dtype, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, N = cfg.hidden_size, 3 * cfg.num_heads * cfg.head_dim
    y = torch.randn((T, h), generator=gen, device="cuda").to(dtype)
    qkv = torch.randn((T, N), generator=gen, device="cuda").to(dtype)
    aids = torch.randint(0, n + 1, (T,), generator=gen, device="cuda",
                         dtype=torch.int32)
    aids[0] = 0
    return y, qkv, aids


def _lora_plain(lora, qkv, y, A, B, aids):
    """The plain version on the card (not counted): qkv + cast(delta),
    and the f32 delta."""
    d = lora._lora_delta_ref(y, A, B, aids)
    return qkv + d.to(qkv.dtype), d


def _lora_bound(aids, h, R, N, itemsize):
    """(bound ms, bound_by) for this run's ids: the ids read; for the rows
    with a nonzero id (an id-0 row is neither read nor written) y read
    and qkv read and written, and each distinct adapter's A and B read
    once; the f32 FMAs of those rows over the f32 CUDA-core peak."""
    ids = aids.tolist()
    live = sum(1 for a in ids if a)
    distinct = len(set(ids) - {0})
    nbytes = (4 * len(ids) + live * (h + 2 * N) * itemsize
              + distinct * (h * R + R * N) * 4)
    flops = 2.0 * live * R * (h + N)
    b_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    f_ms = flops / H100_F32_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def phase_lora_kernel(sd, lora):
    """[lora_kernel]: the per-token LoRA delta kernel against its plain
    version at gpt_1p3b's qkv width (h 2048, N 6144): T 1, 16, a ragged
    mix (516) and 1024; f32 and bf16; 1, 4 and 8 adapters of mixed ranks
    (R 4 and 16); ids including 0. Within f32 1e-5 / one bf16 ulp of the
    plain version, id-0 rows bit-unchanged, each of the first rows of a
    1024-token call bit-equal alone, two launches bit-equal. Then timed at
    decode (T 16, 4 adapters, R 16, bf16) and at a 1024-token chunk:
    eager (CUDA events) and CUDA-graph device ms, beside the plain
    version, two `torch.bmm` over a pre-gathered bank (the library
    yardstick, gather untimed) and the bound. Each bank is packed by
    `attach_adapters`. Returns (max error, the decode shape's timing
    row)."""
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import PagedGPTDecoder
    cfg = gpt_1p3b()
    h, N = cfg.hidden_size, 3 * cfg.num_heads * cfg.head_dim
    packer = PagedGPTDecoder(gpt_1p3b(num_layers=1), sd, num_pages=2,
                             page_size=PS, max_batch=1)
    err = 0.0
    for ci, (T, dtype, n, ranks) in enumerate(LORA_CASES):
        A, B = _lora_bank(packer, ranks, SEED + 10 * ci)
        y, qkv, aids = _lora_inputs(cfg, T, dtype, n, SEED + 100 + ci)
        plain, d32 = _lora_plain(lora, qkv, y, A, B, aids)
        got = qkv.clone()
        lora.lora_delta_(got, y, A, B, aids)
        again = qkv.clone()
        lora.lora_delta_(again, y, A, B, aids)
        torch.cuda.synchronize()
        name = f"lora T{T} {str(dtype)[6:]} n{n} R{max(ranks)}"
        if dtype == torch.float32:
            tol = LORA_TOL * (1.0 + plain.abs())
            if not bool(((got - plain).abs() <= tol).all()):
                raise AssertionError(f"{name}: f32 off the plain version")
        else:
            # the delta alone (a zero qkv) is within one bf16 ulp of the
            # plain f32 delta, and the add rounds at JAX's points:
            # bf16(f32(q) + f32(bf16(delta))) bit for bit
            d16 = torch.zeros_like(qkv)
            lora.lora_delta_(d16, y, A, B, aids)
            _check_close(name + " delta", d16, d32.to(dtype), d32)
            if not _bits_equal(got, (qkv.float() + d16.float()).to(dtype)):
                raise AssertionError(f"{name}: the add's rounding points")
        e = float((got.float() - plain.float()).abs().max())
        err = max(err, e)
        zero = aids == 0
        if not _bits_equal(got[zero], qkv[zero]):
            raise AssertionError(f"{name}: an id-0 row changed")
        if not _bits_equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        alone_ok = True
        if T == 1024:
            for S in (1, 16, 17, 300):
                sub = qkv[:S].clone()
                lora.lora_delta_(sub, y[:S].contiguous(), A, B,
                                 aids[:S].contiguous())
                alone_ok &= _bits_equal(sub, got[:S])
            if not alone_ok:
                raise AssertionError(f"{name}: a token's bits depend on T")
        log("kernel", form="lora_delta", case=repr(name), max_abs_err=f"{e:.3e}",
            zero_rows=int(zero.sum()), bit_equal_alone=alone_ok)
    rows = {}
    for label, T in (("decode", 16), ("chunk", 1024)):
        n, ranks = LORA_N, (LORA_RANK,) * LORA_N
        A, B = _lora_bank(packer, ranks, LORA_SEED)
        y, qkv, _ = _lora_inputs(cfg, T, torch.bfloat16, n, SEED + 8)
        # every id in turn: 0 (skipped rows) and the 4 adapters
        aids = torch.arange(T, device="cuda", dtype=torch.int32) % (n + 1)
        work = qkv.clone()
        ms = cuda_ms(lambda i=0: lora.lora_delta_(work, y, A, B, aids), 200)
        dev_ms = cuda_graph_ms(
            lambda i=0: lora.lora_delta_(work, y, A, B, aids), 200)
        plain_ms = cuda_ms(lambda i=0: _lora_plain(lora, qkv, y, A, B, aids),
                           20)
        Ag, Bg = A[aids.long()], B[aids.long()]          # untimed gather
        y32 = y.float()[:, None, :]

        def bmm(i=0):
            return torch.bmm(torch.bmm(y32, Ag), Bg)
        lib_ms = cuda_ms(bmm, 200)
        lib_dev = cuda_graph_ms(bmm, 200)
        b_ms, by = _lora_bound(aids, h, LORA_RANK, N, 2)
        rows[label] = {"ms": round(ms, 4), "device_ms": round(dev_ms, 4),
                       "plain_ms": round(plain_ms, 4),
                       "bound_ms": round(b_ms, 5), "bound_by": by,
                       "library_ms": round(lib_ms, 4),
                       "library_device_ms": round(lib_dev, 4)}
        log("kernel_time", kernel="lora_delta", shape=label, T=T,
            adapters=n, rank=LORA_RANK, dtype="bf16",
            bound_share=f"{b_ms / dev_ms:.3f}",
            **{k: (f"{v:.4f}" if isinstance(v, float) else v)
               for k, v in rows[label].items()})
    row = dict(rows["decode"])
    row.update({f"chunk_{k}": v for k, v in rows["chunk"].items()
                if k != "bound_by"})
    return err, row


def _launch_counts(mods):
    return {m.__name__.rsplit(".", 1)[1]: (m.kernel_launches,
                                           m.plain_launches) for m in mods}


def _drive(eng, prompts, mods, adapters=None, on_sync=None, **sub_kw):
    """Submit `prompts` (on `adapters`), drain with `on_sync`, the counts
    of every kernel module in `mods` set to 0 just before the run and read
    just after: each must have launched its kernel and never its plain
    version. Returns (streams, wall seconds, counts)."""
    rids = [eng.submit(p, **({"adapter": adapters[i]} if adapters else {}),
                       **sub_kw) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    for m in mods:
        m.reset_counts()
    t0 = time.perf_counter()
    out = eng.run(on_sync=on_sync)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts(mods)
    for name, (k, p) in counts.items():
        if k <= 0 or p:
            raise AssertionError(f"{name}: {k} kernel, {p} plain launches")
    return [out[r] for r in rids], wall, counts


def _audit_hook(findings):
    def hook(e):
        findings.extend(e.audit_pages())
    return hook


def phase_serve_lora(sd, rpa, lora, streams, fields):
    """[serve_lora]: the serving traffic (32 requests, 64-768-token
    prompts, 64 new, k_max 8, max_batch 16) on gpt_1p3b with a bank of 4
    rank-16 adapters (`make_lora_bank(cfg, 4, rank=16, seed=9)`). Every
    request on id 0: streams byte-identical to the no-bank run of
    `[serve]` (`streams`). Requests spread over ids 0-4: each stream
    equal to, or within the oracle rule of, the same request in a
    per-adapter run (one engine a id over the same bank serving only that
    id's requests). Both kernels launch on every run, their plain versions
    never; the page audit (slot_adapters rows included) is empty at every
    sync. Returns the LoRA kernel's launches."""
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder, make_lora_bank)
    cfg = gpt_1p3b()
    rng = np.random.RandomState(SEED)
    lengths = rng.randint(64, 769, N_REQ)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                          max_batch=16)
    dec.attach_adapters(make_lora_bank(cfg, LORA_N, rank=LORA_RANK,
                                       seed=LORA_SEED))
    mods = (rpa, lora)
    warm = ContinuousBatchingEngine(dec, max_new_tokens=4, k_max=K_MAX)
    warm.submit(prompts[0][:64], adapter=1)
    warm.run()
    findings = []

    def engine():
        return ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW,
                                        k_max=K_MAX)
    zero, wall0, counts0 = _drive(engine(), prompts, mods,
                                  on_sync=_audit_hook(findings))
    same0 = sum(a == b for a, b in zip(zero, streams))
    if same0 != len(streams):
        raise AssertionError(f"bank attached, every request on id 0: "
                             f"{same0}/{len(streams)} streams equal the "
                             "no-bank run's")
    aids = [i % (LORA_N + 1) for i in range(N_REQ)]
    mixed, wall, counts = _drive(engine(), prompts, mods, adapters=aids,
                                 on_sync=_audit_hook(findings))
    single = [None] * N_REQ
    for a in range(LORA_N + 1):
        idx = [i for i in range(N_REQ) if aids[i] == a]
        got, _, _ = _drive(engine(), [prompts[i] for i in idx], mods,
                           adapters=[a] * len(idx),
                           on_sync=_audit_hook(findings))
        for i, s in zip(idx, got):
            single[i] = s
    if findings:
        raise AssertionError("serve_lora page audit: " +
                             "; ".join(str(f) for f in findings[:3]))
    if any(len(s) != MAX_NEW for s in mixed):
        raise AssertionError("a LoRA request did not return 64 tokens")
    if len({tuple(mixed[i]) for i in range(N_REQ)}) < N_REQ // 2:
        raise AssertionError("adapter streams collapsed")
    equal, forced, gap = _oracle_rule(dec, prompts, mixed, single, aids=aids)
    distinct = sum(mixed[i] != zero[i] for i in range(N_REQ) if aids[i])
    log("serve_lora", model="gpt_1p3b", adapters=LORA_N, rank=LORA_RANK,
        requests=N_REQ, max_new=MAX_NEW, wall_s=f"{wall:.3f}",
        gen_tok_per_s=f"{N_REQ * MAX_NEW / wall:.1f}",
        id0_gen_tok_per_s=f"{N_REQ * MAX_NEW / wall0:.1f}",
        nobank_gen_tok_per_s=fields["gen_tok_per_s"],
        id0_streams_equal_nobank=f"{same0}/{N_REQ}",
        streams_equal_single_adapter=f"{equal}/{N_REQ}",
        oracle_forced=forced, oracle_gap=f"{gap:.4f}",
        adapted_streams_differing_from_base=f"{distinct}/"
        f"{sum(1 for a in aids if a)}",
        lora_launches=counts["lora_delta"][0],
        lora_launches_id0_run=counts0["lora_delta"][0],
        rpa_launches=counts["ragged_paged_attention"][0],
        plain_launches=0, audit_findings=0)
    return (counts["lora_delta"][0] + counts0["lora_delta"][0],
            counts["ragged_paged_attention"][0]
            + counts0["ragged_paged_attention"][0])


def _tenancy_traffic(vocab):
    """bench.py's run_multi_tenant at gpt_1p3b width: a throughput flood
    (32 x 256-token prompts over adapters 1-4, tenants batch0 / batch1)
    and 8 latency prompts of 384 tokens (tenant chat, ids 0-4 in turn)
    arriving at token-count points spread over the flood's drain."""
    rng = np.random.RandomState(SEED + 31)
    flood = [rng.randint(0, vocab, TEN_FLOOD_LEN).tolist()
             for _ in range(TEN_FLOOD)]
    lat = [rng.randint(0, vocab, TEN_LAT_LEN).tolist()
           for _ in range(TEN_LAT)]
    arrive = [int(TEN_FLOOD * MAX_NEW * (i + 1) / (TEN_LAT + 2))
              for i in range(TEN_LAT)]
    return flood, lat, arrive


def _serve_tenancy(eng, flood, lat, arrive, mods, adapters=True,
                   tenant_kw=True):
    """Drive the tenancy traffic through `eng`: the flood up front, each
    latency prompt submitted at the first sync past its token-count point.
    TTFT of a latency request is read at the host sync that brings its
    first token (the same clock for every engine). Returns (streams by
    rid, wall, counts, latency TTFTs in s, audit findings)."""
    sub_t, ttft, findings = {}, {}, []
    state = {"n": 0}
    lat_rids = []

    def kw(i, slo, tenant):
        d = {}
        if adapters:
            d["adapter"] = (i % LORA_N) + 1 if slo == "throughput" \
                else i % (LORA_N + 1)
        if tenant_kw:
            d.update(tenant=tenant, slo=slo)
        return d

    def on_sync(e):
        findings.extend(e.audit_pages())
        now = time.perf_counter()
        for r in lat_rids:
            if r not in ttft and e._outputs.get(r):
                ttft[r] = now - sub_t[r]
        while state["n"] < len(lat) and \
                e.stats.tokens >= arrive[state["n"]]:
            i = state["n"]
            r = e.submit(lat[i], **kw(i, "latency", "chat"))
            sub_t[r] = time.perf_counter()
            lat_rids.append(r)
            state["n"] += 1
    rids = [eng.submit(p, **kw(i, "throughput", f"batch{i % 2}"))
            for i, p in enumerate(flood)]
    torch.cuda.synchronize()
    for m in mods:
        m.reset_counts()
    t0 = time.perf_counter()
    out = eng.run(on_sync=on_sync)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts(mods)
    for name, (k, p) in counts.items():
        if k <= 0 or p:
            raise AssertionError(f"{name}: {k} kernel, {p} plain launches")
    if state["n"] != len(lat) or len(ttft) != len(lat):
        raise AssertionError("latency arrivals did not all fire and land")
    rids += lat_rids
    return ({r: out[r] for r in rids}, wall, counts,
            [ttft[r] for r in lat_rids], findings)


def phase_tenancy(sd, rpa, lora):
    """[tenancy]: bench.py's run_multi_tenant at gpt_1p3b width (bf16,
    page 16, the 4-adapter bank): the flood of 32 x 256 tokens and 8
    latency arrivals of 384 tokens, 64 new each, max_batch 16, a pool of
    TEN_PAGES that the resident flood fills, a prefix cache; through the
    class-blind `ContinuousBatchingEngine` and the `TenantEngine` (both
    traced). Reports latency TTFT p50/p99, tok/s, preemptions and resumes
    (>= 1 each); every tenant stream equal to the blind engine's (its
    never-preempted twin) or within the oracle rule; the tenant trace's
    chrome export passes the schema check with one pid per tenant; the
    audit is empty at every sync. JAX's bar (latency TTFT p99 >= 2x
    better at >= 0.85x the tok/s) is a reading. Returns (LoRA kernel
    launches, ragged kernel launches)."""
    import os
    import shutil as _sh
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder, PrefixCache,
                                          TenantEngine, export_chrome_trace,
                                          make_lora_bank,
                                          validate_chrome_trace)
    cfg = gpt_1p3b()
    flood, lat, arrive = _tenancy_traffic(cfg.vocab_size)
    dec = PagedGPTDecoder(cfg, sd, num_pages=TEN_PAGES, page_size=PS,
                          max_batch=TEN_BATCH)
    dec.attach_adapters(make_lora_bank(cfg, LORA_N, rank=LORA_RANK,
                                       seed=LORA_SEED))
    mods = (rpa, lora)
    runs = {}
    for label in ("blind", "tenant"):
        cache = PrefixCache(PS, salt=dec.cache_fingerprint())
        if label == "blind":
            eng = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW,
                                           k_max=K_MAX, prefix_cache=cache,
                                           trace=True)
        else:
            eng = TenantEngine(dec, max_new_tokens=MAX_NEW, k_max=K_MAX,
                               prefix_cache=cache, trace=True)
        out, wall, counts, ttft, findings = _serve_tenancy(
            eng, flood, lat, arrive, mods, tenant_kw=label == "tenant")
        if findings:
            raise AssertionError(f"tenancy {label} audit: {findings[0]}")
        runs[label] = dict(out=out, wall=wall, counts=counts, ttft=ttft,
                           eng=eng)
    t = runs["tenant"]["eng"]
    if t.stats.preemptions < 1 or t.stats.resumes < 1:
        raise AssertionError(f"tenancy: {t.stats.preemptions} preemptions, "
                             f"{t.stats.resumes} resumes (need >= 1 each)")
    preempted = sorted({ev["rid"] for ev in t.trace.events
                        if ev["kind"] == "preempt"})
    rids = sorted(runs["blind"]["out"])
    prompts = flood + lat
    aids = [(i % LORA_N) + 1 for i in range(TEN_FLOOD)] + \
        [i % (LORA_N + 1) for i in range(TEN_LAT)]
    got = [runs["tenant"]["out"][r] for r in rids]
    ref = [runs["blind"]["out"][r] for r in rids]
    here = os.path.dirname(os.path.abspath(__file__))
    tdir = os.path.join(here, TRACE_DIR)
    os.makedirs(tdir, exist_ok=True)
    path = export_chrome_trace(os.path.join(tdir, "tenancy.json"), t.trace)
    problems = validate_chrome_trace(path)
    with open(path) as f:
        names = [e["args"]["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"]
    _sh.rmtree(tdir, ignore_errors=True)
    tenants = sorted(n.split("tenant=")[1] for n in names if "tenant=" in n)
    if problems or tenants != ["batch0", "batch1", "chat"]:
        raise AssertionError(f"tenancy trace: {problems[:3]}, {tenants}")
    equal, forced, gap = _oracle_rule(dec, prompts, got, ref, aids=aids)
    pre_equal = sum(got[r] == ref[r] for r in preempted)
    reading = {}
    for label, r in runs.items():
        tt = np.asarray(r["ttft"]) * 1e3
        reading[label] = (float(np.percentile(tt, 50)),
                          float(np.percentile(tt, 99)),
                          (TEN_FLOOD + TEN_LAT) * MAX_NEW / r["wall"])
        log("tenancy", engine=label, wall_s=f"{r['wall']:.3f}",
            gen_tok_per_s=f"{reading[label][2]:.1f}",
            latency_ttft_p50_ms=f"{reading[label][0]:.1f}",
            latency_ttft_p99_ms=f"{reading[label][1]:.1f}",
            preemptions=r["eng"].stats.preemptions,
            resumes=r["eng"].stats.resumes,
            lora_launches=r["counts"]["lora_delta"][0],
            rpa_launches=r["counts"]["ragged_paged_attention"][0])
    b, tn = reading["blind"], reading["tenant"]
    summ = t.tenancy_summary()
    log("tenancy_summary", pool_pages=TEN_PAGES, streams_equal_blind=
        f"{equal}/{len(rids)}", oracle_forced=forced,
        oracle_gap=f"{gap:.4f}", preempted_rids=len(preempted),
        preempted_equal_twin=f"{pre_equal}/{len(preempted)}",
        ttft_p99_ratio_blind_over_tenant=f"{b[1] / tn[1]:.2f}",
        tok_per_s_ratio_tenant_over_blind=f"{tn[2] / b[2]:.3f}",
        jax_bar_ttft_2x="met" if b[1] >= 2 * tn[1] else "missed",
        jax_bar_tok_085x="met" if tn[2] >= 0.85 * b[2] else "missed",
        fairness_jain=summ["fairness_jain"],
        latency_target_ms=summ["classes"]["latency"]["roofline_target_ms"],
        k_latency=t.scheduler.k_latency, trace_tenant_pids=len(tenants))
    return (sum(r["counts"]["lora_delta"][0] for r in runs.values()),
            sum(r["counts"]["ragged_paged_attention"][0]
                for r in runs.values()))


class _PoolSpy:
    """Stands in for the decoder module's `rpa`: passes every call to the
    kernel's wrappers and counts the calls by the pool layout they read
    (bf16, int8, int4)."""

    def __init__(self, rpa):
        self.rpa, self.calls = rpa, {}

    def _note(self, kp):
        lay = "bf16" if not isinstance(kp, tuple) else (
            "int4" if kp[0].dtype == torch.uint8 else "int8")
        self.calls[lay] = self.calls.get(lay, 0) + 1

    def ragged_paged_attention(self, q, kp, vp, *args):
        self._note(kp)
        return self.rpa.ragged_paged_attention(q, kp, vp, *args)

    def ragged_paged_attention_packed(self, q, kp, vp, *args):
        self._note(kp)
        return self.rpa.ragged_paged_attention_packed(q, kp, vp, *args)


def phase_precision_routed(sd, rpa):
    """[precision_routed]: the tenancy traffic (no adapters) through
    `PrecisionRoutedEngine(kv_precision={"latency": "int8", "throughput":
    "int4"})`: class_capacity(), the int8 and int4 branches of the ragged
    kernel launched (counted by the pool they read), each class's streams
    equal to, or within the oracle rule of, a single-precision
    TenantEngine of that class's pool serving that class's requests under
    the same rids. Returns the ragged kernel's calls by pool layout."""
    import paddle_tpu_torch.serving.decoder as decoder_module
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import (PagedGPTDecoder,
                                          PrecisionRoutedEngine, PrefixCache,
                                          TenantEngine)
    cfg = gpt_1p3b()
    flood, lat, arrive = _tenancy_traffic(cfg.vocab_size)
    prec = {"latency": "int8", "throughput": "int4"}
    eng = PrecisionRoutedEngine(cfg, sd, kv_precision=prec,
                                max_new_tokens=MAX_NEW, num_pages=TEN_PAGES,
                                page_size=PS, max_batch=TEN_BATCH,
                                k_max=K_MAX)
    cap = eng.class_capacity()
    for slo, row in cap.items():
        log("precision_routed_capacity", slo=slo, **row)
    spy = _PoolSpy(rpa)
    state = {"n": 0}
    lat_rids = []

    def on_sync(router, e):
        while state["n"] < len(lat) and \
                sum(x.stats.tokens for x in router._unique_engines()) >= \
                arrive[state["n"]]:
            lat_rids.append(router.submit(lat[state["n"]], tenant="chat",
                                          slo="latency"))
            state["n"] += 1
    rids = [eng.submit(p, tenant=f"batch{i % 2}") for i, p in
            enumerate(flood)]
    torch.cuda.synchronize()
    rpa.reset_counts()
    decoder_module.rpa = spy
    try:
        t0 = time.perf_counter()
        out = eng.run(on_sync=on_sync)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        decoder_module.rpa = rpa
    launches = rpa.kernel_launches
    if rpa.plain_launches or not spy.calls.get("int8") or \
            not spy.calls.get("int4") or spy.calls.get("bf16"):
        raise AssertionError(f"precision routed launches: {spy.calls}, "
                             f"plain {rpa.plain_launches}")
    if state["n"] != len(lat):
        raise AssertionError("latency arrivals did not all fire")
    summ = eng.tenancy_summary()
    del eng
    torch.cuda.empty_cache()
    checks = {}
    for slo, quant, idx_rids, prompts in (
            ("latency", "int8", lat_rids, lat),
            ("throughput", "int4", rids, flood)):
        dec = PagedGPTDecoder(cfg, sd, num_pages=TEN_PAGES, page_size=PS,
                              max_batch=TEN_BATCH, kv_quant=quant)
        twin = TenantEngine(dec, max_new_tokens=MAX_NEW, k_max=K_MAX,
                            prefix_cache=PrefixCache(
                                PS, salt=dec.cache_fingerprint()))
        for r, p in zip(idx_rids, prompts):
            twin._next_id = r
            twin.submit(p, slo=slo)
        twin_out = twin.run()
        got = [out[r] for r in idx_rids]
        ref = [twin_out[r] for r in idx_rids]
        checks[slo] = _oracle_rule(dec, prompts, got, ref)
        del dec, twin
        torch.cuda.empty_cache()
    log("precision_routed", wall_s=f"{wall:.3f}",
        gen_tok_per_s=f"{(TEN_FLOOD + TEN_LAT) * MAX_NEW / wall:.1f}",
        int8_calls=spy.calls["int8"], int4_calls=spy.calls["int4"],
        rpa_launches=launches, plain_launches=0,
        latency_equal_twin=f"{checks['latency'][0]}/{TEN_LAT}",
        throughput_equal_twin=f"{checks['throughput'][0]}/{TEN_FLOOD}",
        oracle_forced=checks["latency"][1] + checks["throughput"][1],
        oracle_gap=f"{max(checks['latency'][2], checks['throughput'][2]):.4f}",
        latency_ttft_p99_ms=summ["classes"]["latency"].get("ttft_p99_ms"),
        throughput_ttft_p99_ms=summ["classes"]["throughput"].get(
            "ttft_p99_ms"))
    return spy.calls


def _fleet_wave(vocab, wave):
    """One wave of the fleet traffic (bench.py's run_fleet: every request
    of the throughput class): 48 requests, each a Zipf(0.7) pick of 8
    fixed 512-token templates plus a fresh 64-token suffix; tenants t0 /
    t1."""
    t_rng = np.random.RandomState(SEED + 41)
    templates = [t_rng.randint(0, vocab, FLEET_TEMPLATE_LEN).tolist()
                 for _ in range(FLEET_TEMPLATES)]
    p = 1.0 / np.arange(1, FLEET_TEMPLATES + 1) ** FLEET_ZIPF
    rng = np.random.RandomState(SEED + 50 + wave)
    picks = rng.choice(FLEET_TEMPLATES, FLEET_REQ, p=p / p.sum())
    reqs = []
    for i, t in enumerate(picks):
        reqs.append((templates[t] +
                     rng.randint(0, vocab, FLEET_SUFFIX).tolist(),
                     "throughput", f"t{i % 2}"))
    return reqs


def _fleet_engine(cfg, sd, tier_dir, trace=False):
    from paddle_tpu_torch.serving import (PagedGPTDecoder, PrefixCache,
                                          SharedHostKVTier, TenantEngine)
    dec = PagedGPTDecoder(cfg, sd, num_pages=FLEET_PAGES, page_size=PS,
                          max_batch=FLEET_BATCH)
    tier = SharedHostKVTier(tier_dir, capacity_bytes=FLEET_TIER_BYTES,
                            fingerprint=dec)
    cache = PrefixCache(PS, salt=dec.cache_fingerprint(), tier=tier)
    return TenantEngine(dec, max_new_tokens=MAX_NEW, k_max=K_MAX,
                        prefix_cache=cache, tier_policy="restore",
                        trace=trace or None)


def _fleet_run_wave(router, reqs, parallel):
    """Submit one wave, drain it; returns (streams in submission order,
    wall seconds, the wave's block hit rate, its block hits)."""
    before = router.merged_stats()
    gids = [router.submit(p, tenant=t, slo=s) for p, s, t in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = router.run(parallel=parallel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = router.merged_stats()
    hits = after.prefix_hits - before.prefix_hits
    misses = after.prefix_misses - before.prefix_misses
    return [out[g] for g in gids], wall, hits / max(hits + misses, 1), hits


def _fleet_respawn(cfg, sd, router, tier_dir, root):
    """The respawn check of the 1-replica fleet after its waves. The
    shared tier is copied as it stands at the kill; the next wave then
    runs from that state three times: through the replica that was never
    killed (the reference), through a fresh replica respawned over the
    copy (the warm start) and through one respawned over an empty tier
    (the cold start). A killed replica spills nothing, so the warm start
    loses exactly the blocks that only the dead replica's pool held: a
    request can miss its chain from the first such block on, and every
    other block the reference hit is in the tier. So the warm start must
    hit at least the reference's hits less those chain tails, beat the
    cold start, restore, and recompute no restored span. Returns the
    readings for the log."""
    import os
    import shutil as _sh
    eng = router.engines[0]
    snap = os.path.join(root, "respawn_tier")
    _sh.copytree(tier_dir, snap)
    pool_only = {k for k in eng.cache._entries if k not in eng.tier}
    wave = _fleet_wave(cfg.vocab_size, FLEET_WAVES)
    tails = 0
    for p, _, _ in wave:
        keys = eng.cache.block_keys(p)
        tails += len(keys) - next(
            (i for i, k in enumerate(keys) if k in pool_only), len(keys))
    _, _, ref, ref_hits = _fleet_run_wave(router, wave, False)
    router.respawn(0, _fleet_engine(cfg, sd, snap))
    _, wall, post, post_hits = _fleet_run_wave(router, wave, False)
    rs = router.engines[0].stats
    router.respawn(0, _fleet_engine(cfg, sd, os.path.join(root, "cold")))
    _, _, cold, _ = _fleet_run_wave(router, wave, False)
    readings = dict(respawn_hit_rate=f"{post:.4f}",
                    never_killed_hit_rate=f"{ref:.4f}",
                    cold_respawn_hit_rate=f"{cold:.4f}",
                    respawn_hits=post_hits, never_killed_hits=ref_hits,
                    pool_only_blocks=len(pool_only),
                    pool_only_chain_tails=tails,
                    respawn_restores=rs.tier_restores,
                    respawn_recomputes=rs.tier_recomputes,
                    respawn_wall_s=f"{wall:.3f}")
    if post_hits < ref_hits - tails or post <= cold or \
            rs.tier_restores < 1 or rs.tier_recomputes:
        raise AssertionError(f"respawn: {readings}")
    return readings


def phase_fleet(sd, rpa):
    """[fleet]: bench.py's run_fleet at gpt_1p3b width (FLEET_LAYERS of its
    layers): 8 templates of 512 tokens (Zipf 0.7), 64-token suffixes, 64
    new, 48 requests a wave, 3 waves (cut from 5) with the last one timed;
    replicas of max_batch 8
    over a pool of FLEET_PAGES (one replica's cliff: the 1-replica fleet
    spills to the shared tier and restores), `tier_policy="restore"`, the
    store under the checkout. Fleets of 1 replica, 3 round-robin and 3 on
    threads; streams equal across them or within the oracle rule; the
    1-replica fleet restores at least once; a respawned replica 0 of the
    1-replica fleet warm-starts from the shared tier (`_fleet_respawn`:
    its hit rate on the next wave held to the never-killed replica's on
    that wave); the traced 3-replica
    export passes the schema check with disjoint pids per (replica,
    tenant). Returns the ragged kernel's launches."""
    import os
    import shutil as _sh
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import FleetRouter, validate_chrome_trace
    cfg = gpt_1p3b(num_layers=FLEET_LAYERS)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, FLEET_DIR)
    _sh.rmtree(root, ignore_errors=True)
    waves = [_fleet_wave(cfg.vocab_size, w) for w in range(FLEET_WAVES)]
    streams, launches = {}, 0
    for label, n, parallel in (("1", 1, False), ("3_sequential", 3, False),
                               ("3_parallel", 3, True)):
        tier_dir = os.path.join(root, label)
        router = FleetRouter([_fleet_engine(cfg, sd, tier_dir,
                                            trace=label == "3_sequential")
                              for _ in range(n)], affinity_blocks=2)
        rpa.reset_counts()
        got, walls, rates = [], [], []
        for reqs in waves:
            s, wall, rate, _ = _fleet_run_wave(router, reqs, parallel)
            got.append(s)
            walls.append(wall)
            rates.append(rate)
        if rpa.kernel_launches <= 0 or rpa.plain_launches:
            raise AssertionError(f"fleet {label}: {rpa.kernel_launches} "
                                 f"kernel, {rpa.plain_launches} plain")
        launches += rpa.kernel_launches
        st = router.merged_stats()
        tier = router.engines[0].tier
        findings = [f for e in router.engines for f in e.audit_pages()]
        if findings:
            raise AssertionError(f"fleet {label} audit: {findings[0]}")
        extra = {}
        if label == "1":
            if st.tier_restores < 1:
                raise AssertionError("the 1-replica fleet never restored")
            extra = _fleet_respawn(cfg, sd, router, tier_dir, root)
        if label == "3_sequential":
            path = os.path.join(root, "fleet_trace.json")
            router.export_trace(path)
            problems = validate_chrome_trace(path)
            with open(path) as f:
                pids = {}
                for e in json.load(f)["traceEvents"]:
                    if e.get("ph") == "M" and e.get("name") == "process_name":
                        rep = e["args"]["name"].split(" ")[0]
                        pids.setdefault(rep, set()).add(e["pid"])
            disjoint = all(not (pids[a] & pids[b]) for a in pids
                           for b in pids if a < b)
            if problems or len(pids) != FLEET_REPLICAS or not disjoint:
                raise AssertionError(f"fleet trace: {problems[:3]}, {pids}")
            extra = dict(trace_pid_blocks=len(pids),
                         trace_pids=sum(len(v) for v in pids.values()))
        streams[label] = [s for w in got for s in w]
        log("fleet", replicas=n, parallel=parallel, layers=cfg.num_layers,
            wave_walls_s=",".join(f"{w:.2f}" for w in walls),
            gen_tok_per_s=f"{FLEET_REQ * MAX_NEW / walls[-1]:.1f}",
            hit_rates=",".join(f"{r:.3f}" for r in rates),
            tier_spills=st.tier_spills, tier_restores=st.tier_restores,
            tier_recomputes=st.tier_recomputes,
            shared_tier_entries=tier.n_entries,
            shared_tier_MB=f"{tier.bytes_used / 1e6:.1f}",
            rpa_launches=rpa.kernel_launches, **extra)
        if label != "3_parallel":
            del router
            torch.cuda.empty_cache()
    prompts = [p for w in waves for p, _, _ in w]
    dec = router.engines[0].d
    for label in ("3_sequential", "3_parallel"):
        equal, forced, gap = _oracle_rule(dec, prompts, streams[label],
                                          streams["1"])
        log("fleet_streams", fleet=label, equal_1_replica=
            f"{equal}/{len(prompts)}", oracle_forced=forced,
            oracle_gap=f"{gap:.4f}")
    del router
    _sh.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- slice 19
# Int8 inference: the A8W8 kernels (row quantize, int8 GEMM), a8w8 serving
# of gpt_1p3b, and paddle.quantization on gpt_1p3b: quantize_model (int8
# and int4 weights), PTQ and QAT.

H100_INT8_OPS = 1979e12             # data sheet, int8 dense tensor cores
# gpt_1p3b's four products a layer: (name, K, N)
A8_PRODUCTS = (("qkv", 2048, 6144), ("proj", 2048, 2048),
               ("fc1", 2048, 8192), ("fc2", 8192, 2048))
A8_DECODE_T, A8_CHUNK_T = 16, 1024
# rows whose bits must not depend on the call's row count
A8_ROWS = (1, 16, 17, 1024)
A8_ITERS = 50
# quantize_model / PTQ / QAT: batch 4 x 1024 of gpt_1p3b (all 24 layers)
QM_B, QM_L = 4, 1024
PTQ_CALIB = 4
QAT_STEPS = 3


def _ptxas_a8w8():
    """Registers and spill stores of each a8w8 body from nvcc's log; raises
    if an instantiation is missing (3 dtypes x 2 modes or orders)."""
    from paddle_tpu_torch.ops import _build
    text = _build.build_logs.get("a8w8_matmul")
    if text is None:
        log("ptxas_a8w8", checked=False,
            reason="library built before this run")
        return "not measured (library built before this run)"
    entries = _ptxas_entries(text)
    summary = []
    for body in ("a8w8_quantize_rows_kernel<", "a8w8_gemm_decode_kernel<",
                 "a8w8_gemm_tile_kernel<"):
        got = [(_ptxas_number(r"Used (\d+) registers", regs),
                _ptxas_number(r"(\d+) bytes spill stores", spill))
               for fn, regs, spill in entries if fn and fn.startswith(body)]
        if len(got) != 6:
            raise RuntimeError(f"ptxas: {body}...> has {len(got)} of its 6 "
                               "instantiations")
        regs = f"{min(r for r, _ in got)}-{max(r for r, _ in got)}"
        spill = max(b for _, b in got)
        log("ptxas_a8w8", kernel=body.rstrip("<"), instantiations=len(got),
            registers=regs, spill_store_bytes=spill)
        summary.append(f"{body.rstrip('<')} {regs} regs, {spill} B spill")
    return "; ".join(summary)


def _a8_rows(gen, T, K, dtype):
    """x [T, K] on the card: row 0 zero, row 1 with an exact multiple of
    127 as its absmax (every element on the grid, the extremes +-127),
    row 2 with exact halves of a step."""
    x = torch.randn((T, K), generator=gen, device="cuda")
    if T > 2:
        x[0] = 0
        x[1] = (torch.arange(K, device="cuda") % 255 - 127).float()
        x[2] = torch.randint(-254, 255, (K,), generator=gen,
                             device="cuda").float() / 2
        x[2, 0] = 127.0
    return x.to(dtype)


def _a8_weight(gen, K, N):
    """A quantized gpt_1p3b-like weight: K-contiguous int8 [N, K] and its
    f32 scales, from N(0, 0.02) through `quantize_weight`."""
    from paddle_tpu_torch.quantization import quantize_weight
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
    q, s = quantize_weight(w, axis=0)
    return q.t().contiguous(), s.reshape(-1)


def _a8_bound(T, K, N, itemsize, bias_itemsize):
    """(quantize bound ms, GEMM bound ms, GEMM bound_by): the quantize
    reads x once and writes xq and sx; the GEMM reads xq, the int8 weight,
    sx, sw and b once and writes the output, and does 2 T N K int8
    operations at the dense int8 peak; the bound is the larger time."""
    q_bytes = T * K * (itemsize + 1) + 4 * T
    g_bytes = T * K + N * K + 4 * T + 4 * N + N * bias_itemsize \
        + T * N * itemsize
    b_ms = g_bytes / H100_HBM_BYTES_PER_S * 1e3
    o_ms = 2.0 * T * N * K / H100_INT8_OPS * 1e3
    return (q_bytes / H100_HBM_BYTES_PER_S * 1e3, max(b_ms, o_ms),
            "bytes" if b_ms >= o_ms else "operations")


def phase_a8w8_kernel(a8):
    """[a8w8_kernel]: the row quantize and the int8 GEMM against their
    plain versions at gpt_1p3b's four products, T 1024: dynamic and static
    scales, both epilogue orders, f32 / bf16 / f16 x, an f32, bf16 or no
    bias; bits equal; the first T rows (T in A8_ROWS) of a 1024-row call
    bit-equal alone (a row's bits do not depend on T; T <= 16 runs the
    decode body, T > 16 the tile body); two launches bit-equal; an odd
    shape (K 40, N 130, T 300: the byte-wise loads). Then times at the
    decode shape (T 16) and at a 1024-row chunk: eager (CUDA events),
    device (CUDA-graph replay), the plain versions, `torch._int_mm` on the
    same int8 operands (its int32 product only; it needs M > 16, so the
    decode rows are padded to 32), and the bound. Returns (max error
    {kernel: 0.0}, timing {kernel: fields}, ptxas summary)."""
    from paddle_tpu_torch.quantization import quantize_weight
    from paddle_tpu_torch.serving import decoder as sdec
    ptxas = _ptxas_a8w8()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the plain quantizers on the card divide as on the CPU (and in JAX):
    # a CUDA division by a Python scalar would multiply by its reciprocal
    w = torch.randn((2048, 2048), generator=gen, device="cuda") * 0.02
    kv = torch.randn((1024, 16, 128), generator=gen, device="cuda")
    same = {
        "quantize_weight": all(
            _bits_equal(a.cpu(), b) for bits in (8, 4) for a, b in zip(
                quantize_weight(w, bits=bits),
                quantize_weight(w.cpu(), bits=bits))),
        "quantize_kv": all(
            _bits_equal(a.cpu(), b) for fn in (sdec._quantize_kv,
                                               sdec._quantize_kv_int4)
            for a, b in zip(fn(kv), fn(kv.cpu()))),
        "quantize_rows_plain": all(
            _bits_equal(a.cpu(), b) for a, b in zip(
                a8._quantize_rows_ref(w), a8._quantize_rows_ref(w.cpu())))}
    log("kernel", form="a8w8_plain_division",
        **{f"{k}_card_equals_cpu": v for k, v in same.items()})
    if not all(same.values()):
        raise AssertionError(f"a plain quantizer's bits differ between the "
                             f"card and the CPU: {same}")
    checked = 0
    cases = [(name, K, N, dt) for name, K, N in A8_PRODUCTS
             for dt in (torch.float32, torch.bfloat16, torch.float16)]
    cases.append(("odd", 40, 130, torch.bfloat16))
    for name, K, N, dt in cases:
        T = A8_CHUNK_T if name != "odd" else 300
        x = _a8_rows(gen, T, K, dt)
        wt, sw = _a8_weight(gen, K, N)
        b = {torch.float32: torch.randn(N, generator=gen, device="cuda"),
             torch.bfloat16: torch.randn(N, generator=gen, device="cuda")
             .bfloat16(), torch.float16: None}[dt]
        static = torch.tensor(float(x.float().abs().max()) / 200.0,
                              device="cuda")     # saturates some rows
        for sx_in in (None, static):
            xq, sx = a8.quantize_rows(x, sx_in)
            pq, psx = a8._quantize_rows_ref(x, sx_in)
            if not (_bits_equal(xq, pq) and _bits_equal(sx, psx)):
                raise AssertionError(f"a8w8 quantize {name} {dt} "
                                     f"static={sx_in is not None}: bits "
                                     "differ from the plain version")
            if sx_in is None and T > 2 and not (
                    bool((xq[0] == 0).all())
                    and int(xq[1].abs().max()) == 127):
                raise AssertionError("zero / +-127 rows quantized wrongly")
            for order in (a8.DECODER, a8.PTQ):
                got = a8.a8w8_matmul(xq, sx, wt, sw, b, order, dt)
                want = a8._a8w8_ref(xq, sx, wt, sw, b, order, dt)
                again = a8.a8w8_matmul(xq, sx, wt, sw, b, order, dt)
                if not (_bits_equal(got, want) and _bits_equal(got, again)):
                    raise AssertionError(
                        f"a8w8 GEMM {name} {dt} order {order}: bits differ "
                        f"(max {float((got.float() - want.float()).abs().max())})")
                checked += 1
            rows_equal = []
            full = a8.a8w8_matmul(xq, sx, wt, sw, b, a8.DECODER, dt)
            for t in (A8_ROWS if name != "odd" else (1, 17)):
                q1, s1 = a8.quantize_rows(x[:t].contiguous(), sx_in)
                part = a8.a8w8_matmul(q1, s1, wt, sw, b, a8.DECODER, dt)
                rows_equal.append(_bits_equal(q1, xq[:t])
                                  and _bits_equal(part, full[:t]))
            if not all(rows_equal):
                raise AssertionError(f"a8w8 {name} {dt}: a row's bits "
                                     f"depend on T ({rows_equal})")
        log("kernel", form="a8w8", product=name, T=T, K=K, N=N,
            dtype=str(dt).split(".")[1],
            bias=None if b is None else str(b.dtype).split(".")[1],
            quantize_bits_equal=True, gemm_bits_equal=True,
            orders="decoder,ptq", scales="dynamic,static",
            rows_bit_equal_alone=",".join(map(str, A8_ROWS if name != "odd"
                                               else (1, 17))))
    log("kernel", form="a8w8_summary", cases=checked,
        routes=dict(sorted(a8.branch_launches.items())))

    timing = {"a8w8_quantize_rows": {}, "a8w8_gemm": {}}
    tot = {k: [0.0] * 6 for k in timing}
    by_ms = {"bytes": 0.0, "operations": 0.0}   # the decode bound's parts
    for T in (A8_DECODE_T, A8_CHUNK_T):
        for name, K, N in A8_PRODUCTS:
            dt = torch.bfloat16
            x = _a8_rows(gen, T, K, dt)
            wt, sw = _a8_weight(gen, K, N)
            b = torch.randn(N, generator=gen, device="cuda").bfloat16()
            xq, sx = a8.quantize_rows(x)
            q_bound, g_bound, g_by = _a8_bound(T, K, N, 2, 2)
            q_ms = cuda_ms(lambda i=0: a8.quantize_rows(x), A8_ITERS)
            q_dev = cuda_graph_ms(lambda i=0: a8.quantize_rows(x), A8_ITERS)
            q_plain = cuda_ms(lambda i=0: a8._quantize_rows_ref(x), 10)
            g_ms = cuda_ms(lambda i=0: a8.a8w8_matmul(
                xq, sx, wt, sw, b, a8.DECODER, dt), A8_ITERS)
            g_dev = cuda_graph_ms(lambda i=0: a8.a8w8_matmul(
                xq, sx, wt, sw, b, a8.DECODER, dt), A8_ITERS)
            g_plain = cuda_ms(lambda i=0: a8._a8w8_ref(
                xq, sx, wt, sw, b, a8.DECODER, dt), 5)
            pad = max(T, 32)
            xp = torch.zeros((pad, K), dtype=torch.int8, device="cuda")
            xp[:T] = xq
            wk = wt.t()                      # [K, N], column-major
            lib_ms = cuda_ms(lambda i=0: torch._int_mm(xp, wk), A8_ITERS)
            lib_dev = cuda_graph_ms(lambda i=0: torch._int_mm(xp, wk),
                                    A8_ITERS)
            log("kernel_time", kernel="a8w8", product=name, T=T, K=K, N=N,
                dtype="bfloat16", quantize_ms=f"{q_ms:.4f}",
                quantize_device_ms=f"{q_dev:.4f}",
                quantize_plain_ms=f"{q_plain:.4f}",
                quantize_bound_ms=f"{q_bound:.5f}",
                gemm_ms=f"{g_ms:.4f}", gemm_device_ms=f"{g_dev:.4f}",
                gemm_plain_ms=f"{g_plain:.4f}",
                gemm_bound_ms=f"{g_bound:.5f}", gemm_bound_by=g_by,
                int_mm_ms=f"{lib_ms:.4f}", int_mm_device_ms=f"{lib_dev:.4f}",
                int_mm_rows=pad,
                gemm_share_of_bound=f"{g_bound / g_dev:.3f}",
                route=("decode" if T <= 16 else "tile"))
            if T == A8_DECODE_T:
                by_ms[g_by] += g_bound
                for k, vals in (("a8w8_quantize_rows",
                                 (q_ms, q_dev, q_plain, q_bound, None,
                                  None)),
                                ("a8w8_gemm",
                                 (g_ms, g_dev, g_plain, g_bound, lib_ms,
                                  lib_dev))):
                    tot[k] = [a + (v or 0.0) for a, v in zip(tot[k], vals)]
            else:
                timing["a8w8_quantize_rows"][f"chunk_{name}_device_ms"] = \
                    round(q_dev, 4)
                timing["a8w8_gemm"][f"chunk_{name}_ms"] = round(g_ms, 4)
                timing["a8w8_gemm"][f"chunk_{name}_device_ms"] = \
                    round(g_dev, 4)
                timing["a8w8_gemm"][f"chunk_{name}_bound_ms"] = \
                    round(g_bound, 6)
                timing["a8w8_gemm"][f"chunk_{name}_int_mm_ms"] = \
                    round(lib_ms, 4)
    # the JSON line: one layer's four products at the decode shape
    for k, by, lib in (("a8w8_quantize_rows", "bytes", False),
                       ("a8w8_gemm", max(by_ms, key=by_ms.get), True)):
        ms, dev, plain, bound, lms, ldev = tot[k]
        timing[k].update({
            "ms": round(ms, 4), "device_ms": round(dev, 4),
            "plain_ms": round(plain, 4), "bound_ms": round(bound, 6),
            "bound_by": by, "library_ms": round(lms, 4) if lib else None,
            **({"library_device_ms": round(ldev, 4),
                "library": "torch._int_mm, rows padded to 32"}
               if lib else {}),
            "shape": "one gpt_1p3b layer's 4 products at T 16, bf16"})
    err = {"a8w8_quantize_rows": 0.0, "a8w8_gemm": 0.0}
    return err, timing, ptxas


def phase_serve_a8w8(sd, prompts, ref_streams, nll_bf16, rpa, a8):
    """[serve_a8w8]: the serving configuration with quant="a8w8" (int8
    weights, dynamic int8 activations) on the bf16 pool, the bf16 run's
    traffic. tok/s, TTFT, per-token latency, launches a tick, peak memory;
    the streams that equal the bf16 run's, and the streams that equal the
    per-tick engine's under a8w8 (all 32); the 4 oracle requests
    teacher-forced on the per-tick decoder (LOGIT_TOL); and the NLL of the
    bf16 run's streams against the bf16 decoder's (reported, not gated:
    the weights are random). Returns the a8w8 kernels' launches."""
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder)
    cfg = gpt_1p3b()
    t0 = time.perf_counter()
    dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                          max_batch=16, quant="a8w8")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng, streams, wall, counts = _serve_run(dec, prompts, (rpa, a8))
    quant, gemm = a8.quantize_launches, a8.gemm_launches
    routes = dict(sorted(a8.branch_launches.items()))
    plain = counts["ragged_paged_attention"][1] + counts["a8w8_matmul"][1]
    # four products a layer, each one quantize and one GEMM
    if gemm <= 0 or quant != gemm or plain or \
            gemm % (4 * cfg.num_layers) or \
            counts["ragged_paged_attention"][0] * 4 != gemm:
        raise AssertionError(f"a8w8 launches on the card: quantize {quant}, "
                             f"GEMM {gemm}, {counts}")
    ticks = eng.stats.ticks
    log("serve_a8w8", model="gpt_1p3b", layers=cfg.num_layers,
        hidden=cfg.hidden_size, requests=N_REQ, max_new=MAX_NEW,
        max_batch=16, k_max=K_MAX, setup_s=f"{setup_s:.2f}",
        **_serve_fields(eng, wall),
        a8w8_quantize_launches=quant, a8w8_gemm_launches=gemm, **routes,
        a8w8_launches_per_tick=f"{(quant + gemm) / ticks:.1f}",
        rpa_launches=counts["ragged_paged_attention"][0],
        plain_launches=plain,
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        weight_bytes_per_tick=dec.step_hbm_bytes(avg_ctx=0))
    phase_profile(dec, prompts, mode="a8w8")
    same_bf16 = sum(a == b for a, b in zip(streams, ref_streams))
    per_tick = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW, k_max=1)
    rids = [per_tick.submit(p) for p in prompts]
    out = per_tick.run()
    same_tick = sum(out[r] == s for r, s in zip(rids, streams))
    gap, _ = _teacher_force(dec, prompts[:N_ORACLE], streams[:N_ORACLE])
    if gap > LOGIT_TOL:
        raise AssertionError(f"an a8w8 engine token scores {gap:.4f} below "
                             f"the per-tick best logit (tolerance "
                             f"{LOGIT_TOL})")
    _, nll = _teacher_force(dec, prompts[:N_ORACLE],
                            ref_streams[:N_ORACLE])
    log("serve_a8w8_oracle", streams_equal_bf16=f"{same_bf16}/{N_REQ}",
        streams_equal_per_tick=f"{same_tick}/{N_REQ}",
        max_logit_gap=f"{gap:.5f}", tolerance=LOGIT_TOL,
        nll_of_bf16_streams=f"{nll:.5f}", nll_bf16=f"{nll_bf16:.5f}",
        nll_delta=f"{nll - nll_bf16:.5f}",
        nll_gate="none (random weights: reported only)")
    del dec, eng, per_tick
    torch.cuda.empty_cache()
    return quant, gemm


def _qm_model(cfg):
    from paddle_tpu_torch.models import GPT
    return GPT(cfg, device="cuda", seed=SEED).bfloat16().eval()


def _qm_batch(cfg, seed):
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                              (QM_B, QM_L + 1))
    return (torch.from_numpy(ids[:, :-1]).cuda(),
            torch.from_numpy(ids[:, 1:]).cuda())


def _qm_eval(model, ids, labels, reps=3):
    """(f32 logits, mean NLL, eval ms a forward) of a no-grad forward at
    QM_B x QM_L; the time is the mean of `reps` timed forwards after one
    warm-up."""
    with torch.no_grad():
        logits = model(ids).float()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            model(ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        nll = float(torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()))
    return logits, nll, ms


def _rel_err(got, want):
    return float((got - want).norm() / want.norm())


def phase_quant_model(w4, a8):
    """[quant_model]: quantize_model(gpt_1p3b, weight_bits=8) and (4), bf16,
    eval at 4 x 1024: the logits' relative error and the NLL against the
    float model's, eval ms a forward, and W4 launches (96 a forward, at
    4096 rows on the tensor-core prefill body)."""
    import copy
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.quantization import (QuantizedLinear,
                                               QuantizedLinearW4,
                                               quantize_model)
    cfg = gpt_1p3b(max_seq_len=QM_L)
    base = _qm_model(cfg)
    ids, labels = _qm_batch(cfg, SEED)
    ref, nll_ref, ms_ref = _qm_eval(base, ids, labels)
    log("quant_model", weights="bfloat16", batch=f"{QM_B}x{QM_L}",
        eval_ms=f"{ms_ref:.2f}", nll=f"{nll_ref:.5f}")
    for bits, cls in ((8, QuantizedLinear), (4, QuantizedLinearW4)):
        model = quantize_model(copy.deepcopy(base), weight_bits=bits)
        n = sum(type(m) is cls for m in model.modules())
        if n != 4 * cfg.num_layers:
            raise AssertionError(f"quantize_model({bits}): {n} layers")
        w4.reset_counts()
        a8.reset_counts()
        logits, nll, ms = _qm_eval(model, ids, labels)
        calls = 4                              # one warm-up, 3 timed
        if w4.plain_launches or a8.kernel_launches or \
                w4.kernel_launches != (n * calls if bits == 4 else 0):
            raise AssertionError(f"quantize_model({bits}): W4 launches "
                                 f"{w4.kernel_launches}, plain "
                                 f"{w4.plain_launches}")
        log("quant_model", weight_bits=bits, layers_quantized=n,
            batch=f"{QM_B}x{QM_L}", eval_ms=f"{ms:.2f}",
            eval_ms_float=f"{ms_ref:.2f}",
            logits_rel_err=f"{_rel_err(logits, ref):.5f}",
            nll=f"{nll:.5f}", nll_float=f"{nll_ref:.5f}",
            nll_delta=f"{nll - nll_ref:.5f}",
            w4_launches_per_forward=w4.kernel_launches / calls,
            w4_rows=QM_B * QM_L, **dict(sorted(w4.branch_launches.items())))
        if bits == 4:
            w4_launches = w4.kernel_launches
        del model, logits
        torch.cuda.empty_cache()
    # row 11 at quantize_model's rows: each product alone at S 4096, bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    w4_time = {"quant_model_launches": w4_launches,
               "quant_model_rows": QM_B * QM_L}
    for name, K, N in A8_PRODUCTS:
        x = torch.randn((QM_B * QM_L, K), generator=gen,
                        device="cuda").bfloat16()
        packed, scale = w4.quantize_w4(torch.randn(
            (K, N), generator=gen, device="cuda") * 0.02)
        ms = cuda_ms(lambda i=0: w4.w4_matmul(x, packed, scale, K), 20)
        dev = cuda_graph_ms(lambda i=0: w4.w4_matmul(x, packed, scale, K),
                            20)
        w4_time[f"s4096_{name}_ms"] = round(ms, 4)
        w4_time[f"s4096_{name}_device_ms"] = round(dev, 4)
        log("kernel_time", kernel="w4_matmul", product=name,
            S=QM_B * QM_L, K=K, N=N, ms=f"{ms:.4f}", device_ms=f"{dev:.4f}",
            bound_ms=f"{2.0 * QM_B * QM_L * K * N / H100_BF16_FLOPS * 1e3:.4f}",
            body=dict(sorted(w4.branch_launches.items())))
    return base, ids, labels, ref, nll_ref, w4_time


def phase_ptq_gpt(a8, base, ids, labels, ref, nll_ref):
    """[ptq_gpt]: PTQ on gpt_1p3b (bf16): calibrate on PTQ_CALIB batches of
    4 x 1024, convert (every Linear -> QuantizedLinearA8W8, static
    activation scales), evaluate: relative error and NLL against the float
    model, A8W8 layers and launches (one quantize and one GEMM a layer a
    forward, the GEMM on the tile body)."""
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.quantization import PTQ, QuantizedLinearA8W8
    cfg = gpt_1p3b(max_seq_len=QM_L)
    model = base
    ptq = PTQ(model)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(PTQ_CALIB):
            model(_qm_batch(cfg, SEED + 1 + i)[0])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    model = ptq.convert()
    n = sum(isinstance(m, QuantizedLinearA8W8) for m in model.modules())
    if n != 4 * cfg.num_layers:
        raise AssertionError(f"PTQ converted {n} layers")
    a8.reset_counts()
    logits, nll, ms = _qm_eval(model, ids, labels)
    calls = 4
    if a8.plain_launches or a8.quantize_launches != n * calls or \
            a8.gemm_launches != n * calls or \
            a8.branch_launches.get("a8w8_gemm[tile]") != n * calls:
        raise AssertionError(f"PTQ A8W8 launches: quantize "
                             f"{a8.quantize_launches}, GEMM "
                             f"{a8.gemm_launches}, {a8.branch_launches}, "
                             f"plain {a8.plain_launches}")
    log("ptq_gpt", model="gpt_1p3b", batch=f"{QM_B}x{QM_L}",
        calibration=f"{PTQ_CALIB}x{QM_B}x{QM_L}", calib_s=f"{calib_s:.2f}",
        a8w8_layers=n, eval_ms=f"{ms:.2f}",
        logits_rel_err=f"{_rel_err(logits, ref):.5f}", nll=f"{nll:.5f}",
        nll_float=f"{nll_ref:.5f}", nll_delta=f"{nll - nll_ref:.5f}",
        a8w8_launches_per_forward=(a8.quantize_launches
                                   + a8.gemm_launches) / calls,
        **dict(sorted(a8.branch_launches.items())))
    launches = (a8.quantize_launches, a8.gemm_launches)
    del model, logits
    torch.cuda.empty_cache()
    return launches


def phase_qat_gpt(a8, smi):
    """[qat_gpt]: QAT on gpt_1p3b (bf16 weights, AdamW with bf16 slots and
    the global-norm clip, the Trainer): quantize, QAT_STEPS steps at
    4 x 1024 with remat 'none' (a recomputed forward would update the
    observers twice a step, which JAX's eager loop never does), convert,
    evaluate against the fake-quant model's eval logits: relative error,
    NLL, A8W8 layers and launches; step ms beside a float step."""
    from paddle_tpu_torch.distributed import Trainer
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt_1p3b
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.quant import QuantizedLinear as FakeQuant
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.quantization import QAT, QuantizedLinearA8W8
    cfg = gpt_1p3b(max_seq_len=QM_L, remat_policy="none")
    crit = GPTPretrainingCriterion()
    ids, labels = _qm_batch(cfg, SEED + 10)
    batch = {"input_ids": ids, "labels": labels}
    out = {}
    for mode in ("float", "qat"):
        model = _qm_model(cfg).train()
        qat = QAT()
        if mode == "qat":
            qat.quantize(model)
            n = sum(isinstance(m, FakeQuant) for m in model.modules())
            if n != 4 * cfg.num_layers:
                raise AssertionError(f"QAT wrapped {n} layers")
        opt = AdamW(learning_rate=2e-4, weight_decay=0.1,
                    grad_clip=ClipGradByGlobalNorm(1.0),
                    accumulator_dtype="bfloat16")
        trainer = Trainer(model, opt, lambda m, b: crit(
            m(b["input_ids"]), b["labels"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(QAT_STEPS):
            t0 = time.perf_counter()
            losses.append(trainer.step(batch))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{mode} losses {losses}")
        out[mode] = {"step_ms": sum(times[1:]) / (QAT_STEPS - 1) * 1e3,
                     "losses": losses,
                     "peak": torch.cuda.max_memory_allocated() / 1e9}
        if mode == "float":
            del trainer, model, opt
            torch.cuda.empty_cache()
            continue
        seen = [int(m._fake_quant_input.seen) for m in model.modules()
                if isinstance(m, FakeQuant)]
        if min(seen) != 1:
            raise AssertionError("a QAT observer saw no activation")
        model.eval()
        fake, nll_fake, _ = _qm_eval(model, ids, labels, reps=1)
        del trainer, opt
        torch.cuda.empty_cache()
        qat.convert(model)
        n = sum(isinstance(m, QuantizedLinearA8W8) for m in model.modules())
        if n != 4 * cfg.num_layers:
            raise AssertionError(f"QAT converted {n} layers")
        a8.reset_counts()
        logits, nll, ms = _qm_eval(model, ids, labels, reps=1)
        calls = 2
        if a8.plain_launches or a8.gemm_launches != n * calls or \
                a8.quantize_launches != n * calls:
            raise AssertionError(f"QAT A8W8 launches {a8.gemm_launches}, "
                                 f"plain {a8.plain_launches}")
        launches = (a8.quantize_launches, a8.gemm_launches)
        log("qat_gpt", model="gpt_1p3b", batch=f"{QM_B}x{QM_L}",
            remat="none (a recompute would update the observers twice a "
            "step; JAX's eager loop updates them once)",
            steps=QAT_STEPS, gpu=repr(smi),
            step_ms=f"{out['qat']['step_ms']:.2f}",
            float_step_ms=f"{out['float']['step_ms']:.2f}",
            peak_mem_GB=f"{out['qat']['peak']:.2f}",
            float_peak_mem_GB=f"{out['float']['peak']:.2f}",
            losses=",".join(f"{v:.5f}" for v in out["qat"]["losses"]),
            float_losses=",".join(f"{v:.5f}"
                                  for v in out["float"]["losses"]),
            a8w8_layers=n, eval_ms=f"{ms:.2f}",
            logits_rel_err_vs_fake_quant=f"{_rel_err(logits, fake):.5f}",
            nll=f"{nll:.5f}", nll_fake_quant=f"{nll_fake:.5f}",
            a8w8_launches_per_forward=(a8.quantize_launches
                                       + a8.gemm_launches) / calls)
        del model, logits, fake
        torch.cuda.empty_cache()
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import dropout as D
    from paddle_tpu_torch.ops import fused_ops as X
    from paddle_tpu_torch.ops import layer_norm as LN
    from paddle_tpu_torch.ops import lora_delta as lora
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops import w4_matmul as w4
    from paddle_tpu_torch.ops import a8w8_matmul as a8
    t_start = time.perf_counter()
    smi = phase_environment()
    layouts = [v[2] for v in SERVE_KERNELS.values()]
    serve_err = {lay: max(phase_kernel_checks(rpa, lay),
                          phase_kernel_long_rows(rpa, lay))
                 for lay in layouts}
    w4_err = phase_w4_checks(w4)
    a8_err, a8_timing, a8_ptxas = phase_a8w8_kernel(a8)
    serve_timing = {lay: phase_kernel_timing(rpa, lay) for lay in layouts}
    for lay in layouts:
        phase_chunk_mix_timing(rpa, lay)
        phase_split_plan_timing(rpa, lay)
    dense_err = phase_dense_window_checks(rpa)
    verify_timing = phase_verify_timing(rpa)
    w4_timing = phase_w4_timing(w4)
    sd, dec, prompts, streams, launches, greedy_fields = phase_serving(rpa)
    phase_profile(dec, prompts)
    nll_bf16 = phase_oracle(rpa, dec, prompts, streams)
    t17 = time.perf_counter()
    slice17_launches = (
        phase_serve_trace(rpa, dec, prompts, streams, smi)
        + phase_serve_dense(rpa, dec, prompts, streams, greedy_fields, smi)
        + phase_serve_multi(rpa, dec, prompts, streams, smi))
    log("serve_slice17_phases", total_s=f"{time.perf_counter() - t17:.1f}")
    del dec
    torch.cuda.empty_cache()
    phase_serve_sampled(sd, prompts, greedy_fields, rpa)
    quant_launches = phase_serve_quant(sd, prompts, streams, nll_bf16, rpa,
                                       w4)
    torch.cuda.empty_cache()
    a8_launches = [phase_serve_a8w8(sd, prompts, streams, nll_bf16, rpa,
                                    a8)]
    torch.cuda.empty_cache()
    t_prefix = time.perf_counter()
    prefix_launches, prefix_err = phase_prefix_serving(sd, rpa)
    tier_launches, tier_err = phase_serve_tier(sd, rpa)
    log("prefix_phases", total_s=f"{time.perf_counter() - t_prefix:.1f}")
    torch.cuda.empty_cache()
    slice17_launches += phase_speculative(rpa, smi)
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    lora_err, lora_timing = phase_lora_kernel(sd, lora)
    lora_launches, slice18_launches = phase_serve_lora(sd, rpa, lora,
                                                       streams, greedy_fields)
    torch.cuda.empty_cache()
    ten_lora, ten_rpa = phase_tenancy(sd, rpa, lora)
    lora_launches += ten_lora
    slice18_launches += ten_rpa
    torch.cuda.empty_cache()
    routed_calls = phase_precision_routed(sd, rpa)
    torch.cuda.empty_cache()
    slice18_launches += phase_fleet(sd, rpa)
    log("slice18_phases", total_s=f"{time.perf_counter() - t18:.1f}")
    torch.cuda.empty_cache()
    phase_generate(sd, smi)
    del sd
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    qm = phase_quant_model(w4, a8)
    w4_quant_model = qm[-1]
    a8_launches.append(phase_ptq_gpt(a8, *qm[:-1]))
    del qm
    torch.cuda.empty_cache()
    a8_launches.append(phase_qat_gpt(a8, smi))
    torch.cuda.empty_cache()
    log("slice19_model_phases", total_s=f"{time.perf_counter() - t19:.1f}")
    phase_small_reference()
    slice5_err = phase_slice5_kernel_checks(LN, X)
    slice5_timing = phase_slice5_kernel_timing(X)
    norm_launches = phase_norm_entry_points(LN, X)
    torch.cuda.empty_cache()
    slice6_err = phase_slice6_kernel_checks(bsa, pa)
    slice6_timing = phase_slice6_kernel_timing(bsa, pa)
    torch.cuda.empty_cache()
    slice6_launches = {"block_sparse_attention": phase_sparse_entry(bsa),
                       "paged_attention": phase_paged_entry(pa)}
    torch.cuda.empty_cache()
    train_err = phase_train_kernel_checks(A, LN, X)
    train_timing = phase_train_kernel_timing(A, X)
    norm_err = phase_norm_checks(LN)
    norm_timing = phase_norm_timing(LN)
    dropout_err = phase_dropout_checks(D)
    dropout_timing = phase_dropout_timing(D)
    trainer, batch, train_launches, losses, full_bs8 = phase_training(
        A, LN, X, smi)
    phase_train_profile(trainer, batch)
    phase_train_split(trainer, batch)
    adamw_lists = {"gpt_1p3b": phase_adamw_list(trainer, batch, X,
                                                "gpt_1p3b")}
    del trainer
    torch.cuda.empty_cache()
    phase_train_route("gpt_1p3b", lambda opt_cls: _trainer(
        _gpt_train_cfg(), opt_cls=opt_cls), batch, losses)
    del batch
    phase_train_small_reference()
    torch.cuda.empty_cache()
    phase_train_dots(A, LN, X, smi, full_bs8)
    phase_dots_equal()
    phase_resume()
    torch.cuda.empty_cache()
    masked_err, ln768_err = phase_bert_kernel_checks(A, LN)
    bert_timing = phase_bert_kernel_timing(A)
    torch.cuda.empty_cache()
    trainer, batch, bert_launches, losses = phase_bert_training(A, LN, X,
                                                                smi)
    phase_bert_split(trainer, batch)
    adamw_lists["bert_base"] = phase_adamw_list(trainer, batch, X,
                                                "bert_base")
    del trainer
    torch.cuda.empty_cache()
    phase_train_route("bert_base", lambda opt_cls: _bert_trainer(
        _bert_train_cfg(), opt_cls=opt_cls), batch, losses)
    del batch
    torch.cuda.empty_cache()
    phase_bert_small_reference()
    trainer, batch = phase_resnet_training(smi)
    phase_resnet_profile(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    phase_resnet_small_reference()
    t_moe = time.perf_counter()
    trainer, batch, moe_launches, step_ms = phase_moe_training(A, LN, X,
                                                               smi)
    phase_moe_routing(trainer, smi)
    phase_moe_profile(trainer, batch, step_ms)
    phase_moe_keys(trainer, batch, smi)
    del trainer, batch
    torch.cuda.empty_cache()
    phase_moe_gates(smi)
    phase_moe_small_reference()
    log("moe_phases", total_s=f"{time.perf_counter() - t_moe:.1f}")
    log("done", total_s=f"{time.perf_counter() - t_start:.1f}")
    # the cached runs (prefix cache, host tier, persistence) count too
    # slice 17: traced, dense, dispatch-separate and speculative serving
    # slice 18: LoRA, tenancy and fleet serving (bf16), the precision-routed
    # engine's int8 and int4 classes
    serve_launches = {
        "bf16": launches["kernel"] + prefix_launches["bf16"] + tier_launches
        + slice17_launches + slice18_launches,
        "int8": quant_launches["int8"]["ragged_paged_attention"]
        + prefix_launches["int8"] + routed_calls["int8"],
        "int4": quant_launches["int4"]["ragged_paged_attention"]
        + prefix_launches["int4"] + routed_calls["int4"]}
    prefix_err["bf16"] = max(prefix_err["bf16"], tier_err)
    serve_err = {lay: max(e, prefix_err[lay]) for lay, e in serve_err.items()}
    serve_err["bf16"] = max(serve_err["bf16"], dense_err,
                            verify_timing["max_abs_err"])
    kernels = []
    for name, (source, replaces, lay) in SERVE_KERNELS.items():
        # the bf16 row also carries the verify window's readings
        extra = {} if lay != "bf16" else {
            f"verify_{k}": v for k, v in verify_timing.items()
            if k != "max_abs_err"}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": serve_launches[lay],
                        "max_abs_err": serve_err[lay], **serve_timing[lay],
                        **extra})
    # the w4a16 serving run's launches and quantize_model's (4096 rows)
    kernels.append({"name": "w4_matmul", "route": "cuda",
                    "source": "paddle_tpu_torch/ops/csrc/w4_matmul.cu",
                    "replaces": "paddle_tpu/ops/w4_matmul.py:59",
                    "launches": quant_launches["w4a16"]["w4_matmul"]
                    + w4_quant_model["quant_model_launches"],
                    "max_abs_err": w4_err, **w4_timing, **w4_quant_model})
    gpt_rows, bert_rows = (f"{n}x{h}" for n, h in NORM_SHAPES)
    for name, (source, replaces) in TRAIN_KERNELS.items():
        timing = (norm_timing[f"{name}[{gpt_rows}]"] if name in NORM_KERNELS
                  else train_timing[name])
        err = (max(train_err.get(name, 0.0), norm_err[name])
               if name in NORM_KERNELS else train_err[name])
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": train_launches[name] + moe_launches[name],
                        "max_abs_err": err, **timing})
    for name in A.KERNELS:
        source, replaces = TRAIN_KERNELS[name]
        kernels.append({"name": f"{name}[{MASKED}]", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": bert_launches[name],
                        "max_abs_err": masked_err[name],
                        **bert_timing[f"{name}[{MASKED}]"]})
    for name in NORM_KERNELS:
        source, replaces = TRAIN_KERNELS[name]
        kernels.append({"name": f"{name}[h{BHID}]", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": bert_launches[name],
                        "max_abs_err": max(norm_err[name], ln768_err
                                           if name == "layer_norm" else 0.0),
                        **norm_timing[f"{name}[{bert_rows}]"]})
    kernels.append({"name": "rms_norm", "route": "cuda",
                    "source": "paddle_tpu_torch/ops/csrc/layer_norm.cu",
                    "replaces": "paddle_tpu/ops/layer_norm.py:29",
                    "launches": norm_launches["rms_norm"],
                    "max_abs_err": max(slice5_err["rms_norm"],
                                       norm_err["rms_norm"]),
                    **norm_timing[f"rms_norm[{gpt_rows}]"]})
    for name, source, replaces, launches, timing in (
            ("adamw", "adamw.cu", "fused_ops.py:215",
             train_launches["adamw"] + bert_launches["adamw"]
             + moe_launches["adamw"], "adamw"),
            ("dropout_residual_layer_norm", "layer_norm.cu",
             "fused_ops.py:288", norm_launches["dropout_residual_layer_norm"],
             f"dropout_residual_layer_norm[{BB * BL}x{BHID}]")):
        extra = {} if name != "adamw" else {
            f"{m}_list_{k}": v for m, r in adamw_lists.items()
            for k, v in r.items() if k.endswith("ms")}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"paddle_tpu_torch/ops/csrc/{source}",
                        "replaces": f"paddle_tpu/ops/{replaces}",
                        "launches": launches,
                        "max_abs_err": slice5_err[name],
                        **slice5_timing[timing], **extra})
    # no Pallas kernel: the counterpart of the XLA-fused JAX `_hash_keep`
    # + `dropout`; BERT's launches
    for name in ("hash_dropout", "hash_dropout_bwd"):
        kernels.append({"name": name, "route": "cuda",
                        "source": "paddle_tpu_torch/ops/csrc/hash_dropout.cu",
                        "replaces": "paddle_tpu/nn/functional/common.py:42",
                        "launches": bert_launches[name],
                        "max_abs_err": dropout_err,
                        **dropout_timing[name]})
    for name, replaces in (
            ("block_sparse_attention", "block_sparse_attention.py:35"),
            ("paged_attention", "paged_attention.py:105")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"paddle_tpu_torch/ops/csrc/{name}.cu",
                        "replaces": f"paddle_tpu/ops/{replaces}",
                        "launches": slice6_launches[name],
                        "max_abs_err": slice6_err[name],
                        **slice6_timing[name]})
    # no Pallas kernel: the counterpart of the XLA-fused JAX `_lora_delta`
    kernels.append({"name": "lora_delta", "route": "cuda",
                    "source": "paddle_tpu_torch/ops/csrc/lora_delta.cu",
                    "replaces": "paddle_tpu/serving/decoder.py:284",
                    "launches": lora_launches, "max_abs_err": lora_err,
                    **lora_timing})
    # no Pallas kernel: the counterparts of the XLA-fused activation
    # quantize and int8 dot of the JAX decoder's `_mm` / `_mm_heads` and
    # `QuantizedLinearA8W8`; launches of [serve_a8w8], [ptq_gpt], [qat_gpt]
    for i, name in enumerate(("a8w8_quantize_rows", "a8w8_gemm")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "paddle_tpu_torch/ops/csrc/a8w8_matmul.cu",
                        "replaces": "paddle_tpu/serving/decoder.py:330",
                        "also_replaces": "paddle_tpu/serving/decoder.py:307, "
                        "paddle_tpu/quantization.py:118",
                        "launches": sum(n[i] for n in a8_launches),
                        "max_abs_err": a8_err[name], "ptxas": a8_ptxas,
                        **a8_timing[name]})
    if any(k["route"] not in ("cuda", "triton") for k in kernels):
        raise AssertionError("a kernel's route is not cuda or triton")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
