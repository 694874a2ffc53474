#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py          # needs one CUDA card (an H100)

Builds every hand-written kernel from the sources in the checkout, holds
each against its plain PyTorch version at the shapes of the path that
runs it (serving: ragged paged attention over bf16, int8 and int4 pools,
the W4A16 matmul; training: flash attention forward/dQ/dK-dV, LayerNorm,
streaming cross-entropy forward/backward) and times it beside its bound
and a library yardstick; serves GPT-1.3B (gpt_1p3b at full width, random
weights from seed 0) through the port's default engine, profiles a short
serving window and checks the streams against the port's per-tick
decoder; serves it again from an int8 pool, an int4 pool and int4
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
the RMSNorm kernel and the dropout + residual + LayerNorm kernel
are held against their plain versions and timed at full width, and the
two norm ops are driven through their entry points (nn.RMSNorm forward
and backward, the dropout op in training and eval). The two legacy
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
row beside the decode one. Every phase raises on failure. The output
is one line per phase, then one JSON line with the kernels' numbers, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Without CUDA, or without the package next
to it, the script exits non-zero and prints no result. Imports only
torch, numpy and the port (never jax or paddle_tpu).
"""
import ctypes
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


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


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
    for name, line in (("flash_attention", "ptxas_bwd"),
                       ("block_sparse_attention", "ptxas_bsa")) + tuple(
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


def _serve_run(dec, prompts, mods):
    """The main serving run: a warm-up request, then the 32 prompts x 64
    new tokens through the default (ragged, packed) engine with k_max 8.
    Every kernel count of `mods` is set to 0 just before the run and read
    just after. Returns (engine, streams, wall seconds, {module: (kernel
    launches, plain launches)}, with the ragged kernel's device launches
    under "device")."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    # warm-up (cuBLAS handles, allocator): one short request
    warm = ContinuousBatchingEngine(dec, max_new_tokens=4, k_max=K_MAX)
    warm.submit(prompts[0][:64])
    warm.run()
    eng = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW, k_max=K_MAX)
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
    log("serve", model="gpt_1p3b", layers=cfg.num_layers,
        hidden=cfg.hidden_size, requests=N_REQ, max_new=MAX_NEW,
        max_batch=16, k_max=K_MAX, priced_k_max=priced_k,
        chunk_tokens=eng.scheduler.chunk_tokens, setup_s=f"{setup_s:.2f}",
        **_serve_fields(eng, wall),
        kernel_launches=launches["kernel"],
        plain_launches=launches["plain"], device_launches=device,
        device_launches_per_call=f"{device / launches['kernel']:.3f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return sd, dec, prompts, streams, launches


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
    fam = {"attention": 0.0, "w4_matmul": 0.0, "gemm": 0.0, "other": 0.0}
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


def _teacher_force(dec, prompts, streams):
    """Teacher-force the per-tick decoder (`_decode_step`) with each
    request's prompt and then `streams`. Returns (the largest gap between
    a tick's best logit and the stream token's, the mean NLL of the
    stream tokens)."""
    n = len(streams)
    ps = dec.page_size
    tbl = np.full((n, dec.max_pages), dec.num_pages - 1, np.int32)
    nxt_page = 0
    for r in range(n):
        need = (len(prompts[r]) + MAX_NEW + ps - 1) // ps
        tbl[r, :need] = np.arange(nxt_page, nxt_page + need)
        nxt_page += need
    dec.prefill_batch([(prompts[r][:-1], tbl[r][tbl[r] < dec.num_pages - 1]
                        .tolist()) for r in range(n)])
    table = dec._as_i32(tbl)
    gap, nll = 0.0, []
    for i in range(MAX_NEW):
        toks = [prompts[r][-1] if i == 0 else streams[r][i - 1]
                for r in range(n)]
        lens = [len(prompts[r]) - 1 + i for r in range(n)]
        _, logits = dec._decode_step(dec._as_i32(toks), dec._as_i32(lens),
                                     table)
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


# (name, B, L, Hq, Hkv, D, causal): the training shape, a small GQA case
# with a ragged length, a non-causal case, head_dim 256 with GQA and a
# ragged length, and q, k, v as views at an odd storage offset (not
# 16-byte aligned; the bf16 wrapper copies them for the tensor-core body)
FLASH_CASES = [("train", TB, TL, TH, TH, TD, True),
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
        check("layer_norm", LN._launch(x, w, b, 1e-5), plain32.to(dtype),
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


def phase_train_kernel_timing(A, LN, X):
    """Each training kernel at the main path's shape and dtype (bf16
    attention and LayerNorm, f32 logits), against its plain version and
    one PyTorch call computing the same function (never called by the
    port): SDPA's flash backend forward and backward, F.layer_norm,
    F.cross_entropy forward and backward. Bounds: bytes over 3.35 TB/s
    or flops over 989 TFLOP/s (bf16 dense), the larger."""
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
    x = _rand(gen, (TN, THID), bf, 2.0)
    w, b = _rand(gen, (THID,), bf), _rand(gen, (THID,), bf)
    specs["layer_norm"] = (
        lambda i=0: LN._launch(x, w, b, 1e-5),
        lambda i=0: LN._ln_kernel_ref(x, w, b, 1e-5),
        cuda_ms(lambda i=0: torch.nn.functional.layer_norm(
            x, (THID,), w, b, 1e-5), 20),
        2 * TN * THID * 2 + 2 * THID * 2, 8 * TN * THID)
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
# per block twice + ln_f, one cross-entropy forward and backward
# per step, and one AdamW update per parameter (`adamw` is set to
# len(trainer.params) by the phase); the norm kernels of slice 5 run on
# neither training path
EXPECTED_PER_STEP = {"flash_fwd": 48, "flash_bwd_dq": 24,
                     "flash_bwd_dkv": 24, "layer_norm": 97, "rms_norm": 0,
                     "xent_fwd": 1, "xent_bwd": 1,
                     "dropout_residual_layer_norm": 0}


def _train_counts(A, LN, X):
    k = {**A.kernel_launches, "layer_norm": LN.kernel_launches,
         "rms_norm": LN.rms_kernel_launches, **X.kernel_launches,
         "adamw": X.adamw_kernel_launches,
         "dropout_residual_layer_norm": X.drln_kernel_launches}
    p = {**A.plain_launches, "layer_norm": LN.plain_launches,
         "rms_norm": LN.rms_plain_launches, **X.plain_launches,
         "adamw": X.adamw_plain_launches,
         "dropout_residual_layer_norm": X.drln_plain_launches}
    return k, p


def _reset_train_counts(A, LN, X):
    for mod in (A, LN, X):
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
    return trainer, batch, kern, losses


_FAMILIES = (("flash_attention", ("flash_fwd", "flash_dq", "flash_dkv")),
             ("layer_norm", ("layer_norm_kernel",)),
             ("xent", ("xent_fwd", "xent_bwd")),
             ("adamw", ("adamw_kernel",)),
             ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")))


def phase_train_profile(trainer, batch):
    """Where one training step's time goes: device time by kernel family
    under torch.profiler, and the device's busy share (device kernel
    time over the step's wall time; one stream, so kernels do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = dict.fromkeys([f for f, _ in _FAMILIES] + ["other"], 0.0)
    kernels = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        kernels.append((us, ev.key))
        name = ev.key.lower()
        for f, keys in _FAMILIES:
            if any(t in name for t in keys):
                fam[f] += us
                break
        else:
            fam["other"] += us
    busy = sum(fam.values()) / 1e6
    if busy <= 0:
        log("train_profile", device_time="not measured (the profiler saw "
            "no device kernels)", wall_ms=f"{wall * 1e3:.2f}")
        return
    log("train_profile", wall_ms=f"{wall * 1e3:.2f}",
        device_ms=f"{busy * 1e3:.2f}", device_busy_share=f"{busy / wall:.3f}",
        **{f"{k}_ms": f"{v / 1e3:.2f}" for k, v in fam.items()})
    for us, name in sorted(kernels, reverse=True)[:8]:
        log("train_profile_top", kernel=repr(name[:90]),
            ms=f"{us / 1e3:.3f}")


def phase_train_split(trainer, batch):
    """One more step timed in two parts with CUDA events: forward and
    backward (loss and gradients), then the clip and the optimizer
    update."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    _, grads = trainer._loss_and_grads(batch)
    ev[1].record()
    trainer.optimizer.apply_gradients(trainer.params, grads)
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
                "layer_norm", LN._launch(x, w, b, eps), plain32.to(dtype),
                plain32))
        log("kernel", form=f"layer_norm [{BB * BL}, {BHID}] eps 1e-5, 1e-12",
            dtype=str(dtype)[6:], ln_err=f"{ln_err:.3e}")
    torch.cuda.synchronize()
    return err, ln_err


# bf16 [B, L, H, D] tensors and f32 [B, H, L] rows of the BERT shape
_BIO = BB * BL * BH * BD * 2
_BROWS = BB * BH * BL * 4
_BPAIRS = BB * BH * BL * BL


def phase_bert_kernel_timing(A, LN):
    """Each masked branch of the three flash kernels at the BERT shape in
    bf16 (kvb, fb, dropout, kvb+dropout — the last is BERT's), against
    its plain version and one PyTorch call with the same additive mask
    and rate (SDPA forward, and its backward for dQ, dK and dV together;
    timed only, never called by the port); LayerNorm at [16384, 768].
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
    x = _rand(gen, (BB * BL, BHID), bf, 2.0)
    w, b = _rand(gen, (BHID,), bf), _rand(gen, (BHID,), bf)
    ms = cuda_ms(lambda i=0: LN._launch(x, w, b, 1e-12), 20)
    plain_ms = cuda_ms(lambda i=0: LN._ln_kernel_ref(x, w, b, 1e-12), 5)
    library_ms = cuda_ms(lambda i=0: torch.nn.functional.layer_norm(
        x, (BHID,), w, b, 1e-12), 20)
    bound_ms, bound_by = _bound(2 * x.numel() * 2 + 2 * BHID * 2,
                                8 * x.numel())
    out["layer_norm[h768]"] = {"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": library_ms}
    log("kernel_time", kernel="layer_norm[h768]",
        shape=f"[{BB * BL}, {BHID}] bf16", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
    return out


# a bert_base training step launches, per layer, one attention forward,
# dQ and dK/dV (kvb + dropout) and two LayerNorms, plus the embeddings'
# and the MLM head's LayerNorm; the vocabulary (30522) has no 128-multiple
# block, so the criterion takes F.cross_entropy, not the xent kernels
BERT_EXPECTED_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12,
                          "flash_bwd_dkv": 12, "layer_norm": 26,
                          "rms_norm": 0, "xent_fwd": 0, "xent_bwd": 0,
                          "dropout_residual_layer_norm": 0}


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


_BERT_FAMILIES = ("flash_attention", "cublas", "layer_norm", "dropout_hash",
                  "xent_logits", "optimizer", "other")


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
    named for the flash kernels, cuBLAS and LayerNorm; the rest are
    priced by the op that launched them (the hash ranges of F.dropout,
    the optimizer's range, the ops on the [16384, 30522] f32 logits);
    and the device's busy share (device time over the step's wall
    time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        _, grads = trainer._loss_and_grads(batch)
        with torch.profiler.record_function("bert_optimizer"):
            trainer.optimizer.apply_gradients(trainer.params, grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = dict.fromkeys(_BERT_FAMILIES, 0.0)
    named = {"flash_attention": ("flash_fwd", "flash_dq", "flash_dkv"),
             "layer_norm": ("layer_norm_kernel",),
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
NORM_SHAPES = ((TN, THID), (BB * BL, BHID))
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
    in f32 and bf16 at both widths, the latter with its keep-mask equal to
    the plain hash mask, its kept fraction near 1 - p, and caller bits
    equal to its own hash giving bit-equal outputs."""
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
        for n, h in NORM_SHAPES:
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


def phase_slice5_kernel_timing(LN, X):
    """The three kernels at the main paths' shapes (bf16), beside their
    plain versions and one PyTorch call computing the same function
    (never called by the port): `torch._fused_adamw_` on the same
    tensors (without the clip scale), `F.rms_norm`; no single PyTorch
    call computes dropout + residual + LayerNorm and the pre-LN sum.
    Bounds: each input read once and each output written once over 3.35
    TB/s, or the f32 flops over 67 TFLOP/s, the larger. The JSON rows
    take the GPT width for RMSNorm and the BERT width for the dropout
    op, the shapes of the norm entry-point phase."""
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
        specs[f"rms_norm[{n}x{h}]"] = (
            lambda i=0, x=x, w=w: LN._rms_launch(x, w, RMS_EPS),
            lambda i=0, x=x, w=w: LN._rms_kernel_ref(x, w, RMS_EPS),
            lambda i=0, x=x, w=w, h=h: torch.nn.functional.rms_norm(
                x, (h,), w, RMS_EPS),
            4 * n * h + 2 * h, 4 * n * h, f"[{n}, {h}] bf16")
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
    "xent_fwd": ("paddle_tpu_torch/ops/csrc/softmax_cross_entropy.cu",
                 "paddle_tpu/ops/fused_ops.py:65"),
    "xent_bwd": ("paddle_tpu_torch/ops/csrc/softmax_cross_entropy.cu",
                 "paddle_tpu/ops/fused_ops.py:99"),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import fused_ops as X
    from paddle_tpu_torch.ops import layer_norm as LN
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops import w4_matmul as w4
    t_start = time.perf_counter()
    smi = phase_environment()
    layouts = [v[2] for v in SERVE_KERNELS.values()]
    serve_err = {lay: max(phase_kernel_checks(rpa, lay),
                          phase_kernel_long_rows(rpa, lay))
                 for lay in layouts}
    w4_err = phase_w4_checks(w4)
    serve_timing = {lay: phase_kernel_timing(rpa, lay) for lay in layouts}
    for lay in layouts:
        phase_chunk_mix_timing(rpa, lay)
        phase_split_plan_timing(rpa, lay)
    w4_timing = phase_w4_timing(w4)
    sd, dec, prompts, streams, launches = phase_serving(rpa)
    phase_profile(dec, prompts)
    nll_bf16 = phase_oracle(rpa, dec, prompts, streams)
    del dec
    torch.cuda.empty_cache()
    quant_launches = phase_serve_quant(sd, prompts, streams, nll_bf16, rpa,
                                       w4)
    del sd
    torch.cuda.empty_cache()
    phase_small_reference()
    slice5_err = phase_slice5_kernel_checks(LN, X)
    slice5_timing = phase_slice5_kernel_timing(LN, X)
    norm_launches = phase_norm_entry_points(LN, X)
    torch.cuda.empty_cache()
    slice6_err = phase_slice6_kernel_checks(bsa, pa)
    slice6_timing = phase_slice6_kernel_timing(bsa, pa)
    torch.cuda.empty_cache()
    slice6_launches = {"block_sparse_attention": phase_sparse_entry(bsa),
                       "paged_attention": phase_paged_entry(pa)}
    torch.cuda.empty_cache()
    train_err = phase_train_kernel_checks(A, LN, X)
    train_timing = phase_train_kernel_timing(A, LN, X)
    trainer, batch, train_launches, losses = phase_training(A, LN, X, smi)
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
    masked_err, ln768_err = phase_bert_kernel_checks(A, LN)
    bert_timing = phase_bert_kernel_timing(A, LN)
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
    log("done", total_s=f"{time.perf_counter() - t_start:.1f}")
    serve_launches = {"bf16": launches["kernel"],
                      "int8": quant_launches["int8"]["ragged_paged_attention"],
                      "int4": quant_launches["int4"]["ragged_paged_attention"]}
    kernels = []
    for name, (source, replaces, lay) in SERVE_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": serve_launches[lay],
                        "max_abs_err": serve_err[lay], **serve_timing[lay]})
    kernels.append({"name": "w4_matmul", "route": "cuda",
                    "source": "paddle_tpu_torch/ops/csrc/w4_matmul.cu",
                    "replaces": "paddle_tpu/ops/w4_matmul.py:59",
                    "launches": quant_launches["w4a16"]["w4_matmul"],
                    "max_abs_err": w4_err, **w4_timing})
    for name, (source, replaces) in TRAIN_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": train_launches[name],
                        "max_abs_err": train_err[name],
                        **train_timing[name]})
    for name in A.KERNELS:
        source, replaces = TRAIN_KERNELS[name]
        kernels.append({"name": f"{name}[{MASKED}]", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": bert_launches[name],
                        "max_abs_err": masked_err[name],
                        **bert_timing[f"{name}[{MASKED}]"]})
    source, replaces = TRAIN_KERNELS["layer_norm"]
    kernels.append({"name": "layer_norm[h768]", "route": "cuda",
                    "source": source, "replaces": replaces,
                    "launches": bert_launches["layer_norm"],
                    "max_abs_err": ln768_err,
                    **bert_timing["layer_norm[h768]"]})
    for name, source, replaces, launches, timing in (
            ("adamw", "adamw.cu", "fused_ops.py:215",
             train_launches["adamw"] + bert_launches["adamw"], "adamw"),
            ("rms_norm", "layer_norm.cu", "layer_norm.py:29",
             norm_launches["rms_norm"], f"rms_norm[{TN}x{THID}]"),
            ("dropout_residual_layer_norm", "dropout_residual_layer_norm.cu",
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
    for name, replaces in (
            ("block_sparse_attention", "block_sparse_attention.py:35"),
            ("paged_attention", "paged_attention.py:105")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"paddle_tpu_torch/ops/csrc/{name}.cu",
                        "replaces": f"paddle_tpu/ops/{replaces}",
                        "launches": slice6_launches[name],
                        "max_abs_err": slice6_err[name],
                        **slice6_timing[name]})
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
