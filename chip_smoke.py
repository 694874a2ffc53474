#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py          # needs one CUDA card (an H100)

Builds every hand-written kernel from the sources in the checkout, holds
each against its plain PyTorch version at the shapes of the path that
runs it (serving: ragged paged attention; training: flash attention
forward/dQ/dK-dV, LayerNorm, streaming cross-entropy forward/backward)
and times it beside its bound and a library yardstick; serves GPT-1.3B
(gpt_1p3b at full width, random weights from seed 0) through the port's
default engine, profiles a short serving window and checks the streams
against the port's per-tick decoder; trains gpt_1p3b (full depth, bf16,
remat 'full', batch 8 x 1024, AdamW + global-norm clip) for 2 warm-up
and 8 timed steps, counts each kernel's launches a step, profiles one
step; and checks serving and training on gpt_tiny against the port's
CPU path. Every phase raises on failure. The output
is one line per phase, then one JSON line with the kernels' numbers, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Without CUDA, or without the package next
to it, the script exits non-zero and prints no result. Imports only
torch, numpy and the port (never jax or paddle_tpu).
"""
import json
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
        for fn, regs, spill in _ptxas_entries(text):
            log("ptxas", kernel=name, fn=repr(fn), info=repr(regs),
                spill=repr(spill))
    return smi


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


def _check_close(name, got, plain, plain32):
    """f32: within atol=rtol=1e-5 of the plain version (both accumulate
    in f32; only summation order differs). bf16: within one bf16 ulp of
    the plain version's f32 result on the same inputs (the kernel rounds
    its f32 result once; the rounding step is half an ulp) plus the f32
    allowance 1e-5 (an output near zero is a sum whose terms cancel, so
    the f32 summation-order error is absolute, not relative to it)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
        return float((got - plain).abs().max())
    err = (got.float() - plain32).abs()
    if not bool((err <= bf16_ulp(plain32) + 1e-5).all()):
        raise AssertionError(f"{name}: bf16 kernel output off by more "
                             "than one ulp of the f32 plain result")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    return float((got.float() - plain.float()).abs().max())


def phase_kernel_checks(rpa):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    P = 16 * MP + 1
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        kp, vp = (x[0] for x in _pool(gen, P, dtype))
        kp32, vp32 = kp.float(), vp.float()
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
            plain = rpa._ragged_ref(q, kp, vp, table, start, scale)
            plain32 = rpa._ragged_ref(q.float(), kp32, vp32, table, start,
                                      scale)
            err = _check_close(f"dense W={W}", got, plain, plain32)
            max_err = max(max_err, err)
            log("kernel", form="dense", dtype=str(dtype)[6:], W=W,
                max_abs_err=f"{err:.3e}")
            if W == 16:
                # bit-identity: each query alone (W=1), inside the W=16
                # window, and inside a shuffled packed stream
                alone = torch.cat([rpa.ragged_paged_attention(
                    q[:, j:j + 1].contiguous(), kp, vp, table, start + j)
                    for j in range(W)], dim=1)
                rows = torch.arange(n, device="cuda").repeat_interleave(W)
                pos = (start[:, None] + torch.arange(
                    W, device="cuda")).reshape(-1)
                perm = torch.randperm(n * W, generator=gen, device="cuda")
                packed = rpa.ragged_paged_attention_packed(
                    q.reshape(n * W, H, D)[perm].contiguous(), kp, vp,
                    table, rows[perm].int().contiguous(),
                    pos[perm].int().contiguous())
                unperm = torch.empty_like(packed)
                unperm[perm] = packed
                if not (torch.equal(alone, got) and
                        torch.equal(unperm.reshape(n, W, H, D), got)):
                    raise AssertionError(
                        f"{dtype}: a query's output differs between W=1, "
                        "a W=16 window and a packed stream")
                log("kernel", check="bit-identical W=1 == W=16 window == "
                    "shuffled packed stream", dtype=str(dtype)[6:])
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
        plain = rpa._ragged_ref(q[:, None], kp, vp, *ref_args)[:, 0]
        plain32 = rpa._ragged_ref(q[:, None].float(), kp32, vp32,
                                  *ref_args)[:, 0]
        err = _check_close("packed T=64", got, plain, plain32)
        max_err = max(max_err, err)
        log("kernel", form="packed", dtype=str(dtype)[6:], T=64,
            max_abs_err=f"{err:.3e}")
    torch.cuda.synchronize()
    return max_err


def phase_kernel_timing(rpa, layers=24):
    """Time the kernel at the serving path's decode shape: one packed
    decode token per slot (T=16), context positions drawn like the
    served requests', bf16 pools of all 24 layers (each launch reads the
    next layer's pool, as a serving tick does, so the 50 MB L2 does not
    hold the pages between launches)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    P = 16 * MP + 1
    T = 16
    kp, vp = _pool(gen, P, torch.bfloat16, layers=layers)
    table = torch.from_numpy(
        rng.permutation(P - 1)[:T * MP].reshape(T, MP).astype(np.int32)
    ).cuda()
    pos_np = rng.randint(64, 832, T).astype(np.int32)
    pos = torch.from_numpy(pos_np).cuda()
    rows = torch.arange(T, dtype=torch.int32, device="cuda")
    q = torch.randn((layers, T, H, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    scale = 1.0 / D ** 0.5

    def kern(i=0):
        return rpa.ragged_paged_attention_packed(
            q[i % layers], kp[i % layers], vp[i % layers], table, rows, pos)

    def plain(i=0):
        return rpa._ragged_ref(q[i % layers][:, None], kp[i % layers],
                               vp[i % layers], table, pos, scale)

    # yardstick only, never called by the port: one SDPA call over K/V
    # gathered to dense [T, H, MP*PS, D] with a causal key mask
    kd = [kp[l][table.long()].reshape(T, MP * PS, H, D).transpose(1, 2)
          for l in range(2)]
    vd = [vp[l][table.long()].reshape(T, MP * PS, H, D).transpose(1, 2)
          for l in range(2)]
    mask = (torch.arange(MP * PS, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]

    def library(i=0):
        return torch.nn.functional.scaled_dot_product_attention(
            q[i % layers][:, :, None],
            kd[i % 2], vd[i % 2], attn_mask=mask, scale=scale)

    ms = cuda_ms(kern, 240)
    plain_ms = cuda_ms(plain, 24)
    library_ms = cuda_ms(library, 240)
    keys = pos_np.astype(np.int64) + 1
    kv_bytes = int(keys.sum()) * H * D * 2 * 2           # K and V, bf16
    io_bytes = 2 * T * H * D * 2 + 4 * (2 * T + int((keys + PS - 1).sum()
                                                    // PS))
    flops = int(keys.sum()) * H * 4 * D                  # q.k and p.v
    bytes_ms = (kv_bytes + io_bytes) / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    log("kernel_time", shape=f"packed T={T} H={H} D={D} ps={PS} MP={MP} "
        f"bf16 mean_ctx={keys.mean():.1f}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        achieved_GBps=f"{(kv_bytes + io_bytes) / ms / 1e6:.1f}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------- phase 3

N_REQ, MAX_NEW, K_MAX = 32, 64, 8


def phase_serving(rpa):
    from paddle_tpu_torch.models import gpt_1p3b, init_state_dict
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder)
    from paddle_tpu_torch.serving.scheduler import RaggedScheduler
    cfg = gpt_1p3b()
    t0 = time.perf_counter()
    sd = init_state_dict(cfg, seed=SEED)
    dec = PagedGPTDecoder(cfg, sd, num_pages=16 * MP + 1, page_size=PS,
                          max_batch=16)
    del sd
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    lengths = rng.randint(64, 769, N_REQ)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    # warm-up (cuBLAS handles, allocator): one short request
    warm = ContinuousBatchingEngine(dec, max_new_tokens=4, k_max=K_MAX)
    warm.submit(prompts[0][:64])
    warm.run()
    priced_k = RaggedScheduler(dec).k_max
    eng = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW, k_max=K_MAX)
    rids = [eng.submit(p) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rpa.reset_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"kernel": rpa.kernel_launches, "plain": rpa.plain_launches}
    streams = [out[r] for r in rids]
    if any(len(s) != MAX_NEW for s in streams):
        raise AssertionError("a request did not return 64 tokens")
    if not all(0 <= t < cfg.vocab_size for s in streams for t in s):
        raise AssertionError("a token id is out of the vocabulary")
    if launches["kernel"] <= 0 or launches["plain"] != 0:
        raise AssertionError(f"attention launches on the card: {launches}")
    st = eng.stats.summary()
    log("serve", model="gpt_1p3b", layers=cfg.num_layers,
        hidden=cfg.hidden_size, requests=N_REQ, max_new=MAX_NEW,
        max_batch=16, k_max=K_MAX, priced_k_max=priced_k,
        chunk_tokens=eng.scheduler.chunk_tokens, setup_s=f"{setup_s:.2f}",
        wall_s=f"{wall:.3f}", gen_tok_per_s=f"{N_REQ * MAX_NEW / wall:.1f}",
        ttft_p50_ms=st.get("ttft_p50_ms"), ttft_p99_ms=st.get("ttft_p99_ms"),
        token_p50_ms=st.get("token_p50_ms"),
        token_p99_ms=st.get("token_p99_ms"), horizons=st["decode_syncs"],
        ticks=st["ticks"], pad_fraction=st.get("pad_fraction"),
        kernel_launches=launches["kernel"],
        plain_launches=launches["plain"],
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return dec, prompts, streams, launches


def phase_profile(dec, prompts):
    """Where a serving window's time goes: 16 requests (128-token
    prompts, 32 new tokens) through the default engine under
    torch.profiler. Device time is summed by kernel family; the busy
    share is device kernel time over the window's wall time (one stream,
    so kernels do not overlap)."""
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
    fam = {"attention": 0.0, "gemm": 0.0, "other": 0.0}
    kernels = []
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
        if "ragged_paged_attention" in name:
            fam["attention"] += us
        elif any(t in name.lower() for t in ("gemm", "nvjet", "cutlass",
                                             "xmma")):
            fam["gemm"] += us                # cuBLAS / cuBLASLt kernels
        else:
            fam["other"] += us
    ticks = eng.stats.ticks
    busy = sum(fam.values()) / 1e6
    if busy <= 0:
        log("profile", device_time="not measured (the profiler saw no "
            "device kernels)", wall_s=f"{wall:.3f}", ticks=ticks)
        return
    log("profile", window="16 req x (128 prompt + 32 new)", ticks=ticks,
        wall_ms_per_tick=f"{wall / ticks * 1e3:.3f}",
        device_ms_per_tick=f"{busy / ticks * 1e3:.3f}",
        device_busy_share=f"{busy / wall:.3f}",
        **{f"{k}_ms_per_tick": f"{v / 1e3 / ticks:.3f}"
           for k, v in fam.items()})
    for us, name in sorted(kernels, reverse=True)[:6]:
        log("profile_top", kernel=repr(name[:90]),
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


def phase_oracle(dec, prompts, streams):
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(dec, max_new_tokens=MAX_NEW, k_max=1)
    rids = [eng.submit(p) for p in prompts[:N_ORACLE]]
    out = eng.run()
    per_tick = [out[r] for r in rids]
    agree = sum(a == b for a, b in zip(per_tick, streams))
    for i, (a, b) in enumerate(zip(per_tick, streams)):
        if a != b:
            j = next(t for t, (x, y) in enumerate(zip(a, b)) if x != y)
            log("oracle", request=i, first_divergence=j,
                prompt_len=len(prompts[i]), per_tick_token=a[j],
                engine_token=b[j])
    # teacher-force the per-tick decoder with the engine's tokens
    ps = dec.page_size
    tbl = np.full((N_ORACLE, dec.max_pages), dec.num_pages - 1, np.int32)
    nxt_page = 0
    for r in range(N_ORACLE):
        need = (len(prompts[r]) + MAX_NEW + ps - 1) // ps
        tbl[r, :need] = np.arange(nxt_page, nxt_page + need)
        nxt_page += need
    dec.prefill_batch([(prompts[r][:-1], tbl[r][tbl[r] < dec.num_pages - 1]
                        .tolist()) for r in range(N_ORACLE)])
    table = dec._as_i32(tbl)
    gap = 0.0
    for i in range(MAX_NEW):
        toks = [prompts[r][-1] if i == 0 else streams[r][i - 1]
                for r in range(N_ORACLE)]
        lens = [len(prompts[r]) - 1 + i for r in range(N_ORACLE)]
        _, logits = dec._decode_step(dec._as_i32(toks), dec._as_i32(lens),
                                     table)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite per-tick logits")
        chosen = logits[torch.arange(N_ORACLE, device=logits.device),
                        torch.as_tensor([s[i] for s in streams[:N_ORACLE]],
                                        device=logits.device)]
        gap = max(gap, float((logits.max(-1).values - chosen).max()))
    if gap > LOGIT_TOL:
        raise AssertionError(f"an engine token scores {gap:.4f} below the "
                             f"per-tick best logit (tolerance {LOGIT_TOL})")
    log("oracle", streams_agree=f"{agree}/{N_ORACLE}",
        max_logit_gap=f"{gap:.5f}", tolerance=LOGIT_TOL)


def phase_small_reference():
    """gpt_tiny in f32: the card's path (kernel) against the port's CPU
    path (plain version) on the same weights — decode logits within
    1e-4, ragged engine streams equal."""
    from paddle_tpu_torch.models import gpt_tiny, init_state_dict
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedGPTDecoder)
    cfg = gpt_tiny(max_seq_len=128, dtype="float32")
    sd = init_state_dict(cfg, seed=SEED, device="cpu")
    rng = np.random.RandomState(SEED + 2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 17, 90, 1, 33)]
    outs, logits = [], []
    for device in ("cuda", "cpu"):
        dec = PagedGPTDecoder(cfg, {k: v.to(device) for k, v in sd.items()},
                              num_pages=48, page_size=16, max_batch=4,
                              device=device)
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
        raise AssertionError("gpt_tiny f32 streams differ card vs CPU")
    log("small_ref", model="gpt_tiny f32", streams="equal card vs cpu",
        logit_max_abs_err=f"{float((logits[0] - logits[1]).abs().max()):.3e}")


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
# with a ragged length, a non-causal case
FLASH_CASES = [("train", TB, TL, TH, TH, TD, True),
               ("gqa", 2, 200, 4, 2, 64, True),
               ("noncausal", 2, 256, 2, 2, 128, False)]


def phase_train_kernel_checks(A, LN, X):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    err = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "layer_norm", "xent_fwd", "xent_bwd"), 0.0)

    def check(name, got, plain, plain32):
        err[name] = max(err[name], _check_close(name, got, plain, plain32))

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for case, B, L, Hq, Hkv, D, causal in FLASH_CASES:
            q = _rand(gen, (B, L, Hq, D), dtype)
            k = _rand(gen, (B, L, Hkv, D), dtype)
            v = _rand(gen, (B, L, Hkv, D), dtype)
            do = _rand(gen, (B, L, Hq, D), dtype)
            sc = D ** -0.5
            out, lse = A._fwd(q, k, v, causal, sc)
            p32 = A._fwd_ref(q.float(), k.float(), v.float(), causal, sc)
            check("flash_fwd", out, p32[0].to(dtype), p32[0])
            check("flash_fwd", lse, p32[1], p32[1])
            grads = A._bwd(q, k, v, out, lse, do, causal, sc)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
            r32 = A._bwd_ref(q.float(), k.float(), v.float(), do.float(),
                             lse, delta.contiguous(), causal, sc)
            check("flash_bwd_dq", grads[0], r32[0].to(dtype), r32[0])
            for g, r in zip(grads[1:], r32[1:]):
                check("flash_bwd_dkv", g, r.to(dtype), r)
            log("kernel", form=f"flash {case} B={B} L={L} Hq={Hq} Hkv={Hkv} "
                f"D={D} causal={causal}", dtype=dt,
                fwd_err=f"{err['flash_fwd']:.3e}",
                dq_err=f"{err['flash_bwd_dq']:.3e}",
                dkv_err=f"{err['flash_bwd_dkv']:.3e}")
            del q, k, v, do, out, lse, grads, r32, p32
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


def _bound(nbytes, flops):
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_BF16_FLOPS * 1e3
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
    specs = {
        "flash_fwd": (lambda i=0: A._fwd(q, k, v, True, sc),
                      lambda i=0: A._fwd_ref(q, k, v, True, sc),
                      sdpa_fwd, 4 * io + rows, 4 * TD * pairs),
        "flash_bwd_dq": (
            lambda i=0: _ok(A._kernel_lib().flash_bwd_dq(
                *_flash_ptrs(q, k, v, do, lse, delta),
                torch.empty_like(q).data_ptr(), *A._tail(
                    (TB, TL, TL, TH, TH, TD), True, sc, q))),
            lambda i=0: A._bwd_ref(q, k, v, do, lse, delta, True, sc),
            sdpa_bwd, 5 * io + 2 * rows, 6 * TD * pairs),
        "flash_bwd_dkv": (
            lambda i=0: _ok(A._kernel_lib().flash_bwd_dkv(
                *_flash_ptrs(q, k, v, do, lse, delta),
                torch.empty_like(k).data_ptr(),
                torch.empty_like(v).data_ptr(), *A._tail(
                    (TB, TL, TL, TH, TH, TD), True, sc, q))),
            lambda i=0: A._bwd_ref(q, k, v, do, lse, delta, True, sc),
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
            achieved_GBps=f"{nbytes / ms / 1e6:.1f}")
    return out


def _ok(rc):
    """A raw kernel call (timed alone, so not counted) that must launch."""
    if rc:
        raise RuntimeError(f"kernel launch failed ({rc})")


def _flash_ptrs(q, k, v, do, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


# ---------------------------------------------------------------- phase 6

TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# a training step of gpt_1p3b under remat 'full' launches: 24 attention
# forwards + 24 recomputed, one dQ and one dK/dV per layer, 2 LayerNorms
# per block twice + ln_f, one cross-entropy forward and backward
EXPECTED_PER_STEP = {"flash_fwd": 48, "flash_bwd_dq": 24,
                     "flash_bwd_dkv": 24, "layer_norm": 97, "xent_fwd": 1,
                     "xent_bwd": 1}


def _train_counts(A, LN, X):
    k = {**A.kernel_launches, "layer_norm": LN.kernel_launches,
         **X.kernel_launches}
    p = {**A.plain_launches, "layer_norm": LN.plain_launches,
         **X.plain_launches}
    return k, p


def _reset_train_counts(A, LN, X):
    for mod in (A, LN, X):
        mod.reset_counts()


def _trainer(cfg, device=None, lr=2e-4, acc_dtype="bfloat16", bf16=True,
             state=None):
    """The bench.py recipe: GPT(cfg) (seed 0, or the weights `state`)
    [.bfloat16()], the pretraining criterion, AdamW(lr, weight_decay
    0.1, ClipGradByGlobalNorm(1.0), bf16 moment slots), Trainer."""
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
    opt = AdamW(learning_rate=lr, weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0),
                accumulator_dtype=acc_dtype)
    return Trainer(model, opt,
                   lambda m, b: crit(m(b["input_ids"]), b["labels"]),
                   device=device)


def _batch(cfg, B, L, seed=SEED):
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, L + 1))
    return {"input_ids": ids[:, :-1].astype("int32"),
            "labels": ids[:, 1:].astype("int32")}


def phase_training(A, LN, X, smi):
    from paddle_tpu_torch.distributed import LossBuffer
    from paddle_tpu_torch.models import gpt_1p3b
    cfg = gpt_1p3b(max_seq_len=TL, remat_policy="full")
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
    if per_step != EXPECTED_PER_STEP or any(plain.values()):
        raise AssertionError(f"launches a step {per_step} (expected "
                             f"{EXPECTED_PER_STEP}), plain {plain}")
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
        plain=sum(plain.values()))
    return trainer, batch, kern


_FAMILIES = (("flash_attention", ("flash_fwd", "flash_dq", "flash_dkv")),
             ("layer_norm", ("layer_norm_kernel",)),
             ("xent", ("xent_fwd", "xent_bwd")),
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
    from paddle_tpu_torch.ops import fused_ops as X
    from paddle_tpu_torch.ops import layer_norm as LN
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    t_start = time.perf_counter()
    smi = phase_environment()
    max_err = phase_kernel_checks(rpa)
    timing = phase_kernel_timing(rpa)
    dec, prompts, streams, launches = phase_serving(rpa)
    phase_profile(dec, prompts)
    phase_oracle(dec, prompts, streams)
    del dec
    phase_small_reference()
    train_err = phase_train_kernel_checks(A, LN, X)
    train_timing = phase_train_kernel_timing(A, LN, X)
    trainer, batch, train_launches = phase_training(A, LN, X, smi)
    phase_train_profile(trainer, batch)
    phase_train_split(trainer, batch)
    del trainer, batch
    phase_train_small_reference()
    log("done", total_s=f"{time.perf_counter() - t_start:.1f}")
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/ragged_paged_attention.py:229",
        "launches": launches["kernel"], "max_abs_err": max_err, **timing}]
    for name, (source, replaces) in TRAIN_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": train_launches[name],
                        "max_abs_err": train_err[name],
                        **train_timing[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
