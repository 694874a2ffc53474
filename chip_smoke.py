#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py          # needs one CUDA card (an H100)

Builds every hand-written kernel from the sources in the checkout, holds
each against its plain PyTorch version at the serving path's shapes,
serves GPT-1.3B (gpt_1p3b at full width, random weights from seed 0)
through the port's default engine, profiles a short serving window
(device time by kernel family), and checks what comes out against the
port's per-tick decoder and, on gpt_tiny, against the port's CPU path.
Every phase raises on failure. The output
is one line per phase, then one JSON line with the kernels' numbers, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Without CUDA, or without the package next
to it, the script exits non-zero and prints no result. Imports only
torch, numpy and the port (never jax or paddle_tpu).
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_HBM_BYTES_PER_S = 3.35e12      # NVIDIA data sheet, H100 SXM
H100_F32_FLOPS = 67e12              # data sheet, f32 outside tensor cores
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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas", kernel=name, info=repr(line.strip()))
    return smi


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
    log("done", total_s=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/ragged_paged_attention.py:229",
        "launches": launches["kernel"], "max_abs_err": max_err,
        **timing}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
