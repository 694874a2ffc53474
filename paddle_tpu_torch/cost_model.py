"""Serving cost model (counterpart of the decode/ragged half of
`paddle_tpu/cost_model.py`): the roofline legs of a decode or mixed
ragged tick, the ragged scheduler's chunk budget, the multi-step
horizon K, and the host KV tier's restore-vs-recompute pricing
(`prefill_ttft_s`, `kv_restore_s`).

The chip is an NVIDIA H100 SXM. Its peak figures below are NVIDIA's
data-sheet values (dense bf16 tensor-core FLOP/s, HBM bytes/s and
capacity), not measurements; they price scheduling decisions, never a
reported result. `efficiency` (default 0.65) is an assumed achievable
share of the bf16 peak for the scheduler's compute leg — it is not
measured on the card.
"""
import math
import time
from dataclasses import dataclass

import torch

__all__ = ["ChipSpec", "H100_SXM", "decode_tick_roofline_s",
           "ragged_tick_legs", "ragged_tick_roofline_s",
           "ragged_chunk_tokens", "decode_horizon", "measured_host_sync_s",
           "prefill_ttft_s", "kv_restore_s"]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float      # dense bf16 FLOP/s
    hbm_bw: float          # HBM bytes/s
    hbm_bytes: int         # HBM capacity
    # host<->card wire bytes/s, one direction: the H2D leg a host-tier
    # restore pays (`kv_restore_s`)
    host_bw: float = 64e9
    # host-RAM read bytes/s a cross-process host tier pays before the
    # wire (`kv_restore_s(shared=True)`); an assumed DRAM-copy rate,
    # not a data-sheet or measured figure
    host_read_bw: float = 64e9


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s, 80 GB;
# host link PCIe Gen5 x16, 128 GB/s both directions together, so 64 GB/s
# a direction
H100_SXM = ChipSpec("h100-sxm", 989e12, 3.35e12, 80 * 10 ** 9,
                    host_bw=64e9)


def _chip(chip):
    return chip if isinstance(chip, ChipSpec) else H100_SXM


# Fallback host cost of one decode sync when no measurement is available.
# The engine's horizon only needs its magnitude: K is capped and bucketed.
DEFAULT_DECODE_SYNC_S = 4e-4

_MEASURED_SYNC = {}


def measured_host_sync_s(device="cuda", force=False):
    """Measure (once per process and device type) what one host sync of
    the decode loop costs: enqueue a trivial op and wait for it — a
    `torch.cuda.synchronize()` round trip on the card, a `.item()` read
    on the CPU. This is the overhead `decode_horizon` amortizes over K
    device-resident ticks."""
    dev = torch.device(device)
    if dev.type in _MEASURED_SYNC and not force:
        return _MEASURED_SYNC[dev.type]
    x = torch.zeros(8, dtype=torch.int32, device=dev)

    def sync():
        x.add_(1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        else:
            x[0].item()

    sync()                                   # first call outside the timing
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        sync()
    _MEASURED_SYNC[dev.type] = max((time.perf_counter() - t0) / n, 1e-6)
    return _MEASURED_SYNC[dev.type]


def decode_tick_roofline_s(step_hbm_bytes, chip=None):
    """Floor of ONE decode tick: decode is HBM-bound, so a tick cannot
    beat its bytes moved (every weight byte + the batch's KV prefix,
    `PagedGPTDecoder.step_hbm_bytes`) over HBM bandwidth."""
    return step_hbm_bytes / _chip(chip).hbm_bw


def ragged_tick_legs(step_hbm_bytes, new_tokens=0, flops_per_token=0.0,
                     chip=None, efficiency=0.65):
    """(hbm_s, compute_s) legs of one mixed tick: the decode tick's HBM
    leg and the compute leg of its `new_tokens` new positions."""
    chip = _chip(chip)
    hbm = step_hbm_bytes / chip.hbm_bw
    compute = (max(float(new_tokens), 0.0) *
               max(float(flops_per_token), 0.0) /
               (chip.peak_flops * efficiency))
    return hbm, compute


def ragged_tick_roofline_s(step_hbm_bytes, new_tokens=0,
                           flops_per_token=0.0, chip=None, efficiency=0.65):
    """Floor of ONE mixed (ragged) tick priced on its total new-token
    count: max(HBM leg, token compute leg). While the tokens' compute
    fits under the HBM leg, prompt tokens ride the tick at no marginal
    time — why chunked prefill works."""
    return max(*ragged_tick_legs(step_hbm_bytes, new_tokens,
                                 flops_per_token, chip=chip,
                                 efficiency=efficiency))


def ragged_chunk_tokens(step_hbm_bytes, flops_per_token, chip=None,
                        efficiency=0.65, cap=256, floor=8):
    """Default per-tick new-token budget of the ragged scheduler: the
    largest power of two whose compute leg hides under the decode
    tick's HBM leg, clamped to [floor, cap]. `cap` bounds the decode
    rows' per-tick latency jitter; `floor` keeps prompts moving for
    models whose tick is compute-tight."""
    chip = _chip(chip)
    hbm = step_hbm_bytes / chip.hbm_bw
    per_tok = (max(float(flops_per_token), 0.0) /
               (chip.peak_flops * efficiency))
    if per_tok <= 0:
        return int(cap)
    w = int(floor)
    while w * 2 <= int(cap) and (w * 2) * per_tok <= hbm:
        w *= 2
    return w


def decode_horizon(step_hbm_bytes, host_sync_s=None, chip=None,
                   k_cap=32, sync_overhead_frac=0.10,
                   chunk_tokens=0, flops_per_token=0.0, device="cuda"):
    """Best multi-step horizon K — how many device-resident ticks to
    fuse per host sync. With K ticks fused, per-token time is about
    t_tick + h/K (h: host cost per sync, measured on `device` when not
    given); pick the smallest K with h/(K*t_tick) <= sync_overhead_frac,
    capped at `k_cap`. With `chunk_tokens`/`flops_per_token` the tick is
    priced as a mixed ragged tick."""
    if host_sync_s is None:
        host_sync_s = measured_host_sync_s(device)
    if chunk_tokens:
        t = ragged_tick_roofline_s(step_hbm_bytes, chunk_tokens,
                                   flops_per_token, chip=chip)
    else:
        t = decode_tick_roofline_s(step_hbm_bytes, chip=chip)
    if t <= 0:
        return int(k_cap)
    k = math.ceil(host_sync_s / (sync_overhead_frac * t))
    return int(min(max(k, 1), int(k_cap)))


def prefill_ttft_s(prompt_tokens, flops_per_token, cached_frac=0.0,
                   chip=None, host_sync_s=None, efficiency=0.65,
                   device="cuda"):
    """Analytic time-to-first-token of one prompt: the compute roofline
    of the UNCACHED prompt span plus one host sync (measured on `device`
    when not given). `cached_frac` is the prefix-cache hit fraction of
    the prompt: cached pages are mounted into the page table host-side
    (zero device FLOPs), so prefill compute scales with the
    (1 - cached_frac) remainder."""
    chip = _chip(chip)
    if host_sync_s is None:
        host_sync_s = measured_host_sync_s(device)
    frac = min(max(float(cached_frac), 0.0), 1.0)
    uncached = max(float(prompt_tokens), 0.0) * (1.0 - frac)
    compute = (uncached * max(float(flops_per_token), 0.0)
               / (chip.peak_flops * efficiency))
    return compute + host_sync_s


def kv_restore_s(restore_bytes, chip=None, shared=False):
    """Analytic floor of re-mounting spilled KV pages from pinned host
    RAM: bytes over the host-to-card wire (`ChipSpec.host_bw`). The host
    tier compares it with the recompute price of the same span
    (`prefill_ttft_s` with no sync floor) and restores only when the wire
    wins (`serving.kv_tier.restore_beats_recompute`). `shared=True` adds a
    host-RAM read leg (`ChipSpec.host_read_bw`) before the copy, for a
    tier that lives in another process's memory."""
    chip = _chip(chip)
    b = max(float(restore_bytes), 0.0)
    t = b / chip.host_bw
    if shared:
        t += b / chip.host_read_bw
    return t
