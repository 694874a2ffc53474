"""Times the block-sparse attention kernel, the single-tensor AdamW
update, the LayerNorm / RMSNorm kernels and the dropout kernels of
several checkouts of the port on one card, in one call, on the same
inputs, so that two versions are compared within one run.

The inputs are chip_smoke.py's timing inputs, drawn by its own helpers
from the same seeds: block-sparse at B 4 x 16 x 4096 x 128 bf16, bs 128,
one BigBird pattern per (batch, head); AdamW at one [2048, 8192] bf16
p/g/m/v with a clip scale; the norms at GPT's [8192, 2048] and BERT's
[16384, 768] bf16 rows (eps 1e-5 and 1e-12), bf16 weights. For the norms
each tree is timed through its own entry points: the LayerNorm forward
(`fused_layer_norm` without grad), the LayerNorm backward a CUDA tensor
takes in that tree (its kernel where the tree has one, else autograd of
`_ln_ref`), the eager chain (autograd of `_ln_ref`, in every tree), the
forward and backward through the entry point together, and the RMSNorm
forward; beside them the library calls (`F.layer_norm`, aten's
`native_layer_norm_backward`, the two through autograd, `F.rms_norm`),
which no tree calls. The dropout group times F.dropout at BERT's
[16384, 768] bf16, p 0.1, through the entry point (forward alone, and
forward and backward: the hash dropout kernel where the tree has one,
else the eager int64 chain and autograd of its `where`), and the dropout
+ residual + LayerNorm op's launch (`fused_ops._drln_launch`) at GPT's
and BERT's rows with the in-kernel hash and at BERT's with the caller's
bits, on chip_smoke.py's timing inputs. A tree is a directory holding a
`paddle_tpu_torch/` package (the repo root, or an unpacked `git archive`
of another commit). Each tree is timed in a process of its own that
imports the package from that tree, so its kernels are built from its own
sources into its own `_build/`; the builds of all trees run first, side
by side. List a tree more than once (A B B A) to bracket drift.

    python3 tools/kernel_ab.py [--out FILE] [--kernels bsa,adamw,norm,dropout] TREE ...

Prints one JSON line per run (CUDA-event ms of eager calls, as
chip_smoke.py times them, and CUDA-graph device ms; a norm entry is
[eager ms, device ms]), then the card's name and power limit. Needs one
card.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# the kernel sources each group builds, where the tree has them
GROUPS = {"bsa": ("block_sparse_attention",), "adamw": ("adamw",),
          "norm": ("layer_norm",),
          "dropout": ("hash_dropout", "layer_norm",
                      "dropout_residual_layer_norm")}


def _import_tree(tree):
    sys.path[:0] = [str(tree), str(REPO)]
    import paddle_tpu_torch
    pkg = Path(paddle_tpu_torch.__file__).resolve()
    if tree not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")


def build(tree, groups):
    _import_tree(tree)
    from paddle_tpu_torch.ops import _build
    return _build.build_all([n for g in groups for n in GROUPS[g]
                             if (_build.CSRC / f"{n}.cu").exists()])


def time_tree(tree, groups):
    """One JSON-able dict of the tree's timings."""
    _import_tree(tree)
    row = {"tree": str(tree)}
    if "bsa" in groups:
        _time_bsa(row)
    if "adamw" in groups:
        _time_adamw(row)
    if "norm" in groups:
        _time_norms(row)
    if "dropout" in groups:
        _time_dropout(row)
    return row


def _time_bsa(row):
    import torch

    import chip_smoke as S
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 31)
    q, k, v, cols, counts, visited, _ = S._bs_timing_inputs(bsa, gen)
    scale = 1.0 / S.D ** 0.5

    def bs(i=0):
        return bsa._launch(q, k, v, cols, counts, S.SBS, scale)

    if hasattr(bsa, "reset_counts"):
        bsa.reset_counts()
    out = bs()
    plain32 = bsa._bs_fwd_ref(q.float(), k.float(), v.float(), cols,
                              counts, S.SBS, scale)
    err = (out.float() - plain32).abs()
    row.update(
        bs_ms=[S.cuda_ms(bs, 20) for _ in range(3)],
        bs_device_ms=S.cuda_graph_ms(bs, 20),
        bs_max_abs_err=float(err.max()),
        bs_within_ulp=bool((err <= S.bf16_ulp(plain32) + 1e-5).all()),
        bs_routes=dict(getattr(bsa, "route_launches", {})),
        bs_visited_blocks=visited)


def _time_adamw(row):
    import torch

    import chip_smoke as S
    from paddle_tpu_torch.ops import fused_ops as X
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 21)
    p, g, m, v, _, clip = S._adamw_tensors(gen, S._BF16, S._BF16, S._BF16,
                                           False, True)
    hyper = (*S.ADAMW_HYPER, *S._adamw_bc(S.ADAMW_STEP))

    def adamw(i=0):
        X._adamw_launch(p, g, m, v, None, clip, hyper)

    row.update(adamw_ms=[S.cuda_ms(adamw, 20) for _ in range(3)],
               adamw_device_ms=S.cuda_graph_ms(adamw, 20))


def _time_norms(row):
    import torch

    import chip_smoke as S
    from paddle_tpu_torch.ops import layer_norm as LN
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 32)
    for n, h in S.NORM_SHAPES:
        eps = 1e-5 if h == S.THID else 1e-12
        x = S._rand(gen, (n, h), S._BF16, 2.0)
        w, b = S._rand(gen, (h,), S._BF16), S._rand(gen, (h,), S._BF16)
        g = S._rand(gen, (n, h), S._BF16)
        xg, wg, bg = (t.detach().requires_grad_() for t in (x, w, b))
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], w, b, eps)

        def eager_bwd(i=0):
            with torch.enable_grad():
                xs, ws, bs = (t.detach().requires_grad_() for t in (x, w, b))
                return torch.autograd.grad(LN._ln_ref(xs, ws, bs, eps),
                                           (xs, ws, bs), g)

        if hasattr(LN, "_bwd_launch"):
            _, mean, rstd = LN._launch(x, w, b, eps)

            def tree_bwd(i=0):
                return LN._bwd_launch(x, g, w, mean, rstd)
        else:
            tree_bwd = eager_bwd

        def fwd_bwd(i=0, fn=LN.fused_layer_norm):
            with torch.enable_grad():
                return torch.autograd.grad(fn(xg, wg, bg, eps), (xg, wg, bg),
                                           g)

        def no_grad(fn, *args):
            def run(i=0):
                with torch.no_grad():
                    return fn(*args)
            return run

        runs = {
            "ln_fwd": (no_grad(LN.fused_layer_norm, x, w, b, eps), 20),
            "ln_bwd": (tree_bwd, 20),
            "ln_bwd_eager": (eager_bwd, 5),
            "ln_fwd_bwd": (fwd_bwd, 10),
            "rms_fwd": (no_grad(LN.fused_rms_norm, x, w, 1e-6), 20),
            "lib_ln_fwd": (no_grad(F.layer_norm, x, (h,), w, b, eps), 20),
            "lib_ln_bwd": (lambda i=0: torch.ops.aten.
                           native_layer_norm_backward(
                               g, x, [h], lmean, lrstd, w, b,
                               [True, True, True]), 20),
            "lib_ln_fwd_bwd": (lambda i=0: fwd_bwd(
                fn=lambda a, c, d, e: F.layer_norm(a, (h,), c, d, e)), 10),
            "lib_rms_fwd": (no_grad(F.rms_norm, x, (h,), w, 1e-6), 20),
        }
        for name, (fn, iters) in runs.items():
            row[f"{name}[{n}x{h}]"] = [S.cuda_ms(fn, iters),
                                       S.cuda_graph_ms(fn, iters)]
        del x, g, xg, lmean, lrstd, runs
        torch.cuda.empty_cache()


def _time_dropout(row):
    import torch

    import chip_smoke as S
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_ops as X
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 26)
    shape, p = (S.BB * S.BL, S.BHID), S.BERT_RATE
    x, g = S._rand(gen, shape, S._BF16), S._rand(gen, shape, S._BF16)
    xg = x.detach().requires_grad_()

    def fwd(i=0):
        with torch.no_grad():
            return F.dropout(x, p)

    def fwd_bwd(i=0):
        with torch.enable_grad():
            return torch.autograd.grad(F.dropout(xg, p), xg, g)

    runs = {f"dropout_fwd[{shape[0]}x{shape[1]}]": (fwd, 20),
            f"dropout_fwd_bwd[{shape[0]}x{shape[1]}]": (fwd_bwd, 20)}
    # phase_slice5_kernel_timing's inputs, drawn in its order
    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 21)
    S._adamw_tensors(gen, S._BF16, S._BF16, S._BF16, False, True)
    for n, h in S.NORM_SHAPES:
        xd = S._rand(gen, (n, h), S._BF16, 2.0)
        wd, bd = S._rand(gen, (h,), S._BF16), S._rand(gen, (h,), S._BF16)
        rd = S._rand(gen, (n, h), S._BF16)
        runs[f"drln_hash[{n}x{h}]"] = (
            lambda i=0, a=(xd, rd, wd, bd): X._drln_launch(
                *a, S.DRLN_RATE, 1e-5, S.DRLN_SEED, None), 20)
    n, h = S.NORM_SHAPES[1]
    bits = torch.zeros((n, h), dtype=torch.int32, device="cuda")
    xd, rd = (S._rand(gen, (n, h), S._BF16) for _ in range(2))
    wd, bd = (S._rand(gen, (h,), S._BF16) for _ in range(2))
    runs[f"drln_bits[{n}x{h}]"] = (
        lambda i=0: X._drln_launch(xd, rd, wd, bd, S.DRLN_RATE, 1e-5, 0,
                                   bits), 20)
    for name, (fn, iters) in runs.items():
        row[name] = [S.cuda_ms(fn, iters), S.cuda_graph_ms(fn, iters)]
    del runs
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", help="also append the JSON lines here")
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help="groups to time, of " + ",".join(GROUPS))
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    groups = args.kernels.split(",")
    if set(groups) - set(GROUPS):
        ap.error(f"--kernels takes {','.join(GROUPS)}")
    if args.build:
        build(Path(args.build).resolve(), groups)
        return 0
    if args.one:
        print(json.dumps(time_tree(Path(args.one).resolve(), groups)),
              flush=True)
        return 0
    if not args.trees:
        ap.error("give at least one tree")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    trees = [Path(t).resolve() for t in args.trees]
    me = [sys.executable, str(Path(__file__).resolve())]
    me += ["--kernels", args.kernels]
    builds = [subprocess.Popen(me + ["--build", str(t)])
              for t in dict.fromkeys(trees)]
    if any([b.wait() for b in builds]):
        return 1
    rows = []
    for tree in trees:
        res = subprocess.run(me + ["--one", str(tree)],
                             capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows.append(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(rows) + "\n")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
