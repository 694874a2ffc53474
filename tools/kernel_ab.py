"""Times the block-sparse attention kernel and the single-tensor AdamW
update of several checkouts of the port on one card, in one call, on the
same inputs, so that two versions are compared within one run.

The inputs are chip_smoke.py's timing inputs, drawn by its own helpers
from the same seeds: block-sparse at B 4 x 16 x 4096 x 128 bf16, bs 128,
one BigBird pattern per (batch, head); AdamW at one [2048, 8192] bf16
p/g/m/v with a clip scale. A tree is a directory holding a
`paddle_tpu_torch/` package (the repo root, or an unpacked `git archive`
of another commit). Each tree is timed in a process of its own that
imports the package from that tree, so its kernels are built from its own
sources into its own `_build/`; the builds of all trees run first, side
by side. List a tree more than once (A B B A) to bracket drift.

    python3 tools/kernel_ab.py [--out FILE] TREE [TREE ...]

Prints one JSON line per run (CUDA-event ms of eager calls, as
chip_smoke.py times them, and CUDA-graph device ms), then the card's name
and power limit. Needs one card.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
KERNELS = ["block_sparse_attention", "adamw"]


def _import_tree(tree):
    sys.path[:0] = [str(tree), str(REPO)]
    import paddle_tpu_torch
    pkg = Path(paddle_tpu_torch.__file__).resolve()
    if tree not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")


def build(tree):
    _import_tree(tree)
    from paddle_tpu_torch.ops import _build
    return _build.build_all(KERNELS)


def time_tree(tree):
    """One JSON-able dict of the tree's timings."""
    _import_tree(tree)
    import torch

    import chip_smoke as S
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import fused_ops as X

    row = {"tree": str(tree)}
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
    del q, k, v, out, plain32, err

    gen = torch.Generator(device="cuda").manual_seed(S.SEED + 21)
    p, g, m, v, _, clip = S._adamw_tensors(gen, S._BF16, S._BF16, S._BF16,
                                           False, True)
    hyper = (*S.ADAMW_HYPER, *S._adamw_bc(S.ADAMW_STEP))

    def adamw(i=0):
        X._adamw_launch(p, g, m, v, None, clip, hyper)

    row.update(adamw_ms=[S.cuda_ms(adamw, 20) for _ in range(3)],
               adamw_device_ms=S.cuda_graph_ms(adamw, 20))
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", help="also append the JSON lines here")
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        build(Path(args.build).resolve())
        return 0
    if args.one:
        print(json.dumps(time_tree(Path(args.one).resolve())), flush=True)
        return 0
    if not args.trees:
        ap.error("give at least one tree")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    trees = [Path(t).resolve() for t in args.trees]
    me = [sys.executable, str(Path(__file__).resolve())]
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
