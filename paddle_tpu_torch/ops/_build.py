"""Build and load the port's hand-written CUDA kernels.

Each `ops/csrc/<name>.cu` compiles with nvcc, on its own, into a shared
library with a plain C interface (`lib<name>-<hash>.so`) that the op
modules load with ctypes. The build runs at first use, from the sources
in the checkout, into `paddle_tpu_torch/_build/` (listed in
.gitignore); the file name carries a hash of the source, of the csrc/
headers it includes (`tc_tile.cuh`, `decode_attention.cuh`,
`adamw.cuh`) and of the flags, so an edited source or header rebuilds
and an unchanged one is reused.
`build_all` starts one nvcc per source together, so the build takes as
long as the slowest source, not the sum.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build_all", "load", "build_seconds", "build_logs"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# sm_90a (not sm_90): the Hopper-only instructions (wgmma, setmaxnreg)
# exist only for that target. -Xptxas=-v reports registers, shared
# memory and spills per kernel into the build log.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

build_seconds = {}   # name -> seconds this process spent building it
build_logs = {}      # name -> nvcc's output for that build
_LIBS = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(src, seen=None):
    """`src` and every header of csrc/ it includes with quotes, directly
    or through another header, in include order."""
    seen = [] if seen is None else seen
    if src in seen or not src.exists():
        return seen
    seen.append(src)
    for inc in _INCLUDE.findall(src.read_bytes()):
        _sources(src.parent / inc.decode(), seen)
    return seen


def _target(name):
    """(source, library path): the name carries a hash of the source, the
    headers it includes and the flags, so an edited header rebuilds
    too."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in _sources(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None):
    """Build the kernel libraries `names` (default: every csrc/*.cu) that
    are not built yet, one nvcc process per source, all started
    together. Returns {name: seconds spent building it here} (0.0 for a
    library that was already built)."""
    names = list(names) if names else sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log = proc.communicate()[0].decode(errors="replace")
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builders agree
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: build_seconds[name] for name in names}


def load(name):
    """The ctypes handle of kernel library `name`, building it first if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, out = _target(name)
        if not out.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib
