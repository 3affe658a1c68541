"""Build the port's CUDA sources with nvcc and load them with ctypes.

No counterpart in ``deepspeed_tpu``: Pallas kernels compile inside jax. Here
each ``deepspeed_tpu_torch/csrc/<name>.cu`` is compiled on first use into
``build/deepspeed_tpu_torch/<name>-<hash>.so`` beside the package, where the
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source rebuilds and an
unchanged one loads at once. Every source exports a plain C interface:
compiling against PyTorch's headers takes minutes per file, nvcc on a plain
``.cu`` takes seconds.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "deepspeed_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def sources():
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
            "needed to build the deepspeed_tpu_torch kernels")
    return path


def library_path(name: str) -> Path:
    # the shared headers count too: an edited header rebuilds every source
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=None):
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns
    ``{name: {"seconds": wall seconds, "log": compiler output}}`` for the
    sources it compiled; raises with nvcc's output if any fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        done[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))
