"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers: seconds to build, not
minutes) and loaded with ``ctypes``. Libraries land in ``build/torch_kernels``
at the repository root, named by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is reused.

Nothing here runs at import time; the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
KERNELS = ("nms", "roi_align", "matcher")

# -fmad=false: no FMA contraction, so the kernels round each product and sum
# as their plain PyTorch versions do (NMS decisions at the IoU threshold and
# the matcher's thresholds and ties must agree exactly).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS = {}


def nvcc_path():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name):
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, "lib{}-{}.so".format(name, digest[:12]))


def build(names=KERNELS):
    """Compile every missing library, one nvcc per source, all at once.

    Returns {name: compiler output} for the libraries it built (ptxas's
    register and shared-memory report, since the flags carry -Xptxas -v).
    Raises RuntimeError naming the source if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs[name] = (proc, tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out.decode(errors="replace")
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for {}:\n{}".format(
            ", ".join(failed), "\n".join(logs[n] for n in failed)))
    return logs


def load(name):
    """The ctypes handle of kernel library `name`, built if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build((name,))
        lib = ctypes.CDLL(path)
        _LIBS[name] = lib
    return lib


def check(rc, what):
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError("{} kernel failed: CUDA error {}".format(what, rc))
