"""Build and load the port's hand-written CUDA kernels and host libraries.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers: seconds to build, not
minutes) and loaded with ``ctypes``; each ``csrc/<name>.cpp`` (host code: the
mask rasterizer) likewise by the host C++ compiler (``CXX``, else ``c++``).
Libraries land in ``build/torch_kernels`` at the repository root, named by a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is reused.

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
KERNELS = ("nms", "roi_align", "matcher", "group_norm")
HOST_LIBS = ("maskops",)

# -fmad=false: no FMA contraction, so the kernels round each product and sum
# as their plain PyTorch versions do (NMS decisions at the IoU threshold and
# the matcher's thresholds and ties must agree exactly).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# ISO C++ (not gnu++): no floating-point contraction, so the rasterizer
# rounds as the JAX package's build of the same routine does
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIBS = {}


def nvcc_path():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source(name):
    """(source path, compiler, flags) of library `name`."""
    if name in HOST_LIBS:
        cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
        if not cxx:
            raise RuntimeError("no host C++ compiler found: set CXX")
        return os.path.join(CSRC, name + ".cpp"), cxx, HOST_FLAGS
    return os.path.join(CSRC, name + ".cu"), None, NVCC_FLAGS


def library_path(name):
    src, _, flags = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, "lib{}-{}.so".format(name, digest[:12]))


def build(names=KERNELS):
    """Compile every missing library, one compiler process per source, all
    at once.

    Returns {name: compiler output} for the libraries it built (for CUDA
    sources ptxas's register and shared-memory report, since the flags carry
    -Xptxas -v). Raises RuntimeError naming the source if any compile
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        src, compiler, flags = _source(name)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler or nvcc_path(), *flags, "-o", tmp, src]
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
        raise RuntimeError("compiling failed for {}:\n{}".format(
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
