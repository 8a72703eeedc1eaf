"""Build the package's CUDA sources into a shared library, once per content.

`nvcc` compiles `nmcfluid_torch/csrc/*.cu` for Hopper (sm_90a) into a
shared library with a plain C interface, which the kernel wrappers load
with ctypes. The library lands in `nmcfluid_torch/_build/` (listed in
.gitignore) under a name keyed by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses it; ptxas's report of each
kernel's registers, shared memory and spills (`-Xptxas -v`) is kept
beside it (`build_log`). Nothing is built at import: the first wrapper
call on a CUDA tensor builds.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or $CUDA_HOME/bin)")


def library_path(name: str, sources) -> str:
    """Path of the shared library for `sources` (file names in csrc/),
    building it first if no library for this content exists."""
    paths = [os.path.join(CSRC, s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}\n"
                               f"{res.stderr}")
        with open(out + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, out)        # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_log(name: str, sources) -> str:
    """nvcc's output for the library of `sources` (ptxas -v lines),
    building it first if needed."""
    with open(library_path(name, sources) + ".log") as f:
        return f.read()


def load_source(name: str, src: str) -> ctypes.CDLL:
    """Build (once per content) and load a library from CUDA source text,
    for the probes that time edited copies of a csrc/ file."""
    tag = hashlib.sha256((" ".join(NVCC_FLAGS) + src).encode()).hexdigest()
    base = os.path.join(BUILD_DIR, f"{name}_{tag[:16]}")
    if not os.path.exists(base + ".so"):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(base + ".cu", "w") as f:
            f.write(src)
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", base + ".so",
                              base + ".cu"], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}\n"
                               f"{res.stderr}")
    return ctypes.CDLL(base + ".so")


def load(name: str, sources) -> ctypes.CDLL:
    """The ctypes handle of the built library (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(library_path(name, sources))
        _loaded[name] = lib
    return lib
