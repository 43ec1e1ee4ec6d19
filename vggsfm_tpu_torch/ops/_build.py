"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

nvcc compiles the sources for ``sm_90a`` (Hopper) into a shared library
with a plain C interface, loaded with ctypes. The library is named by a
hash of the sources and the command, under ``vggsfm_tpu_torch/_build/``
(listed in .gitignore), so a fresh checkout builds it on its first call and
an edited source never loads a stale library. Importing this module needs
neither CUDA nor nvcc: nothing is built until a kernel is first launched.

The same device code also builds with the host C++ compiler against
``csrc/host_emu.h`` (`load_host_emulation`), which runs it on the CPU
thread by thread for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

CUDA_SOURCES = ("fused_former.cu", "corr_sample.cu", "flash_attn.cu")
HEADERS = ("fused_former.cuh", "corr_sample.cuh", "flash_attn.cuh")
EMU_SOURCES = ("host_emu.cpp", "attn_emu.cpp")
EMU_HEADERS = ("host_emu.h", "fused_former.cuh", "corr_sample.cuh",
               "flash_attn.cuh")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict = {}
# what the last build reported: seconds, compiler output, library path
build_info: dict = {}


def find_nvcc() -> str | None:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    return shutil.which("nvcc")


def nvcc_command(out_path: str, nvcc: str = "nvcc") -> list:
    """The nvcc command line that builds the kernels into `out_path`.
    ``--threads 0`` compiles the sources side by side; ``-Xptxas -v``
    makes ptxas report registers, shared memory and spills per kernel
    (kept in `build_info`)."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "--threads",
            "0", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out_path,
            *[os.path.join(CSRC, s) for s in CUDA_SOURCES]]


def host_emu_command(out_path: str, cxx: str = "g++") -> list:
    return [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
            "-o", out_path, *[os.path.join(CSRC, s) for s in EMU_SOURCES]]


def _digest(files, cmd_tail) -> str:
    h = hashlib.sha256()
    for name in files:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(cmd_tail).encode())
    return h.hexdigest()[:16]


def _build(kind: str, files, make_cmd) -> str:
    """Compile into a content-named library unless it exists; returns its
    path. Writes to a temporary name first and renames, so concurrent
    builds never load a half-written file."""
    tail = make_cmd("OUT")[1:]
    path = os.path.join(BUILD_DIR, f"lib{kind}_{_digest(files, tail)}.so")
    if os.path.exists(path):
        build_info[kind] = {"seconds": 0.0, "log": "cached", "path": path}
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = make_cmd(tmp)
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.time() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"building {kind} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    build_info[kind] = {"seconds": secs,
                        "log": (proc.stdout + proc.stderr).strip(),
                        "path": path}
    return path


def _declare(lib, with_stream: bool):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    tail = [vp] if with_stream else []
    lib.vf_fused_ln_mlp.argtypes = [ci] + [vp] * 7 + [ci] * 3 + tail
    lib.vf_fused_ln_mlp.restype = ci
    lib.vf_ln_mlp_kernels.argtypes = [ci] * 2
    lib.vf_ln_mlp_kernels.restype = ci
    lib.vf_ln_mlp_scratch_bytes.argtypes = [ci] * 4
    lib.vf_ln_mlp_scratch_bytes.restype = ctypes.c_size_t
    lib.vf_fused_block.argtypes = [ci] + [vp] * 10 + [ci] * 5 + tail
    lib.vf_fused_block.restype = ci
    lib.vf_block_smem_bytes.argtypes = [ci] * 3
    lib.vf_block_smem_bytes.restype = ctypes.c_size_t
    lib.vf_ln_mlp_smem_bytes.argtypes = [ci]
    lib.vf_ln_mlp_smem_bytes.restype = ctypes.c_size_t
    lib.vf_fused_ln_attn.argtypes = [ci] + [vp] * 7 + [ci] * 5 + tail
    lib.vf_fused_ln_attn.restype = ci
    lib.vf_attn_scratch_bytes.argtypes = [ci] * 3
    lib.vf_attn_scratch_bytes.restype = ctypes.c_size_t
    lib.vf_cc_tile.argtypes = [ci] * 3
    lib.vf_cc_tile.restype = ci
    lib.vf_attn_smem_bytes.argtypes = [ci] * 4
    lib.vf_attn_smem_bytes.restype = ctypes.c_size_t
    cll = ctypes.c_longlong
    lib.vf_corr_sample.argtypes = ([ci] * 3 + [vp] * 5 + [cll] * 2 + [vp]
                                   + [ci] * 4 + tail)
    lib.vf_corr_sample.restype = ci
    lib.vf_corr_variant.argtypes = [ci, ci, vp, vp, vp, ci]
    lib.vf_corr_variant.restype = ci
    lib.vf_corr_smem_bytes.argtypes = [ci] * 3
    lib.vf_corr_smem_bytes.restype = ctypes.c_size_t
    lib.vf_flash_attn.argtypes = [vp] * 4 + [ci] * 4 + [ctypes.c_float] \
        + tail
    lib.vf_flash_attn.restype = ci
    return lib


def load_library():
    """The CUDA kernels' library, built on first call."""
    with _lock:
        if "cuda" not in _libs:
            nvcc = find_nvcc()
            if nvcc is None:
                raise RuntimeError(
                    "nvcc not found (looked in $CUDA_HOME/bin, "
                    "/usr/local/cuda/bin and PATH): the port's kernels "
                    "cannot be built")
            path = _build("vf_former", CUDA_SOURCES + HEADERS,
                          lambda out: nvcc_command(out, nvcc))
            _libs["cuda"] = _declare(ctypes.CDLL(path), with_stream=True)
        return _libs["cuda"]


def load_host_emulation():
    """The same device code built for the CPU against host_emu.h."""
    with _lock:
        if "emu" not in _libs:
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no host C++ compiler (g++/c++) found")
            path = _build("vf_former_emu", EMU_SOURCES + EMU_HEADERS,
                          lambda out: host_emu_command(out, cxx))
            _libs["emu"] = _declare(ctypes.CDLL(path), with_stream=False)
        return _libs["emu"]

