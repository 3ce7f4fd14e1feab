"""Build the package's CUDA C++ sources with nvcc and load them with ctypes.

Each library is compiled on first use into `build/kernels/<name>-<hash>/`
at the repository root, keyed by a hash of the flags, the library's sources
and every other file in `csrc/` (the headers the sources include), so a
changed source or header builds anew and an unchanged tree loads from the
cache.  The sources have a plain C interface (no PyTorch headers), which
keeps a build to seconds.

No fast math, and FMA contraction off: fast division, fast sqrt or a fused
multiply-add can flip branches that hinge on ULP-close compares, which
would break pixel parity with the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path          # the shared library
    cache_hit: bool     # loaded from an earlier build
    seconds: float      # time spent building (0 on a cache hit)
    log: str            # nvcc's output (registers, spills) from the build


# name -> (library, BuildInfo): a library is loaded once per process
_LOADED: dict = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "nvcc on the machine that has the GPU")
    return path


def build_dir(name: str, sources: tuple[str, ...], csrc_dir: Path = CSRC_DIR) -> Path:
    """The cache directory of library `name`: keyed by the flags, the list
    of sources to compile and the bytes of every file under `csrc_dir`,
    so an edit to an included header changes it too."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(" ".join(sources).encode())
    for p in sorted(q for q in csrc_dir.rglob("*") if q.is_file()):
        digest.update(p.relative_to(csrc_dir).as_posix().encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}"


def load(name: str, sources: tuple[str, ...]):
    """Build (or reuse) `lib<name>.so` from `csrc/<sources>` and load it.
    Returns (ctypes.CDLL, BuildInfo).  Raises if nvcc is missing or fails."""
    if name in _LOADED:
        return _LOADED[name]
    paths = [CSRC_DIR / s for s in sources]
    out_dir = build_dir(name, sources)
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "build.log"

    if lib_path.exists():
        info = BuildInfo(lib_path, True, 0.0,
                         log_path.read_text() if log_path.exists() else "")
    else:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
        info = BuildInfo(lib_path, False, seconds, log)

    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, info)
    return lib, info


def occupancy(name: str, sources: tuple[str, ...], symbol: str, threads: int, smem: int,
              flags: int = 0) -> dict:
    """What `cudaOccupancyMaxActiveBlocksPerMultiprocessor` gives for a
    kernel of library `name` through its `*_occupancy` export (`symbol`)
    at `threads` threads a block and `smem` bytes of dynamic shared memory
    (`flags`: the copy, where the kernel has several, as its export reads
    them; for K1, K4 and K5 bit 0 is the copy with the SDF march):
    {"blocks", "warps"} per SM, the "registers" and "local_bytes" (stack
    and spills) per thread, and the "threads" and "smem" asked for."""
    lib, _ = load(name, sources)
    fn = getattr(lib, symbol)
    fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    rc = fn(int(flags), threads, smem, out)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc}")
    return {"blocks": out[0], "warps": out[0] * -(-threads // 32), "registers": out[1],
            "local_bytes": out[2], "threads": threads, "smem": smem}
