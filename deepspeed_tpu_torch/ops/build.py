"""Build the CUDA sources of the port into shared libraries, load with ctypes.

Parity role: ``deepspeed_tpu/ops/op_builder.py`` (the op-builder seam). On a
TPU "building" an op resolved a Pallas kernel; here each ``ops/csrc/*.cu``
is compiled by ``nvcc`` for Hopper into a library with a plain C interface
and bound with ``ctypes``. No PyTorch headers are included, so a build
takes seconds, not minutes.

* Builds happen at first use, into ``build/torch_kernels/`` beside the
  package (``DSTPU_TORCH_BUILD_DIR`` overrides), cached by a hash of the
  source, the flags and the compiler path: an unchanged source is not
  rebuilt, a changed one is.
* :func:`build_all` starts one ``nvcc`` per source, all at once, and waits
  for them together.
* A failed build raises :class:`KernelBuildError` with nvcc's stderr.
* Callers declare ``argtypes`` with ``ctypes.c_void_p`` for every pointer
  and the stream; left undeclared, ctypes passes Python ints as 32-bit
  C ints and cuts the pointers.
* Host libraries (``ops/csrc/*.cpp``: the async file I/O of the NVMe
  tier, the host Adam of the host-executed step) build the same way with
  ``g++`` (:func:`load_host`), each with its flags (:data:`HOST_FLAGS`),
  cached by a hash of the source, the flags and the compiler path, and,
  for a ``-march=native`` build, of the host CPU's model and feature
  flags; a failed build raises :class:`KernelBuildError` too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
#: a host library's flags where they are not :data:`CXX_FLAGS`. The host
#: Adam: vectorised for this host's CPU, no fused multiply-add (every fp32
#: operation rounded as in the plain version), no errno from ``sqrt`` (so
#: it vectorises; the results are IEEE all the same)
HOST_FLAGS = {"cpu_adam": ("-O3", "-std=c++17", "-shared", "-fPIC",
                           "-pthread", "-march=native", "-ffp-contract=off",
                           "-fno-math-errno")}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per source: {"seconds": build wall time (0.0 on a cache hit), "cached":
#: bool, "path": library, "ptxas": nvcc's resource report (kept beside the
#: library, so a cache hit has it too)}
build_log: Dict[str, Dict[str, object]] = {}


class KernelBuildError(RuntimeError):
    pass


def build_dir() -> Path:
    env = os.environ.get("DSTPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels build on a machine with the "
        "CUDA toolkit")


def _target(name: str, nvcc: str) -> Path:
    # the shared headers (``csrc/*.cuh``) are part of every source's key
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode() + nvcc.encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _report(lib: Path) -> Path:
    """nvcc's resource report (ptxas -v) of a built library, kept beside it
    for cache hits."""
    return lib.with_suffix(".ptxas.txt")


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Build (or find cached) and load every named source — all of
    ``ops/csrc/*.cu`` by default — with one ``nvcc`` process per source
    started together. Returns ``{name: CDLL}``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: _libs[n] for n in names}
        nvcc = find_nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = _target(name, nvcc)
            if out.exists():
                report = _report(out)
                build_log[name] = {"seconds": 0.0, "cached": True,
                                   "path": str(out),
                                   "ptxas": report.read_text()
                                   if report.exists() else ""}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, out, time.perf_counter())
        errors = []
        for name, (proc, tmp, out, t0) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{stderr}{stdout}")
                continue
            _report(out).write_text(stderr)
            os.replace(tmp, out)
            build_log[name] = {"seconds": time.perf_counter() - t0,
                               "cached": False, "path": str(out),
                               "ptxas": stderr}
        if errors:
            raise KernelBuildError("\n".join(errors))
        for name in todo:
            _libs[name] = ctypes.CDLL(build_log[name]["path"])
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``ops/csrc/<name>.cu``, built at first use."""
    return build_all([name])[name]


def find_cxx() -> str:
    """``$CXX`` when set (and then only it), else ``g++`` on ``$PATH`` or
    ``/usr/bin/g++``."""
    env = os.environ.get("CXX")
    cands = (env,) if env else (shutil.which("g++") or "", "/usr/bin/g++")
    for cand in cands:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(f"g++ not found (looked at {', '.join(cands)}): "
                           "the host libraries need a C++17 compiler")


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (a ``-march=native`` build
    runs on that CPU only)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        import platform

        return platform.processor().encode()


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of ``ops/csrc/<name>.cpp`` (a host library: no
    CUDA), built with ``g++`` at first use and cached by source hash."""
    key = f"host:{name}"
    with _lock:
        if key in _libs:
            return _libs[key]
        cxx = find_cxx()
        src = CSRC / f"{name}.cpp"
        flags = HOST_FLAGS.get(name, CXX_FLAGS)
        h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                           + cxx.encode()
                           + (_host_cpu() if "-march=native" in flags
                              else b""))
        out = build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        cached = out.exists()
        if not cached:
            build_dir().mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *flags, str(src), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"g++ failed for {name}.cpp (exit {proc.returncode}):\n"
                    f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, out)
        build_log[key] = {"seconds": 0.0 if cached
                          else time.perf_counter() - t0,
                          "cached": cached, "path": str(out), "ptxas": "",
                          "flags": " ".join(flags)}
        _libs[key] = ctypes.CDLL(str(out))
        return _libs[key]
