"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with :mod:`ctypes` — no PyTorch headers, so a
build takes seconds. Libraries are cached under the build directory by a hash
of their source, the shared headers (``csrc/*.cuh``) and the flags; all
sources compile in parallel, one ``nvcc`` each.

The build directory is ``$REPRO_TORCH_BUILD_DIR`` when set, else ``build/``
at the root of the checkout. Nothing here runs on the CPU path: the kernel
wrappers call :func:`load` only when handed a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: seconds the last :func:`build_all` spent compiling (0.0 on a cache hit)
last_build_seconds = 0.0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every stale source in parallel; returns {stem: library path}."""
    global last_build_seconds
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: st for stem, st in targets.items() if not st[1].exists()}
    t0 = time.perf_counter()
    procs = []
    for stem, (src, so) in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        procs.append((stem, src, so, tmp, log, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for stem, src, so, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((src, so.with_suffix(".log").read_text()[-4000:]))
        else:
            os.replace(tmp, so)
    last_build_seconds = time.perf_counter() - t0 if todo else 0.0
    if failed:
        msg = "\n".join(f"{src}:\n{log}" for src, log in failed)
        raise RuntimeError(f"nvcc failed:\n{msg}")
    return {stem: so for stem, (_, so) in targets.items()}


def resources() -> dict[str, dict[str, str]]:
    """Per library, per kernel: what ``-Xptxas -v`` reported when it was
    built (registers, spill bytes, barriers, and any advisory such as
    serialized wgmma), read from the build logs."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        log = _target(src).with_suffix(".log")
        if not log.exists():
            continue
        kernels, name = {}, None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            adv = re.search(r"(Performance Loss.*) in the function '(\w+)'", line)
            if m:
                name = m.group(1)
            elif adv:
                kernels[adv.group(2)] = (kernels.get(adv.group(2), "") + " "
                                         + adv.group(1)).strip()
            elif name and ("spill" in line or "Used" in line):
                kernels[name] = (kernels.get(name, "") + " " + line.split(
                    ":", 1)[-1].strip()).strip()
        names = list(kernels)
        try:  # demangled names, where the toolkit has its filter
            filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
            plain = subprocess.run([filt, *names], capture_output=True,
                                   text=True, timeout=60).stdout.splitlines()
            names = plain if len(plain) == len(names) else names
        except OSError:
            pass
        out[src.stem] = dict(zip(names, kernels.values()))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds on first use)."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            for name, path in paths.items():
                if name not in _libs:
                    _libs[name] = ctypes.CDLL(str(path))
        return _libs[stem]
