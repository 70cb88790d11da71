"""Build and load the hand-written CUDA kernels (``nomad_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use (nothing is compiled when a module is
imported), one ``nvcc`` per source, all started together, into
``nomad_tpu_torch/_build/`` under a name that carries a digest of the
source and the flags, so an edited source rebuilds and an unchanged one
loads at once.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into a
``RuntimeError``.
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

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # IEEE fp32 everywhere: no contraction of a*b+c into one rounding,
    # so the kernels' scores equal the plain versions' bit for bit.
    "-fmad=false",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C prototypes of each library's entry points (argtypes, all returning
# an int error code).  Pointers and the stream travel as c_void_p.
PROTOTYPES = {
    "binpack": {
        "nomad_place_sequence_plan": (_I, _I, _P),
        "nomad_place_sequence": (_P,) * 9 + (_F,) + (_I,) * 6 + (_P,) * 6,
        "nomad_place_rounds_plan": (_I, _I, _I, _P),
        "nomad_place_rounds": (_P,) * 8 + (_F,) + (_I,) * 5 + (_P,) * 6,
        "nomad_place_sequence_batch_plan": (_I, _I, _I, _P),
        "nomad_place_sequence_batch": (_P,) * 10 + (_I,) * 7 + (_P,) * 6,
        "nomad_place_rounds_batch": (_P,) * 9 + (_I,) * 6 + (_P,) * 6,
        # the sharded walks' kernels (parallel/mesh.py): a walk on one
        # card, and K7a+c and K7b for rows whose shards span cards
        "nomad_shard_walk_plan": (_I, _I, _I, _I, _P),
        "nomad_shard_walk": (_P,) + (_I,) * 9 + (_P,) * 5,
        "nomad_shard_step": (_P,) + (_I,) * 10 + (_P,),
        "nomad_merge_select": (_P,) * 2 + (_I,) * 10 + (_P,) * 7,
    },
    "scatter_rows": {
        "nomad_scatter_rows": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
    "window_verify": {
        "nomad_window_verify_setup": (),
        "nomad_window_verify": (_P, _P, _P, _I, _P) + (_I,) * 4 + (_P, _P),
        # K6 on a mesh's shards, and K7d for shards on another card
        # (parallel/mesh.py)
        "nomad_window_verify_sharded_setup": (),
        "nomad_window_verify_sharded": (_P,) + (_I,) * 4 + (_P, _P)
        + (_I,) * 4 + (_P, _P),
        "nomad_shard_gather": (_P,) * 3 + (_I,) * 3 + (_P, _I, _P, _P),
    },
}

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(candidate):
            path = candidate
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile every missing library in ``names`` (all by default), one
    ``nvcc`` per source, started together.  Returns ``{name: seconds}``
    for the libraries this call built (an up-to-date one is absent).
    Raises ``RuntimeError`` with the compiler's output on failure."""
    names = list(PROTOTYPES) if names is None else list(names)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = time.perf_counter()
    procs = []
    for name, target in todo:
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    built, errors = {}, []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{out.decode(errors='replace')}")
            continue
        os.replace(tmp, target)
        built[name] = time.perf_counter() - started
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:  # loaded: no lock on the launch path
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in PROTOTYPES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.nomad_error_string.argtypes = [ctypes.c_int]
            lib.nomad_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, what: str, code: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.nomad_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``
    (a ``torch.device`` with an index, as a CUDA tensor's is, takes
    PyTorch's raw accessor: no Stream object per launch)."""
    import torch

    if getattr(device, "index", None) is not None:
        return torch._C._cuda_getCurrentRawStream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def route(tensors: dict):
    """The one device every argument lies on; raises on a mix or on a
    device type other than cpu and cuda."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(
            f"arguments on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def check_args(tensors: dict, specs: dict) -> None:
    """Check dtype, shape and contiguity of each kernel argument against
    ``specs`` (name -> (dtype, shape)); raise on anything the kernel
    does not take."""
    for name, (dtype, shape) in specs.items():
        t = tensors[name]
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
