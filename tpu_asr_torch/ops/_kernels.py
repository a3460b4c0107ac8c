"""Build, load and call the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with its own `nvcc`, all started together, and the
objects link into ONE shared library with a plain C interface, loaded with
`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu     (one per source)
    nvcc -shared -o libtpu_asr_torch.so *.o

The library is built at first use (the first kernel launch, never at
import) into `build/tpu_asr_torch/<hash>/` beside the package, keyed on a
hash of the flags and the sources (headers included), so a fresh checkout
builds exactly once and an edited source rebuilds. The compiler logs (with
`-Xptxas -v` register and spill counts) land beside the library as
`nvcc.log`.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `call` raises if that is not 0.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
import weakref
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpu_asr_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libtpu_asr_torch.so"
SMEM_LIMIT = 227 * 1024          # dynamic shared memory of one H100 block

PTR = ctypes.c_void_p
INT = ctypes.c_int
UINT = ctypes.c_uint
FLOAT = ctypes.c_float


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    return str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"


def _run_all(cmds):
    """Run the commands concurrently; (log text, [failed stderr])."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    log, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]}: code {proc.returncode}\n{err[-4000:]}")
    return "\n".join(log), failed


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [path.with_name(f"{src.stem}.{tag}.o") for src in sources()]
    log, failed = _run_all(
        [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
         for src, obj in zip(sources(), objs)])
    tmp = path.with_name(f"{LIB_NAME}.{tag}.tmp")
    if not failed:
        link_log, failed = _run_all(
            [[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
        log += "\n" + link_log
    (path.parent / "nvcc.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, path)           # atomic: concurrent builds agree
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.tat_error_string.argtypes = [INT]
    lib.tat_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, argtypes: tuple):
    """The C function `name` with its argument types declared."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = INT
    return fn


def call(name: str, argtypes: tuple, device: torch.device, *args) -> None:
    """Launch through C entry point `name` on `device`'s current stream
    (appended as the last argument) and raise on a launch error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = entry(name, argtypes)(*args, stream)
    if rc != 0:
        msg = library().tat_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need the gradient of an eval-only kernel
    (grad mode on and an input that requires grad)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is eval-only and has no gradient; call "
                           f"it under torch.no_grad()")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor {tuple(t.shape)}")


def use_kernel(backend: str, refusal: Optional[str]) -> bool:
    """Whether a model route calls the kernel wrapper. `refusal` is what
    the wrapper's own pre-launch check would say of the call (None: the
    kernel takes it). 'xla': never. 'auto': where the kernel takes the
    call, else the plain version, as the JAX package's 'auto' falls back to
    XLA. 'pallas': always, and a refused call raises here."""
    if backend == "xla":
        return False
    if backend == "pallas" and refusal is not None:
        raise ValueError(refusal)
    return refusal is None


def prepared(fn):
    """Memoise fn(*args), which builds kernel-layout copies of parameters.
    The key holds every tensor argument's identity, data pointer,
    `_version`, dtype, device and shape (and the other arguments as they
    are), so an in-place update (an optimizer step) or `.to()` builds anew;
    an entry is used only while its tensors are alive. Copies are built
    outside autograd and outside inference mode, so that one built while
    serving may be saved for a backward later; an inference tensor among
    the arguments keeps no version counter, and then nothing is cached. The
    newest 64 entries are kept."""
    entries = collections.OrderedDict()

    @functools.wraps(fn)
    def get(*args):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if any(t.is_inference() for t in tensors):
            return fn(*args)
        key = tuple((id(a), a.data_ptr(), a._version, a.dtype, a.device,
                     tuple(a.shape)) if isinstance(a, torch.Tensor) else a
                    for a in args)
        hit = entries.get(key)
        if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
            entries.move_to_end(key)
            return hit[1]
        with torch.inference_mode(False), torch.no_grad():
            value = fn(*args)
        entries[key] = ([weakref.ref(t) for t in tensors], value)
        while len(entries) > 64:
            entries.popitem(last=False)
        return value

    get.cache_clear = entries.clear
    return get
