"""Build, load and count the port's hand-written CUDA kernels.

Each ``pmce_tpu_torch/csrc/<name>.cu`` has a plain C interface. At first use
it is compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``pmce_tpu_torch/_build/`` (a directory git ignores) and loaded with
``ctypes``; a library whose source or flags changed gets a new file name, so
a stale build is never loaded. :func:`build_all` starts one ``nvcc`` per
source at once.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc`` or a card.

Every C entry point returns ``cudaGetLastError()``; :meth:`CudaLibrary.call`
raises :class:`KernelError` when that is not 0, so a refused launch never
passes silently. Each wrapper keeps a :class:`LaunchCounter`, raised by one
where it launches its kernel and nowhere else; a run reads the counters to
show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


class LaunchCounter:
    """Launches of one wrapper's kernel since the last reset."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


_COUNTERS: dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    counter = LaunchCounter(name)
    _COUNTERS[name] = counter
    return counter


def reset_launch_counts() -> None:
    for counter in _COUNTERS.values():
        counter.count = 0


def launch_counts() -> dict[str, int]:
    return {name: c.count for name, c in _COUNTERS.items()}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError("nvcc not found: the CUDA kernels are built with "
                          "the CUDA toolkit on the machine with the card")
    return path


class CudaLibrary:
    """One ``csrc/<source>.cu`` compiled into a ctypes-loaded library."""

    def __init__(self, source: str, error_fn: str,
                 signatures: dict[str, tuple]):
        self.source = source
        self.error_fn = error_fn
        # name -> (restype, argtypes)
        self.signatures = signatures
        self._lib = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        digest = hashlib.sha1()
        for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{self.source}.cu"]:
            digest.update(f.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source}-{digest.hexdigest()[:12]}.so"

    def build_command(self) -> tuple[list[str], Path, Path]:
        out = self.path
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{self.source}.cu")]
        return cmd, tmp, out

    def load(self):
        with self._lock:
            if self._lib is None:
                if not self.path.is_file():
                    _build([self])
                lib = ctypes.CDLL(str(self.path))
                for name, (restype, argtypes) in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = list(argtypes)
                err = getattr(lib, self.error_fn)
                err.restype = ctypes.c_char_p
                err.argtypes = [I]
                self._error_string = err
                self._lib = lib
            return self._lib

    def call(self, name: str, *args):
        """Run one C entry point; raise if it reports a CUDA error."""
        rc = getattr(self.load(), name)(*args)
        if rc != 0:
            msg = self._error_string(rc).decode()
            raise KernelError(f"{self.source}.{name}: CUDA error {rc} ({msg})")

    def query(self, name: str, *args):
        """Run a C helper that returns a value (no CUDA work)."""
        return getattr(self.load(), name)(*args)


def _build(libs: list[CudaLibrary]) -> None:
    """Compile the given libraries, one nvcc process each, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for lib in libs:
        if lib.path.is_file():
            continue
        cmd, tmp, out = lib.build_command()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((lib, proc, tmp, out))
    failures = []
    for lib, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        # ptxas's register / shared-memory / spill report, kept beside the
        # library it describes.
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{lib.source}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise KernelError("nvcc failed\n" + "\n".join(failures))


# gemm_entry (csrc/transformer_ops.cuh): A, W, M, N, K, epi, out_f32, bias,
# res, res_f32, rowscale, rows_per_scale, qcols, qscale, save, aux, out,
# stream.
GEMM_ARGS = (P, P, I, I, I, I, I, P, P, I, P, I, I, F, P, P, P, P)
TRUNK = CudaLibrary("lifter_trunk", "pmce_trunk_error_string", {
    "pmce_trunk_ln": (I, (P, I, P, P, P, P, I, I, I, F, P)),
    "pmce_trunk_gemm": (I, GEMM_ARGS),
    "pmce_trunk_attn": (I, (P, P, I, I, I, I, I, I, P)),
    "pmce_trunk_block": (I, (P,) * 17 + (I, I, I, I, I, F, F, P, P)),
    "pmce_trunk_tile_rows": (I, ()),
    "pmce_trunk_stamps": (I, ()),
})
# The scan: a table of per-direction pointers, per-direction integers
# (int64), dirs, B, H, the plan's units, wm, wk, save, shared memory, the
# barrier counter, the stamps (or null), stream. The backward scan: a table
# of its ten pointers, T, reverse, dgi in bf16, B, H, the plan's units, wm,
# wk, shared memory, the barrier counter, the stamps (or null), stream.
GRU = CudaLibrary("gru_scan", "pmce_gru_error_string", {
    "pmce_gru_scan": (I, (P, ctypes.POINTER(L), I, I, I, I, I, I, I, L, P, P,
                          P)),
    "pmce_gru_device_limits": (I, (I, ctypes.POINTER(I),
                                   ctypes.POINTER(I))),
    "pmce_gru_bwd_scan": (I, (P, I, I, I, I, I, I, I, I, L, P, P, P)),
})
# Rows 3 / 14, the chain and the whole block in bf16: one CTA a clip (S =
# 1, the joint workspace at ws) or a cluster of S CTAs a clip (ws unused):
# the chain's joints, jout, vout, gammas, betas, the pointer table, ws, B,
# J, V, NB, S, eps, the two attention scales, stream; the whole block's
# jf0, vf0, jout, vout, gammas, betas, the table, ws, B, J, V, S, the same
# floats, stream. The one-CTA program's workspace (J) and shared memory
# (V); a cluster rank's shared memory at (J, V, S) (-1: the cluster program
# does not take it) and the clusters the card holds at once (the same names
# in both libraries).
CHAIN = CudaLibrary("coevo_chain", "pmce_chain_error_string", {
    "pmce_chain_workspace_bytes": (L, (I,)),
    "pmce_chain_smem_bytes": (L, (I,)),
    "pmce_coevo_cluster_smem_bytes": (L, (I, I, I)),
    "pmce_coevo_clusters": (I, (I, I, I)),
    "pmce_coevo_chain": (I, (P,) * 7 + (I, I, I, I, I, F, F, F, P)),
    "pmce_coevo_chain_prof": (I, (P, P, P, P, P, P, P, I, I, I, I, F, F, F,
                                  P, P)),
    "pmce_max_stamps": (I, ()),
})
COEVO_BLOCK = CudaLibrary("coevo_block", "pmce_coevo_block_error_string", {
    "pmce_coevo_block_workspace_bytes": (L, (I,)),
    "pmce_coevo_block_smem_bytes": (L, (I,)),
    "pmce_coevo_cluster_smem_bytes": (L, (I, I, I)),
    "pmce_coevo_clusters": (I, (I, I, I)),
    "pmce_coevo_block": (I, (P,) * 8 + (I, I, I, I, F, F, F, P)),
    "pmce_coevo_block_prof": (I, (P,) * 8 + (I, I, I, F, F, F, P, P)),
})
# The block: the forward's tile program (a table of its 29 pointers, clips,
# N, hid, eps, post_eps, qscale, stream); the backward's tile program (a
# table of its 27 pointers, the same integers and floats, stream) and its
# weight-gradient launch (a table of 13 pointers, M, hid, splits, the tile
# program's tile count, stream).
BLOCK = CudaLibrary("block", "pmce_block_error_string", {
    "pmce_block_fwd_tile": (I, (P, I, I, I, F, F, F, P)),
    "pmce_block_bwd_tile": (I, (P, I, I, I, F, F, F, P)),
    "pmce_block_wgrad": (I, (P, I, I, I, I, P)),
})
# Skinning: v_posed, A, W, out, B, V, J, bodies a block, stream.
SKIN = CudaLibrary("skinning", "pmce_skin_error_string", {
    "pmce_skinning": (I, (P, P, P, P, I, I, I, I, P)),
})
# The decoder's attention blocks: one call runs a direction's whole launch
# sequence from a table of pointers (:func:`ptr_table`); the backward's
# scratch is one workspace of the size the *_workspace helper gives.
# The self-attention forward's tile program: a table of its 11 pointers,
# clips, N, C, heads, clips a CTA, stream; the backward's: a table of its
# 11 pointers, the same integers, the weight launch's tile count, stream;
# its weight launch: a table of 8 pointers, M, C, splits, stream.
MHSA = CudaLibrary("mhsa", "pmce_mhsa_error_string", {
    "pmce_mhsa_workspace": (L, (I, I, I, I)),
    "pmce_mhsa_fwd_tile": (I, (P, I, I, I, I, I, P)),
    "pmce_mhsa_bwd_tile": (I, (P, I, I, I, I, I, I, P)),
    "pmce_mhsa_wgrad": (I, (P, I, I, I, P)),
    "pmce_mhsa_fwd": (I, (P, I, I, I, I, P)),
    "pmce_mhsa_bwd": (I, (P, I, I, I, I, P)),
})
# The AdaLN block's forward tile programs (a table of their 28 pointers,
# clips, N, hid, heads, eps, stream) and the CTAs of launch B the card
# holds at once; the backward's tile program: a table of its 30 pointers,
# clips, N, hid, heads, eps, stream; its weight-gradient launch: a table of
# 12 pointers, M, hid, splits, stream.
ADA = CudaLibrary("ada_block", "pmce_ada_block_error_string", {
    "pmce_ada_block_workspace": (L, (I, I, I, I, I)),
    "pmce_ada_fwd_tile": (I, (P, I, I, I, I, F, P)),
    "pmce_ada_fwd_resident": (I, ()),
    "pmce_ada_block_fwd": (I, (P, I, I, I, I, I, F, P)),
    "pmce_ada_block_bwd": (I, (P, I, I, I, I, I, F, P)),
    "pmce_ada_bwd_tile": (I, (P, I, I, I, I, F, P)),
    "pmce_ada_wgrad": (I, (P, I, I, I, P)),
    "pmce_ada_tile_clusters": (I, ()),
})
# The CA block: the forward's tile program (a table of its 42 pointers,
# clips, Nq, Nk, hid, heads, eps, stream) and the launch sequence of the
# shapes outside its gate; the backward's tile program (a table of its 40
# pointers, clips, Nq, Nk, hid, heads, eps, stream) and its weight-gradient
# launch (a table of 16 pointers, clips, Nq, Nk, hid, splits, stream).
CA = CudaLibrary("ca_block", "pmce_ca_block_error_string", {
    "pmce_ca_fwd_tile": (I, (P, I, I, I, I, I, F, P)),
    "pmce_ca_tile_clusters": (I, (I,)),
    "pmce_ca_block_fwd": (I, (P, I, I, I, I, I, I, F, P)),
    "pmce_ca_bwd_tile": (I, (P, I, I, I, I, I, F, P)),
    "pmce_ca_wgrad": (I, (P, I, I, I, I, I, P)),
})
# The f32 block: row 6f's forward (a table of its 18 pointers, clips, N,
# hid, eps, post_eps, qscale, the persistent CTAs, stream) and row 7f's
# backward (a table of its 44 pointers, the same integers and floats, the
# weight gradients' row ranges, the persistent CTAs, stream).
BLOCK_F32 = CudaLibrary("block_f32", "pmce_block_f32_error_string", {
    "pmce_block_fwd_f32": (I, (P, I, I, I, F, F, F, I, P)),
    "pmce_block_bwd_f32": (I, (P, I, I, I, F, F, F, I, I, P)),
})
# Rows 4f / 5f, the self-attention in f32: the forward (a table of its 8
# pointers, clips, N, C, heads, qscale, the persistent CTAs, stream) and
# the backward (a table of its 13 pointers, the same integers and float,
# the weight gradients' row ranges, the persistent CTAs, stream).
MHSA_F32 = CudaLibrary("mhsa_f32", "pmce_mhsa_f32_error_string", {
    "pmce_mhsa_fwd_f32": (I, (P, I, I, I, I, F, I, P)),
    "pmce_mhsa_bwd_f32": (I, (P, I, I, I, I, F, I, I, P)),
})
# Rows 3f / 14f, the chain and the whole block in f32: a cluster of S CTAs
# a clip (the chain: joints, jout, vout, gammas, betas, the pointer table,
# B, J, V, NB, S, eps, the two attention scales, stream; the whole block:
# jf0, vf0, jout, vout, gammas, betas, the table, B, J, V, S, the same
# floats, stream); a CTA's shared memory at (V, S) (-1: the plan does not
# take V) and the clusters of S CTAs the card holds at once.
COEVO_F32 = CudaLibrary("coevo_f32", "pmce_coevo_f32_error_string", {
    "pmce_coevo_f32_smem_bytes": (L, (I, I)),
    "pmce_coevo_f32_clusters": (I, (I,)),
    "pmce_coevo_chain_f32": (I, (P,) * 6 + (I, I, I, I, I, F, F, F, P)),
    "pmce_coevo_block_f32": (I, (P,) * 7 + (I, I, I, I, F, F, F, P)),
})
# Rows 8f / 9f, the AdaLN block in f32: the forward (a table of its 17
# pointers, clips, N, hid, heads, eps, qscale, the most CTAs a program
# launches, stream) and the backward (a table of its 24 pointers, the
# same, the weight gradients' row ranges, the mask gradients owed, the
# most CTAs a program launches, stream); the backward's workspace in floats
# (clips, N, hid, heads, row ranges).
ADA_F32 = CudaLibrary("ada_f32", "pmce_ada_f32_error_string", {
    "pmce_ada_f32_workspace": (L, (I, I, I, I, I)),
    "pmce_ada_fwd_f32": (I, (P, I, I, I, I, F, F, I, P)),
    "pmce_ada_bwd_f32": (I, (P, I, I, I, I, F, F, I, I, I, P)),
})
# Rows 10f / 11f, the CA block in f32: the forward (a table of its 27
# pointers, clips, Nq, Nk, hid, heads, eps, qscale, the most CTAs a
# program launches, stream) and the backward (a table of its 40 pointers,
# the same, the row ranges of the query side's and the key side's weight
# gradients, the mask gradients owed, the most CTAs a program launches,
# stream); the backward's workspace (clips, Nq, Nk, hid, heads, row
# ranges, the most CTAs a program launches).
CA_F32 = CudaLibrary("ca_f32", "pmce_ca_f32_error_string", {
    "pmce_ca_f32_workspace": (L, (I, I, I, I, I, I, I)),
    "pmce_ca_fwd_f32": (I, (P, I, I, I, I, I, F, F, I, P)),
    "pmce_ca_bwd_f32": (I, (P, I, I, I, I, I, F, F, I, I, I, I, P)),
})
LIBRARIES = (TRUNK, GRU, CHAIN, COEVO_BLOCK, BLOCK, SKIN, MHSA, ADA, CA,
             BLOCK_F32, COEVO_F32, MHSA_F32, ADA_F32, CA_F32)


def build_all() -> None:
    """Build every kernel library of the port (in parallel) and load it."""
    _build(list(LIBRARIES))
    for lib in LIBRARIES:
        lib.load()


def stream_ptr(device) -> P:
    import torch

    return P(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> P:
    return P(t.data_ptr())


def ptr_table(*tensors) -> P:
    """A host array of the tensors' device pointers (None: a null pointer),
    as the ``void* const*`` table the block entry points read (the cast
    keeps the array alive with the pointer)."""
    arr = (P * len(tensors))(*[None if t is None else t.data_ptr()
                              for t in tensors])
    return ctypes.cast(arr, P)


def _refuse_sharded(t, name: str) -> None:
    """Raise on an FSDP shard: a kernel reads whole tensors by pointer, and
    a ``DTensor``'s pointer is one rank's slice (FSDP gathers a unit's
    parameters only inside the unit's forward and backward)."""
    if type(t).__name__ == "DTensor":
        raise ValueError(f"{name}: a sharded DTensor reached a kernel; "
                         "read parameters inside their FSDP unit")


def to_kernel(a, device, dtype, shape: tuple, name: str):
    """``a`` as a contiguous ``dtype`` tensor on ``device`` (a cast copy
    when needed), raising unless its shape is ``shape``."""
    _refuse_sharded(a, name)
    t = a.detach().to(device=device, dtype=dtype).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t


def check_cuda(t, name: str, dtype, shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape."""
    _refuse_sharded(t, name)
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
