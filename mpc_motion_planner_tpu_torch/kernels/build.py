"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each kernel source in ``csrc/`` is compiled at first use into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) under ``build/torch_kernels/`` at the root of the checkout. The
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a current one is loaded as it is. Nothing here runs at import.

Flags: ``sm_90a`` (Hopper), ``-O3``, and deliberately no
``--use_fast_math``: the parity tolerances rest on accurate ``sinf``,
``cosf``, ``sqrtf`` and division.

Kernels 2 and 3 are compiled for one transcription (:class:`Geometry`):
its ``-D`` flags set the node count, the spline order and the joint count
in ``csrc/common.cuh`` and enter the hash, so each geometry has a library of
its own, built and loaded at its first use. Kernel 3's library is also built
for one shared-memory layout (``-DMPC_SMEM_LAYOUT``) and one count of z
elements and rows per thread (``-DMPC_EPT``), those its geometry takes
unless the geometry names others. Kernel 1 is compiled for one joint count
(the ``-DMPC_NQ`` flag alone), kernel 4 once.

A library may export an ``init`` function, which is called once when it is
loaded (the kernels' shared-memory attributes are set there, not in every
launch). The launches themselves are CUDA-graph safe: no allocation, no
synchronisation, every parameter passed by value.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import weakref
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232448
# an H100 SM's shared memory, 228 KB, of which 1 KB is reserved per block
SM_SMEM = 233472

# kernel 3's shared-memory layouts, in the order of their -DMPC_SMEM_LAYOUT
# values (csrc/common.cuh)
LAYOUTS = ("full", "compact", "split", "stream", "lean", "far", "deep", "pair")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The transcription a library of kernel 2 or 3 is built for: spline
    segments and order (nodes = segments * order + 1, band width = order)
    and the robot's joint count nq, which gives 2 nq states, nq controls
    and nq + 1 constraint rows (the torques and the tool height) per node.
    The defaults are the 19-node Panda transcription, ``csrc/common.cuh``'s
    defaults. Kernel 1's library depends on ``nq`` alone.

    ``layout`` is kernel 3's shared-memory layout, one of :data:`LAYOUTS`,
    and ``ept`` the z elements and constraint rows each of its threads owns;
    None (the default, and what an OCP gives) stands for the geometry's own
    (``kernels/structured_admm.py`` ``choose_layout`` and ``ept_of``).
    Naming another is for holding and timing one build against another;
    kernels 1 and 2 ignore both."""

    segments: int = 6
    order: int = 3
    nq: int = 7
    layout: str = None
    ept: int = None

    def __post_init__(self):
        if self.layout not in (None, *LAYOUTS):
            raise ValueError(f"layout {self.layout!r}: expected one of {LAYOUTS} or None")
        if self.ept is not None and (not isinstance(self.ept, int) or self.ept < 1):
            raise ValueError(f"ept {self.ept!r}: expected a positive int or None")

    @classmethod
    def of_ocp(cls, ocp) -> "Geometry":
        return cls(ocp.coll.num_segments, ocp.coll.order, ocp.nq)

    @classmethod
    def of_band(cls, Mband) -> "Geometry":
        """The geometry of a banded KKT matrix (B, nodes, bw + 1, blk, blk)
        of a model with blk = 3 nq (2 nq states, nq controls)."""
        nodes, bw, blk = Mband.shape[1], Mband.shape[2] - 1, Mband.shape[3]
        if bw < 1 or (nodes - 1) % bw or blk % 3 or blk == 0:
            raise ValueError(f"no transcription has a band of shape {tuple(Mband.shape[1:])}")
        return cls((nodes - 1) // bw, bw, blk // 3)

    @property
    def nx(self) -> int:
        return 2 * self.nq

    @property
    def nu(self) -> int:
        return self.nq

    @property
    def ng(self) -> int:
        return self.nq + 1

    @property
    def nodes(self) -> int:
        return self.segments * self.order + 1

    @property
    def blk(self) -> int:
        return self.nx + self.nu

    @property
    def num_var(self) -> int:
        return self.nodes * self.blk + 1

    @property
    def num_eq(self) -> int:
        return self.segments * (self.order + 1) * self.nx

    @property
    def num_rows(self) -> int:
        return self.num_eq + self.nodes * self.ng

    def flags(self) -> tuple:
        """The nvcc flags that set this geometry in ``csrc/common.cuh``
        (the layout's and ept's only where they are set)."""
        flags = (f"-DMPC_SEGMENTS={self.segments}", f"-DMPC_ORDER={self.order}",
                 f"-DMPC_NQ={self.nq}")
        if self.layout is not None:
            flags += (f"-DMPC_SMEM_LAYOUT={LAYOUTS.index(self.layout)}",)
        if self.ept is not None:
            flags += (f"-DMPC_EPT={self.ept}",)
        return flags


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaKernel:
    """One kernel source: a lazy build per geometry, ctypes binding and a
    launch count.

    ``per_geometry`` says what a library is compiled for: ``"transcription"``
    (kernels 2 and 3: one library per :class:`Geometry`), ``"joints"``
    (kernel 1: one per joint count, whatever the transcription) or ``None``
    (one library); a ``None`` geometry is the default one. ``launches`` is
    one count for the kernel, whatever the geometry, incremented by the
    wrapper each time it launches the kernel, and nowhere else;
    ``build_log`` holds nvcc's report (registers, shared memory, spills) of
    each build, by geometry.

    ``resolve`` (kernel 3): the geometry a library is built for, a function
    of the geometry that fills in the layout and ept it does not name;
    without it a library ignores the geometry's layout and ept."""

    def __init__(self, name: str, source: str, entry: str, argtypes, init: str = None,
                 per_geometry: str = None, resolve=None):
        if per_geometry not in (None, "joints", "transcription"):
            raise ValueError(f"per_geometry {per_geometry!r}")
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.init = init
        self.per_geometry = per_geometry
        self.resolve = resolve
        self.launches = 0
        self.build_log = {}
        self._fns = {}  # geometry -> bound entry point

    def sources(self):
        return [CSRC / self.source, *sorted(CSRC.glob("*.cuh"))]

    def geometry(self, geometry=None):
        """The geometry a library is built for: None for a kernel that does
        not depend on it; for a kernel built per joint count the default
        transcription with ``geometry``'s joint count; else ``geometry`` or
        the default one, as ``resolve`` completes it (with no layout and no
        ept for a kernel without ``resolve``)."""
        if self.per_geometry is None:
            return None
        g = geometry or Geometry()
        if self.per_geometry == "joints":
            return Geometry(nq=g.nq)
        if self.resolve is None:
            return dataclasses.replace(g, layout=None, ept=None)
        return self.resolve(g)

    def flags(self, geometry=None) -> tuple:
        g = self.geometry(geometry)
        if g is None:
            return NVCC_FLAGS
        return NVCC_FLAGS + ((f"-DMPC_NQ={g.nq}",) if self.per_geometry == "joints"
                             else g.flags())

    def library_path(self, geometry=None) -> Path:
        flags = self.flags(geometry)
        h = hashlib.sha256(" ".join(flags).encode())
        for src in self.sources():
            h.update(src.read_bytes())
        g = self.geometry(geometry)
        tag = ("" if g is None else f"_q{g.nq}" if self.per_geometry == "joints"
               else f"_n{g.nodes}_o{g.order}_q{g.nq}" + (f"_{g.layout}" if g.layout else "")
               + (f"_e{g.ept}" if g.ept else ""))
        return BUILD_DIR / f"{self.name}{tag}_{h.hexdigest()[:16]}.so"

    def build(self, geometry=None) -> Path:
        """Compile the library of ``geometry`` if it is missing or stale;
        return its path."""
        out = self.library_path(geometry)
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *self.flags(geometry), "-o", tmp, str(CSRC / self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {self.source} {self.geometry(geometry)} "
                f"({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
        self.build_log[self.geometry(geometry)] = proc.stderr
        return out

    def library(self, geometry=None):
        """The loaded library of ``geometry`` (built first if needed)."""
        return ctypes.CDLL(str(self.build(geometry)))

    def function(self, geometry=None):
        """The bound C entry point of ``geometry``'s library; builds and
        loads the library on first use, and then calls its ``init``
        function once."""
        g = self.geometry(geometry)
        fn = self._fns.get(g)
        if fn is None:
            lib = self.library(g)
            if self.init is not None:
                init = getattr(lib, self.init)
                init.restype = ctypes.c_int
                err = init()
                if err != 0:
                    raise RuntimeError(f"{self.name} library init failed: CUDA error {err}")
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[g] = fn
        return fn

    def launch(self, *args, geometry=None):
        """Call the entry point of ``geometry``'s library on PyTorch's
        current stream; raise if the launch was refused. Counts the
        launch."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        err = self.function(geometry)(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1


def check_cuda_tensor(name: str, t, shape, dtype=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of the given shape
    (and dtype, float32 by default)."""
    import torch

    dtype = dtype or torch.float32
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def capturing(device) -> bool:
    """Whether work on ``device`` is being captured into a CUDA graph now (on
    PyTorch's current stream), when nothing may synchronise with the host."""
    import torch

    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


class DeviceCount:
    """A count that the solve adds to on the device that holds its data, with
    no host synchronisation: inside a captured CUDA graph too, whose every
    replay then adds again. Reading it synchronises."""

    def __init__(self):
        self._acc = {}  # device -> 0-d int64 tensor

    def add(self, n) -> None:
        """Add a 0-d integer tensor ``n``. The first addition on a device
        allocates its accumulator, which a graph capture may not: a capture
        is preceded by a warm-up run."""
        acc = self._acc.get(n.device)
        if acc is None:
            if capturing(n.device):
                raise RuntimeError("a DeviceCount's first addition on a device inside a graph "
                                   "capture; run the captured work once before capturing it")
            import torch

            acc = self._acc[n.device] = torch.zeros((), dtype=torch.int64, device=n.device)
        acc.add_(n)

    @property
    def count(self) -> int:
        return sum(int(a) for a in self._acc.values())

    def reset(self) -> None:
        """Zero the count in place (a captured graph keeps adding to the same
        accumulator)."""
        for a in self._acc.values():
            a.zero_()


class HostConstants:
    """Constants derived from objects (a robot model and frame, a
    collocation), made once per (objects, device) and reused while those
    objects live: host arrays that a launch passes by value, so it does not
    copy them back from the card, and device tensors that the solve would
    otherwise copy from host memory at every call (which a CUDA graph
    capture refuses).

    Keyed by object identity: the port's models and collocations are frozen
    dataclasses whose tensors it never changes in place."""

    def __init__(self):
        self._entries = {}

    def get(self, objs, device, make):
        """The value for ``objs`` on ``device``, from ``make()`` on a miss."""
        key = (tuple(id(o) for o in objs), str(device))
        hit = self._entries.get(key)
        if hit is not None and all(ref() is o for ref, o in zip(hit[0], objs)):
            return hit[1]
        # forget entries whose objects are gone (their ids may be reused)
        self._entries = {
            k: v for k, v in self._entries.items() if all(ref() is not None for ref in v[0])
        }
        value = make()
        self._entries[key] = (tuple(weakref.ref(o) for o in objs), value)
        return value
