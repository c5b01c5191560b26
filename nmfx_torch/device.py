"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device is present: the port never carries on quietly on the CPU. The
    CPU runs only when the caller passes ``device="cpu"``.

    On CUDA this also switches TF32 off for float32 matmuls
    (``torch.backends.cuda.matmul.allow_tf32 = False``), so every plain
    product in the port runs in full float32. It is set here, when an
    entry point runs, never when the package is imported.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nmfx_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


def explicit_device(device: torch.device) -> torch.device:
    """``device`` with its index: a CUDA device without one names the
    calling thread's current card. Threads keep their own current
    device, so a device handed to another thread must carry its index."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def to_device(x, dtype, device) -> torch.Tensor:
    """A tensor or array-like as a ``dtype`` tensor on ``device`` (host
    arrays are copied, so read-only buffers are never aliased)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _mesh_device(d) -> torch.device:
    """One mesh entry as a device with its index: a CUDA entry needs a
    card (no fallback to the CPU), and one without an index names card 0,
    so every thread that serves it reaches the same card."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh entry {dev} is a CUDA device and no CUDA device is "
                "available; build the mesh from devices='cpu' entries to "
                "run the plain versions on the CPU")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"mesh entry {dev}: this process sees "
                f"{torch.cuda.device_count()} CUDA device(s)")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"mesh entries must be 'cuda' or 'cpu', got {dev}")
    return dev


class Mesh:
    """The counterpart of ``jax.sharding.Mesh``: an ``np.ndarray`` of
    ``torch.device`` entries with one name per axis.

    A device may appear more than once: two restart shards on one card
    (or on the one CPU) are two entries of the same device, served in
    turn by that device's thread. ``processes`` (same shape, a global
    mesh's) gives the process that owns each entry; None means every
    entry is this process's. Entries of this process are checked (a CUDA
    entry with no card raises); another process's are kept as named."""

    def __init__(self, devices, axis_names, processes=None):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(
                f"mesh devices have {arr.ndim} axes, got {len(names)} "
                f"names {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        procs = (None if processes is None
                 else np.asarray(processes, dtype=np.int64).reshape(
                     arr.shape))
        rank = _process_index()
        out = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            mine = procs is None or int(procs[idx]) == rank
            out[idx] = (_mesh_device(arr[idx]) if mine
                        else torch.device(arr[idx]))
        self.devices = out
        self.axis_names = names
        self.processes = procs

    @property
    def shape(self) -> dict:
        """Axis name → size, in axis order (``jax``'s ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def process_of(self, idx) -> int:
        """The process that owns entry ``idx`` (this process for a local
        mesh)."""
        return (_process_index() if self.processes is None
                else int(self.processes[idx]))

    def distinct_devices(self) -> list:
        """This process's devices, each once, in first-seen order (the
        cost model prices a mesh that names one card twice as one card)."""
        seen: list = []
        for idx in np.ndindex(self.devices.shape):
            d = self.devices[idx]
            if self.process_of(idx) == _process_index() and d not in seen:
                seen.append(d)
        return seen

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.axis_names,
                None if self.processes is None
                else tuple(int(p) for p in self.processes.flat),
                self.devices.shape)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _process_index() -> int:
    """This process's rank in an initialized ``torch.distributed`` group,
    else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The processes of an initialized ``torch.distributed`` group, else
    1 (``jax.process_count()``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
