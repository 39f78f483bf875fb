"""DeviceMesh: named logical axes over the ranks of a torch.distributed
world (counterpart of paddle_tpu/parallel/mesh.py).

The port runs one process per rank, each on one device, so a mesh's
"devices" are the world's ranks.  The axis names, the `-1` auto size and
its errors are the JAX package's (`mesh_sizes`, a plain function the
tests hold against the JAX `DeviceMesh` without a process group).  The
torch `DeviceMesh` under it (`torch_mesh`) is made on first use, so a
mesh built only to annotate a program (`apply_zero(main, mesh)`) needs
no process group.

Canonical axis names (any subset may be present, sizes multiply to the
device count):
    dp  — data parallel (batch dim)
    fsdp— fully-sharded data parallel (params/optimizer state sharded too)
    tp  — tensor (megatron) parallel: weight-matrix sharding
    sp  — sequence/context parallel (long sequences; ring attention)
    pp  — pipeline parallel (layer stages)
    ep  — expert parallel (MoE experts)
"""

from __future__ import annotations

import contextlib
import math

AXIS_NAMES = ("dp", "fsdp", "pp", "tp", "sp", "ep")

_CURRENT_MESH = []


def mesh_sizes(axes: dict, ndev: int) -> dict:
    """{axis: size} with the one `-1` (or None) axis filled in from `ndev`
    devices; raises ValueError as the JAX DeviceMesh does (mesh.py:33-58)."""
    sizes = dict(axes)
    auto = [a for a, s in sizes.items() if s in (-1, None)]
    fixed = math.prod(s for s in sizes.values() if s not in (-1, None))
    if len(auto) > 1:
        raise ValueError("only one mesh axis may have size -1")
    if auto:
        if ndev % fixed:
            raise ValueError(
                f"{ndev} devices not divisible by fixed axes {sizes}"
            )
        sizes[auto[0]] = ndev // fixed
    if math.prod(sizes.values()) != ndev:
        raise ValueError(
            f"mesh {sizes} needs {math.prod(sizes.values())} devices, "
            f"have {ndev}"
        )
    return sizes


def _world_size():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DeviceMesh:
    """Named-axis view over the world's ranks.  `devices` is the number of
    ranks (default: the world size, 1 without a process group); `place` is
    where each rank computes (default: the card, as every entry point of
    the port).  Rank r sits at the row-major position r of the axes."""

    def __init__(self, axes: dict, devices=None, place=None):
        ndev = _world_size() if devices is None else (
            devices if isinstance(devices, int) else len(devices))
        sizes = mesh_sizes(axes, ndev)
        self.axis_names = tuple(sizes.keys())
        self.axis_sizes = tuple(sizes.values())
        self._place = place
        self._torch_mesh = None

    @property
    def size(self):
        return math.prod(self.axis_sizes)

    def axis_size(self, name, default=1):
        try:
            return self.axis_sizes[self.axis_names.index(name)]
        except ValueError:
            return default

    def has_axis(self, name):
        return name in self.axis_names

    def dim(self, name):
        """The mesh dimension of axis `name` (its index in axis_names)."""
        return self.axis_names.index(name)

    @property
    def device(self):
        """This rank's torch.device: `place`, by default the current card
        (the one init_distributed gave this rank; all ranks share cuda:0
        on a one-card machine), or the CPU when asked for."""
        from ..framework.core_types import as_device

        return as_device(self._place)

    @property
    def torch_mesh(self):
        """The torch.distributed DeviceMesh over the world (made once; the
        process group must be up and its size must be the mesh's).  On the
        card under gloo it stages DTensor's collectives through the host
        (`comm.stage_cuda_collectives`)."""
        if self._torch_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh as _TM
            import torch

            if _world_size() != self.size:
                raise RuntimeError(
                    f"{self!r} needs a process group of {self.size} ranks; "
                    f"the world has {_world_size()} (init_distributed first)")
            dev = self.device
            if dev.type == "cuda":
                from . import comm

                if comm.backend_of() == "gloo":
                    comm.stage_cuda_collectives()
            ranks = torch.arange(self.size).reshape(self.axis_sizes)
            self._torch_mesh = _TM(dev.type, ranks,
                                   mesh_dim_names=self.axis_names)
        return self._torch_mesh

    def coordinate(self, name):
        """This rank's index along axis `name`."""
        return self.torch_mesh.get_local_rank(name)

    def group(self, name):
        """The process group of this rank's line along axis `name`."""
        return self.torch_mesh.get_group(name)

    def __enter__(self):
        _CURRENT_MESH.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT_MESH.pop()

    def __repr__(self):
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names,
                                                   self.axis_sizes))
        return f"DeviceMesh({axes})"


def make_mesh(devices=None, place=None, **axes) -> DeviceMesh:
    """make_mesh(dp=4), make_mesh(dp=-1, tp=2), ...  Default: all ranks on
    one dp axis (the reference ParallelExecutor's all-GPUs-data-parallel)."""
    if not axes:
        axes = {"dp": -1}
    return DeviceMesh(axes, devices=devices, place=place)


def get_current_mesh() -> DeviceMesh | None:
    return _CURRENT_MESH[-1] if _CURRENT_MESH else None


@contextlib.contextmanager
def mesh_guard(mesh: DeviceMesh):
    with mesh:
        yield mesh
