"""The executor mesh (counterpart of ``spark_rapids_jni_tpu/parallel/
mesh.py``).

Spark executors map to positions along one axis, ``EXEC_AXIS``. The
reference builds a JAX ``Mesh`` and runs its distributed steps inside
``jax.shard_map``, with collectives in the middle. The port writes each
step bulk-synchronously instead: a local stage is a loop over the
executors this process holds, and each collective is a method of
:class:`ExecutorMesh` that takes and returns the per-executor list.

Two transports sit behind that one interface:

- **local** (no ``group``): one process holds every executor. Blocks move
  between the executors' devices by copies: a concatenation of the
  blocks addressed to each receiver, with a peer ``.to()`` where the
  devices differ;
- **process group** (``group`` given): one executor per rank, the world
  size being the executor count. Blocks move through
  ``torch.distributed`` (``all_to_all_single``, ``all_reduce``,
  ``all_gather_into_tensor``): NCCL for CUDA tensors, gloo for CPU ones.

Unlike a JAX ``Mesh``, a device may repeat: executors may share a device,
which plays the role of the reference's virtual CPU devices in tests and
lets several executors share one card. Masks cross the wire as
``uint8`` (not every backend takes ``torch.bool`` in every collective),
unsigned integers as their signed views. Float reductions gather the
executors' values on every transport: sums fold in executor order, so
the bits do not depend on the transport, and min/max pick as the
single-device groupby's float lanes do (NaN wins, -0.0 below 0.0),
where the reference's ``pmin``/``pmax`` give whatever XLA's reduction
gives for NaN. Integer reductions are exact either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from spark_rapids_jni_tpu_torch.ops.sort import INT64_MIN

__all__ = ["EXEC_AXIS", "ExecutorMesh", "executor_mesh"]

# Axis name of the executor dimension (the reference binds its
# collectives to it; the port keeps it as the mesh's only axis name).
EXEC_AXIS = "exec"

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    view = _SIGNED.get(x.dtype)
    return x if view is None else x.view(view)


def _from_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return x != 0
    return x if x.dtype == dtype else x.view(dtype)


def _order_space(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` as int64 keys whose ``op`` ("min"/"max") picks the reduced
    value: integers by value; floats by IEEE total order (-0.0 below
    0.0) with NaN winning either reduction, as the single-device
    groupby's min/max lanes (kernel A's) propagate it."""
    if x.dtype.is_floating_point:
        wide = x.to(torch.float64)
        bits = wide.view(torch.int64)
        key = torch.where(bits < 0, bits ^ ((1 << 63) - 1), bits)
        nan_key = INT64_MIN if op == "min" else (1 << 63) - 1
        return torch.where(torch.isnan(wide), nan_key, key)
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ INT64_MIN
    if x.dtype in (torch.uint16, torch.uint32):
        bits = x.dtype.itemsize * 8
        return x.view(_SIGNED[x.dtype]).to(torch.int64) & ((1 << bits) - 1)
    return x.to(torch.int64)


@dataclass(frozen=True)
class ExecutorMesh:
    """Executors along ``EXEC_AXIS``: ``devices[e]`` is executor e's
    device (devices may repeat); ``group`` a ``torch.distributed``
    process group whose rank r is executor r, or None for one process
    holding them all."""

    devices: tuple
    group: Optional[object] = None

    @property
    def size(self) -> int:
        """The executor count D."""
        return len(self.devices)

    @property
    def executors(self) -> tuple:
        """The executors this process holds, in order: all of them on the
        local transport, this rank's alone in a process group."""
        if self.group is None:
            return tuple(range(self.size))
        import torch.distributed as dist

        return (dist.get_rank(self.group),)

    @property
    def local_devices(self) -> tuple:
        return tuple(self.devices[e] for e in self.executors)

    def _check(self, xs: Sequence) -> list:
        xs = list(xs)
        if len(xs) != len(self.executors):
            raise ValueError(
                f"{len(xs)} per-executor values for the {len(self.executors)}"
                f" executors this process holds")
        return xs

    # ---- collectives ---------------------------------------------------

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list:
        """The tiled all-to-all of the reference's shuffle: executor s
        sends rows ``[r*C, (r+1)*C)`` of its ``(D*C, ...)`` buffer to
        executor r, and every receiver lays the D blocks it gets out by
        source, as ``all_to_all(x, axis, 0, 0, tiled=True)`` does."""
        xs = self._check(xs)
        dtype = xs[0].dtype
        d = self.size
        if self.group is not None:
            import torch.distributed as dist

            x = _to_wire(xs[0]).contiguous()
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.group)
            return [_from_wire(out, dtype)]
        wire = [_to_wire(x) for x in xs]
        cap = wire[0].shape[0] // d
        out = []
        for r, dev in enumerate(self.devices):
            parts = [w[r * cap:(r + 1) * cap].to(dev) for w in wire]
            out.append(_from_wire(torch.cat(parts), dtype))
        return out

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list:
        """Every executor's value stacked along a new leading axis of D,
        on each held executor's device."""
        xs = self._check(xs)
        dtype = xs[0].dtype
        if self.group is not None:
            import torch.distributed as dist

            x = _to_wire(xs[0]).contiguous()
            # the concatenated form: gloo takes no stacked output
            out = torch.empty((self.size * x.numel(),), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, x.reshape(-1), group=self.group)
            return [_from_wire(out.reshape((self.size,) + tuple(x.shape)),
                               dtype)]
        wire = [_to_wire(x) for x in xs]
        return [_from_wire(torch.stack([w.to(dev) for w in wire]), dtype)
                for dev in self.devices]

    def _reduce(self, xs: Sequence[torch.Tensor], op: str) -> list:
        xs = self._check(xs)
        dtype = xs[0].dtype
        if dtype == torch.bool:
            raise TypeError("reduce integer lanes, not bool masks")
        plain_int = not (dtype.is_floating_point or dtype in _SIGNED)
        if self.group is not None and plain_int:
            import torch.distributed as dist

            ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                   "max": dist.ReduceOp.MAX}
            x = xs[0].clone()
            dist.all_reduce(x, op=ops[op], group=self.group)
            return [x]
        out = []
        for stack in self.all_gather(xs):
            if op == "sum" and dtype.is_floating_point:
                acc = stack[0]
                for i in range(1, self.size):
                    acc = acc + stack[i]
                out.append(acc)
            elif op == "sum":
                out.append(stack.sum(0, dtype=dtype) if plain_int
                           else stack.view(_SIGNED[dtype]).sum(0).view(dtype))
            else:
                key = _order_space(stack, op)
                pick = key.argmin(0) if op == "min" else key.argmax(0)
                out.append(torch.gather(
                    _to_wire(stack), 0, pick.unsqueeze(0))[0].view(dtype))
        return out

    def psum(self, xs: Sequence[torch.Tensor]) -> list:
        """Element-wise sum over the executors (integer lanes exact and
        wrapping, float lanes folded in executor order)."""
        return self._reduce(xs, "sum")

    def pmin(self, xs: Sequence[torch.Tensor]) -> list:
        return self._reduce(xs, "min")

    def pmax(self, xs: Sequence[torch.Tensor]) -> list:
        return self._reduce(xs, "max")


def executor_mesh(num_executors: Optional[int] = None,
                  devices: Optional[Sequence] = None, *,
                  group=None) -> ExecutorMesh:
    """A mesh of ``num_executors`` executors along ``EXEC_AXIS``.

    ``devices`` defaults to every visible CUDA device (one executor per
    card, the 1 task : 1 device contract of Spark's plugin) and raises
    when there is none, as ``resolve_device`` does; a device may repeat.
    ``num_executors`` defaults to the device count, or to the world size
    of ``group``; more executors than devices raises ``ValueError``. With
    a process group the executor count must equal its world size."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass devices=[...] (e.g. "
                "['cpu'] * 4) to run on the CPU explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if num_executors is None:
        num_executors = len(devices)
        if group is not None:
            import torch.distributed as dist

            num_executors = dist.get_world_size(group)
    if num_executors > len(devices):
        raise ValueError(
            f"requested {num_executors} executors but only "
            f"{len(devices)} devices are visible"
        )
    if group is not None:
        import torch.distributed as dist

        if dist.get_world_size(group) != num_executors:
            raise ValueError(
                f"a process-group mesh has one executor per rank: "
                f"{num_executors} executors for a world of "
                f"{dist.get_world_size(group)}")
    return ExecutorMesh(tuple(devices[:num_executors]), group)
