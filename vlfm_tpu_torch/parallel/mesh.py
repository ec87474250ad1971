"""Device mesh and episode sharding over PyTorch devices.

Counterpart of ``vlfm_tpu/parallel/mesh.py``. A ``Mesh`` is a (data,
model) grid of ``torch.device``s with JAX's axis names:

- axis "data": parallel episodes. An episode batch is split along its
  leading (lane) axis into one contiguous block per data row; every map
  op is independent across lanes, so each block runs on its own device and
  the blocks together equal the unsplit batch.
- axis "model": tensor parallelism for the VLM stack. Only a model axis of
  1 is served here: a parameter tree or module is copied whole to each data
  row. Above 1 the helpers raise (ROADMAP Queue 1, "tensor parallelism over
  a model axis above 1").

JAX runs one SPMD program over the mesh; PyTorch has no such program, so a
sharded batch is a list of per-device blocks (one per data row) that the
caller dispatches device by device (``runner/sim_farm.py``'s
``sharding=``). ``best_devices`` returns CUDA devices and raises when there
are fewer than asked for: where JAX falls back to (virtual) CPU devices,
the port does not hide the device, and a run on the CPU names its devices
(``make_mesh(devices=[torch.device("cpu")] * 2)``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vlfm_tpu_torch.runner.checkpoint import map_tensors

AXES = ("data", "model")
TP_ITEM = "ROADMAP Queue 1, tensor parallelism over a model axis above 1"


@dataclass(frozen=True)
class Mesh:
    """``devices[r][m]``: the device of data row r and model column m."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = AXES

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def data_devices(self) -> List[torch.device]:
        """One device per data row; a model axis above 1 raises."""
        if self.shape["model"] != 1:
            raise NotImplementedError(f"a model axis of {self.shape['model']} is not served ({TP_ITEM})")
        return [row[0] for row in self.devices]


def best_devices(n: Optional[int] = None) -> List[torch.device]:
    """The first ``n`` CUDA devices (all of them when ``n`` is None). Fewer
    than ``n``, or none at all, raises: pass ``devices=`` to ``make_mesh``
    for a mesh on the CPU."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = n if n is not None else max(have, 1)
    if have < want:
        raise RuntimeError(f"need {want} CUDA devices, have {have}; a mesh on the CPU takes its devices "
                           f"explicitly, e.g. make_mesh(devices=[torch.device('cpu')] * {want})")
    return [torch.device("cuda", i) for i in range(want)]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[torch.device | str]] = None) -> Mesh:
    """A (n / model_parallel, model_parallel) mesh over ``devices``, else
    over ``best_devices(n_devices)``."""
    devs = [torch.device(d) for d in devices] if devices is not None else best_devices(n_devices)
    n = len(devs)
    if n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices do not make rows of {model_parallel}")
    return Mesh(tuple(tuple(devs[r:r + model_parallel]) for r in range(0, n, model_parallel)))


@dataclass(frozen=True)
class Sharding:
    """A placement over ``mesh``: ``spec == ("data",)`` splits the leading
    axis over the data rows (``episode_sharding``), ``spec == ()`` copies to
    each row (``replicated``)."""

    mesh: Mesh
    spec: Tuple[str, ...] = ()

    def data_devices(self) -> List[torch.device]:
        return self.mesh.data_devices()

    def place(self, tree: Any) -> List[Any]:
        """One copy of ``tree`` per data row, on the row's device: its
        tensors' leading-axis block (``("data",)``, which must divide into
        equal blocks), or whole (``()``). Other leaves are shared."""
        devices = self.data_devices()
        if not self.spec:
            return [map_tensors(lambda t, d=d: t.to(d, copy=True), tree) for d in devices]
        n = len(devices)

        def block(t: torch.Tensor, r: int, d: torch.device) -> torch.Tensor:
            if t.ndim == 0 or t.shape[0] % n:
                raise ValueError(f"a leading axis of {tuple(t.shape)[:1]} does not split into {n} equal blocks")
            size = t.shape[0] // n
            return t[r * size:(r + 1) * size].to(d, copy=True)

        return [map_tensors(lambda t, r=r, d=d: block(t, r, d), tree) for r, d in enumerate(devices)]


def episode_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis episode sharding (data parallelism)."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_episode_batch(tree: Any, mesh: Mesh) -> List[Any]:
    """Every tensor of an episode-batched tree with its leading axis split
    over the data axis: one block tree per data row, on its device. Each
    tensor's leading axis must be its lane axis (a policy state's maps are
    so; PointNav's (L, B, 512) recurrence is not: ``itm.create_state`` per
    block makes a state whole)."""
    return episode_sharding(mesh).place(tree)


def shard_params_tp(params: Any, mesh: Mesh) -> List[Any]:
    """Parameters placed for the mesh. With a model axis of 1: a copy per
    data row on its device (a parameter tree's tensors, or a deep copy of
    an ``nn.Module``). A model axis above 1 (heads and MLP columns split
    over devices, as JAX shards them) raises."""
    if mesh.shape["model"] != 1:
        raise NotImplementedError(f"tensor-parallel placement over a model axis of {mesh.shape['model']} is not "
                                  f"ported ({TP_ITEM})")
    if isinstance(params, nn.Module):
        return [copy.deepcopy(params).to(d) for d in mesh.data_devices()]
    return replicated(mesh).place(params)
