"""Device mesh, episode sharding and tensor-parallel placement over
PyTorch devices.

Counterpart of ``vlfm_tpu/parallel/mesh.py``. A ``Mesh`` is a (data,
model) grid of ``torch.device``s with JAX's axis names:

- axis "data": parallel episodes. An episode batch is split along its
  leading (lane) axis into one contiguous block per data row, on the row's
  lead device ``devices[r][0]`` (JAX's ``P("data")`` replicates a block
  over the model axis); every map op is independent across lanes, so each
  block runs on its own row and the blocks together equal the unsplit
  batch.
- axis "model": tensor parallelism for the VLM stack. ``shard_params_tp``
  copies a module to each row's lead device and splits every ``Dense``
  whose output divides by the model axis into a ``SplitDense``: one block
  of output columns per model device, gathered back on the lead device
  (the all-gather XLA inserts after an output-split kernel). Everything
  else of the module stays whole on the lead device.

JAX runs one SPMD program over the mesh; PyTorch has no such program, so a
sharded batch is a list of per-row blocks that the caller dispatches row by
row (``runner/sim_farm.py``'s ``sharding=``), and the model axis is
explicit copies between a row's devices. Where a row's columns are the same
device (a (2, 2) mesh over one card), those copies are no-ops.
``best_devices`` returns CUDA devices and raises when there are fewer than
asked for: where JAX falls back to (virtual) CPU devices, the port does not
hide the device, and a run on the CPU names its devices
(``make_mesh(devices=[torch.device("cpu")] * 4, model_parallel=2)``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vlfm_tpu_torch.models.layers import Dense, dense
from vlfm_tpu_torch.runner.checkpoint import map_tensors

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """``devices[r][m]``: the device of data row r and model column m."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = AXES

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def data_devices(self) -> List[torch.device]:
        """Each data row's lead device, ``devices[r][0]``."""
        return [row[0] for row in self.devices]

    def model_devices(self, r: int) -> List[torch.device]:
        """Row ``r``'s devices, one per model column."""
        return list(self.devices[r])


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


class SplitDense(nn.Module):
    """A ``layers.Dense`` split on its output axis over ``devices``: column
    c holds rows ``[c * n, (c + 1) * n)`` of the weight (torch's axis 0,
    the last axis of JAX's kernel) and the same slice of the bias, on
    ``devices[c]``. ``forward`` copies ``x`` to each column's device,
    computes that column's block there by ``layers.dense``'s promotion rule
    and gathers the blocks on ``x``'s device in column order. No whole
    weight is kept. The parameters are ``weights.c`` and ``biases.c``, so a
    split module's state dict has other keys than the whole module's:
    save the whole module, not a split one."""

    def __init__(self, whole: Dense, devices: Sequence[torch.device]):
        super().__init__()
        k = len(devices)
        if whole.out_features % k:
            raise ValueError(f"{whole.out_features} output features do not split into {k} equal blocks")
        self.devices = tuple(torch.device(d) for d in devices)
        n = whole.out_features // k

        def blocks(p: nn.Parameter) -> nn.ParameterList:
            return nn.ParameterList(
                nn.Parameter(p.detach()[c * n:(c + 1) * n].to(d, copy=True), requires_grad=p.requires_grad)
                for c, d in enumerate(self.devices))

        self.weights = blocks(whole.weight)
        self.biases = None if whole.bias is None else blocks(whole.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        biases = self.biases if self.biases is not None else [None] * len(self.devices)
        return torch.cat([dense(x.to(d), w, b).to(x.device)
                          for d, w, b in zip(self.devices, self.weights, biases)], -1)


def shard_params_tp(params: Any, mesh: Mesh) -> List[Any]:
    """Parameters placed for the mesh, one copy per data row.

    A module: a deep copy on the row's lead device (ordinary parameters,
    even when called under ``inference_mode``); above a model axis of 1,
    every ``Dense`` of the copy whose output divides by the model axis is
    replaced in place by a ``SplitDense`` over the row's devices; every
    other module (an ``nn.Linear`` that is not a ``Dense``, convolutions,
    embeddings, norms) and bare parameter stays whole. JAX's
    ``shard_params_tp`` splits every leaf with two or more axes whose last
    axis divides, embeddings and the patch convolution included; the port
    splits the ``Dense`` kernels alone, as JAX's docstring describes, and
    keeps the rest whole, so no embedding is gathered at each use.

    A parameter tree: its tensors copied whole to each row at a model axis
    of 1. A tree holds no ``Dense`` to split, so above 1 it raises a
    ``TypeError``: pass the module."""
    if not isinstance(params, nn.Module):
        if mesh.shape["model"] != 1:
            raise TypeError(f"tensor-parallel placement over a model axis of {mesh.shape['model']} takes an "
                            f"nn.Module (its Dense layers are split), not a {type(params).__name__} of tensors")
        return replicated(mesh).place(params)
    k, rows = mesh.shape["model"], []
    for r, lead in enumerate(mesh.data_devices()):
        with torch.inference_mode(False), torch.no_grad():
            row = copy.deepcopy(params).to(lead)
            sites = [(parent, name) for parent in row.modules() for name, child in parent._modules.items()
                     if k > 1 and isinstance(child, Dense) and child.out_features % k == 0]
            for parent, name in sites:  # each whole Dense is dropped once replaced
                setattr(parent, name, SplitDense(getattr(parent, name), mesh.model_devices(r)))
        rows.append(row)
    return rows
