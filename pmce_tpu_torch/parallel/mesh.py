"""Device mesh, data-parallel replication (DDP) and FSDP sharding.

Port of ``pmce_tpu/parallel/mesh.py``: one mesh dimension, named by
``TRAIN.data_axis`` (``"data"``), over the process group's ranks; batches
split over it, gradients reduced over it.

- :func:`replicate` is ``DistributedDataParallel``. PMCE has parameters
  that get no gradient: the joint streams of the decoder blocks whose
  joint output feeds nothing (``coevoblock1.j_Q_embed``,
  ``joint_SA_FFN.*``, ...). Plain DDP fails on those at its second step.
  ``static_graph=True`` handles them at less cost than
  ``find_unused_parameters=True``, which walks the autograd graph after
  every forward: the set of unused parameters is a property of the
  configuration, the same at every step (the edge term and the branch
  masks are multiplied in, so they cut no edge of the graph). A parameter
  that no rank reaches keeps ``grad None``, as on one device.
- :func:`shard_fsdp` is FSDP2's ``fully_shard``. The units
  (:func:`fsdp_units`) are each lifter block, each decoder block and the
  BiGRU; the root takes the rest. There is no mixed-precision policy:
  parameters stay f32, as the JAX package's FSDP keeps them, and the
  kernel wrappers take their own bf16 copies inside each unit's forward.
  Layout: FSDP2 shards every parameter's dim 0 (padded to a multiple of
  the ranks), where JAX's ``fsdp_leaf_sharding`` shards the largest
  divisible axis and replicates leaves without one. Each rank owns a
  different slice of the same parameters; the gathered forward, the
  reduced gradient and the Adam update are the same mathematics.
- :func:`full_state` / :func:`load_full_state`: checkpoints as full state
  dicts, in the file format of the single-device trainer (the optimizer's
  state keyed by parameter index), so that a checkpoint moves both ways
  between one device and N ranks.
- :func:`gathered` holds every FSDP unit gathered for an evaluation: the
  fused evaluation path reads the blocks' weights from the lifter's and
  the decoder's own forward (the trunk and chain kernels take every
  block at once), outside the blocks' forwards where FSDP gathers them.
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch import nn


def create_mesh(n_data: int | None = None, device_type: str = "cuda",
                axis: str = "data"):
    """A one-dimensional ``DeviceMesh`` named ``axis`` over ``n_data``
    ranks (default: the whole process group)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = n_data or dist.get_world_size()
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def replicate(model: nn.Module, mesh) -> nn.Module:
    """``model`` under DDP over ``mesh`` (its parameters stay the
    model's; see the module docstring for ``static_graph``)."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=mesh.get_group(), static_graph=True)


def fsdp_units(model: nn.Module) -> list[nn.Module]:
    """The submodules that become FSDP units: each lifter block (spatial
    and temporal) and, for PMCE, each decoder block and the BiGRU."""
    lifter = getattr(model, "pose_lifter", model)
    units = [*lifter.SpatialBlocks, *lifter.TemporalBlocks]
    decoder = getattr(model, "pose_mesh_coevo", None)
    if decoder is not None:
        units += [*decoder.blocks(), decoder.gru_cur]
    return units


def shard_fsdp(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model`` in place with FSDP2 (units, then the root); returns
    it."""
    from torch.distributed.fsdp import fully_shard

    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Every FSDP unit of ``model`` gathered inside the block (a no-op for
    a model that is not sharded)."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(model, FSDPModule):
        yield
        return
    mods = [*fsdp_units(model), model]
    for m in mods:
        m.unshard()
    try:
        yield
    finally:
        for m in mods:
            m.reshard()


def _options(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, **kw)


def full_state(model: nn.Module, optimizer) -> tuple[dict, dict]:
    """(model state dict, optimizer state dict) as full CPU tensors on rank
    0 (empty dicts on the others), in the single-device format. Every rank
    must call it."""
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    opts = _options(cpu_offload=True)
    params = get_model_state_dict(model, options=opts)
    osd = get_optimizer_state_dict(model, optimizer, options=opts)
    if not osd:
        return params, osd
    # The optimizer is built over the model's parameters in order, so a
    # parameter's index is its place in named_parameters(); the groups'
    # settings are the optimizer's own, as one device writes them.
    index = {n: i for i, (n, _) in enumerate(model.named_parameters())}
    return params, {
        "state": {index[n]: s for n, s in osd["state"].items()},
        "param_groups": optimizer.state_dict()["param_groups"]}


def load_full_state(model: nn.Module, optimizer, params: dict,
                    opt_state: dict) -> None:
    """Load full state dicts in the single-device format (as
    :func:`full_state` returns them) into a replicated or sharded model
    and its optimizer; every rank passes the same dicts."""
    from torch.distributed.checkpoint.state_dict import (
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    names = [n for n, _ in model.named_parameters()]
    osd = {"state": {names[i]: s for i, s in opt_state["state"].items()},
           "param_groups": [dict(g, params=[names[i] for i in g["params"]])
                            for g in opt_state["param_groups"]]}
    set_model_state_dict(model, params, options=_options())
    # Not strict: a parameter that never got a gradient has no Adam state,
    # as on one device.
    set_optimizer_state_dict(model, optimizer, osd,
                             options=_options(strict=False))
