"""Device mesh, replicated and tensor-parallel parameters (port of
reslic_tcm_tpu/parallel/mesh.py).

The mesh is a ``torch.distributed`` DeviceMesh over every rank with
dimensions ``("data", "model")``, rank d * n_model + m holding data row d
and model column m. The placements are DTensor's: ``batch_sharding`` (the
batch split over "data", whole on every "model" rank) and ``replicated``
(whole everywhere), JAX's ``NamedSharding``s of the same names. The batch
is placed by the first (``shard_batch``: each rank keeps its rows, no
communication). The parameters are placed by the second (``replicate``:
rank 0's copy broadcast), or, with
``shard_params(tp=True)``, the wide convolutions and linears that
``tensor_parallel_specs`` selects hold only their output-channel slice on
each "model" rank: each such layer computes its slice of the output channels
and gathers the rest from the other model ranks (``_GatherChannels``), so
everything downstream runs replicated across the model ranks, as GSPMD runs
the JAX package's sharded kernels; in the backward the model ranks' parts of
the layer's input gradient are summed (``_ToModelRanks``).

``GradientSync`` is the sharded train step's part
(``training/step.py::shard_train_step``): it averages the gradients over the
data ranks in buckets of one ``all_reduce`` each, and takes the global norm
of the clip over the full parameters, the slices included.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..ops.layers import compute_dtype
from .multihost import gather_cat, local_batch_size


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """The ``("data", "model")`` DeviceMesh over every rank of the process
    group, on the group's device type (NCCL: cuda, gloo: cpu)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh does not cover {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh) -> list:
    """The placement of a batch on ``mesh``: split along its first axis
    over "data", whole on every "model" rank (JAX's ``P("data", ...)``)."""
    return [Shard(0), Replicate()]


def replicated(mesh) -> list:
    """The placement of a tensor that every rank holds whole (JAX's ``P()``)."""
    return [Replicate(), Replicate()]


def shard_batch(mesh, batch) -> torch.Tensor:
    """This rank's rows of the global ``batch`` (its data index's contiguous
    block, ``batch_sharding``), on its device. Every rank passes the same
    batch; nothing is communicated. Raises where "data" does not divide it."""
    t = torch.as_tensor(batch).to(mesh_device(mesh))
    local_batch_size(len(t), mesh)
    return distribute_tensor(t, mesh, batch_sharding(mesh), src_data_rank=None).to_local()


@torch.no_grad()
def replicate(mesh, module: nn.Module) -> nn.Module:
    """``module`` on this rank's device with rank 0's parameters and buffers
    on every rank (``replicated``: broadcast from the mesh's first rank).
    Returns the module."""
    module.to(mesh_device(mesh))
    for t in list(module.parameters()) + list(module.buffers()):
        t.copy_(distribute_tensor(t.detach(), mesh, replicated(mesh)).to_local())
    return module


def _out_dim(module: nn.Module) -> int | None:
    """The output-channel dimension of a layer's weight: 0 for Conv2d
    ([out, in, kh, kw]) and Linear ([out, in]), 1 for ConvTranspose2d
    ([in, out, kh, kw]); None for other modules. The JAX package keeps it
    last in its HWIO and [in, out] kernels."""
    if isinstance(module, nn.ConvTranspose2d):
        return 1
    if isinstance(module, (nn.Conv2d, nn.Linear)):
        return 0
    return None


def tensor_parallel_specs(module: nn.Module, n_model: int, min_channels: int = 128) -> dict:
    """{parameter name: its output-channel dimension} of the weights that a
    model axis of ``n_model`` ranks slices: the JAX package's choice of
    conv, deconv and dense kernels with at least ``min_channels`` output
    channels that ``n_model`` divides, keyed by the port's names (the
    weight bridge's names for the same kernels). Biases stay replicated, as
    in JAX. Empty for ``n_model <= 1``."""
    specs = {}
    if n_model <= 1:
        return specs
    for name, m in module.named_modules():
        dim = _out_dim(m)
        if dim is None:
            continue
        out = m.weight.shape[dim]
        if out >= min_channels and out % n_model == 0:
            specs[f"{name}.weight" if name else "weight"] = dim
    return specs


class _ToModelRanks(torch.autograd.Function):
    """The input of a sliced layer: the identity forward; backward sums
    the model ranks' gradients, each rank having reached the input only
    through its own output slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather of each model rank's output slice along ``dim``. Backward
    keeps this rank's slice of the gradient: downstream of the gather every
    model rank computes the same thing, so its gradient of the gathered
    output is already the whole gradient (``torch.distributed.nn``'s
    all_gather would sum the model ranks' copies of it)."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        k = grad.shape[ctx.dim] // n
        return grad.narrow(ctx.dim, r * k, k).contiguous(), None, None


def _sliced_forward(m: nn.Module, group):
    """The forward of a layer holding its output-channel slice: the slice's
    output, gathered over the model ranks, then the full bias (Megatron's
    column-parallel layer)."""
    if isinstance(m, nn.ConvTranspose2d):
        def local(x, w):
            return F.conv_transpose2d(x, w, None, m.stride, m.padding, m.output_padding,
                                      m.groups, m.dilation)
        act_dim, bias_shape = 1, (-1, 1, 1)
    elif isinstance(m, nn.Conv2d):
        def local(x, w):
            return m._conv_forward(x, w, None)
        act_dim, bias_shape = 1, (-1, 1, 1)
    else:
        def local(x, w):
            return F.linear(x, w)
        act_dim, bias_shape = -1, (-1,)

    def forward(x):
        x = _ToModelRanks.apply(x, group)
        # under bf16 the layers' bf16 branch (ops/layers.py Conv2d, Linear,
        # Deconv): bf16 operands, an fp32 input's result back in fp32
        # before the bias, a bf16 input's (the composed WMSA's) left in bf16
        bf16 = x.dtype == torch.bfloat16 or compute_dtype() is torch.bfloat16
        y = local(x.to(torch.bfloat16), m.weight.to(torch.bfloat16)) if bf16 else local(
            x, m.weight)
        if bf16 and x.dtype != torch.bfloat16:
            y = y.float()
        out = _GatherChannels.apply(y, act_dim, group)
        return out if m.bias is None else out + m.bias.view(bias_shape).to(out.dtype)
    return forward


def shard_params(mesh, module: nn.Module, tp: bool = False) -> nn.Module:
    """Place ``module`` on the mesh: replicated, or with ``tp`` and more than
    one model rank, each weight of ``tensor_parallel_specs`` cut to this
    model rank's output-channel slice (a new, smaller Parameter under the
    same name; build the optimisers afterwards) and its layer's forward
    gathering the slices. The sliced names and dimensions are kept as
    ``module.tensor_parallel``; the layers take their composed branch only
    (train under autograd; ``gathered_state_dict`` for the full weights)."""
    replicate(mesh, module)
    module.tensor_parallel = {}
    n = mesh["model"].size()
    if not tp or n <= 1:
        return module
    group, r = mesh.get_group("model"), mesh.get_local_rank("model")
    specs = tensor_parallel_specs(module, n)
    for name, dim in specs.items():
        m = module.get_submodule(name.rpartition(".")[0])
        k = m.weight.shape[dim] // n
        m.weight = nn.Parameter(m.weight.detach().narrow(dim, r * k, k).clone())
        m.forward = _sliced_forward(m, group)
    module.tensor_parallel = specs
    return module


@torch.no_grad()
def gathered_state_dict(mesh, module: nn.Module) -> dict:
    """The module's state dict with every slice of ``shard_params(tp=True)``
    gathered into the full tensor (what a single-device module holds)."""
    sd = dict(module.state_dict())
    specs = getattr(module, "tensor_parallel", {})
    if specs:
        group = mesh.get_group("model")
        for name, dim in specs.items():
            sd[name] = _GatherChannels.apply(sd[name], dim, group)
    return sd


def _buckets(tensors: list, bucket_numel: int):
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() > bucket_numel:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_mean(tensors: list, group, bucket_numel: int = 1 << 23) -> None:
    """Replace each tensor by its mean over ``group``'s ranks, one
    ``all_reduce`` per bucket of up to ``bucket_numel`` elements."""
    n = dist.get_world_size(group)
    for bucket in _buckets(tensors, bucket_numel):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat /= n
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


class GradientSync:
    """The collectives of the sharded train step for ``module`` on
    ``mesh``: gradients averaged over the data ranks, the clip's global
    norm over the full parameters (a sliced weight's squares summed over
    the model ranks), and metrics averaged over the data ranks."""

    def __init__(self, mesh, module: nn.Module):
        self.data, self.model = mesh.get_group("data"), mesh.get_group("model")
        specs = getattr(module, "tensor_parallel", {})
        self.sliced = {id(p) for name, p in module.named_parameters() if name in specs}

    def reduce(self, params: list) -> None:
        """Average the ``.grad`` of ``params`` over the data ranks (a missing
        gradient counts as zeros, as optax counts it)."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_mean([p.grad for p in params], self.data)

    @torch.no_grad()
    def norm(self, params: list) -> torch.Tensor:
        """The global norm of the ``.grad`` of ``params`` as one device would
        hold them: each slice's squares summed over the model ranks."""
        norms = torch._foreach_norm([p.grad for p in params])
        full = [n for p, n in zip(params, norms) if id(p) not in self.sliced]
        sliced = [n for p, n in zip(params, norms) if id(p) in self.sliced]
        if sliced:
            sq = torch.stack(sliced).square().sum()
            dist.all_reduce(sq, group=self.model)
            full.append(sq.sqrt())
        return torch.linalg.vector_norm(torch.stack(full))

    @torch.no_grad()
    def mean(self, metrics: dict) -> dict:
        """Each 0-d metric averaged over the data ranks."""
        keys = list(metrics)
        flat = torch.stack([metrics[k].detach().float() for k in keys])
        all_reduce_mean([flat], self.data)
        return dict(zip(keys, flat.unbind()))


def rank_noise(noise, rank: int, size: int):
    """A training-noise callable for this rank's rows of a global batch
    split over ``size`` ranks: each call draws the global batch's noise from
    ``noise`` and keeps rank ``rank``'s part, so every rank draws the same
    global noise and ``size`` ranks equal one process on the whole batch.
    The batch is the first axis of an NCHW latent's noise and the outer
    factor of the last axis of the entropy bottleneck's [C, 1, B*H*W]."""
    if size == 1:
        return noise

    def draw(shape):
        if len(shape) == 3:
            c, one, m = shape
            return noise((c, one, m * size))[:, :, rank * m:(rank + 1) * m]
        b = shape[0]
        return noise((b * size,) + tuple(shape[1:]))[rank * b:(rank + 1) * b]
    return draw
