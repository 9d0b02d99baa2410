"""One rank of a gloo world on the CPU for tests/test_torch_port_parallel.py.

    python tests/torch_port_parallel_worker.py INPUTS.npz OUT.npz PORT WORLD RANK

Imports torch, numpy and the port only. Every rank runs every multi-rank
check of the parallel slice on the inputs and weights that the test wrote
to INPUTS.npz (port state dicts under "balle8/", "tcm/" and "balle128/"),
and rank 0 writes the results to OUT.npz:

- ``sharded_conv2d``: the rows of conv_x split over the world;
- ``mesh_sharded_forward``: the factorized prior N=8, M=12 on fwd_x,
  halo 64;
- ``shard_for_inference``: the tiny TCM's compress_batch and
  decompress_batch of serve_x (batch 8), the streams of every image as
  every rank returns them;
- the sharded train step of the factorized prior N=128, M=128 on
  step_x with the replayed global noise on each mesh of step_dims (data
  x model ranks): every rank's loss and the gathered parameters after the
  step;
- the data-parallel train step of the mean-scale hyperprior (N=16, M=24)
  on ms_x with ``step_noise`` at ms_seed, whose y noise is NCHW and whose
  z noise is the entropy bottleneck's [C, 1, B*h*w], and rank 0's
  one-process ``train_step`` on the whole batch from the same weights and
  seed: both losses, both parameter sets and the noise shapes drawn;
- ``local_batch_size`` and ``distribute_batch`` of a batch of 8;
- on a 2 x 2 mesh, whose "data" groups have 2 ranks, the tiny TCM after
  ``shard_for_inference(mesh)``: the device coder's paths at k=128 on
  dev_x (batch 4: compress_device / decompress_device, the analytic pair;
  roundtrip_device_pipelined, serve_roundtrip_pipelined and
  serve_roundtrip_metrics over dev_x and its reverse), compress_device on
  dev_x's first 3 images (which the ranks do not divide), the pipelined
  host paths on serve_x's two halves; the device profiles' calls also on
  an unsharded codec with the same weights in the same process;
- ``batch_sharding`` and ``replicated`` applied to a batch of 8 and to a
  rank's own tensor on that mesh, beside ``shard_batch`` and ``replicate``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist
from torch_port_inputs import TINY_TCM


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _state(z, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: torch.from_numpy(z[k]) for k in z.files
            if k.startswith(prefix + "/")}


def _balle(z, prefix: str, n: int, m: int):
    from reslic_tcm_tpu_torch.models.balle2018 import FactorizedPrior

    module = FactorizedPrior(N=n, M=m)
    module.load_state_dict(_state(z, prefix), strict=True)
    return module


def sharded_conv(z, rank: int, world: int) -> dict:
    from reslic_tcm_tpu_torch.parallel.spatial import sharded_conv2d

    x = _nchw(z["conv_x"])
    weight = torch.from_numpy(np.ascontiguousarray(z["conv_k"].transpose(3, 2, 0, 1)))
    rows = x.shape[2] // world
    out = sharded_conv2d(x[:, :, rank * rows:(rank + 1) * rows].contiguous(), weight)
    parts = [torch.empty_like(out) for _ in range(world)]
    dist.all_gather(parts, out)
    return {"conv": torch.cat(parts, dim=2).permute(0, 2, 3, 1).numpy()}


def sharded_forward(z) -> dict:
    from reslic_tcm_tpu_torch.parallel.spatial import mesh_sharded_forward

    module = _balle(z, "balle8", 8, 12).eval()
    x_hat, bits = mesh_sharded_forward(module, _nchw(z["fwd_x"]), halo=64)
    return {"fwd_x_hat": x_hat.permute(0, 2, 3, 1).numpy(), "fwd_bits": np.float64(bits)}


def serving(z) -> dict:
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.parallel.multihost import gather_objects

    codec = make_tcm(device="cpu", **TINY_TCM)
    codec.module.load_state_dict(_state(z, "tcm"), strict=True)
    codec.update()
    codec.shard_for_inference()
    encs = codec.compress_batch(z["serve_x"])
    dec = codec.decompress_batch([e["strings"] for e in encs], encs[0]["shape"])
    streams = [(e["strings"][0][0], e["strings"][1][0]) for e in encs]
    every_rank = gather_objects([streams])
    y_hat = torch.cat([e["y_hat"] for e in encs])
    return {
        "serve_y": np.array([s[0] for s in streams], dtype=object),
        "serve_z": np.array([s[1] for s in streams], dtype=object),
        "serve_same_on_every_rank": np.bool_(all(s == streams for s in every_rank)),
        "serve_y_hat_exact": np.bool_(torch.equal(dec["y_hat"], y_hat)),
        "serve_x_hat_shape": np.array(dec["x_hat"].shape),
    }


def train_steps(z) -> dict:
    from reslic_tcm_tpu_torch.models.base import replayed_noise
    from reslic_tcm_tpu_torch.parallel.mesh import (gathered_state_dict, make_mesh, shard_batch,
                                                    shard_params)
    from reslic_tcm_tpu_torch.parallel.multihost import gather_objects
    from reslic_tcm_tpu_torch.training.step import create_train_state, shard_train_step

    out = {}
    for dims in z["step_dims"].tolist():
        tag = f"step{dims[0]}x{dims[1]}"
        mesh = make_mesh(*dims)
        module = shard_params(mesh, _balle(z, "balle128", 128, 128).train(), tp=dims[1] > 1)
        state = create_train_state(module, 1e-4, 1e-3, 1.0)
        noise = replayed_noise([torch.from_numpy(z["step_noise"])])
        metrics = shard_train_step(mesh)(state, shard_batch(mesh, _nchw(z["step_x"])),
                                         float(z["lmbda"]), noise)
        out[f"{tag}/losses"] = np.array(gather_objects([float(metrics["loss"])]))
        out[f"{tag}/sliced"] = np.array(sorted(module.tensor_parallel), dtype=object)
        for name, t in gathered_state_dict(mesh, module).items():
            out[f"{tag}/param/{name}"] = t.numpy()
    return out


def noise_step(z, rank: int) -> dict:
    from reslic_tcm_tpu_torch.models.balle2018 import MeanScaleHyperprior
    from reslic_tcm_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
    from reslic_tcm_tpu_torch.parallel.multihost import gather_objects
    from reslic_tcm_tpu_torch.training.step import (create_train_state, shard_train_step,
                                                    step_noise, train_step)

    seed, lmbda, x = int(z["ms_seed"]), float(z["lmbda"]), _nchw(z["ms_x"])
    torch.manual_seed(seed)
    module = MeanScaleHyperprior(N=16, M=24).train()
    start = {k: v.clone() for k, v in module.state_dict().items()}
    mesh = make_mesh()
    state = create_train_state(shard_params(mesh, module))
    shapes = []
    noise = step_noise(seed, 0, "cpu")

    def recorded(shape):
        shapes.append(tuple(shape))
        return noise(shape)
    metrics = shard_train_step(mesh)(state, shard_batch(mesh, x), lmbda, recorded)
    out = {"ms/losses": np.array(gather_objects([float(metrics["loss"])])),
           "ms/noise_shapes": np.array([str(s) for s in shapes])}
    out.update({f"ms/param/{k}": v.numpy() for k, v in module.state_dict().items()})
    if rank == 0:
        one = MeanScaleHyperprior(N=16, M=24).train()
        one.load_state_dict(start)
        one_state = create_train_state(one)
        out["ms/one_loss"] = np.float64(train_step(one_state, x, lmbda,
                                                   step_noise(seed, 0, "cpu"))["loss"])
        out.update({f"ms/one/{k}": v.numpy() for k, v in one.state_dict().items()})
    return out


def _device_streams(enc) -> dict:
    """A device-coder container as arrays: the table profile's y and z words
    and counts, or the analytic profile's packed container."""
    if "packed" in enc:
        return {"packed": enc["packed"]}
    return {f"{name}{i}": a for name, pair in enc["device_streams"].items()
            for i, a in enumerate(pair)}


def sharded_device_paths(z) -> dict:
    """The batch-sharded codec paths at a data group of 2 (two rows a rank:
    PyTorch's CPU convolutions round a batch of one otherwise than a batch
    of two or more, by an ulp here and there, which moves sigma and so the
    analytic container). The unsharded codec, with the same weights, codes
    and decodes the same batches of the device profiles; the pipelines'
    first batch is the device profiles' batch."""
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    codecs = {}
    for tag in ("sharded", "one"):
        codec = make_tcm(device="cpu", **TINY_TCM)
        codec.module.load_state_dict(_state(z, "tcm"), strict=True)
        codec.update()
        if tag == "sharded":
            codec.shard_for_inference(mesh)
        codecs[tag] = codec
    x4, x8, k = z["dev_x"], z["serve_x"], int(z["dev_k"])
    out = {}
    for tag, codec in codecs.items():
        runs = {"table": codec.compress_device(x4, k=k),
                "analytic": codec.compress_device_analytic(x4, k=k),
                "odd": codec.compress_device(x4[:3], k=k)}
        decoded = {"table": codec.decompress_device(runs["table"]),
                   "analytic": codec.decompress_device_analytic(runs["analytic"]),
                   "odd": codec.decompress_device(runs["odd"])}
        for name, enc in runs.items():
            for key, a in _device_streams(enc).items():
                out[f"dev/{tag}/{name}/{key}"] = a
            out[f"dev/{tag}/{name}/exact"] = np.bool_(
                torch.equal(decoded[name]["y_hat"], enc["y_hat"]))
            out[f"dev/{tag}/{name}/y_hat"] = enc["y_hat"].numpy()
            out[f"dev/{tag}/{name}/x_hat"] = decoded[name]["x_hat"].numpy()
    codec, pair = codecs["sharded"], [x4, x4[::-1].copy()]
    for j, r in enumerate(codec.roundtrip_device_pipelined(pair, k=k)):
        for key, a in _device_streams(r["enc"]).items():
            out[f"dev/roundtrip_device_pipelined{j}/{key}"] = a
        out[f"dev/roundtrip_device_pipelined{j}/exact"] = np.bool_(
            torch.equal(r["y_hat"], r["enc"]["y_hat"]))
    for name, fn in (("serve_roundtrip_pipelined", codec.serve_roundtrip_pipelined),
                     ("serve_roundtrip_metrics", codec.serve_roundtrip_metrics)):
        for j, r in enumerate(fn(pair, k=k)):
            out[f"dev/{name}{j}/packed"] = r["enc"]["packed"]
            out[f"dev/{name}{j}/exact"] = np.bool_(torch.equal(r["y_hat"], r["enc"]["y_hat"]))
    rt = codec.roundtrip_pipelined([x8[4:], x8[:4]])
    host = {"compress_pipelined": codec.compress_pipelined([x8[:4], x8[4:]]),
            "roundtrip_pipelined": [e for r in rt[::-1] for e in r["encs"]]}
    out["dev/roundtrip_pipelined/exact"] = np.bool_(all(
        torch.equal(r["y_hat"], torch.cat([e["y_hat"] for e in r["encs"]])) for r in rt))
    for name, encs in host.items():
        out[f"dev/{name}/y"] = np.array([e["strings"][0][0] for e in encs], object)
        out[f"dev/{name}/z"] = np.array([e["strings"][1][0] for e in encs], object)
    return out


def placements(z, rank: int) -> dict:
    """``batch_sharding`` and ``replicated`` on the 2 x 2 mesh: a batch of 8
    distributed by each against ``shard_batch``'s rows, and a tensor that
    differs on every rank distributed by ``replicated`` against
    ``replicate``'s broadcast of the first rank's."""
    from torch.distributed.tensor import distribute_tensor

    from reslic_tcm_tpu_torch.parallel.mesh import (batch_sharding, make_mesh, replicate,
                                                    replicated, shard_batch)
    from reslic_tcm_tpu_torch.parallel.multihost import gather_objects

    mesh = make_mesh(2, 2)
    batch = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    rows = distribute_tensor(batch, mesh, batch_sharding(mesh), src_data_rank=None).to_local()
    mine = torch.full((2, 3), float(rank))
    repl = distribute_tensor(mine, mesh, replicated(mesh)).to_local()
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(rank))
    replicate(mesh, module)
    return {"place/batch_rows": np.array(gather_objects([rows.tolist()])),
            "place/shard_batch_rows": np.array(gather_objects([shard_batch(mesh, batch).tolist()])),
            "place/replicated": np.array(gather_objects([repl.tolist()])),
            "place/replicate": np.array(gather_objects([module.weight.tolist()]))}


def batches() -> dict:
    from reslic_tcm_tpu_torch.parallel.multihost import (distribute_batch, gather_objects,
                                                         local_batch_size)

    try:
        local_batch_size(6)
        refused = False
    except ValueError:
        refused = True
    rows = distribute_batch(None, np.arange(8))
    return {"local_batch_size_8": np.int64(local_batch_size(8)),
            "local_batch_size_6_refused": np.bool_(refused),
            "rows": np.array(gather_objects([rows.tolist()]))}


def main(inputs: str, out: str, port: int, world: int, rank: int) -> None:
    from reslic_tcm_tpu_torch.parallel.multihost import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
    try:
        z = np.load(inputs)
        res = {**sharded_conv(z, rank, world), **sharded_forward(z), **serving(z),
               **train_steps(z), **noise_step(z, rank), **batches(),
               **sharded_device_paths(z), **placements(z, rank)}
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
