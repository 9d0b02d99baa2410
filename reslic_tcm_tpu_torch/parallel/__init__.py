"""Parallel execution (port of reslic_tcm_tpu/parallel/) over torch.distributed.

* ``multihost.py``: bringing up the process group (NCCL on the card, gloo
  on the CPU), the coordinator, each rank's rows of a global batch, and
  the row gathers of the data-parallel codec;
* ``mesh.py``: the ``("data", "model")`` DeviceMesh, replicated and
  tensor-parallel parameters, and the gradient reduction of the sharded
  train step (``training/step.py::shard_train_step``);
* ``spatial.py``: overlap-tiled inference on one device (``tiled_forward``)
  and the spatially sharded forward over ranks (``halo_exchange``,
  ``sharded_conv2d``, ``mesh_sharded_forward``).

Where JAX runs one SPMD program over a mesh of devices, the port runs one
process per rank, each holding its shard, with explicit collectives.
"""
