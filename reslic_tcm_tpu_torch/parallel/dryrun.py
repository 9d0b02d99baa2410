"""The port's single-device check and multi-chip dry run (the JAX package's
root ``__graft_entry__.py``: ``entry`` and ``dryrun_multichip``).

    python -m reslic_tcm_tpu_torch.parallel.dryrun 4 --platform cpu  # 4 gloo ranks
    python -m reslic_tcm_tpu_torch.parallel.dryrun 1                 # the card, NCCL

``entry()`` returns a training-mode forward of TCM-S (N=64, M=320) and its
example arguments. ``dryrun_multichip(n)`` runs one full train step
(forward, rate-distortion loss, gradients, clip, main Adam, aux Adam) of a
small but complete TCM over an n-rank ("data", "model") mesh: the batch
split over "data" (``parallel.mesh.shard_batch``, the gradients averaged by
``GradientSync``), and, with a "model" axis of 2 (n >= 4 and even), the
wide kernels sliced over it (``shard_params(tp=True)``). It starts its n
ranks itself, one process each: gloo on the CPU, NCCL on the card (one
rank a card, so a machine with one card runs a world of one). Rank 0 prints
a line a stage and JAX's ``dryrun_multichip(n): ok, mesh=(...), loss=...``;
the parent kills the ranks and says so after its self-timeout, and returns
the loss.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
LMBDA = 0.0025
HW = (128, 128)
# small but structurally complete: all six TCM stages with window attention,
# the hyperprior and a two-slice channel-AR loop (JAX's dry-run model)
MODEL = dict(N=32, M=40, hyper_ch=24, atten_inter_dim=16, config=(1, 1, 1, 1, 1, 1),
             num_slices=2)
TIMEOUT_S = 900.0  # the self-timeout, JAX's


def entry(device="cuda"):
    """(fn, example_args): fn(module, x, noise) is TCM-S's (N=64, M=320)
    training-mode forward, returning (x_hat, the y likelihoods, the z
    likelihoods); the arguments are the module with seeded weights, a zero
    1x3x256x256 image and seeded uniform noise, on ``device``."""
    from ..models.tcm import make_tcm
    from ..training.step import step_noise

    module = make_tcm(N=64, M=320, device=device, seed=SEED).module.train()
    x = torch.zeros((1, 3, 256, 256), device=device)

    def fn(module, x, noise):
        out = module(x, training=True, noise=noise)
        return out["x_hat"], out["likelihoods"]["y"], out["likelihoods"]["z"]

    return fn, (module, x, step_noise(SEED + 2, 0, x.device))


def mesh_dims(n: int) -> tuple[int, int]:
    """(data, model) ranks of the dry run's mesh: a model axis of 2 where n
    is even and at least 4, as in JAX's."""
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    return n // n_model, n_model


def dryrun_model(device):
    """The dry run's TCM (``MODEL``) with weights from ``SEED``."""
    from ..models.tcm import make_tcm

    return make_tcm(device=device, seed=SEED, **MODEL).module.train()


def dryrun_batch(n_data: int, device) -> torch.Tensor:
    """The global batch: zeros, one 128x128 image a data rank."""
    return torch.zeros((n_data, 3, *HW), device=device)


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """Run the dry run's train step on ``n_devices`` ranks (module
    docstring), one process each on ``device``, and return its loss.
    Raises where a rank fails or the ranks outlast ``TIMEOUT_S``."""
    from .multihost import free_port

    n = int(n_devices)
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"the dry run needs at least one rank, got {n}")
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} NCCL ranks need {n} cards, this machine has "
                         f"{torch.cuda.device_count()} (NCCL refuses two ranks on one card)")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        sys.stdout.flush()
        ranks = [subprocess.Popen(
            [sys.executable, "-m", "reslic_tcm_tpu_torch.parallel.dryrun", str(n), "--rank",
             str(r), "--port", str(port), "--platform", device.type, "--out", out],
            cwd=root, env=env) for r in range(n)]
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while any(p.poll() is None for p in ranks):
                if time.monotonic() > deadline:
                    print(f"dryrun_multichip: the ranks exceeded the {TIMEOUT_S:.0f} s "
                          f"self-timeout (the progress lines above show the last completed "
                          f"stage)", flush=True)
                    raise TimeoutError(f"dryrun_multichip({n}) timed out")
                time.sleep(0.1)
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(ranks) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"dryrun_multichip({n}): ranks {failed} failed (return codes "
                               f"{[ranks[r].returncode for r in failed]}); output above")
        with open(out) as f:
            return json.load(f)["loss"]


def _rank(n: int, rank: int, port: int, device: str, out: str) -> None:
    """One rank of the dry run; rank 0 prints the stages and writes the loss
    to ``out``."""
    t0 = time.monotonic()

    def stage(msg):
        if rank == 0:
            print(f"dryrun_multichip[{time.monotonic() - t0:6.1f}s] {msg}", flush=True)

    from .mesh import make_mesh, shard_batch, shard_params
    from .multihost import initialize_distributed
    from ..training.step import create_train_state, shard_train_step, step_noise

    stage(f"rank start ({device}); torch {torch.__version__}")
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_distributed(f"127.0.0.1:{port}", n, rank, device)
    try:
        n_data, n_model = mesh_dims(n)
        mesh = make_mesh(n_data, n_model)
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else (
            torch.device("cpu"))
        stage(f"process group up: {torch.distributed.get_backend()}, world {n}")
        module = shard_params(mesh, dryrun_model(dev), tp=n_model > 1)
        state = create_train_state(module)
        batch = shard_batch(mesh, dryrun_batch(n_data, dev))
        stage(f"mesh=(data={n_data}, model={n_model}) up; {len(module.tensor_parallel)} kernels "
              f"sliced over 'model'; running the train step (forward + grads + clip + main/aux "
              f"adam)")
        metrics = shard_train_step(mesh)(state, batch, LMBDA, step_noise(SEED, 0, dev))
        loss = float(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stage("step executed")
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss} in the multichip dry run")
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"loss": loss}, f)
            print(f"dryrun_multichip({n}): ok, mesh=(data={n_data}, model={n_model}), "
                  f"loss={loss:.4f}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's multi-chip dry run")
    ap.add_argument("n", type=int, nargs="?", default=1, help="ranks (default 1)")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL, a card a rank (default); cpu: gloo")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.n, args.rank, args.port, args.platform, args.out)
    else:
        dryrun_multichip(args.n, args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
