"""Spatial scaling for high-resolution inference (port of
reslic_tcm_tpu/parallel/spatial.py).

1. ``tile_image`` / ``untile_image`` / ``tiled_forward``: overlap-tiled
   inference on one device. A large image becomes a batch of overlapping
   tiles that go through the codec's eval forward ``tile_batch`` at a time
   (so the kernels run at the tile shape, batched), and the tiles' centres
   are stitched back, the lowest tile index owning a pixel. The rate counts
   each likelihood once, in the region its tile owns.
2. ``halo_exchange`` / ``sharded_conv2d`` / ``mesh_sharded_forward``: the
   image's rows split over the ranks of a process group, each rank
   exchanging ``halo`` rows with its ring neighbours
   (``dist.batch_isend_irecv``) before it runs its rows; zero rows at the
   outer edges, as a 'same' convolution pads.

Tile positions and owned bounds are the JAX package's, integer for
integer. The port's module outputs are NCHW, so a likelihood's rows are its
axis 2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.base import fp32_numerics
from ..ops.layers import matmul_precision
from .multihost import data_group, gather_cat

# the latents' strides: y at 1/16 of the image, z at 1/64
STRIDES = {"y": 16, "z": 64}


def total_bits(likelihoods: dict) -> float:
    """The rate estimate of a forward's likelihoods: -sum log2 over all of
    them, in bits."""
    return sum(float(-torch.log2(lik).sum()) for lik in likelihoods.values())

# --------------------------- halo exchange ---------------------------


def halo_exchange(x_shard: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Pad this rank's [B, C, h, W] rows with ``halo`` rows of the previous
    and the next rank of ``group`` on a ring, zero rows at the outer edges
    (rank 0's top, the last rank's bottom). One rank has no neighbour: its
    two edges are outer edges."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    from_prev = torch.zeros_like(x_shard[:, :, :halo])
    from_next = torch.zeros_like(from_prev)
    if n > 1:
        prev = dist.get_global_rank(group, (r - 1) % n) if group is not None else (r - 1) % n
        nxt = dist.get_global_rank(group, (r + 1) % n) if group is not None else (r + 1) % n
        top, bottom = x_shard[:, :, :halo].contiguous(), x_shard[:, :, -halo:].contiguous()
        # each rank sends its top rows to prev, then its bottom rows to next;
        # receiving from next first keeps the pairs in order when prev == next
        ops = [dist.P2POp(dist.irecv, from_next, nxt, group),
               dist.P2POp(dist.irecv, from_prev, prev, group),
               dist.P2POp(dist.isend, top, prev, group),
               dist.P2POp(dist.isend, bottom, nxt, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if r == 0:
            from_prev.zero_()
        if r == n - 1:
            from_next.zero_()
    return torch.cat([from_prev, x_shard, from_next], dim=2)


def sharded_conv2d(x_shard: torch.Tensor, weight: torch.Tensor, group=None) -> torch.Tensor:
    """A 'same'-padded stride-1 convolution of an image whose rows are split
    over ``group``: this rank's [B, C, h, W] rows and an OIHW ``weight``
    (odd kh) give this rank's rows of the output. Equal to the unsplit
    convolution up to floating-point order."""
    kh, kw = weight.shape[2], weight.shape[3]
    padded = halo_exchange(x_shard, kh // 2, group)
    return F.conv2d(padded, weight, padding=(0, kw // 2))


@torch.no_grad()
def mesh_sharded_forward(module, x: torch.Tensor, mesh=None, halo: int = 64):
    """Spatially sharded eval forward through the whole module: rank r of
    ``mesh``'s data group takes rows [r*h, (r+1)*h) of the NCHW image ``x``
    [1, C, H, W] (every rank passes the whole image), pads them with
    ``halo`` rows from its neighbours (``halo_exchange``), runs the module's
    eval forward and keeps its own rows of x_hat and of each likelihood (y
    at stride 16, z at 64). Bits are summed over the ranks (``all_reduce``)
    and x_hat gathered along H. H must divide by the ranks and ``halo`` by
    64, with ``halo <= H / ranks``. Returns (x_hat [1, C, H, W] clipped to
    [0, 1], on every rank; bits, a float)."""
    group = data_group(mesh)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    _, _, h, _ = x.shape
    if h % n:
        raise ValueError(f"H={h} does not divide by {n} ranks")
    h_s = h // n
    if halo % 64 or halo > h_s:
        raise ValueError(f"halo {halo} must be a multiple of 64 and at most {h_s}")
    xp = halo_exchange(x[:, :, r * h_s:(r + 1) * h_s].contiguous(), halo, group)
    with fp32_numerics():
        out = module(xp)
    x_hat = out["x_hat"][:, :, halo:halo + h_s]
    own = {k: lik[:, :, halo // STRIDES[k]:(halo + h_s) // STRIDES[k]]
           for k, lik in out["likelihoods"].items()}
    bits = torch.tensor(total_bits(own), dtype=torch.float64, device=x.device)
    dist.all_reduce(bits, group=group)
    return torch.clamp(gather_cat(x_hat, group, dim=2), 0.0, 1.0), float(bits)


# --------------------------- tiled inference ---------------------------


def tile_grid(h: int, w: int, tile: int, overlap: int) -> list:
    """Tile origins covering [h, w] with ``tile``-sized tiles stepping
    ``tile - 2 * overlap``; the last row and column are shifted in to stay
    in bounds."""
    step = tile - 2 * overlap
    if step <= 0:
        raise ValueError(f"overlap {overlap} leaves no step in a tile of {tile}")
    ys = list(range(0, max(h - tile, 0) + 1, step))
    xs = list(range(0, max(w - tile, 0) + 1, step))
    if not ys or ys[-1] + tile < h:
        ys.append(h - tile)
    if not xs or xs[-1] + tile < w:
        xs.append(w - tile)
    return [(y, x) for y in ys for x in xs]


def tile_image(x, tile: int = 512, overlap: int = 64):
    """[1, H, W, C] -> ([T, tile, tile, C] on x's device, positions)."""
    x = torch.as_tensor(x)
    _, h, w, _ = x.shape
    pos = tile_grid(h, w, tile, overlap)
    return torch.stack([x[0, y:y + tile, x0:x0 + tile] for y, x0 in pos]), pos


def _kept(y: int, x0: int, h: int, w: int, tile: int, overlap: int) -> tuple:
    """A tile's kept region (tile-local y0, y1, x0, x1): all but the
    overlap on each side that has a neighbour."""
    return (0 if y == 0 else overlap, tile if y + tile >= h else tile - overlap,
            0 if x0 == 0 else overlap, tile if x0 + tile >= w else tile - overlap)


def untile_image(tiles: torch.Tensor, pos, h: int, w: int, tile: int,
                 overlap: int) -> torch.Tensor:
    """Stitch [T, tile, tile, C] tile outputs into [1, h, w, C] on their
    device, keeping each tile's centre; where kept regions overlap the
    lowest tile index wins (written last)."""
    canvas = tiles.new_zeros((h, w, tiles.shape[-1]))
    for k in reversed(range(len(pos))):
        y, x0 = pos[k]
        a, b, c, d = _kept(y, x0, h, w, tile, overlap)
        canvas[y + a:y + b, x0 + c:x0 + d] = tiles[k, a:b, c:d]
    return canvas[None]


def owned_bounds(pos, h: int, w: int, tile: int) -> np.ndarray:
    """[T, 4] int32 tile-local (row0, row1, col0, col1) of the region whose
    likelihoods each tile counts: the cuts sit at the midpoint of each pair
    of adjacent tile starts, rounded to a multiple of 64 (whole z cells)
    with Python's round, half to even, as the JAX package rounds them."""
    def bounds(starts, extent):
        ss = sorted(set(starts))
        cuts = [0]
        for a, b in zip(ss[:-1], ss[1:]):
            cuts.append(int(round((a + tile + b) / 2 / 64)) * 64)
        cuts.append(extent)
        return {s: (cuts[j], cuts[j + 1]) for j, s in enumerate(ss)}

    rows = bounds([p[0] for p in pos], h)
    cols = bounds([p[1] for p in pos], w)
    out = np.zeros((len(pos), 4), np.int32)
    for k, (y, x0) in enumerate(pos):
        (r0, r1), (c0, c1) = rows[y], cols[x0]
        out[k] = (r0 - y, r1 - y, c0 - x0, c1 - x0)
    return out


def _owned_bits(likelihoods: dict, bnd: torch.Tensor) -> torch.Tensor:
    """-sum log2 of each NCHW likelihood inside its tile's owned bounds
    ``bnd`` [tiles, 4] (image pixels, divided by the latent's stride)."""
    bits = torch.zeros((), dtype=torch.float32, device=bnd.device)
    for name, lik in likelihoods.items():
        f = 16 if name == "y" else 64
        hh, ww = lik.shape[2], lik.shape[3]
        ri = torch.arange(hh, device=bnd.device).view(1, 1, hh, 1)
        ci = torch.arange(ww, device=bnd.device).view(1, 1, 1, ww)
        a, b, c, d = ((bnd[:, j] // f).view(-1, 1, 1, 1) for j in range(4))
        mask = (ri >= a) & (ri < b) & (ci >= c) & (ci < d)
        bits = bits - torch.where(mask, torch.log2(lik.float()), 0.0).sum()
    return bits


@torch.no_grad()
def tiled_forward(codec, x, tile: int = 512, overlap: int = 64, tile_batch: int = 8):
    """Eval forward of one NHWC image [1, H, W, C] over overlapping tiles,
    through ``codec.module`` on ``codec.device``: chunks of ``tile_batch``
    tiles (the last padded with zero tiles that own nothing) go through the
    module in turn, the owned-region rate is summed on the device and x_hat
    stitched there. An image no larger than one tile goes through
    ``codec.forward``, as in the JAX package. The chunks run at the codec's
    matmul precision where it has one (``ChannelARCodec``). Returns (x_hat
    [1, H, W, C] clipped to [0, 1] on the device; bits, a float)."""
    x = torch.as_tensor(x, dtype=torch.float32).to(codec.device)
    _, h, w, c = x.shape
    if h <= tile and w <= tile:
        out = codec.forward(x)
        return torch.clamp(out["x_hat"], 0, 1), total_bits(out["likelihoods"])

    tiles, pos = tile_image(x, tile, overlap)
    bnds = owned_bounds(pos, h, w, tile)
    t = len(pos)
    padded = -(-t // tile_batch) * tile_batch
    tiles = torch.cat([tiles, tiles.new_zeros((padded - t, tile, tile, c))]).permute(0, 3, 1, 2)
    bnd = torch.from_numpy(np.concatenate([bnds, np.zeros((padded - t, 4), np.int32)])).to(
        codec.device)
    bits = torch.zeros((), dtype=torch.float32, device=codec.device)
    x_hats = []
    with fp32_numerics(), matmul_precision(getattr(codec, "matmul_precision", None)):
        for k in range(0, padded, tile_batch):
            out = codec.module(tiles[k:k + tile_batch].contiguous())
            bits = bits + _owned_bits(out["likelihoods"], bnd[k:k + tile_batch])
            x_hats.append(torch.clamp(out["x_hat"], 0, 1))
    x_hat = untile_image(torch.cat(x_hats)[:t].permute(0, 2, 3, 1), pos, h, w, tile, overlap)
    return x_hat, float(bits)
