"""The kernel wrappers' launch counters, read and reset together.

Each wrapper counts its float32 instances' launches in ``.launches`` and,
for B1-B3, its bf16 instances' in ``.launches_bf16``; ``launch_counts``
reads one type's.
"""

from __future__ import annotations

import torch

from .flash_window_attn import flash_window_block
from .fused_conv import fused_conv_gdn, fused_residual_block
from .qkv_attention import fused_qkv_attention

WRAPPERS = (flash_window_block, fused_residual_block, fused_conv_gdn, fused_qkv_attention)
BF16_WRAPPERS = (flash_window_block, fused_residual_block, fused_conv_gdn)


def launch_counts(compute_dtype=torch.float32) -> dict:
    """{wrapper name: kernel launches so far} of the float32 instances, or
    with compute_dtype=torch.bfloat16 of B1-B3's bf16 instances."""
    if compute_dtype == torch.bfloat16:
        return {w.__name__: w.launches_bf16 for w in BF16_WRAPPERS}
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    for w in BF16_WRAPPERS:
        w.launches_bf16 = 0


def launches_since(before: dict, compute_dtype=torch.float32) -> dict:
    return {k: v - before[k] for k, v in launch_counts(compute_dtype).items()}
