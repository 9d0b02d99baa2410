"""The kernel wrappers' launch counters, read and reset together."""

from __future__ import annotations

from .flash_window_attn import flash_window_block
from .fused_conv import fused_conv_gdn, fused_residual_block
from .qkv_attention import fused_qkv_attention

WRAPPERS = (flash_window_block, fused_residual_block, fused_conv_gdn, fused_qkv_attention)


def launch_counts() -> dict:
    """{wrapper name: kernel launches so far}."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}
