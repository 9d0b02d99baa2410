"""reslic_tcm_tpu_torch: the PyTorch + CUDA port of reslic_tcm_tpu.

The JAX package beside it is the frozen reference. This package mirrors its
module layout and names, imports only torch, numpy and scipy, and runs the
TCM and WACNN eval paths (forward estimate and the real host rANS codec)
on an NVIDIA H100 through four hand-written CUDA kernels (``csrc/``):

* ``ops/flash_window_attn.py``: a whole Swin sub-block per 8x8 window
  (with LN and MLP for TCM, attention only for WACNN);
* ``ops/fused_conv.py``: the fused residual block and fused conv3x3+GDN;
* ``ops/qkv_attention.py``: per-window qkv attention (WACNN's window 4).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
