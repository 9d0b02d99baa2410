"""JAX parameters -> port state dict (the inverse of
reslic_tcm_tpu/utils/torch_convert.py::convert_state_dict).

The port's modules carry the reference PyTorch state-dict names and layouts,
so the JAX package's flax parameters map onto them with the same name table
its converter uses, run the other way:

  flax conv kernel HWIO [kh, kw, I, O] -> Conv2d weight OIHW [O, I, kh, kw]
  flax Deconv kernel (input-dilated HWIO) -> ConvTranspose2d weight IOHW
                                             [I, O, kh, kw], spatially flipped
  flax dense kernel [I, O]             -> Linear weight [O, I]
  LayerNorm scale -> weight; GDN, entropy-bottleneck chain and relative
  position tables copy as they are.

The same table carries TCM, WACNN and the Balle-2018 family (g_a/g_s
convolutions and Deconvs, GDN beta/gamma, h_a/h_s, the entropy
bottleneck): their flax paths are Sequential indices over bare Conv,
Deconv and GDN layers (``g_a/layers_0/conv/kernel`` -> ``g_a.0.weight``,
``g_s/layers_0/kernel`` -> a Deconv's ``g_s.0.weight``).

The STanH codecs' extra parameters keep their flax layout: the stacked
quantizer tables ``gaussian_conditional/stanh/{w,b}`` ([n_rates, L]), the
STanH bottleneck ``entropy_bottleneck_stanh/*`` (its chain and nested
``stanh``), the stacked refinement ``refine/{kernel,bias}`` ([n_rates,
cin, cout], [n_rates, cout]) and the per-level synthesis clones
``g_s_{i}/...``, which map as ``g_s`` does.

The gain codecs' four gain matrices (``Gain``, ``InverseGain``: [levels,
M]; ``HyperGain``, ``InverseHyperGain``: [levels, N]) are top-level
parameters that copy as they are, and the SC codec's stages
(``qmap_feature_*``, ``g_a1..4``, ``g_s1..4`` Sequentials and the SFT
blocks' ``ga_SFT*/mlp_shared`` convolutions) map through the same rules
(``tests/test_torch_port_gain.py`` holds each whole).

``load_snapshot`` reads the committed fp16 snapshots
(``checkpoints/*.npz``: one array per '/'-joined flax parameter path) and
upcasts them to float32.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _translate_path(parts: tuple) -> tuple[str, list[str]]:
    """flax parameter path -> (torch key, alternative keys). A copy of the
    JAX package's name table. The alternatives cover its one ambiguous
    case: a Conv wrapper named "conv" holding the nn.Conv "conv" is either a
    bare SubpelConv3x3 in a Sequential ("<idx>.0.weight") or
    ResidualBlockUpsample's mid conv ("<idx>.conv.weight")."""
    leaf = parts[-1]
    out: list[str] = []
    amb: list[int] = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if m := re.fullmatch(r"layers_(\d+)", p):
            out.append(m.group(1))
        elif m := re.fullmatch(r"(atten_mean|atten_scale)_(\d+)", p):
            # the reference wraps each SWAtten in a Sequential
            out.extend([m.group(1), m.group(2), "0"])
        elif m := re.fullmatch(r"(cc_mean|cc_scale|lrp)_(\d+)", p):
            name = {"cc_mean": "cc_mean_transforms", "cc_scale": "cc_scale_transforms",
                    "lrp": "lrp_transforms"}[m.group(1)]
            out.extend([name, m.group(2)])
        elif m := re.fullmatch(r"conv_(a|b)(\d)", p):
            out.extend([f"conv_{m.group(1)}", m.group(2)])
        elif p == "conv_b_out":
            out.extend(["conv_b", "3"])
        elif p == "mlp1":
            out.extend(["mlp", "0"])
        elif p == "mlp2":
            out.extend(["mlp", "2"])
        elif p in ("subpel", "upsample"):
            # SubpelConv3x3 = Sequential(conv, PixelShuffle); CompressAI's
            # ResidualBlockUpsample names its main branch "subpel_conv"
            out.extend(["subpel_conv" if p == "subpel" else p, "0"])
            if i + 1 < len(parts) - 1 and parts[i + 1] == "conv":
                i += 1  # the Conv wrapper
                if i + 1 < len(parts) - 1 and parts[i + 1] == "conv":
                    i += 1  # its nn.Conv child
        elif p == "conv" and i + 1 < len(parts) - 1 and parts[i + 1] == "conv":
            amb.append(len(out))
            out.append("0")
            i += 1
        elif re.fullmatch(r"conv[123]?", p) and i + 1 < len(parts) - 1 and parts[i + 1] == "conv":
            # Conv wrapper <name>/conv/kernel -> <name>.weight; ResidualUnit's
            # conv1/conv2/conv3 -> conv.0/.2/.4
            parent = parts[i - 1] if i > 0 else ""
            if re.fullmatch(r"conv_(a|b)\d", parent):
                out.extend(["conv", {"conv1": "0", "conv2": "2", "conv3": "4"}[p]])
            else:
                out.append(p)
            i += 1
        elif p == "conv" and parts[min(i + 1, len(parts) - 1)] in ("kernel", "bias"):
            pass  # a bare Conv directly in a Sequential: g_a.9.weight
        else:
            out.append(p)
        i += 1

    if leaf == "kernel":
        suffix = ".weight"
    elif leaf == "bias" and not re.fullmatch(r"bias\d", parts[-2] if len(parts) > 1 else ""):
        suffix = ".bias"
    elif leaf == "scale":
        suffix = ".weight"
    else:
        suffix = None
    if suffix is None:
        return ".".join(out + [leaf]), []
    alts = []
    for j in amb:
        alt = list(out)
        alt[j] = "conv"
        alts.append(".".join(alt) + suffix)
    return ".".join(out) + suffix, alts


def _finalize_key(k: str) -> str:
    """CompressAI's entropy-bottleneck chain names: matrix0 -> _matrix0 (also
    in the STanH bottleneck, ``entropy_bottleneck_stanh``)."""
    return re.sub(r"\b(entropy_bottleneck(?:_stanh)?)\.(matrix|bias|factor)(\d)", r"\1._\2\3",
                  k)


def torch_key(path: str, flat_keys) -> str:
    """The port state-dict key of the '/'-joined flax path ``path``; the
    ambiguous "conv/conv" case is resolved by whether the parent module is
    a ResidualBlockUpsample (has an ``igdn`` child in ``flat_keys``)."""
    parts = tuple(path.split("/"))
    key, alts = _translate_path(parts)
    if alts:
        k = next(i for i in range(len(parts) - 1) if parts[i] == parts[i + 1] == "conv")
        if "/".join(parts[:k] + ("igdn", "beta")) in flat_keys:
            key = alts[0]
    return _finalize_key(key)


def is_deconv_path(path: str) -> bool:
    """A 4-D flax ``kernel`` that its module stores directly, with no Conv
    wrapper ("conv") as parent, is a Deconv's (the JAX converter's rule)."""
    parts = path.split("/")
    return parts[-1] == "kernel" and len(parts) >= 2 and parts[-2] != "conv"


def from_jax_params(flat: dict) -> dict:
    """flax parameters, flattened to '/'-joined paths -> a port state dict
    of float32 tensors (fp16 snapshot values upcast)."""
    sd = {}
    for path, value in flat.items():
        v = np.array(value, dtype=np.float32)
        if path.endswith("/kernel") and v.ndim == 4 and is_deconv_path(path):
            v = v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif path.endswith("/kernel") and v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif path.endswith("/kernel") and v.ndim == 2:
            v = v.T
        key = torch_key(path, flat)
        if key in sd:
            raise ValueError(f"two parameters map to {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def load_snapshot(path: str) -> dict:
    """A committed ``.npz`` snapshot as {flax path: float32 array}."""
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


def load_snapshot_into(module: torch.nn.Module, path: str,
                       allow_unused: bool = False) -> list[str]:
    """Load a snapshot into a port module. Every parameter of the module must
    be in the snapshot, with its shape. Snapshot entries the module has no
    place for raise, unless ``allow_unused``; they are returned (flax paths),
    e.g. the two quantizer tables of a STanH snapshot loaded into its plain
    backbone."""
    flat = load_snapshot(path)
    sd = from_jax_params(flat)
    own = module.state_dict()
    unused = sorted(p for p in flat if torch_key(p, flat) not in own)
    if unused and not allow_unused:
        raise ValueError(f"{path}: {len(unused)} entries have no parameter here, "
                         f"e.g. {unused[:5]}")
    missing = [k for k in own if k not in sd]
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} parameters, e.g. {missing[:5]}")
    module.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=True)
    return unused
