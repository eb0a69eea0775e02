"""Weight bridge: the JAX package's segmentation variables -> the port's
state dict.

``jax_params_to_torch(params, batch_stats)`` takes the flax ``params`` and
``batch_stats`` of a ``MultiHeadSegModel`` or a ``SegModel`` (nested dicts of
numpy arrays) and returns a state dict that the port's model of the same
kind loads strictly.  The name mapping is this module's own copy of the one
in samrs_tpu/seg/port.py (``load_torch_rvsa_backbone`` and
``load_torch_vitseg_backbone``, read in the other direction); the port does
not import the JAX package.  ViTSeg's flax names are inline
(``blocks_{i}_norm1``, ``blocks_{i}_attn/qkv``, ``blocks_{i}_mlp/lin1``)
where RVSA's are nested (``blocks_{i}/norm1``); both map to
``blocks.{i}.norm1``.

Layout conversions (flax -> torch):
  dense   kernel (in, out)        -> weight (out, in)
  conv    kernel (kh, kw, I, O)   -> weight (O, I, kh, kw)
  convT   kernel (kh, kw, I, O)   -> weight (I, O, kh, kw), spatially flipped back
          (flax's ConvTranspose convention; torch's ConvTranspose2d needs no flip)
  norms   scale / bias -> weight / bias; BatchNorm mean / var -> running_mean / running_var
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# flax module path (with '/') -> torch module path, applied in order
_RENAMES: Tuple[Tuple[str, str], ...] = (
    (r"^encoder/patch_embed$", "encoder.patch_embed.proj"),
    (r"^encoder/neck/fpn1_deconv1$", "encoder.fpn1.0"),
    (r"^encoder/neck/fpn1_norm$", "encoder.fpn1.1.ln"),
    (r"^encoder/neck/fpn1_deconv2$", "encoder.fpn1.3"),
    (r"^encoder/neck/fpn2_deconv$", "encoder.fpn2.0"),
    (r"^encoder/blocks_(\d+)[/_]", r"encoder.blocks.\1."),
    (r"mlp/lin1$", "mlp.fc1"),
    (r"mlp/lin2$", "mlp.fc2"),
    (r"attn/sampling_(offsets|scales|angles)$", r"attn.sampling_\1.2"),
    (r"^head_(\d+)/", r"heads.\1."),
)
_DECONVS = ("fpn1_deconv1", "fpn1_deconv2", "fpn2_deconv")
_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _torch_module(path: str) -> str:
    for pat, rep in _RENAMES:
        path = re.sub(pat, rep, path)
    return path.replace("/", ".")


def _convert(path: str, leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf != "kernel":
        return _LEAVES.get(leaf, leaf), v
    if v.ndim == 2:                                   # dense
        return "weight", v.T
    if path.split("/")[-1] in _DECONVS:               # convT: undo flax's flip
        return "weight", v[::-1, ::-1].transpose(2, 3, 0, 1)
    return "weight", v.transpose(3, 2, 0, 1)          # conv HWIO -> OIHW


def jax_params_to_torch(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) of a MultiHeadSegModel -> the
    port's state dict (fp32 tensors on the CPU)."""
    flat = _flatten(params)
    flat.update(_flatten(batch_stats or {}))
    sd = {}
    for full, v in flat.items():
        path, leaf = full.rsplit("/", 1)
        name, value = _convert(path, leaf, v)
        key = f"{_torch_module(path)}.{name}" if path else name
        if key in sd:
            raise KeyError(f"two flax leaves map to {key}")
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd
