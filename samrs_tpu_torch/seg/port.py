"""Weight bridge: the JAX package's segmentation variables -> the port's
state dict.

``jax_params_to_torch(params, batch_stats)`` takes the flax ``params`` and
``batch_stats`` of a ``MultiHeadSegModel``, a ``MultiHeadMask2FormerModel``
or a ``SegModel`` (nested dicts of numpy arrays) and returns a state dict
that the port's model of the same kind loads strictly.  The name mapping is this module's own copy of the one
in samrs_tpu/seg/port.py (``load_torch_rvsa_backbone`` and
``load_torch_vitseg_backbone``, read in the other direction); the port does
not import the JAX package.  ViTSeg's flax names are inline
(``blocks_{i}_norm1``, ``blocks_{i}_attn/qkv``, ``blocks_{i}_mlp/lin1``)
where RVSA's are nested (``blocks_{i}/norm1``); both map to
``blocks.{i}.norm1``.  The Mask2Former decoder's module names are the flax
ones (``seg_decoder/pixel_decoder/encoder0_attn/value_proj``,
``seg_decoder/layer0_cross/q_proj``, ``head_0/cls``); only the MLP's
``layers_{i}`` become ``layers.{i}``, and its parameters ``level_embed``,
``query_feat`` and ``query_embed`` keep their names and layout.
InternImage's flax names (``stem_conv{1,2}``, ``stem_norm{1,2}``,
``level{l}_block{b}/{norm1, dcn/{input_proj, dw_conv, dw_norm, offset, mask,
output_proj}, norm2, mlp/lin{1,2}, gamma{1,2}}``, ``level_norm{l}``,
``downsample{l}``, ``downsample_norm{l}``) map to the reference's key layout
(samrs_tpu/seg/port.py:325-417): ``patch_embed.conv{1,2}`` /
``norm{1,2}.1``, ``levels.{l}.blocks.{b}.{norm1.0, dcn.dw_conv.0,
dcn.dw_conv.1.1, ...}``, ``levels.{l}.norm.0``, ``levels.{l}.downsample.{conv,
norm.1}``; the depthwise kernel (3, 3, 1, C) becomes (C, 1, 3, 3) by the conv
rule.  The ViT-Adapter's flax names map to its reference key layout
(samrs_tpu/seg/port.py:564-790): ``spm/stem{1,2,3}`` and ``_bn`` ->
``spm.stem.{0,3,6}`` / ``{1,4,7}``, ``spm/conv{n}`` / ``_bn`` ->
``spm.conv{n}.0`` / ``.1``, ``injector{i}`` (the MSDeformAttn) ->
``interactions.{i}.injector.attn``, ``injector{i}_qnorm`` / ``_vnorm`` /
``_gamma`` -> ``...injector.query_norm`` / ``feat_norm`` / ``gamma``,
``extractor{i}`` -> ``interactions.{i}.extractor`` (its ``ffn/dwconv`` ->
``ffn.dwconv.dwconv``), ``extra_extractor{j}`` ->
``interactions.{last}.extra_extractors.{j}``, ``blocks_{i}_gamma{1,2}`` ->
``blocks.{i}.gamma{1,2}``; ``up`` is a transposed conv.  The UNet / UNet++
decoders' flax names (``block{i}/conv1/conv``, ``attention1/cse_fc1``,
``node_{l}_{j}_conv1/bn``, ``final_conv``) are the port's.  Swin's
(``patch_embed``, ``patch_norm``, ``stage{s}_block{b}``, ``merge{s}``,
``norm{s}``) map to the reference layout of samrs_tpu/seg/port.py:144-232
(``patch_embed.proj`` / ``.norm``, ``layers.{s}.blocks.{b}``,
``layers.{s}.downsample``, ``norm{s}``); ResNet's (``stem_conv``,
``stem_bn``, ``layer{l}_block{b}/{conv,bn}{j}``, ``downsample_{conv,bn}``)
to torchvision's (:235-322: ``conv1``, ``bn1``, ``layer{l}.{b}.conv{j}`` /
``bn{j}``, ``layer{l}.{b}.downsample.{0,1}``); ViTAEv2's (``rc{s}/
{prm_conv{d}, pcm/conv{i}, pcm/bn{i}, norm1, attn[/attn]/{qkv,proj}, norm2,
mlp}``, ``nc{s}_{b}/...``) to the reference's (:418-563:
``layers.{s}.RC.{PRM.convs.{d - 1}.0, PCM.{3i} / {3i + 1}, attn.{norm1,
attn.{qkv,proj}, norm2, mlp}}``, ``layers.{s}.NC.{b}.{norm1, attn.{qkv,
proj}, PCM.*, norm2, mlp}``).

Layout conversions (flax -> torch):
  dense   kernel (in, out)        -> weight (out, in)
  conv    kernel (kh, kw, I, O)   -> weight (O, I, kh, kw)
  convT   kernel (kh, kw, I, O)   -> weight (I, O, kh, kw), spatially flipped back
          (flax's ConvTranspose convention; torch's ConvTranspose2d needs no flip)
  norms   scale / bias -> weight / bias (LayerNorm, GroupNorm); BatchNorm mean / var ->
          running_mean / running_var
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# flax parameters held by the ViT-Adapter itself -> a module path and a leaf
_LEAF_RENAMES: Tuple[Tuple[str, str], ...] = (
    (r"^encoder/injector(\d+)_gamma$", r"encoder/interactions.\1.injector/gamma"),
    (r"^encoder/blocks_(\d+)_gamma([12])$", r"encoder/blocks.\1/gamma\2"),
)
# flax module path (with '/') -> torch module path, applied in order
_RENAMES: Tuple[Tuple[str, Any], ...] = (
    (r"^encoder/patch_embed$", "encoder.patch_embed.proj"),
    (r"^encoder/spm/stem([123])(_bn)?$",
     lambda m: f"encoder.spm.stem.{3 * int(m[1]) - 3 + bool(m[2])}"),
    (r"^encoder/spm/conv(\d)_bn$", r"encoder.spm.conv\1.1"),
    (r"^encoder/spm/conv(\d)$", r"encoder.spm.conv\1.0"),
    (r"^encoder/injector(\d+)_qnorm$", r"encoder.interactions.\1.injector.query_norm"),
    (r"^encoder/injector(\d+)_vnorm$", r"encoder.interactions.\1.injector.feat_norm"),
    (r"^encoder/injector(\d+)(/|$)", r"encoder.interactions.\1.injector.attn\2"),
    (r"^encoder/extractor(\d+)(/|$)", r"encoder.interactions.\1.extractor\2"),
    (r"(extractors?(?:\.\d+)?)/ffn/dwconv$", r"\1.ffn.dwconv.dwconv"),
    (r"^encoder/stem_conv([12])$", r"encoder.patch_embed.conv\1"),
    (r"^encoder/stem_norm([12])$", r"encoder.patch_embed.norm\1.1"),
    (r"^encoder/level(\d+)_block(\d+)/(norm[12])$", r"encoder.levels.\1.blocks.\2.\3.0"),
    (r"^encoder/level(\d+)_block(\d+)/dcn/dw_conv$", r"encoder.levels.\1.blocks.\2.dcn.dw_conv.0"),
    (r"^encoder/level(\d+)_block(\d+)/dcn/dw_norm$",
     r"encoder.levels.\1.blocks.\2.dcn.dw_conv.1.1"),
    (r"^encoder/level(\d+)_block(\d+)(/|$)", r"encoder.levels.\1.blocks.\2\3"),
    (r"^encoder/level_norm(\d+)$", r"encoder.levels.\1.norm.0"),
    (r"^encoder/downsample_norm(\d+)$", r"encoder.levels.\1.downsample.norm.1"),
    (r"^encoder/downsample(\d+)$", r"encoder.levels.\1.downsample.conv"),
    (r"^encoder/patch_norm$", "encoder.patch_embed.norm"),
    (r"^encoder/stage(\d+)_block(\d+)(/|$)", r"encoder.layers.\1.blocks.\2\3"),
    (r"^encoder/merge(\d+)(/|$)", r"encoder.layers.\1.downsample\2"),
    (r"^encoder/stem_conv$", "encoder.conv1"),
    (r"^encoder/stem_bn$", "encoder.bn1"),
    (r"^encoder/layer(\d+)_block(\d+)/downsample_conv$", r"encoder.layer\1.\2.downsample.0"),
    (r"^encoder/layer(\d+)_block(\d+)/downsample_bn$", r"encoder.layer\1.\2.downsample.1"),
    (r"^encoder/layer(\d+)_block(\d+)/", r"encoder.layer\1.\2."),
    (r"^encoder/rc(\d+)/prm_conv(\d+)$",  # dilation d is the (d - 1)-th branch
     lambda m: f"encoder.layers.{m[1]}.RC.PRM.convs.{int(m[2]) - 1}.0"),
    (r"^encoder/(rc|nc)(\d+)(?:_(\d+))?/pcm/(conv|bn)(\d)$",
     lambda m: f"encoder.layers.{m[2]}.{'RC' if m[1] == 'rc' else 'NC.' + m[3]}.PCM."
               f"{3 * int(m[5]) + (m[4] == 'bn')}"),
    (r"^encoder/rc(\d+)/(?:attn/)?attn/(qkv|proj)$", r"encoder.layers.\1.RC.attn.attn.\2"),
    (r"^encoder/rc(\d+)/", r"encoder.layers.\1.RC.attn."),
    (r"^encoder/nc(\d+)_(\d+)/(?:attn/)?attn/(qkv|proj)$", r"encoder.layers.\1.NC.\2.attn.\3"),
    (r"^encoder/nc(\d+)_(\d+)/", r"encoder.layers.\1.NC.\2."),
    (r"^encoder/neck/fpn1_deconv1$", "encoder.fpn1.0"),
    (r"^encoder/neck/fpn1_norm$", "encoder.fpn1.1.ln"),
    (r"^encoder/neck/fpn1_deconv2$", "encoder.fpn1.3"),
    (r"^encoder/neck/fpn2_deconv$", "encoder.fpn2.0"),
    (r"^encoder/blocks_(\d+)[/_]", r"encoder.blocks.\1."),
    (r"mlp/lin1$", "mlp.fc1"),
    (r"mlp/lin2$", "mlp.fc2"),
    (r"^(encoder\.blocks\.\d+\.attn)/sampling_(offsets|scales|angles)$", r"\1.sampling_\2.2"),
    (r"mask_embed_mlp/layers_(\d+)$", r"mask_embed_mlp.layers.\1"),
    (r"^head_(\d+)/", r"heads.\1."),
)
_DECONV = re.compile(r"(^|/)(fpn1_deconv1|fpn1_deconv2|fpn2_deconv)$|^encoder/up$")
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


def _torch_module(path: str, last_interaction: int = 0) -> str:
    path = re.sub(r"^encoder/extra_extractor(\d+)(/|$)",
                  rf"encoder.interactions.{last_interaction}.extra_extractors.\1\2", path)
    for pat, rep in _RENAMES:
        path = re.sub(pat, rep, path)
    return path.replace("/", ".")


def _convert(path: str, leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf != "kernel":
        return _LEAVES.get(leaf, leaf), v
    if v.ndim == 2:                                   # dense
        return "weight", v.T
    if _DECONV.search(path):                          # convT: undo flax's flip
        return "weight", v[::-1, ::-1].transpose(2, 3, 0, 1)
    return "weight", v.transpose(3, 2, 0, 1)          # conv HWIO -> OIHW


def jax_params_to_torch(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) of a MultiHeadSegModel -> the
    port's state dict (fp32 tensors on the CPU)."""
    flat = _flatten(params)
    flat.update(_flatten(batch_stats or {}))
    last = max((int(m[1]) for m in map(re.compile(r"^encoder/extractor(\d+)/").match, flat)
                if m), default=0)
    sd = {}
    for full, v in flat.items():
        for pat, rep in _LEAF_RENAMES:
            full = re.sub(pat, rep, full)
        path, leaf = full.rsplit("/", 1)
        name, value = _convert(path, leaf, v)
        key = f"{_torch_module(path, last)}.{name}" if path else name
        if key in sd:
            raise KeyError(f"two flax leaves map to {key}")
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd
