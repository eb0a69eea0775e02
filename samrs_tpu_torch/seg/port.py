"""Weight bridge: the JAX package's segmentation variables -> the port's
state dict; and ``load_backbone_checkpoint``, which grafts a torch backbone
checkpoint of any of the seven families into a port encoder with the JAX
package's key rules (below the bridge).

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

import logging
import re
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from samrs_tpu_torch.nn.layers import resize_bicubic_jax

logger = logging.getLogger("samrs_tpu_torch.seg.port")

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


# ------------------------------------------------ torch backbone checkpoints ----
#
# load_backbone_checkpoint grafts a MAE / IMP / timm / official .pth into an
# encoder, as samrs_tpu/seg/port.py:992-1069 does: the family is detected from
# the keys and each family's rule (:55-790) decides, key by key, what loads and
# what is skipped.  The port's encoders use the reference key layout, so a rule
# only names the port key a checkpoint key goes to; it loads when that key
# exists with the checkpoint tensor's shape, as the JAX rule loads when its
# flax leaf exists with that shape.  The loaded and skipped lists are the JAX
# rules' own, quirks included (keys a rule drops silently, keys it lists as
# loaded without loading them).

_PREFIXES = ("module.", "backbone.", "encoder.")
_VIT_BLOCK = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "attn.qkv.weight",
              "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias", "mlp.fc1.weight",
              "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")
_SWIN_BLOCK = _VIT_BLOCK + ("attn.relative_position_bias_table",)
_SWIN_MERGE = ("reduction.weight", "norm.weight", "norm.bias")
_II_STEM = tuple(f"patch_embed.{m}.{leaf}" for m in ("conv1", "norm1.1", "conv2", "norm2.1")
                 for leaf in ("weight", "bias"))
_II_BLOCK = ("norm1.0.weight", "norm1.0.bias", "norm2.0.weight", "norm2.0.bias", "gamma1",
             "gamma2") + tuple(f"dcn.{m}.{leaf}" for m in (
                 "input_proj", "output_proj", "offset", "mask", "dw_conv.0", "dw_conv.1.1")
                 for leaf in ("weight", "bias")) + _VIT_BLOCK[8:]
_VITAE_RC = ("attn.norm1.weight", "attn.norm1.bias", "attn.norm2.weight", "attn.norm2.bias",
             "attn.mlp.fc1.weight", "attn.mlp.fc1.bias", "attn.mlp.fc2.weight",
             "attn.mlp.fc2.bias")
_VITAE_NC = tuple(k[len("attn."):] for k in _VITAE_RC)
_VITAE_DIL = ((1, 2, 3, 4), (1, 2, 3), (1, 2), (1, 2))  # PRM dilations a stage
_VITAE_DEAD = ("relative_position_bias_table", "relative_position_index", "attn_mask")
_ADAPTER_BLOCK = ("gamma1", "gamma2") + _VIT_BLOCK
_MSDA = tuple(f"{m}.{leaf}" for m in ("value_proj", "sampling_offsets", "attention_weights",
                                      "output_proj") for leaf in ("weight", "bias"))
_BN = ("weight", "bias", "running_mean", "running_var")


def _strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the ``module.`` / ``backbone.`` / ``encoder.`` prefixes, in that order."""
    out = {}
    for k, v in sd.items():
        for pre in _PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def interpolate_pos_embed(pos: torch.Tensor, target_tokens: int,
                          has_cls: bool = True) -> torch.Tensor:
    """(1, (1+)N, D) -> (1, target, D) in fp32: the cls slot dropped where the
    token count says there is one, the (g, g) grid resized with jax.image's
    bicubic weights (Keys a = -0.5, half-pixel centres, antialiased when it
    shrinks; samrs_tpu/seg/port.py:31-52), the sums taken in float64 and
    rounded once (JAX's fp32 contraction lands up to ~2e-6 of the value
    from that).  Raises ValueError if N is not square."""
    n = pos.shape[1]
    if has_cls and n % int(round(n ** 0.5)) ** 2 != 0:
        pos = pos[:, 1:]
    elif has_cls and int(round((n - 1) ** 0.5)) ** 2 == n - 1:
        pos = pos[:, 1:]
    n = pos.shape[1]
    g_old, g_new = int(round(n ** 0.5)), int(round(target_tokens ** 0.5))
    if g_old * g_old != n:
        raise ValueError(f"pos embed length {n} is not square")
    if g_old == g_new:
        return pos.float()
    grid = resize_bicubic_jax(pos.reshape(1, g_old, g_old, -1), (g_new, g_new), torch.float64)
    return grid.reshape(1, g_new * g_new, -1).float()


def detect_backbone_family(keys) -> str:
    """The reference backbone family of a (prefix-stripped) state dict's keys."""
    keyset = set(keys)
    if any(".RC." in k or ".NC." in k for k in keyset):
        return "vitae"
    if any(k.startswith("interactions.") or k.startswith("spm.") for k in keyset):
        return "vit_adapter"
    if any(".dcn." in k or k.startswith("patch_embed.conv1.") for k in keyset):
        return "internimage"
    if any(k.startswith("layer1.") or k.startswith("conv1.") for k in keyset):
        return "resnet"
    if any("layers." in k and ".blocks." in k for k in keyset):
        return "swin"
    return "vit"


class _Plan:
    """A family rule's decisions: ``load`` (port key -> tensor) and the
    checkpoint keys reported ``loaded`` and ``skipped``."""

    def __init__(self, sd: Dict[str, torch.Tensor], target: Mapping[str, torch.Tensor]):
        self.sd, self.target = sd, target
        self.load: Dict[str, torch.Tensor] = {}
        self.loaded: list = []
        self.skipped: list = []

    def try_set(self, key: str, value: torch.Tensor, tk: str) -> None:
        t = self.target.get(key)
        if t is None or tuple(t.shape) != tuple(value.shape):
            self.skipped.append(tk)
            return
        self.load[key] = value
        self.loaded.append(tk)

    def set_bn(self, key: str, tk_prefix: str) -> None:
        for leaf in _BN:
            tk = f"{tk_prefix}.{leaf}"
            if tk in self.sd:
                self.try_set(f"{key}.{leaf}", self.sd[tk], tk)

    def deform_attn(self, key: str, tk_prefix: str) -> None:
        for leaf in _MSDA:
            if f"{tk_prefix}.{leaf}" in self.sd:
                self.try_set(f"{key}.{leaf}", self.sd[f"{tk_prefix}.{leaf}"],
                             f"{tk_prefix}.{leaf}")


def _wb(tk: str) -> str:
    return "weight" if tk.endswith("weight") else "bias"


def _vit_rule(p: _Plan, nested_blocks: bool) -> None:
    """load_torch_vit_backbone (:55-141).  Its block paths are RVSA's nested
    flax names (``blocks_{i}/norm1``); ViTSeg and the ViT-Adapter name their
    blocks inline (``blocks_{i}_norm1``), so for them every block key is
    skipped and only the patch embedding and the pos-embed load."""
    for tk, v in p.sd.items():
        if tk in ("cls_token", "mask_token", "norm.weight", "norm.bias"):
            p.skipped.append(tk)
        elif tk == "pos_embed":
            tgt = p.target.get("pos_embed")
            if tgt is not None:
                try:
                    v2 = interpolate_pos_embed(v, tgt.shape[1], has_cls=True)
                    if tuple(v2.shape) == tuple(tgt.shape):
                        p.load["pos_embed"] = v2
                        p.loaded.append(tk)
                        continue
                except ValueError:
                    pass
            p.skipped.append(tk)
        elif tk.startswith("patch_embed.proj."):
            p.try_set(f"patch_embed.proj.{_wb(tk)}", v, tk)
        elif (m := re.match(r"blocks\.(\d+)\.(.*)", tk)):
            if nested_blocks and m[2] in _VIT_BLOCK + ("attn.rel_pos_h", "attn.rel_pos_w"):
                p.try_set(f"blocks.{m[1]}.{m[2]}", v, tk)
            else:
                p.skipped.append(tk)
        else:
            p.skipped.append(tk)


def _swin_rule(p: _Plan) -> None:
    """load_torch_swin_backbone (:144-232)."""
    for tk, v in p.sd.items():
        if tk.startswith("patch_embed.proj."):
            p.try_set(f"patch_embed.proj.{_wb(tk)}", v, tk)
        elif tk.startswith("patch_embed.norm."):
            p.try_set(f"patch_embed.norm.{_wb(tk)}", v, tk)
        elif (m := re.match(r"norm(\d+)\.(weight|bias)", tk)):
            p.try_set(f"norm{m[1]}.{m[2]}", v, tk)
        elif (m := re.match(r"layers\.(\d+)\.downsample\.(.*)", tk)):
            if m[2] in _SWIN_MERGE:
                p.try_set(f"layers.{m[1]}.downsample.{m[2]}", v, tk)
            else:
                p.skipped.append(tk)
        elif (m := re.match(r"layers\.(\d+)\.blocks\.(\d+)\.(.*)", tk)):
            if m[3] in _SWIN_BLOCK:
                p.try_set(f"layers.{m[1]}.blocks.{m[2]}.{m[3]}", v, tk)
            else:
                p.skipped.append(tk)  # relative_position_index buffers etc.
        else:
            p.skipped.append(tk)


def _resnet_rule(p: _Plan) -> None:
    """load_torch_resnet_backbone (:235-322): a BatchNorm's five keys go
    together, and a consumed key never counts as skipped; ``fc.*`` and the
    step counters are dropped."""
    consumed = set()

    def set_bn(key: str, tk_prefix: str) -> None:
        p.set_bn(key, tk_prefix)
        consumed.update(f"{tk_prefix}.{s}" for s in _BN + ("num_batches_tracked",))

    if "conv1.weight" in p.sd:
        p.try_set("conv1.weight", p.sd["conv1.weight"], "conv1.weight")
        consumed.add("conv1.weight")
    set_bn("bn1", "bn1")
    for tk, v in p.sd.items():
        if tk in consumed:
            continue
        if (m := re.match(r"layer(\d+)\.(\d+)\.conv(\d)\.weight", tk)):
            p.try_set(f"layer{m[1]}.{m[2]}.conv{m[3]}.weight", v, tk)
        elif (m := re.match(r"layer(\d+)\.(\d+)\.bn(\d)\.", tk)):
            set_bn(f"layer{m[1]}.{m[2]}.bn{m[3]}", tk.rsplit(".", 1)[0])
        elif (m := re.match(r"layer(\d+)\.(\d+)\.downsample\.0\.weight", tk)):
            p.try_set(f"layer{m[1]}.{m[2]}.downsample.0.weight", v, tk)
        elif (m := re.match(r"layer(\d+)\.(\d+)\.downsample\.1\.", tk)):
            set_bn(f"layer{m[1]}.{m[2]}.downsample.1", tk.rsplit(".", 1)[0])
        elif not (tk.endswith("num_batches_tracked") or tk.startswith("fc.")):
            p.skipped.append(tk)
    p.loaded, p.skipped = sorted(set(p.loaded)), sorted(set(p.skipped) - consumed)


def _internimage_rule(p: _Plan) -> None:
    """load_torch_internimage_backbone (:325-415); the classification head
    (``conv_head``, ``head``, ``norm``) is dropped."""
    for tk, v in p.sd.items():
        if tk in _II_STEM:
            p.try_set(tk, v, tk)
        elif (m := re.match(r"levels\.(\d+)\.blocks\.(\d+)\.(.*)", tk)):
            if m[3] in _II_BLOCK:
                p.try_set(f"levels.{m[1]}.blocks.{m[2]}.{m[3]}", v, tk)
            else:
                p.skipped.append(tk)
        elif (m := re.match(r"levels\.(\d+)\.norm\.0\.(weight|bias)", tk)):
            p.try_set(f"levels.{m[1]}.norm.0.{m[2]}", v, tk)
        elif (m := re.match(r"levels\.(\d+)\.downsample\.conv\.weight", tk)):
            p.try_set(f"levels.{m[1]}.downsample.conv.weight", v, tk)
        elif (m := re.match(r"levels\.(\d+)\.downsample\.norm\.1\.(weight|bias)", tk)):
            p.try_set(f"levels.{m[1]}.downsample.norm.1.{m[2]}", v, tk)
        elif not tk.startswith(("conv_head.", "head.", "norm.")):
            p.skipped.append(tk)


def _vitae_rule(p: _Plan) -> None:
    """load_torch_vitae_backbone (:418-561): the reference's dead parameters
    (rel-pos tables, attention masks, the out-norms) and the PCM step
    counters are listed as loaded without a target."""

    def pcm(cell: str, rest: str, v, tk) -> bool:
        m = re.match(r"PCM\.(\d)\.(weight|bias|running_mean|running_var|num_batches_tracked)",
                     rest)
        if not m:
            return False
        idx, leaf = m[1], m[2]
        if leaf == "num_batches_tracked":
            p.loaded.append(tk)
        elif idx in ("0", "3", "6"):
            p.try_set(f"{cell}.PCM.{idx}.{'weight' if leaf == 'weight' else 'bias'}", v, tk)
        elif idx in ("1", "4"):
            p.try_set(f"{cell}.PCM.{idx}.{leaf}", v, tk)
        else:
            p.skipped.append(tk)
        return True

    for tk, v in p.sd.items():
        if any(d in tk for d in _VITAE_DEAD) or re.match(r"norm\d\.(weight|bias)", tk):
            p.loaded.append(tk)
        elif (m := re.match(r"layers\.(\d+)\.RC\.(.*)", tk)):
            s, rest, cell = m[1], m[2], f"layers.{m[1]}.RC"
            if (pm := re.match(r"PRM\.convs\.(\d+)\.0\.(weight|bias)", rest)):
                dil = _VITAE_DIL[int(s)][int(pm[1])]
                p.try_set(f"{cell}.PRM.convs.{dil - 1}.0.{pm[2]}", v, tk)
            elif pcm(cell, rest, v, tk):
                pass
            elif rest in _VITAE_RC or re.match(r"attn\.attn\.(qkv|proj)\.(weight|bias)", rest):
                p.try_set(f"{cell}.{rest}", v, tk)
            else:
                p.skipped.append(tk)
        elif (m := re.match(r"layers\.(\d+)\.NC\.(\d+)\.(.*)", tk)):
            rest, cell = m[3], f"layers.{m[1]}.NC.{m[2]}"
            if pcm(cell, rest, v, tk):
                pass
            elif rest in _VITAE_NC or re.match(r"attn\.(qkv|proj)\.(weight|bias)", rest):
                p.try_set(f"{cell}.{rest}", v, tk)
            else:
                p.skipped.append(tk)
        else:
            p.skipped.append(tk)


def _vit_adapter_rule(p: _Plan) -> None:
    """load_torch_vit_adapter_backbone (:564-788): the pos-embed loses its
    cls slot (resized where the grids differ); a trunk checkpoint's extras
    (cls / mask tokens, the final norm, the head) and the step counters are
    listed as loaded without a target; the extra extractors go to the port's
    last interaction."""
    sd = p.sd
    consumed = set()
    last = max((int(m[1]) for m in (re.match(r"interactions\.(\d+)\.extra_extractors\.", k)
                                    for k in p.target) if m), default=None)

    def extractor(key: str, tk_prefix: str) -> None:
        for name in ("query_norm", "feat_norm", "ffn_norm", "ffn.fc1", "ffn.fc2",
                     "ffn.dwconv.dwconv"):
            if name == "ffn.fc1":
                p.deform_attn(f"{key}.attn", f"{tk_prefix}.attn")
            for leaf in ("weight", "bias"):
                if f"{tk_prefix}.{name}.{leaf}" in sd:
                    p.try_set(f"{key}.{name}.{leaf}", sd[f"{tk_prefix}.{name}.{leaf}"],
                              f"{tk_prefix}.{name}.{leaf}")

    if "pos_embed" in sd:
        pos, tgt = sd["pos_embed"], p.target.get("pos_embed")
        n = 0 if tgt is None else tgt.shape[1]
        if pos.shape[1] == n + 1:
            pos = pos[:, 1:]
        if pos.shape[1] != n and tgt is not None:
            try:
                pos = interpolate_pos_embed(pos, n, has_cls=False)
            except ValueError:
                pass
        if tgt is not None and tuple(pos.shape) == tuple(tgt.shape):
            p.load["pos_embed"] = pos
            p.loaded.append("pos_embed")
        else:
            p.skipped.append("pos_embed")
        consumed.add("pos_embed")
    for leaf in ("weight", "bias"):
        if f"patch_embed.proj.{leaf}" in sd:
            p.try_set(f"patch_embed.proj.{leaf}", sd[f"patch_embed.proj.{leaf}"],
                      f"patch_embed.proj.{leaf}")
            consumed.add(f"patch_embed.proj.{leaf}")
    if "level_embed" in sd:
        p.try_set("level_embed", sd["level_embed"], "level_embed")
        consumed.add("level_embed")

    for tk, v in sd.items():
        if tk in consumed:
            continue
        if (m := re.match(r"blocks\.(\d+)\.(.*)", tk)):
            if m[2] in _ADAPTER_BLOCK:
                p.try_set(f"blocks.{m[1]}.{m[2]}", v, tk)
            else:
                p.skipped.append(tk)
        elif (m := re.match(r"spm\.stem\.(\d+)\.", tk)):
            idx = int(m[1])
            if idx in (0, 3, 6) and tk.endswith("weight"):
                p.try_set(f"spm.stem.{idx}.weight", v, tk)
            elif idx in (1, 4, 7):
                p.set_bn(f"spm.stem.{idx}", tk.rsplit(".", 1)[0])
            elif tk.endswith("num_batches_tracked"):
                p.loaded.append(tk)
            else:
                p.skipped.append(tk)
        elif (m := re.match(r"spm\.conv(\d)\.(\d)\.", tk)):
            if m[2] == "0" and tk.endswith("weight"):
                p.try_set(f"spm.conv{m[1]}.0.weight", v, tk)
            elif m[2] == "1":
                p.set_bn(f"spm.conv{m[1]}.1", tk.rsplit(".", 1)[0])
            elif tk.endswith("num_batches_tracked"):
                p.loaded.append(tk)
            else:
                p.skipped.append(tk)
        elif (m := re.match(r"spm\.fc(\d)\.(weight|bias)", tk)):
            p.try_set(f"spm.fc{m[1]}.{m[2]}", v, tk)
        elif (m := re.match(r"interactions\.(\d+)\.injector\.(.*)", tk)):
            key, rest = f"interactions.{m[1]}.injector", m[2]
            if rest == "gamma":
                p.try_set(f"{key}.gamma", v, tk)
            elif rest.startswith(("query_norm.", "feat_norm.")):
                p.try_set(f"{key}.{rest.split('.')[0]}.{_wb(rest)}", v, tk)
            elif rest.startswith("attn."):
                p.deform_attn(f"{key}.attn", f"{key}.attn")
                consumed.update(f"{key}.attn.{leaf}" for leaf in _MSDA)
            else:
                p.skipped.append(tk)
        elif (m := re.match(r"interactions\.(\d+)\.extractor\.", tk)):
            pre = f"interactions.{m[1]}.extractor"
            extractor(pre, pre)
            consumed.update(k for k in sd if k.startswith(pre + "."))
        elif (m := re.match(r"interactions\.(\d+)\.extra_extractors\.(\d)\.", tk)):
            pre = f"interactions.{m[1]}.extra_extractors.{m[2]}"
            extractor(f"interactions.{m[1] if last is None else last}.extra_extractors.{m[2]}",
                      pre)
            consumed.update(k for k in sd if k.startswith(pre + "."))
        elif tk.startswith("up."):
            p.try_set(f"up.{_wb(tk)}", v, tk)
        elif (m := re.match(r"norm(\d)\.", tk)):
            if tk.endswith("num_batches_tracked"):
                p.loaded.append(tk)
            else:
                p.set_bn(f"norm{m[1]}", f"norm{m[1]}")
        elif tk in ("cls_token", "mask_token", "norm.weight", "norm.bias") or \
                tk.startswith(("head.", "fc_norm.")):
            p.loaded.append(tk)
        else:
            p.skipped.append(tk)
    p.loaded, p.skipped = sorted(set(p.loaded)), sorted(set(p.skipped))


_BN_FAMILIES = ("resnet", "vitae", "vit_adapter")


@dataclass
class CheckpointLoad:
    """What ``load_backbone_checkpoint`` did: the detected family and the
    checkpoint keys (prefixes stripped) it loaded and skipped."""

    family: str
    loaded: List[str]
    skipped: List[str]


def load_backbone_checkpoint(path: str, encoder: torch.nn.Module,
                             allow_pickle: bool = False) -> CheckpointLoad:
    """Load a torch .pth (MAE / IMP / timm / official; ``state_dict``,
    ``state_dict_ema``, ``model`` or ``module`` wrappers) into `encoder`
    non-strictly, in place, with the JAX package's family rules
    (samrs_tpu/seg/port.py:1009-1069): the same keys load (BatchNorm running
    statistics too, for resnet / vitae / vit_adapter) and the same are
    skipped.  ``weights_only=True`` first; full unpickling only under
    `allow_pickle`.  The tensors go in through ``load_state_dict``, so the
    parameters' version counters move and the kernels' weight caches
    (K11's tf32 halves, the GEMM's copies) refresh."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_pickle:
            raise RuntimeError(
                f"{path} needs full unpickling (weights_only=True failed: {e}); "
                "re-call with allow_pickle=True if you trust this checkpoint") from e
        warnings.warn(f"unpickling {path} with weights_only=False (allow_pickle)")
        sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "state_dict_ema", "model", "module"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
            break
    sd = _strip_prefixes({k: v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(
        np.asarray(v)) for k, v in sd.items()})
    family = detect_backbone_family(sd)
    target = encoder.state_dict()
    if family in _BN_FAMILIES and not any(k.endswith("running_mean") for k in target):
        raise ValueError(f"{family} checkpoints carry BatchNorm statistics; the encoder has "
                         "no BatchNorm to take them")
    plan = _Plan(sd, target)
    if family == "vit":
        from samrs_tpu_torch.seg.backbones.rvsa import ViTRVSA
        _vit_rule(plan, isinstance(encoder, ViTRVSA))
    else:
        {"swin": _swin_rule, "resnet": _resnet_rule, "internimage": _internimage_rule,
         "vitae": _vitae_rule, "vit_adapter": _vit_adapter_rule}[family](plan)
    missing = sorted(set(plan.load) - set(target))
    if missing:
        raise RuntimeError(f"[{family}] keys meant to load are not in the encoder: {missing[:5]}")
    encoder.load_state_dict(plan.load, strict=False)
    logger.info("[%s] loaded %d tensors, skipped %d (e.g. %s)", family, len(plan.loaded),
                len(plan.skipped), plan.skipped[:5])
    return CheckpointLoad(family, list(plan.loaded), list(plan.skipped))
