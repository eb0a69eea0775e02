"""Weight bridge: flax SAM variables -> the port's (official-layout) state dict.

Takes the JAX package's variable tree as nested dicts of numpy arrays and
returns a state dict that ``Sam.load_state_dict(..., strict=True)`` accepts;
the same keys and layouts as an official ``sam_vit_*.pth``.  The mapping
table is this module's own copy of samrs_tpu/sam/port.py's (the port does
not import the JAX package).

Layout conversions (flax -> torch):
  dense   kernel (in, out)        -> weight (out, in)          [transpose]
  conv    kernel (kh, kw, I, O)   -> weight (O, I, kh, kw)
  convT   kernel (kh, kw, I, O)   -> weight (I, O, kh, kw), spatially flipped
  raw     LayerNorm scale -> weight, embeddings, rel-pos tables: unchanged
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from samrs_tpu_torch.core.config import SamConfig

Entry = Tuple[str, str, str]  # (torch key, flax path, kind)


def _mapping_table(cfg: SamConfig) -> List[Entry]:
    t: List[Entry] = []

    def ln(tk: str, fk: str) -> None:
        t.append((f"{tk}.weight", f"{fk}/scale", "raw"))
        t.append((f"{tk}.bias", f"{fk}/bias", "raw"))

    def dense(tk: str, fk: str) -> None:
        t.append((f"{tk}.weight", f"{fk}/kernel", "dense"))
        t.append((f"{tk}.bias", f"{fk}/bias", "raw"))

    def conv(tk: str, fk: str, bias: bool = True) -> None:
        t.append((f"{tk}.weight", f"{fk}/kernel", "conv"))
        if bias:
            t.append((f"{tk}.bias", f"{fk}/bias", "raw"))

    ie = "image_encoder"
    conv(f"{ie}.patch_embed.proj", f"{ie}/patch_embed")
    t.append((f"{ie}.pos_embed", f"{ie}/pos_embed", "raw"))
    for i in range(cfg.encoder_depth):
        tb, fb = f"{ie}.blocks.{i}", f"{ie}/blocks_{i}"
        ln(f"{tb}.norm1", f"{fb}/norm1")
        ln(f"{tb}.norm2", f"{fb}/norm2")
        dense(f"{tb}.attn.qkv", f"{fb}/attn/qkv")
        dense(f"{tb}.attn.proj", f"{fb}/attn/proj")
        t.append((f"{tb}.attn.rel_pos_h", f"{fb}/attn/rel_pos_h", "raw"))
        t.append((f"{tb}.attn.rel_pos_w", f"{fb}/attn/rel_pos_w", "raw"))
        dense(f"{tb}.mlp.lin1", f"{fb}/mlp/lin1")
        dense(f"{tb}.mlp.lin2", f"{fb}/mlp/lin2")
    conv(f"{ie}.neck.0", f"{ie}/neck_conv1", bias=False)
    ln(f"{ie}.neck.1", f"{ie}/neck_ln1")
    conv(f"{ie}.neck.2", f"{ie}/neck_conv2", bias=False)
    ln(f"{ie}.neck.3", f"{ie}/neck_ln2")

    pr = "prompt_encoder"
    t.append((f"{pr}.pe_layer.positional_encoding_gaussian_matrix",
              f"{pr}/pe_layer/positional_encoding_gaussian_matrix", "raw"))
    for i in range(4):
        t.append((f"{pr}.point_embeddings.{i}.weight", f"{pr}/point_embed_{i}", "raw"))
    t.append((f"{pr}.not_a_point_embed.weight", f"{pr}/not_a_point_embed", "raw"))
    t.append((f"{pr}.no_mask_embed.weight", f"{pr}/no_mask_embed", "raw"))
    conv(f"{pr}.mask_downscaling.0", f"{pr}/mask_conv1")
    ln(f"{pr}.mask_downscaling.1", f"{pr}/mask_ln1")
    conv(f"{pr}.mask_downscaling.3", f"{pr}/mask_conv2")
    ln(f"{pr}.mask_downscaling.4", f"{pr}/mask_ln2")
    conv(f"{pr}.mask_downscaling.6", f"{pr}/mask_conv3")

    md = "mask_decoder"
    t.append((f"{md}.iou_token.weight", f"{md}/iou_token", "raw"))
    t.append((f"{md}.mask_tokens.weight", f"{md}/mask_tokens", "raw"))

    def attn(tk: str, fk: str) -> None:
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{tk}.{p}", f"{fk}/{p}")

    tr = f"{md}/transformer"
    trk = f"{md}.transformer"
    for i in range(cfg.decoder_depth):
        tl, fl = f"{trk}.layers.{i}", f"{tr}/layers_{i}"
        attn(f"{tl}.self_attn", f"{fl}/self_attn")
        attn(f"{tl}.cross_attn_token_to_image", f"{fl}/cross_attn_token_to_image")
        attn(f"{tl}.cross_attn_image_to_token", f"{fl}/cross_attn_image_to_token")
        for n in ("norm1", "norm2", "norm3", "norm4"):
            ln(f"{tl}.{n}", f"{fl}/{n}")
        dense(f"{tl}.mlp.lin1", f"{fl}/mlp/lin1")
        dense(f"{tl}.mlp.lin2", f"{fl}/mlp/lin2")
    attn(f"{trk}.final_attn_token_to_image", f"{tr}/final_attn_token_to_image")
    ln(f"{trk}.norm_final_attn", f"{tr}/norm_final_attn")

    t.append((f"{md}.output_upscaling.0.weight", f"{md}/upscale_conv1/kernel", "convT"))
    t.append((f"{md}.output_upscaling.0.bias", f"{md}/upscale_conv1/bias", "raw"))
    ln(f"{md}.output_upscaling.1", f"{md}/upscale_ln")
    t.append((f"{md}.output_upscaling.3.weight", f"{md}/upscale_conv2/kernel", "convT"))
    t.append((f"{md}.output_upscaling.3.bias", f"{md}/upscale_conv2/bias", "raw"))
    for i in range(cfg.num_multimask_outputs + 1):
        for j in range(3):
            dense(f"{md}.output_hypernetworks_mlps.{i}.layers.{j}", f"{md}/hyper_mlp_{i}/layers_{j}")
    for j in range(cfg.iou_head_depth):
        dense(f"{md}.iou_prediction_head.layers.{j}", f"{md}/iou_head/layers_{j}")
    return t


_TO_TORCH = {
    "raw": lambda w: w,
    "dense": lambda w: w.T,
    "conv": lambda w: w.transpose(3, 2, 0, 1),
    "convT": lambda w: w[::-1, ::-1].transpose(2, 3, 0, 1),
}


def _get(tree: Mapping[str, Any], path: str) -> np.ndarray:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return np.asarray(node)


def jax_params_to_torch(variables_np: Mapping[str, Any], cfg: SamConfig) -> Dict[str, torch.Tensor]:
    """Flax variables (nested dicts of numpy arrays, with or without the
    top-level "params") -> official-layout fp32 state dict."""
    params = variables_np["params"] if "params" in variables_np else variables_np
    return {
        tk: torch.from_numpy(np.array(_TO_TORCH[kind](_get(params, fk)), np.float32, order="C"))
        for tk, fk, kind in _mapping_table(cfg)
    }
