"""Mask2Former decoder, head, loss and prediction (mirrors
samrs_tpu/seg/decoders/mask2former.py; reference
E2E/mask2former_decoder/mmdet_mask2former.py and mmseg_mask2former.py).

Model half (NCHW maps in, as the port's backbones give them):
  * ``PixelDecoder``: 1x1 conv + GroupNorm(32) projections of c4 / c3 / c2, six
    MSDeformAttn encoder layers over their 7^2 + 14^2 + 28^2 tokens at 224^2
    (the sampling through K8 under ``use_kernels``), then the lateral c1
    branch, the bilinear top-down add and the 3x3 output and mask convs;
  * ``Mask2FormerDecoder``: 100 learned queries through 9 masked-attention
    layers, round-robin over the three scales, with class-agnostic mask
    logits after every layer (10 outputs);
  * ``Mask2FormerHead``: one class head per dataset.
Module names are the flax ones (``pixel_decoder.encoder0_attn``,
``layer0_cross``, ``mask_embed_mlp.layers.0``), so the weight bridge maps
them one to one.  flax's GroupNorm eps is 1e-6 (torch's default is 1e-5);
the attention mask is the previous layer's logits shrunk with jax's
antialiased bilinear resize (a widened triangle filter, not
``F.interpolate``), thresholded as ``sigmoid(m) < 0.5``.

Loss half: per layer a matching cost (class, mask BCE, dice), one Hungarian
assignment of all layers' costs on the host (scipy, one device-to-host
copy), then the matched CE + BCE + dice.  ``num_points=None`` is the exact
full-mask loss; with ``num_points`` the mask terms are point-sampled
(mmdet's 12544): random points shared per image for the matching cost
(K8 through ``grid_sample``), uncertainty-biased points per query for the
loss (K9 through ``point_sample``).  The random draws come from a
``torch.Generator`` or from the ``draw`` seam (the tests feed JAX's).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment
from torch import nn

from samrs_tpu_torch.kernels import bilinear_gather
from samrs_tpu_torch.nn.layers import MLP, jax_resize_weights, resize_bilinear
from samrs_tpu_torch.seg.backbones.vit_adapter import MSDeformAttnModule, _ref_points

# draw(kind, layer, shape) -> uniform [0, 1) fp32 tensor; kind is "match" (the
# matching points), "candidates" (the oversampled points) or "random" (the top-up)
Draw = Callable[[str, int, Tuple[int, ...]], torch.Tensor]


@functools.lru_cache(maxsize=None)
def _sine_pe(h: int, w: int, dim: int, device: torch.device,
             temperature: float = 10000.0) -> torch.Tensor:
    scale = 2 * np.pi
    y = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h * scale
    x = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w * scale
    half = dim // 2
    dim_t = temperature ** (2 * (torch.arange(half, dtype=torch.float32, device=device) // 2)
                            / half)
    pos_x = x[None, :, None] / dim_t
    pos_y = y[:, None, None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], -1)
    pos_x = pos_x.reshape(1, w, half).expand(h, w, half)
    pos_y = pos_y.reshape(h, 1, half).expand(h, w, half)
    return torch.cat([pos_y, pos_x], -1)


def sine_positional_encoding(h: int, w: int, dim: int, device=None) -> torch.Tensor:
    """(h, w, dim) sine PE (mmdet SinePositionalEncoding, normalize=True),
    cached per shape and device."""
    return _sine_pe(h, w, dim, torch.device(device or "cpu"))


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_matrices(hw_in: Tuple[int, int], hw_out: Tuple[int, int], device: torch.device):
    return tuple(torch.from_numpy(jax_resize_weights(i, o, _triangle)).to(device)
                 for i, o in zip(hw_in, hw_out))


def resize_bilinear_antialias(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (..., h, w), "bilinear")`` (antialias on, its
    default) over the last two axes, in fp32."""
    wy, wx = _resize_matrices(tuple(x.shape[-2:]), tuple(out_hw), x.device)
    return torch.einsum("...hw,hy,wx->...yx", x.float(), wy, wx)


@functools.lru_cache(maxsize=None)
def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    # jax's _resize_nearest: floor((i + 0.5) * n_in / n_out) in fp32, no clip
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
    return torch.from_numpy(np.floor(f / np.float32(n_out)).astype(np.int64)).to(device)


def resize_nearest(labels: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(labels, (B, h, w), "nearest")`` of (B, H, W): the
    half-pixel rule (torch's ``nearest-exact``, not ``nearest``)."""
    H, W = labels.shape[-2:]
    iy = _nearest_index(H, out_hw[0], labels.device)
    ix = _nearest_index(W, out_hw[1], labels.device)
    return labels[..., iy, :][..., ix]


# ---------------------------------------------------------------- model ----


class PixelDecoder(nn.Module):
    """MSDeformAttn encoder over c4 / c3 / c2 + lateral fusion down to the
    stride-4 mask features (mmdet's MSDeformAttnPixelDecoder)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048), embed_dim: int = 256,
                 num_layers: int = 6, num_heads: int = 8, n_points: int = 4) -> None:
        super().__init__()
        D = embed_dim
        self.embed_dim, self.num_layers = D, num_layers
        for i, c in enumerate(reversed(in_channels[1:])):  # c4, c3, c2
            self.add_module(f"input_proj{i}", nn.Conv2d(c, D, 1, bias=False))
            self.add_module(f"input_proj{i}_gn", nn.GroupNorm(32, D, eps=1e-6))
        self.level_embed = nn.Parameter(torch.zeros(3, D))
        for i in range(num_layers):
            self.add_module(f"encoder{i}_attn", MSDeformAttnModule(D, 3, num_heads, n_points, 1.0))
            self.add_module(f"encoder{i}_norm1", nn.LayerNorm(D, eps=1e-5))
            self.add_module(f"encoder{i}_ffn1", nn.Linear(D, 4 * D))
            self.add_module(f"encoder{i}_ffn2", nn.Linear(4 * D, D))
            self.add_module(f"encoder{i}_norm2", nn.LayerNorm(D, eps=1e-5))
        self.lateral_c1 = nn.Conv2d(in_channels[0], D, 1, bias=False)
        self.lateral_c1_gn = nn.GroupNorm(32, D, eps=1e-6)
        self.output_conv = nn.Conv2d(D, D, 3, padding=1, bias=False)
        self.output_conv_gn = nn.GroupNorm(32, D, eps=1e-6)
        self.mask_conv = nn.Conv2d(D, D, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor], use_kernels: bool = True):
        """feats [c1 (s4), c2, c3, c4 (s32)] NCHW -> (mask features (B, D, H4,
        W4), [(tokens (B, h*w, D), (h, w))] for s32, s16, s8)."""
        c1, c2, c3, c4 = feats
        B, D = c1.shape[0], self.embed_dim
        toks, poses, shapes = [], [], []
        for i, c in enumerate([c4, c3, c2]):
            y = getattr(self, f"input_proj{i}_gn")(getattr(self, f"input_proj{i}")(c))
            h, w = y.shape[-2:]
            s = y.flatten(2).transpose(1, 2)
            pe = sine_positional_encoding(h, w, D, y.device).reshape(1, h * w, D)
            # the JAX decoder re-adds tokens - values: (s + pe + level) - s, rounded as it is
            poses.append((s + pe + self.level_embed[i]) - s)
            toks.append(s)
            shapes.append((h, w))
        x = torch.cat(toks, 1)
        pos = torch.cat(poses, 1)
        ref = _ref_points(shapes, x.device)[:, :, None, :].expand(B, x.shape[1], 3, 2)
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"encoder{i}_{name}")
            x = layer("norm1")(x + layer("attn")(x + pos, ref, x, shapes, use_kernels))
            x = layer("norm2")(x + layer("ffn2")(F.relu(layer("ffn1")(x))))
        outs, start = [], 0
        for h, w in shapes:
            outs.append((x[:, start:start + h * w], (h, w)))
            start += h * w
        lat = self.lateral_c1_gn(self.lateral_c1(c1))
        (t8, (h8, w8)) = outs[-1]
        up = resize_bilinear(t8.transpose(1, 2).reshape(B, D, h8, w8), lat.shape[-2:])
        fused = F.relu(self.output_conv_gn(self.output_conv(lat + up)))
        return self.mask_conv(fused), outs


class MaskedCrossAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q: torch.Tensor, kv: torch.Tensor, attn_mask: torch.Tensor):
        """q (B, Q, D); kv (B, S, D); attn_mask (B, Q, S) True = blocked."""
        B, Q, D = q.shape
        nH = self.num_heads
        hd = D // nH
        qq = self.q_proj(q).reshape(B, Q, nH, hd)
        kk = self.k_proj(kv).reshape(B, -1, nH, hd)
        vv = self.v_proj(kv).reshape(B, -1, nH, hd)
        logits = torch.einsum("bqnd,bsnd->bnqs", qq * hd ** -0.5, kk)
        p = logits.masked_fill(attn_mask[:, None], -1e9).softmax(-1)
        return self.out_proj(torch.einsum("bnqs,bsnd->bqnd", p, vv).reshape(B, Q, D))


class SelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, Q, D = x.shape
        nH = self.num_heads
        hd = D // nH
        q, k, v = self.qkv(x).reshape(B, Q, 3, nH, hd).permute(2, 0, 3, 1, 4)
        p = torch.einsum("bnqd,bnkd->bnqk", q * hd ** -0.5, k).softmax(-1)
        out = torch.einsum("bnqk,bnkd->bnqd", p, v).transpose(1, 2).reshape(B, Q, D)
        return self.proj(out)


class Mask2FormerDecoder(nn.Module):
    """Pixel decoder + masked-attention transformer decoder.  ``forward``
    returns per layer (query features (B, Nq, D), mask logits (B, Nq, H4,
    W4)): the initial queries' and each of the ``num_decoder_layers``'."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048), embed_dim: int = 256,
                 num_queries: int = 100, num_decoder_layers: int = 9, num_heads: int = 8) -> None:
        super().__init__()
        D = embed_dim
        self.embed_dim, self.num_queries = D, num_queries
        self.num_decoder_layers = num_decoder_layers
        self.pixel_decoder = PixelDecoder(tuple(in_channels), D)
        self.query_feat = nn.Parameter(torch.zeros(num_queries, D))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, D))
        self.mask_embed_mlp = MLP(D, D, D, 3)
        for i in range(num_decoder_layers):
            self.add_module(f"layer{i}_cross", MaskedCrossAttention(D, num_heads))
            self.add_module(f"layer{i}_norm1", nn.LayerNorm(D, eps=1e-5))
            self.add_module(f"layer{i}_self", SelfAttention(D, num_heads))
            self.add_module(f"layer{i}_norm2", nn.LayerNorm(D, eps=1e-5))
            self.add_module(f"layer{i}_ffn1", nn.Linear(D, 8 * D))
            self.add_module(f"layer{i}_ffn2", nn.Linear(8 * D, D))
            self.add_module(f"layer{i}_norm3", nn.LayerNorm(D, eps=1e-5))

    def forward(self, features: Sequence[torch.Tensor], use_kernels: bool = True):
        """features [img, c1, c2, c3, c4] (the backbone's) -> 1 +
        num_decoder_layers (query features, mask logits) pairs."""
        mask_feat, scales = self.pixel_decoder(features[1:], use_kernels)
        B, D, Nq = mask_feat.shape[0], self.embed_dim, self.num_queries
        q = self.query_feat[None].expand(B, Nq, D)
        qpos = self.query_embed[None].expand(B, Nq, D)

        def predict(qx):
            mask_embed = self.mask_embed_mlp(qx.float())
            return qx, torch.einsum("bqd,bdhw->bqhw", mask_embed, mask_feat.float())

        outputs = [predict(q)]
        for i in range(self.num_decoder_layers):
            layer = lambda name: getattr(self, f"layer{i}_{name}")
            tokens, (h, w) = scales[i % len(scales)]
            kv = tokens + sine_positional_encoding(h, w, D, tokens.device).reshape(1, h * w, D)
            with torch.no_grad():  # the previous layer's mask prediction, no gradient
                m = resize_bilinear_antialias(outputs[-1][1], (h, w))
                attn_mask = (torch.sigmoid(m) < 0.5).reshape(B, Nq, h * w)
                # a fully-masked row would give NaN: unmask those rows (as mmdet)
                attn_mask &= ~attn_mask.all(-1, keepdim=True)
            q = layer("norm1")(q + layer("cross")(q + qpos, kv, attn_mask))
            q = layer("norm2")(q + layer("self")(q + qpos))
            q = layer("norm3")(q + layer("ffn2")(F.relu(layer("ffn1")(q))))
            outputs.append(predict(q))
        return outputs


class Mask2FormerHead(nn.Module):
    """Per-dataset class head over the decoder's query features
    (mmseg_mask2former.py:140-150)."""

    def __init__(self, embed_dim: int, num_classes: int) -> None:
        super().__init__()
        self.cls = nn.Linear(embed_dim, num_classes + 1)

    def forward(self, outputs):
        """[(query features, mask logits)] -> [(class logits, mask logits)]."""
        return [(self.cls(q.float()), m) for q, m in outputs]


# ----------------------------------------------------------------- loss ----


def hungarian_match(cost: torch.Tensor) -> torch.Tensor:
    """(N, Q, G) costs -> (N, Q) int64 matched slot, or -1, on the costs'
    device: one device-to-host copy, then scipy's ``linear_sum_assignment``
    per matrix (the JAX package's host oracle ``_hungarian_host``; its
    device solver reaches the same optimum, ties aside)."""
    c = cost.detach().float().cpu().numpy()
    out = np.full(c.shape[:2], -1, np.int64)
    for i, m in enumerate(c):
        rows, cols = linear_sum_assignment(m)
        out[i, rows] = cols
    return torch.from_numpy(out).to(cost.device)


def semantic_to_instances(labels: torch.Tensor, num_classes: int):
    """Semantic labels (B, H, W) -> per-class binary masks (B, C, H, W) fp32
    and their validity (B, C) (mmseg_mask2former.py:83-138)."""
    onehot = labels[:, None] == torch.arange(num_classes, device=labels.device)[None, :, None, None]
    return onehot.float(), onehot.any(-1).any(-1)


def dice_loss(pred_sigmoid: torch.Tensor, target: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    num = 2 * (pred_sigmoid * target).sum((-1, -2))
    den = pred_sigmoid.sum((-1, -2)) + target.sum((-1, -2))
    return 1 - (num + eps) / (den + eps)


def point_sample(masks: torch.Tensor, coords: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Bilinear sample (N, H, W) masks at their own (N, K, 2) xy points in
    [0, 1] (mmcv.ops.point_sample, align_corners=False) -> (N, K) fp32:
    K9's coordinate entry (one launch on the card: the kernel turns the
    points into pixels through the JAX package's [-1, 1] grid), or its
    plain version with ``plain``."""
    if plain:
        return bilinear_gather.point_sample_coords_plain(masks, coords)
    return bilinear_gather.point_sample_coords(masks, coords)


def point_sample_shared(masks: torch.Tensor, coords: torch.Tensor,
                        plain: bool = False) -> torch.Tensor:
    """Bilinear sample (B, M, H, W) masks at (B, K, 2) points shared by the M
    masks of an image -> (B, M, K): the masks ride K8's channels (Gc = M)."""
    grid = (2.0 * coords.float() - 1.0)[:, None]  # (B, 1, K, 2)
    img = masks.permute(0, 2, 3, 1).contiguous()  # (B, H, W, M)
    return bilinear_gather.grid_sample(img, grid, plain=plain)[:, 0].transpose(1, 2)


def uncertain_point_coords(logits: torch.Tensor, num_points: int, draw: Draw, layer: int,
                           oversample_ratio: float = 3.0, importance_sample_ratio: float = 0.75,
                           plain: bool = False) -> torch.Tensor:
    """Uncertainty-biased points (N, num_points, 2) for (N, H, W) logits
    (mmdet get_uncertain_point_coords_with_randomness): oversample uniformly,
    keep the most uncertain (largest -|logit|), top up with fresh uniforms.
    The candidates' sample keeps no autograd graph."""
    n = logits.shape[0]
    n_sampled = int(num_points * oversample_ratio)
    n_unc = int(importance_sample_ratio * num_points)
    n_rand = num_points - n_unc
    cand = draw("candidates", layer, (n, n_sampled, 2))
    with torch.no_grad():
        pl = point_sample(logits.detach(), cand, plain)
        idx = torch.topk(-pl.abs(), n_unc, dim=1).indices
        del pl
    sel = cand.gather(1, idx[..., None].expand(n, n_unc, 2))
    if n_rand > 0:
        sel = torch.cat([sel, draw("random", layer, (n, n_rand, 2))], 1)
    return sel


def generator_draws(generator: torch.Generator) -> Draw:
    """Uniform draws from `generator`, on its device, in call order."""
    return lambda kind, layer, shape: torch.rand(shape, generator=generator,
                                                 device=generator.device)


def mask2former_targets(labels: torch.Tensor, num_classes: int, hw: Tuple[int, int]):
    """Labels (B, H, W) -> per-class masks on the (H4, W4) mask grid and
    their validity (the loss's targets)."""
    return semantic_to_instances(resize_nearest(labels, hw), num_classes)


@torch.no_grad()
def mask2former_assign(outputs: List[Tuple[torch.Tensor, torch.Tensor]], gt_masks: torch.Tensor,
                       gt_valid: torch.Tensor, class_weight: float = 2.0,
                       mask_weight: float = 5.0, dice_weight: float = 5.0,
                       num_points: Optional[int] = None, draw: Optional[Draw] = None,
                       plain: bool = False) -> torch.Tensor:
    """Pass 1 of the loss: every output's matching cost (class, mask BCE and
    dice; point-sampled at K random points shared per image when
    ``num_points``, mmdet_mask2former.py:913-1011), then one assignment of
    all L * B costs -> (L * B, Q) matched slot or -1.  No autograd: JAX
    stops the cost's gradient."""
    B, Nq = outputs[0][1].shape[:2]
    C = gt_masks.shape[1]
    costs = []
    for li, (cls_logits, mask_logits) in enumerate(outputs):
        cost_cls = -F.log_softmax(cls_logits.float(), -1)[..., :C]  # (B, Q, C)
        if num_points is not None:
            pts = draw("match", li, (B, num_points, 2))
            pred = point_sample_shared(mask_logits, pts, plain)  # (B, Q, K)
            gt = point_sample_shared(gt_masks, pts, plain)  # (B, C, K)
        else:
            pred = mask_logits.reshape(B, Nq, -1)
            gt = gt_masks.reshape(B, C, -1)
        gt_t = gt.transpose(1, 2)
        cost_bce = (F.softplus(-pred) @ gt_t + F.softplus(pred) @ (1 - gt_t)) / pred.shape[-1]
        ps = torch.sigmoid(pred)
        sums = ps.sum(-1)[:, :, None] + gt.sum(-1)[:, None, :]
        cost_dice = 1 - (2 * (ps @ gt_t) + 1) / (sums + 1)
        cost = class_weight * cost_cls + mask_weight * cost_bce + dice_weight * cost_dice
        costs.append(torch.where(gt_valid[:, None, :], cost, 1e6))
        del pred, gt, gt_t, ps
    return hungarian_match(torch.cat(costs, 0))


def mask2former_loss(outputs: List[Tuple[torch.Tensor, torch.Tensor]], labels: torch.Tensor,
                     num_classes: int, class_weight: float = 2.0, mask_weight: float = 5.0,
                     dice_weight: float = 5.0, no_object_weight: float = 0.1,
                     num_points: Optional[int] = None, oversample_ratio: float = 3.0,
                     importance_sample_ratio: float = 0.75,
                     generator: Optional[torch.Generator] = None, draw: Optional[Draw] = None,
                     plain: bool = False) -> Dict[str, torch.Tensor]:
    """Sum over the layers of the matched losses (mmdet loss_by_feat).

    ``num_points=None``: exact full-mask BCE and dice.  With ``num_points``
    the mask terms are point-sampled, drawing from ``draw`` (or uniforms from
    ``generator``).  ``plain`` routes K8 and K9 to their plain versions."""
    B, Nq, H4, W4 = outputs[0][1].shape
    gt_masks, gt_valid = mask2former_targets(labels, num_classes, (H4, W4))
    use_points = num_points is not None
    if use_points and draw is None:
        if generator is None:
            raise ValueError("point-sampled mask2former_loss needs a generator or draws")
        draw = generator_draws(generator)
    all_assign = mask2former_assign(outputs, gt_masks, gt_valid, class_weight, mask_weight,
                                    dice_weight, num_points, draw, plain)  # (L * B, Q)

    total = {"loss_cls": 0.0, "loss_mask": 0.0, "loss_dice": 0.0}
    batch = torch.arange(B, device=labels.device)[:, None]
    for li, (cls_logits, mask_logits) in enumerate(outputs):
        logp = F.log_softmax(cls_logits.float(), -1)  # (B, Q, C + 1)
        assign = all_assign[li * B:(li + 1) * B]
        slot = assign.clamp(min=0)
        matched = (assign >= 0) & gt_valid.gather(1, slot)
        tgt_cls = torch.where(matched, slot, num_classes)  # background = C
        w = torch.where(tgt_cls == num_classes, no_object_weight, 1.0)
        ce = -logp.gather(-1, tgt_cls[..., None])[..., 0]
        total["loss_cls"] = total["loss_cls"] + class_weight * (w * ce).sum() / w.sum()

        tgt_mask = gt_masks[batch, slot]  # (B, Q, H4, W4)
        mw = matched.float()
        denom = mw.sum().clamp(min=1.0)
        if use_points:  # uncertainty-biased points per query (:1016-1100)
            flat = mask_logits.reshape(B * Nq, H4, W4)
            coords = uncertain_point_coords(flat, num_points, draw, li, oversample_ratio,
                                            importance_sample_ratio, plain)
            pred = point_sample(flat, coords, plain).reshape(B, Nq, num_points)
            tgt = point_sample(tgt_mask.reshape(B * Nq, H4, W4), coords,
                               plain).reshape(B, Nq, num_points)
            del coords
        else:
            pred = mask_logits.reshape(B, Nq, -1)
            tgt = tgt_mask.reshape(B, Nq, -1)
        # = softplus(-x) t + softplus(x) (1 - t), the JAX form; autograd keeps x and t only
        bce = F.binary_cross_entropy_with_logits(pred, tgt, reduction="none").mean(-1)
        total["loss_mask"] = total["loss_mask"] + mask_weight * ((bce * mw).sum() / denom)
        ps = torch.sigmoid(pred)
        dl = 1 - (2 * (ps * tgt).sum(-1) + 1) / (ps.sum(-1) + tgt.sum(-1) + 1)
        total["loss_dice"] = total["loss_dice"] + dice_weight * ((dl * mw).sum() / denom)
    return total


def mask2former_predict(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                        num_classes: int) -> torch.Tensor:
    """Final-layer predictions -> semantic scores (B, H, W, C):
    softmax(cls)[:C] . sigmoid(mask) (mmseg_mask2former.py:170-192)."""
    cls_p = cls_logits.float().softmax(-1)[..., :num_classes]
    return torch.einsum("bqc,bqhw->bhwc", cls_p, torch.sigmoid(mask_logits.float()))
