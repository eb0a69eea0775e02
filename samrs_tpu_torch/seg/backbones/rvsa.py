"""ViT + Rotated Varied-Size Window Attention (mirrors
samrs_tpu/seg/backbones/rvsa.py; reference ED/backbone/vit_win_rvsa_v3_wsz7.py).

Per RVSA block, learnable nets over the avg-pooled windows give each window
an offset, a scale and an angle; the window's sampling grid is scaled,
rotated about the window centre and shifted, and K and V are resampled there
with bilinear sampling (align_corners=True, zero padding).  The resampling
is K8 (``kernels.bilinear_gather``): K and V of all windows and heads go
through one launch, as one (B*heads, H, W, 2*head_dim) map, so a block
launches K8's forward and backward once each.  The reference's quirks are
kept: symmetric padding, offsets normalised by H//ws for x and W//ws for y,
qkv on the unpadded map then zero-padded without its bias, the decomposed
rel-pos plus the Swin bias table.  fp32 throughout; full attention every
``interval`` blocks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.kernels import bilinear_gather
from samrs_tpu_torch.nn.layers import checkpoint_with_generator
from samrs_tpu_torch.sam.image_encoder import PatchEmbed, get_rel_pos
from samrs_tpu_torch.seg.backbones.vit_common import FullAttentionRelPos, ViTBlock, ViTFPNNeck


def _swin_rel_index(ws: int) -> np.ndarray:
    """Swin-style pairwise relative-position index over a ws x ws window."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _sampling_net(dim: int, out: int, ws: int) -> nn.Sequential:
    """AvgPool(ws) -> LeakyReLU -> 1x1 conv; only index 2 holds parameters."""
    return nn.Sequential(nn.AvgPool2d(ws, ws), nn.LeakyReLU(), nn.Conv2d(dim, out, 1))


class RotatedVariedSizeWindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 qkv_bias: bool = True) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.window_size = ws = window_size
        hd = dim // num_heads
        self.scale = hd ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.sampling_offsets = _sampling_net(dim, num_heads * 2, ws)
        self.sampling_scales = _sampling_net(dim, num_heads * 2, ws)
        self.sampling_angles = _sampling_net(dim, num_heads, ws)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * ws - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * ws - 1, hd))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) * (2 * ws - 1), num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_swin_rel_index(ws).reshape(-1)), persistent=False)

    def sampling_grid(self, x_pad: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """(B*heads, eh, ew, 2) normalized sampling coordinates (x, y) of
        every window tap, from the padded NHWC map (rvsa.py:74-121)."""
        B, eh, ew, _ = x_pad.shape
        ws, nH = self.window_size, self.num_heads
        nwh, nww = eh // ws, ew // ws
        act = F.leaky_relu(F.avg_pool2d(x_pad.permute(0, 3, 1, 2), ws, ws))

        def heads_first(net, k):  # (B, nH*k, nwh, nww) -> (B*nH, nwh, nww, k)
            t = net[2](act).reshape(B, nH, k, nwh, nww).permute(0, 1, 3, 4, 2)
            return t.reshape(B * nH, nwh, nww, k).float()

        offsets = heads_first(self.sampling_offsets, 2)
        # reference normalization quirk: x by h//ws, y by w//ws
        offsets = offsets / torch.tensor([max(H // ws, 1), max(W // ws, 1)],
                                         dtype=torch.float32, device=x_pad.device)
        scales = heads_first(self.sampling_scales, 2)
        angles = heads_first(self.sampling_angles, 1)[..., 0]

        dev = x_pad.device
        ref_y = torch.linspace(-1.0, 1.0, eh, device=dev)
        ref_x = torch.linspace(-1.0, 1.0, ew, device=dev)
        win_cy = ref_y.reshape(nwh, ws).mean(1)
        win_cx = ref_x.reshape(nww, ws).mean(1)
        base_h = torch.arange(ws, dtype=torch.float32, device=dev) * 2.0 * ws / ws / max(eh - 1, 1)
        base_h = base_h - base_h.mean()
        base_w = torch.arange(ws, dtype=torch.float32, device=dev) * 2.0 * ws / ws / max(ew - 1, 1)
        base_w = base_w - base_w.mean()
        by = base_h[None, :, None, None].expand(nwh, ws, nww, ws)
        bx = base_w[None, None, None, :].expand(nwh, ws, nww, ws)

        sx = 1.0 + scales[..., 0][:, :, None, :, None]  # (B*nH, nwh, 1, nww, 1)
        sy = 1.0 + scales[..., 1][:, :, None, :, None]
        cx = bx[None] * sx
        cy = by[None] * sy
        ca = angles[:, :, None, :, None]
        rx = -cy * torch.sin(ca) + cx * torch.cos(ca)
        ry = cy * torch.cos(ca) + cx * torch.sin(ca)
        fx = win_cx[None, None, None, :, None] + rx + offsets[..., 0][:, :, None, :, None]
        fy = win_cy[None, :, None, None, None] + ry + offsets[..., 1][:, :, None, :, None]
        return torch.stack([fx, fy], -1).reshape(B * nH, eh, ew, 2)

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, nH = self.window_size, self.num_heads
        hd = C // nH
        pad_td, pad_lr = (-H) % ws, (-W) % ws
        pt, pl = pad_td // 2, pad_lr // 2
        pad = (pl, pad_lr - pl, pt, pad_td - pt)  # symmetric, as the reference pads
        eh, ew = H + pad_td, W + pad_lr
        nwh, nww = eh // ws, ew // ws
        grid = self.sampling_grid(F.pad(x, (0, 0) + pad), H, W)

        # qkv over the UNPADDED map, then zero-padded (no bias on the pad)
        qkv = self.qkv(x).reshape(B, H, W, 3, nH, hd)
        q = F.pad(qkv[..., 0, :, :].permute(0, 3, 1, 2, 4).reshape(B * nH, H, W, hd),
                  (0, 0) + pad)
        kv = qkv[..., 1:, :, :].permute(0, 4, 1, 2, 3, 5).reshape(B * nH, H, W, 2 * hd)
        kv = F.pad(kv, (0, 0) + pad).contiguous()
        kv_sel = bilinear_gather.grid_sample(kv, grid, align_corners=True, plain=not use_kernels)

        def to_windows(t):  # (B*nH, eh, ew, hd) -> (B*nwh*nww, nH, ws*ws, hd)
            t = t.reshape(B, nH, nwh, ws, nww, ws, hd).permute(0, 2, 4, 1, 3, 5, 6)
            return t.reshape(B * nwh * nww, nH, ws * ws, hd)

        qw = to_windows(q.float())
        kw = to_windows(kv_sel[..., :hd])
        vw = to_windows(kv_sel[..., hd:])
        attn = (qw * self.scale) @ kw.transpose(-1, -2)

        Rh = get_rel_pos(ws, ws, self.rel_pos_h)
        Rw = get_rel_pos(ws, ws, self.rel_pos_w)
        r_q = qw.reshape(-1, nH, ws, ws, hd)
        rel_h = torch.einsum("wnhxc,hkc->wnhxk", r_q, Rh)
        rel_w = torch.einsum("wnhxc,xkc->wnhxk", r_q, Rw)
        attn = attn.reshape(-1, nH, ws, ws, ws, ws) + rel_h[..., :, None] + rel_w[..., None, :]
        attn = attn.reshape(-1, nH, ws * ws, ws * ws)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(ws * ws, ws * ws, nH).permute(2, 0, 1)[None]

        out = attn.softmax(-1) @ vw
        out = out.reshape(B, nwh, nww, nH, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6)
        out = out.reshape(B, eh, ew, C)[:, pt:pt + H, pl:pl + W, :]
        return self.proj(out)


class ViTRVSA(ViTFPNNeck):
    """RVSA trunk: patch embed, blocks (full attention every `interval`),
    and the FPN neck.  ``forward`` takes NHWC images and returns
    [img, c1, c2, c3, c4] with NCHW maps; out_channels (3, D, D, D, D)
    (rvsa.py:206-293)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 window_size: int = 7, interval: int = 3,
                 out_indices: Tuple[int, ...] = (3, 5, 7, 11), drop_path_rate: float = 0.1,
                 use_abs_pos_emb: bool = True, use_checkpoint: bool = False) -> None:
        super().__init__(embed_dim)
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.depth = depth
        self.out_indices = tuple(out_indices)
        self.use_checkpoint = use_checkpoint
        gp = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.pos_embed = (nn.Parameter(torch.zeros(1, gp * gp, embed_dim))
                          if use_abs_pos_emb else None)
        dpr = np.linspace(0, drop_path_rate, depth)
        blocks = []
        for i in range(depth):
            if (i + 1) % interval == 0:  # no rel-pos in the reference's full-attention class
                attn = FullAttentionRelPos(embed_dim, num_heads, input_size=(gp, gp),
                                           use_rel_pos=False)
            else:
                attn = RotatedVariedSizeWindowAttention(embed_dim, num_heads, window_size)
            blocks.append(ViTBlock(embed_dim, attn, mlp_ratio, float(dpr[i])))
        self.blocks = nn.ModuleList(blocks)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        d = self.embed_dim
        return (3, d, d, d, d)

    def _block(self, blk: ViTBlock, x: torch.Tensor, generator, use_kernels: bool):
        if not (self.use_checkpoint and self.training):
            return blk(x, generator, use_kernels)
        # per-block activation checkpointing (the reference's torch.utils.checkpoint)
        return checkpoint_with_generator(lambda t, g: blk(t, g, use_kernels), x, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> List[torch.Tensor]:
        img = x
        x = self.patch_embed(x)
        B, Hp, Wp, D = x.shape
        if self.pos_embed is not None:
            gp = self.img_size // self.patch_size
            if (gp, gp) != (Hp, Wp):
                raise ValueError(f"pos_embed is for a {gp}x{gp} grid, the input gives {Hp}x{Wp}")
            x = x + self.pos_embed.reshape(1, gp, gp, D)
        feats = {}
        for i, blk in enumerate(self.blocks):
            x = self._block(blk, x, generator, use_kernels)
            if i in self.out_indices:
                feats[i] = x
        return [img, *self.neck([feats[i] for i in self.out_indices])]


def vit_b_rvsa(image_size: int = 224, **kw) -> ViTRVSA:
    """vit_b_rvsa (vit_win_rvsa_v3_wsz7.py:819-845)."""
    cfg = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
               window_size=7, interval=3, out_indices=(3, 5, 7, 11), drop_path_rate=0.1,
               use_abs_pos_emb=False)
    cfg.update(kw)
    return ViTRVSA(img_size=image_size, **cfg)


def vit_l_rvsa(image_size: int = 224, **kw) -> ViTRVSA:
    return ViTRVSA(img_size=image_size, patch_size=16, embed_dim=1024, depth=24, num_heads=16,
                   mlp_ratio=4.0, window_size=7, interval=3, out_indices=(7, 11, 15, 23),
                   drop_path_rate=0.1, use_abs_pos_emb=False, **kw)


def vit_h_rvsa(image_size: int = 224, **kw) -> ViTRVSA:
    """vit_h_rvsa (vit_win_rvsa_v3_wsz7.py:862-881)."""
    return ViTRVSA(img_size=image_size, patch_size=16, embed_dim=1280, depth=32, num_heads=16,
                   mlp_ratio=4.0, window_size=7, interval=3, out_indices=(10, 15, 20, 31),
                   drop_path_rate=0.1, use_abs_pos_emb=False, **kw)
