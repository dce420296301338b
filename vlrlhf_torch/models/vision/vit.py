"""ViT encoder (counterpart of vlrlhf_tpu/models/vision/vit.py `vit_forward`).

Serves CLIP ViT-L/14-336 for LLaVA-1.5 and LLaVA-Next: class token,
pre-LN, quick_gelu, penultimate feature layer (`feature_layer=-2` runs
num_layers - 1 blocks and skips the post norm); InternLM-XC2's CLIP-L/14
at 490 px: every layer, no post norm (`feature_layer=-1`), its 24 x 24
table resized to the 35 x 35 patch grid; Qwen-VL's ViT-bigG/14-448: no
class token, pre-LN, no post-LN, ln_eps 1e-6; and InstructBLIP's EVA
ViT-g/14-224: a patch bias, no pre-LN, every layer then the post norm,
the class token kept. The MLP's activation is the config's HF name
(models/common.py `activation`): an HF import reads EVA's and Qwen's erf
"gelu", a config bridged from vlrlhf_tpu the tanh form jax.nn.gelu
computes.

A position table of another grid than the patches is resized in the
forward by ops/image.py `interpolate_pos_embed` (the grid part only when
there is a class token), as vlrlhf_tpu does; `set_pos_embed_` holds a
checkpoint's table of any square grid. Attention goes through
ops/attention.py, so on the card every block's non-causal attention runs
the flash kernel (S=577, D=64 for CLIP; S=1226, D=64 for XC2's; S=1024,
D=104 for Qwen's; S=257, D=88 for EVA).

The patch embedding is written as patch extraction + one matmul over the
(p*p*3) patch vector in (row, col, channel) order — exactly the NHWC/HWIO
convolution vlrlhf_tpu runs, without cuDNN (whose f32 convolutions default
to TF32 on the card).

Under autograd (DPO with an unfrozen tower) each block is rematerialized
as one checkpoint region (vit.py:192, `cfg.remat`), and the block's
Linears apply their LoRA adapters when the call's Ctx has adapters on, so
`vision/...` LoRA targets train. vlrlhf_tpu's `vit_forward` calls its
linears without the Ctx and so never applies tower adapters (they stay at
zero gradient there); ROADMAP.md §3 records the difference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vlrlhf_torch.models.common import Ctx, Linear, Norm, activation, empty_param
from vlrlhf_torch.models.config import ViTConfig
from vlrlhf_torch.ops.attention import multi_head_attention
from vlrlhf_torch.ops.image import interpolate_pos_embed
from vlrlhf_torch.ops.norms import layer_norm


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.dtype
        self.ln1 = Norm(h, True, device, dt)
        self.ln2 = Norm(h, True, device, dt)
        self.wq = Linear(h, h, True, device, dt)
        self.wk = Linear(h, h, True, device, dt)
        self.wv = Linear(h, h, True, device, dt)
        self.wo = Linear(h, h, True, device, dt)
        self.fc1 = Linear(h, cfg.mlp_dim, True, device, dt)
        self.fc2 = Linear(cfg.mlp_dim, h, True, device, dt)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, lctx: Optional[Ctx] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        lctx = lctx or Ctx()
        actx, mctx = lctx.sub("attn"), lctx.sub("mlp")
        h = layer_norm(x, self.ln1.weight, self.ln1.bias, cfg.ln_eps)
        q = self.wq(h, actx.sub("wq")).reshape(b, s, nh, hd)
        k = self.wk(h, actx.sub("wk")).reshape(b, s, nh, hd)
        v = self.wv(h, actx.sub("wv")).reshape(b, s, nh, hd)
        attn = multi_head_attention(q, k, v, causal=False).reshape(b, s, cfg.hidden_size)
        x = x + self.wo(attn, actx.sub("wo"))
        h = layer_norm(x, self.ln2.weight, self.ln2.bias, cfg.ln_eps)
        return x + self.fc2(activation(cfg.act)(self.fc1(h, mctx.sub("fc1"))), mctx.sub("fc2"))


class VisionTower(nn.Module):
    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        h, p, dt = cfg.hidden_size, cfg.patch_size, cfg.dtype
        self.cfg = cfg
        # (h, p*p*3): the HWIO conv kernel flattened in (row, col, channel)
        self.patch_weight = empty_param((h, p * p * 3), device, dt)
        self.patch_bias = empty_param((h,), device, dt) if cfg.patch_bias else None
        self.pos_embed = empty_param((cfg.seq_len, h), device, dt)
        self.cls_token = empty_param((h,), device, dt) if cfg.use_class_token else None
        self.ln_pre = Norm(h, True, device, dt) if cfg.use_pre_norm else None
        self.ln_post = Norm(h, True, device, dt) if cfg.use_post_norm else None
        self.layers = nn.ModuleList(ViTBlock(cfg, device) for _ in range(cfg.num_layers))

    def set_pos_embed_(self, table: torch.Tensor) -> None:
        """Hold `table` (n, hidden), on its device, as the position table: a
        square grid (plus the class row when the tower has a class token) of
        any size, resized to the patch grid in each forward."""
        n = table.shape[0] - (1 if self.cfg.use_class_token else 0)
        g = round(n**0.5)
        if table.dim() != 2 or table.shape[1] != self.cfg.hidden_size or g * g != n:
            raise ValueError(f"position table {tuple(table.shape)} is not a square grid of "
                             f"{self.cfg.hidden_size}-wide rows")
        self.pos_embed = nn.Parameter(table.to(self.cfg.dtype), requires_grad=False)

    def forward(self, pixel_values: torch.Tensor, ctx: Optional[Ctx] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized float -> (B, n_tokens, hidden) features;
        `ctx` is the tower's context (adapters on or off)."""
        cfg = self.cfg
        dt = cfg.dtype
        p = cfg.patch_size
        b, hh, ww, _ = pixel_values.shape
        gh, gw = hh // p, ww // p
        x = pixel_values.to(dt)[:, : gh * p, : gw * p]
        patches = (
            x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, gh * gw, p * p * 3)
        )
        x = F.linear(patches, self.patch_weight.to(dt))
        if self.patch_bias is not None:
            x = x + self.patch_bias.to(dt)
        pos = self.pos_embed.to(dt)
        n_patches = x.shape[1]
        if cfg.use_class_token:
            cls = self.cls_token.to(dt)[None, None].expand(b, 1, cfg.hidden_size)
            grid_pos = interpolate_pos_embed(pos[1:], n_patches)
            x = torch.cat([cls + pos[None, :1], x + grid_pos[None]], dim=1)
        else:
            x = x + interpolate_pos_embed(pos, n_patches)[None]
        if self.ln_pre is not None:
            x = layer_norm(x, self.ln_pre.weight, self.ln_pre.bias, cfg.ln_eps)
        layers_ctx = (ctx or Ctx()).sub("layers_scanned")
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.layers[: cfg.layers_run]):
            lctx = layers_ctx.fold(i)  # a distinct dropout stream per layer
            # no global RNG draws inside a block: its state is not stashed
            x = (checkpoint(block, x, lctx, use_reentrant=False, preserve_rng_state=False)
                 if remat else block(x, lctx))
        if cfg.layers_run == cfg.num_layers and self.ln_post is not None:
            x = layer_norm(x, self.ln_post.weight, self.ln_post.bias, cfg.ln_eps)
        if cfg.drop_class_token and cfg.use_class_token:
            x = x[:, 1:]
        return x
