"""
CLIP text encoder (ViT-L/14 text tower), as an nn.Module.

The counterpart of riffusion_tpu/models/clip.py: pre-LN transformer with a
causal mask of -1e9 added to the logits in fp32, quick-gelu, a final
LayerNorm; returns the last hidden state.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from riffusion_tpu_torch.models.layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    intermediate_size: int = 3072

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, l, _ = x.shape
        head_dim = cfg.hidden_size // cfg.num_heads
        q = self.q_proj(x).reshape(b, l, cfg.num_heads, head_dim)
        k = self.k_proj(x).reshape(b, l, cfg.num_heads, head_dim)
        v = self.v_proj(x).reshape(b, l, cfg.num_heads, head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head_dim)
        mask_dtype = torch.promote_types(torch.float32, x.dtype)
        logits = logits.to(mask_dtype) + causal_mask.to(mask_dtype)
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, l, cfg.hidden_size)
        return self.out_proj(out)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=1e-5)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    """forward(input_ids (B, L) int) -> last hidden state (B, L, hidden)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(cfg))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        b, l = input_ids.shape
        positions = torch.arange(l, device=input_ids.device)[None, :]
        x = self.token_embedding(input_ids) + self.position_embedding(positions)
        causal_mask = torch.triu(
            torch.full((l, l), -1e9, dtype=torch.float32, device=input_ids.device), diagonal=1
        )
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layers_{i}")(x, causal_mask)
        return self.final_layer_norm(x)
