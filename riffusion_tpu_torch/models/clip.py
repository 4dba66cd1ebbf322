"""
CLIP text encoder (ViT-L/14 text tower), as an nn.Module.

The counterpart of riffusion_tpu/models/clip.py: pre-LN transformer with a
causal mask of -1e9 added to the logits in fp32, quick-gelu, a final
LayerNorm; returns the last hidden state.

`CLIPTextProjectionConfig` widens it to the towers Stable Diffusion XL
conditions on, which the JAX package does not have: an activation of the
config's (exact gelu for OpenCLIP ViT-bigG/14) and, with `projection_dim`,
transformers' CLIPTextModelWithProjection's bias-free `text_projection`.
`penultimate_and_pooled` gives what SDXL reads: the hidden state before the
last layer, and the projected, final-LayerNormed state at the first
end-of-text token.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import torch
import torch.nn.functional as F
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

    @property
    def activation(self) -> str:
        return "quick_gelu"

    @property
    def projection(self) -> T.Optional[int]:
        """The width of text_projection, None for a model without one."""
        return None


@dataclasses.dataclass(frozen=True)
class CLIPTextProjectionConfig(CLIPTextConfig):
    """A tower with its own activation ("gelu" or "quick_gelu") and, where
    `projection_dim` is set, a text projection: SDXL's text_encoder_2
    (OpenCLIP ViT-bigG/14's text tower) by default."""

    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 20
    intermediate_size: int = 5120
    hidden_act: str = "gelu"
    projection_dim: T.Optional[int] = 1280

    @property
    def activation(self) -> str:
        return self.hidden_act

    @property
    def projection(self) -> T.Optional[int]:
        return self.projection_dim


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


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
        self.act = _ACTIVATIONS[cfg.activation]

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


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
        if cfg.projection is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection, bias=False)

    def _run(self, input_ids: torch.Tensor, layers: range,
             x: T.Optional[torch.Tensor] = None) -> torch.Tensor:
        """The hidden state after `layers`, from the embeddings of
        `input_ids` or from `x`."""
        b, l = input_ids.shape
        if x is None:
            positions = torch.arange(l, device=input_ids.device)[None, :]
            x = self.token_embedding(input_ids) + self.position_embedding(positions)
        causal_mask = torch.triu(
            torch.full((l, l), -1e9, dtype=torch.float32, device=input_ids.device), diagonal=1
        )
        for i in layers:
            x = getattr(self, f"layers_{i}")(x, causal_mask)
        return x

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.final_layer_norm(self._run(input_ids, range(self.cfg.num_layers)))

    def penultimate_and_pooled(self, input_ids: torch.Tensor, eos_token_id: int
                               ) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
        """(the hidden state before the last layer (B, L, hidden), the pooled
        output (B, projection) or None for a model without a projection).
        The pooled output is the final-LayerNormed last state at each row's
        first `eos_token_id`, through text_projection: the position of the
        end-of-text token's id, not the argmax of the ids (the legacy rule
        of BPE vocabularies whose end-of-text id is the largest)."""
        n = self.cfg.num_layers
        x = self._run(input_ids, range(n - 1))
        if self.cfg.projection is None:
            return x, None
        last = self.final_layer_norm(self._run(input_ids, range(n - 1, n), x))
        eos = (input_ids == eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos]
        return x, self.text_projection(pooled)
