"""
The benchmark's count of the work of Stable Diffusion XL's cells, by
count.py's rules (products only, 2 FLOPs a multiply-add; a kernel's least
time the largest of its FLOPs, bytes and exp2 calls over the H100's
rates), from the shapes of SDXL's UNet: a head count and a transformer
depth a level, linear projections (the same products as v1's 1x1
convolutions), and the text_time embedding's MLP. The VAE is v1's and is
counted by count.py.
"""

from __future__ import annotations

import typing as T

from bench_port import count
from bench_port.count import Product, Site


def _per_level(value, n: int) -> T.List[int]:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def _transformer(out: T.List[Product], b, c, h, w, ctx_len, ctx_c, depth: int) -> None:
    n = h * w
    count._linear(out, b * n, c, c)  # proj_in
    for _ in range(depth):
        count._attention(out, b, n, n, c, c, True)
        count._attention(out, b, n, ctx_len, c, ctx_c, False)
        count._linear(out, b * n, c, 8 * c)
        count._linear(out, b * n, 4 * c, c)
    count._linear(out, b * n, c, c)  # proj_out


def unet_products(ucfg: T.Mapping[str, T.Any], batch: int, h: int, w: int,
                  ctx_len: int = 77) -> T.List[Product]:
    """The products of one SDXL UNet evaluation at `batch` on an h x w latent."""
    bo = list(ucfg["block_out_channels"])
    n, lpb, cross = len(bo), ucfg["layers_per_block"], ucfg["cross_attention_dim"]
    depth = _per_level(ucfg["transformer_layers_per_block"], n)
    attn = [t.startswith("CrossAttn") for t in ucfg["down_block_types"]]
    temb = 4 * bo[0]
    out: T.List[Product] = []
    count._linear(out, batch, bo[0], temb, input_grad=False)
    count._linear(out, batch, temb, temb)
    count._linear(out, batch, ucfg["projection_class_embeddings_input_dim"], temb,
                  input_grad=False)
    count._linear(out, batch, temb, temb)
    count._conv(out, batch, ucfg["in_channels"], bo[0], 3, h, w, input_grad=False)
    skips, c = [bo[0]], bo[0]
    for i, cout in enumerate(bo):
        for _ in range(lpb):
            count._resnet(out, batch, c, cout, h, w, temb)
            c = cout
            if attn[i]:
                _transformer(out, batch, c, h, w, ctx_len, cross, depth[i])
            skips.append(c)
        if i != n - 1:
            h, w = h // 2, w // 2
            count._conv(out, batch, c, c, 3, h, w)
            skips.append(c)
    count._resnet(out, batch, c, c, h, w, temb)
    _transformer(out, batch, c, h, w, ctx_len, cross, depth[-1])
    count._resnet(out, batch, c, c, h, w, temb)
    for i in reversed(range(n)):
        for _ in range(lpb + 1):
            count._resnet(out, batch, c + skips.pop(), bo[i], h, w, temb)
            c = bo[i]
            if attn[i]:
                _transformer(out, batch, c, h, w, ctx_len, cross, depth[i])
        if i != 0:
            h, w = h * 2, w * 2
            count._conv(out, batch, c, c, 3, h, w)
    count._conv(out, batch, c, ucfg["out_channels"], 3, h, w)
    return out


def self_attention_sites(ucfg: T.Mapping[str, T.Any], h: int, w: int) -> T.List[Site]:
    """The self-attention sites of one evaluation by level: (seq, heads,
    head width, launches), each transformer block one launch."""
    bo, lpb = list(ucfg["block_out_channels"]), ucfg["layers_per_block"]
    n = len(bo)
    heads = _per_level(ucfg["attention_head_dim"], n)
    depth = _per_level(ucfg["transformer_layers_per_block"], n)
    attn = [t.startswith("CrossAttn") for t in ucfg["down_block_types"]]
    sites = []
    for i, c in enumerate(bo):
        launches = (2 * lpb + 1) * depth[i] * attn[i] + (depth[i] if i == n - 1 else 0)
        if launches:
            sites.append(Site((h >> i) * (w >> i), heads[i], c // heads[i], launches))
    return sites


def latent(height: int, width: int) -> T.Tuple[int, int]:
    return height // 8, width // 8


def clip_flops(config: T.Mapping[str, T.Any], evaluations: int, height: int, width: int,
               batch: int = 1) -> float:
    """Model FLOPs of `batch` served clips: the guided UNet at 2 * batch for
    each evaluation, the VAE's encode of the seed image and the decode of
    each clip; the towers' encodes, cached by the pipeline, left out."""
    h, w = latent(height, width)
    return (evaluations * count.forward_flops(unet_products(config["unet"], 2 * batch, h, w))
            + count.forward_flops(count.vae_encode_products(config["vae"], 1, height, width))
            + count.forward_flops(count.vae_decode_products(config["vae"], batch, h, w)))


def k1_least_seconds_per_launch(config: T.Mapping[str, T.Any], height: int, width: int,
                                batch: int = 2) -> float:
    """K1's least time a launch, the mean over an evaluation's launches."""
    sites = self_attention_sites(config["unet"], *latent(height, width))
    total = sum(s.per_eval * count.least_seconds(*count.attention_cost(batch, s.seq, s.heads,
                                                                       s.head_dim))
                for s in sites)
    return total / sum(s.per_eval for s in sites)
