"""
The benchmark's own count of the work its cells do, from the shapes of
Stable Diffusion v1 (a configuration file's widths), for the rooflines and
the model FLOP utilizations.

- Model FLOPs count the products only: every convolution, linear layer and
  attention matmul, at 2 per multiply-add; norms, activations and the
  sampler's arithmetic are left out. A training step adds the backward's
  products: each weight's gradient, and each activation's where its input
  needs one (not the noisy latents, the time embedding's sinusoids or the
  text contexts).
- A kernel's least time is the largest of its FLOPs over the bf16 dense
  peak, its bytes (each input read once, each output written once) over the
  HBM bandwidth, and its exp2 calls (one per logit, once more in the
  backward) over the SFUs' rate at the boost clock.

Peaks of one NVIDIA H100 SXM (the data sheet's dense rates at 700 W).
"""

from __future__ import annotations

import typing as T

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SMS, EXP2_PER_SM_CLOCK, BOOST_HZ = 132, 16, 1.98e9


class Product(T.NamedTuple):
    """One product of a forward pass: its FLOPs, and how many of its two
    operands need a gradient in training (a weight always does)."""

    flops: float
    grads: int


def _conv(out: T.List[Product], b, cin, cout, k, h_out, w_out, input_grad=True):
    out.append(Product(2.0 * b * cout * cin * k * k * h_out * w_out, 1 + input_grad))


def _linear(out, tokens, cin, cout, input_grad=True):
    out.append(Product(2.0 * tokens * cin * cout, 1 + input_grad))


def _resnet(out, b, cin, cout, h, w, temb: T.Optional[int]):
    _conv(out, b, cin, cout, 3, h, w)
    if temb is not None:
        _linear(out, b, temb, cout)
    _conv(out, b, cout, cout, 3, h, w)
    if cin != cout:
        _conv(out, b, cin, cout, 1, h, w)


def _attention(out, b, s_q, s_k, c, ctx_c, self_attention: bool):
    _linear(out, b * s_q, c, c)
    for _ in range(2):
        _linear(out, b * s_k, ctx_c, c, input_grad=self_attention)
    out.append(Product(2.0 * b * s_q * s_k * c, 2))  # Q K^T
    out.append(Product(2.0 * b * s_q * s_k * c, 2))  # P V
    _linear(out, b * s_q, c, c)


def _transformer(out, b, c, h, w, ctx_len, ctx_c):
    n = h * w
    _conv(out, b, c, c, 1, h, w)
    _attention(out, b, n, n, c, c, True)
    _attention(out, b, n, ctx_len, c, ctx_c, False)
    _linear(out, b * n, c, 8 * c)
    _linear(out, b * n, 4 * c, c)
    _conv(out, b, c, c, 1, h, w)


def unet_products(ucfg: T.Mapping[str, T.Any], batch: int, h: int, w: int,
                  ctx_len: int = 77) -> T.List[Product]:
    bo = list(ucfg["block_out_channels"])
    lpb, cross = ucfg["layers_per_block"], ucfg["cross_attention_dim"]
    attn = [t.startswith("CrossAttn") for t in ucfg["down_block_types"]]
    temb = 4 * bo[0]
    out: T.List[Product] = []
    _linear(out, batch, bo[0], temb, input_grad=False)
    _linear(out, batch, temb, temb)
    _conv(out, batch, ucfg["in_channels"], bo[0], 3, h, w, input_grad=False)
    skips, c = [bo[0]], bo[0]
    for i, cout in enumerate(bo):
        for _ in range(lpb):
            _resnet(out, batch, c, cout, h, w, temb)
            c = cout
            if attn[i]:
                _transformer(out, batch, c, h, w, ctx_len, cross)
            skips.append(c)
        if i != len(bo) - 1:
            h, w = h // 2, w // 2
            _conv(out, batch, c, c, 3, h, w)
            skips.append(c)
    _resnet(out, batch, c, c, h, w, temb)
    _transformer(out, batch, c, h, w, ctx_len, cross)
    _resnet(out, batch, c, c, h, w, temb)
    for i in reversed(range(len(bo))):
        for _ in range(lpb + 1):
            _resnet(out, batch, c + skips.pop(), bo[i], h, w, temb)
            c = bo[i]
            if attn[i]:
                _transformer(out, batch, c, h, w, ctx_len, cross)
        if i != 0:
            h, w = h * 2, w * 2
            _conv(out, batch, c, c, 3, h, w)
    _conv(out, batch, c, ucfg["out_channels"], 3, h, w)
    return out


def _vae_mid(out, b, c, h, w):
    _resnet(out, b, c, c, h, w, None)
    _attention(out, b, h * w, h * w, c, c, True)
    _resnet(out, b, c, c, h, w, None)


def vae_encode_products(vcfg: T.Mapping[str, T.Any], batch: int, h: int, w: int
                        ) -> T.List[Product]:
    bo, lpb = list(vcfg["block_out_channels"]), vcfg["layers_per_block"]
    lat = vcfg["latent_channels"]
    out: T.List[Product] = []
    _conv(out, batch, vcfg["in_channels"], bo[0], 3, h, w, input_grad=False)
    c = bo[0]
    for i, cout in enumerate(bo):
        for _ in range(lpb):
            _resnet(out, batch, c, cout, h, w, None)
            c = cout
        if i != len(bo) - 1:
            h, w = h // 2, w // 2
            _conv(out, batch, c, c, 3, h, w)
    _vae_mid(out, batch, c, h, w)
    _conv(out, batch, c, 2 * lat, 3, h, w)
    _conv(out, batch, 2 * lat, 2 * lat, 1, h, w)
    return out


def vae_decode_products(vcfg: T.Mapping[str, T.Any], batch: int, h: int, w: int
                        ) -> T.List[Product]:
    bo, lpb = list(vcfg["block_out_channels"]), vcfg["layers_per_block"]
    lat = vcfg["latent_channels"]
    out: T.List[Product] = []
    _conv(out, batch, lat, lat, 1, h, w, input_grad=False)
    _conv(out, batch, lat, bo[-1], 3, h, w)
    c = bo[-1]
    _vae_mid(out, batch, c, h, w)
    for i, cout in enumerate(reversed(bo)):
        for _ in range(lpb + 1):
            _resnet(out, batch, c, cout, h, w, None)
            c = cout
        if i != len(bo) - 1:
            h, w = h * 2, w * 2
            _conv(out, batch, c, c, 3, h, w)
    _conv(out, batch, c, vcfg["out_channels"], 3, h, w)
    return out


def clip_products(ccfg: T.Mapping[str, T.Any], batch: int, length: int = 77) -> T.List[Product]:
    d, ff = ccfg["hidden_size"], ccfg["intermediate_size"]
    out: T.List[Product] = []
    for _ in range(ccfg["num_hidden_layers"]):
        _attention(out, batch, length, length, d, d, True)
        _linear(out, batch * length, d, ff)
        _linear(out, batch * length, ff, d)
    return out


def forward_flops(products: T.Iterable[Product]) -> float:
    return sum(p.flops for p in products)


def training_flops(products: T.Iterable[Product]) -> float:
    """Forward and backward: each product once forward and once for each
    operand that takes a gradient."""
    return sum(p.flops * (1 + p.grads) for p in products)


# ------------------------------------------------------------- attention


class Site(T.NamedTuple):
    """A self-attention site of one UNet evaluation."""

    seq: int
    heads: int
    head_dim: int
    per_eval: int


def self_attention_sites(ucfg: T.Mapping[str, T.Any], h: int, w: int) -> T.List[Site]:
    """The UNet's self-attention sites by resolution (diffusers v1: the
    head count is `attention_head_dim`)."""
    bo, lpb = list(ucfg["block_out_channels"]), ucfg["layers_per_block"]
    heads = ucfg["attention_head_dim"]
    attn = [t.startswith("CrossAttn") for t in ucfg["down_block_types"]]
    sites: T.Dict[T.Tuple[int, int], int] = {}
    for i, c in enumerate(bo):
        hh, ww = h >> i, w >> i
        count = (2 * lpb + 1) * attn[i]
        if count:
            sites[(hh * ww, c)] = sites.get((hh * ww, c), 0) + count
    mid = (h >> (len(bo) - 1)) * (w >> (len(bo) - 1))
    sites[(mid, bo[-1])] = sites.get((mid, bo[-1]), 0) + 1
    return [Site(s, heads, c // heads, n) for (s, c), n in sites.items()]


def attention_cost(batch: int, seq: int, heads: int, d: int, backward: bool = False
                   ) -> T.Tuple[float, float, float]:
    """(FLOPs, bytes, exp2 calls) of self-attention on (batch, seq, heads*d)
    bf16 operands, forward, or forward and backward with the forward's
    log-sum-exp kept: the backward's products are dV = P^T dO, dP = dO V^T,
    dQ = dS K and dK = dS^T Q, and P is recomputed once."""
    logits = float(batch) * heads * seq * seq
    flops = 4.0 * logits * d
    exps = logits
    tensor = 2.0 * batch * seq * heads * d  # bytes of one bf16 operand
    lse = 4.0 * batch * heads * seq
    nbytes = 4 * tensor
    if backward:
        flops += 8.0 * logits * d
        exps += logits
        nbytes += lse + (5 * tensor + lse) + 3 * tensor  # lse out; q k v o dO, lse in; dq dk dv
    return flops, nbytes, exps


def least_seconds(flops: float, nbytes: float, exps: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES,
               exps / (SMS * EXP2_PER_SM_CLOCK * BOOST_HZ))


# ------------------------------------------------------------- a cell's work


def serving_evaluations(scheduler: str, steps: int, strength: float) -> int:
    """UNet evaluations of one img2img request (riffusion's start rule)."""
    from bench_port.reference import sampling

    t_start, _ = sampling.img2img_start(steps, strength)
    if scheduler == "pndm":
        return len(sampling.PNDM(steps).timesteps) - t_start
    return steps - t_start


def clip_flops(config: T.Mapping[str, T.Any], evaluations: int, batch: int = 1,
               height: int = 512, width: int = 512) -> float:
    """Model FLOPs of `batch` served clips: the guided UNet at 2 * batch for
    each evaluation, the VAE's encode of the one seed image and the decode
    of each clip. The prompts' CLIP encodes, cached by the server, are left
    out (19 GFLOP each, under 0.1% of a clip)."""
    h, w = height // 8, width // 8
    return (evaluations * forward_flops(unet_products(config["unet"], 2 * batch, h, w))
            + forward_flops(vae_encode_products(config["vae"], 1, height, width))
            + forward_flops(vae_decode_products(config["vae"], batch, h, w)))


def train_step_flops(config: T.Mapping[str, T.Any], batch: int) -> float:
    h, w = config["dataset"]["latent_shape"][:2]
    return training_flops(unet_products(config["unet"], batch, h, w,
                                        config["dataset"]["context_shape"][0]))
