"""
The port's models (riffusion_tpu_torch/models: CLIP, VAE, UNet) against the
JAX package's on the CPU, at the tiny geometry, with the JAX random bundle's
weights carried across by `from_jax_params`. Also the port's own random
bundle: every parameter filled with the JAX bundle's statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu.models import weights as jax_weights
from riffusion_tpu.models.clip import CLIPTextModel as JaxCLIP
from riffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from riffusion_tpu.models.vae import AutoencoderKL as JaxVAE
from riffusion_tpu_torch.models import weights


@pytest.fixture(scope="module")
def bundles():
    """The JAX tiny bundle in fp32 with a distinct value per parameter
    (RIFFUSION_TPU_SYNTH_DEDUPE=0: shared values would hide a swapped q/k),
    and the port's bundle holding the same weights."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RIFFUSION_TPU_SYNTH_DEDUPE", "0")
    try:
        jb = jax_weights.random_bundle("tiny", seed=3, dtype=jnp.float32)
    finally:
        mp.undo()
    tb = weights.bundle_from_jax_params("tiny", jb.unet_params, jb.vae_params, jb.clip_params,
                                        device="cpu")
    return jb, tb


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# fp32 on both sides through the same compositions; the differences are sum
# order in XLA:CPU's and PyTorch's convolutions and matmuls. Measured below
# 1e-5 of the peak; 1e-4 is the stated tolerance.
TOL = 1e-4


def test_clip_matches_jax(bundles):
    jb, tb = bundles
    ids = np.random.default_rng(0).integers(0, jb.clip_config.vocab_size, (2, 77))
    ref = JaxCLIP(jb.clip_config, dtype=jnp.float32).apply(
        {"params": jb.clip_params}, jnp.asarray(ids, jnp.int32)
    )
    with torch.no_grad():
        out = tb.text_encoder(torch.from_numpy(ids))
    assert out.shape == ref.shape
    assert _rel_err(out.numpy(), ref) < TOL


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_vae_matches_jax(bundles, hw):
    jb, tb = bundles
    rng = np.random.default_rng(1)
    image = rng.uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    vae = JaxVAE(jb.vae_config, dtype=jnp.float32)
    mean_j, logvar_j = jax.jit(lambda p, x: vae.apply({"params": p}, x, method="encode_moments"))(
        jb.vae_params, jnp.asarray(image))
    with torch.no_grad():
        mean_t, logvar_t = tb.vae.encode_moments(_nchw(image))
    assert _rel_err(mean_t.permute(0, 2, 3, 1).numpy(), mean_j) < TOL
    assert _rel_err(logvar_t.permute(0, 2, 3, 1).numpy(), logvar_j) < TOL

    eps = rng.standard_normal(mean_j.shape).astype(np.float32)
    z = np.asarray(mean_j) + np.exp(0.5 * np.asarray(logvar_j)) * eps
    z_t = tb.vae.sample(_nchw(np.asarray(mean_j)), _nchw(np.asarray(logvar_j)), _nchw(eps))
    np.testing.assert_allclose(z_t.permute(0, 2, 3, 1).numpy(), z, rtol=1e-6, atol=1e-6)

    dec_j = jax.jit(lambda p, z: vae.apply({"params": p}, z, method="decode"))(
        jb.vae_params, jnp.asarray(z))
    with torch.no_grad():
        dec_t = tb.vae.decode(_nchw(z))
    assert dec_t.shape == (1, 3, *hw)
    assert _rel_err(dec_t.permute(0, 2, 3, 1).numpy(), dec_j) < TOL


# (8, 8): the square latent of a 64 px seed; (10, 6): odd intermediate
# sizes (10 -> 5 -> 3 -> 2), where the upsamplers resize to the skip's size.
@pytest.mark.parametrize("hw", [(8, 8), (10, 6)])
def test_unet_matches_jax(bundles, hw):
    jb, tb = bundles
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    t = np.array([801, 801], np.int32)
    ctx = rng.standard_normal((2, 77, jb.unet_config.cross_attention_dim)).astype(np.float32)
    ref = jax.jit(JaxUNet(jb.unet_config, dtype=jnp.float32, flash=False).apply)(
        {"params": jb.unet_params}, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx)
    )
    with torch.no_grad():
        out = tb.unet(_nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    assert out.dtype == torch.float32
    assert _rel_err(out.permute(0, 2, 3, 1).numpy(), ref) < TOL


def test_from_jax_params_layouts(bundles):
    """Dense (in, out) -> Linear (out, in), conv HWIO -> OIHW, scale/embedding
    -> weight, paths -> module names."""
    jb, _ = bundles
    sd_unet, sd_vae, sd_clip = weights.from_jax_params(
        jb.unet_params, jb.vae_params, jb.clip_params
    )
    q = np.asarray(jb.unet_params["down_blocks_0"]["attentions_0"]["blocks_0"]["attn1"]["to_q"]
                   ["kernel"])
    np.testing.assert_array_equal(sd_unet["down_blocks_0.attentions_0.blocks_0.attn1.to_q.weight"],
                                  q.T)
    conv = np.asarray(jb.unet_params["conv_in"]["kernel"])
    np.testing.assert_array_equal(sd_unet["conv_in.weight"], conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd_vae["encoder.conv_norm_out.weight"],
                                  np.asarray(jb.vae_params["encoder"]["conv_norm_out"]["scale"]))
    np.testing.assert_array_equal(sd_clip["token_embedding.weight"],
                                  np.asarray(jb.clip_params["token_embedding"]["embedding"]))


def test_random_bundle_statistics():
    """The port's random:tiny: N(0, 1/fan_in) weights (fan_in in the JAX
    layout), zero biases, unit norm scales; deterministic per seed; the VAE
    stays fp32 whatever the dtype."""
    a = weights.random_bundle("tiny", seed=0, device="cpu", dtype=torch.bfloat16)
    b = weights.random_bundle("tiny", seed=0, device="cpu", dtype=torch.bfloat16)
    for x, y in zip(a.unet.state_dict().values(), b.unet.state_dict().values()):
        assert torch.equal(x, y)
    assert a.unet.dtype == torch.bfloat16 and a.vae.encoder.conv_in.weight.dtype == torch.float32
    sd = a.unet.state_dict()
    w = sd["mid_block.attentions_0.blocks_0.ff.proj_in.weight"].float()  # (out, in)
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
    conv = sd["conv_in.weight"].float()  # OIHW; fan_in = I*H*W
    assert abs(float(conv.std()) * np.sqrt(np.prod(conv.shape[1:])) - 1.0) < 0.15
    assert float(sd["conv_in.bias"].abs().max()) == 0.0
    assert torch.all(sd["conv_norm_out.weight"] == 1)
    c = weights.random_bundle("tiny", seed=1, device="cpu")
    assert not torch.equal(c.unet.conv_in.weight, weights.random_bundle(
        "tiny", seed=0, device="cpu").unet.conv_in.weight)
    with pytest.raises(FileNotFoundError, match="random:tiny"):
        weights.load_bundle("riffusion/riffusion-model-v1", device="cpu")
