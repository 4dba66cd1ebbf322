"""
Stable Diffusion XL base 1.0 in riffusion_tpu_torch against the plain
reference (tests/torch_sdxl_reference.py), on seeded random weights at a
tiny SDXL-shaped size: three levels with no attention at the first,
transformer depths (0, 1, 2) and head counts (1, 2, 4), linear
projections, the text_time embedding, a quick-gelu tower beside a two-layer
gelu tower with a projection.

Each tolerance is shown to reject the two wiring faults the reference can
plant: the added embedding dropped (add_embedding's output zeroed, so the
time embedding goes without it) and the last hidden state read in place of
the penultimate one.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from PIL import Image

import torch_sdxl_reference as ref
from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.models import weights
from riffusion_tpu_torch.models.clip import CLIPTextModel, CLIPTextProjectionConfig
from riffusion_tpu_torch.models.tokenizer import HashTokenizer
from riffusion_tpu_torch.models.unet import UNet2DCondition, UNetXLConfig
from riffusion_tpu_torch.riffusion_pipeline import GeneratorNoise, RiffusionPipeline
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

UNET = {
    "_class_name": "UNet2DConditionModel", "act_fn": "silu", "in_channels": 4,
    "out_channels": 4, "block_out_channels": [32, 64, 64], "layers_per_block": 2,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    "attention_head_dim": [1, 2, 4], "transformer_layers_per_block": [0, 1, 2],
    "cross_attention_dim": 96, "use_linear_projection": True, "norm_num_groups": 32,
    "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
    "projection_class_embeddings_input_dim": 48 + 6 * 8, "flip_sin_to_cos": True,
    "freq_shift": 0,
}
VAE = {"_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
       "latent_channels": 4, "block_out_channels": [32, 32, 32, 32], "layers_per_block": 1,
       "norm_num_groups": 32, "scaling_factor": 0.13025}
TOWER_1 = {"architectures": ["CLIPTextModel"], "hidden_act": "quick_gelu", "hidden_size": 32,
           "intermediate_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
           "max_position_embeddings": 77, "vocab_size": 1024, "projection_dim": 32}
TOWER_2 = {"architectures": ["CLIPTextModelWithProjection"], "hidden_act": "gelu",
           "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
           "num_hidden_layers": 2, "max_position_embeddings": 77, "vocab_size": 1024,
           "projection_dim": 48}
SCHEDULER = {"_class_name": "EulerDiscreteScheduler", "beta_start": 0.00085, "beta_end": 0.012,
             "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
             "steps_offset": 1, "timestep_spacing": "leading"}
CFGS = {"unet": UNET, "vae": VAE, "text_encoder": TOWER_1, "text_encoder_2": TOWER_2}
SHAPES = {"unet": ref.unet_shapes, "vae": ref.vae_shapes, "text_encoder": ref.clip_shapes,
          "text_encoder_2": ref.clip_shapes}
EOS = HashTokenizer().eos_token_id

#: fp64 on both sides: what is left is the order of the sums (the port's
#: attention composition, its fused GEGLU split), about 1e-15 of the output's
#: scale; the faults move the output by a percent or more.
FP64_REL = 1e-9


def _states(seed: int = 3, dtype=torch.float32):
    return {name: ref.random_state(SHAPES[name](CFGS[name]), seed + i, dtype, norm_jitter=0.1)
            for i, name in enumerate(CFGS)}


def _dropped_added_embedding(unet_state):
    """The planted fault: add_embedding's output zeroed, so the time
    embedding goes without the added conditions."""
    return dict(unet_state, **{k: torch.zeros_like(v) for k, v in unet_state.items()
                               if k.startswith("add_embedding.linear_2.")})


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _port_unet(state):
    cfg = weights._unet_config_from_json(UNET)
    assert isinstance(cfg, UNetXLConfig)
    module = UNet2DCondition(cfg).to(next(iter(state.values())).dtype)
    converted, _ = weights.convert_diffusers_state_dict(state, "unet")
    module.load_state_dict(converted, strict=True)
    return module.eval()


def _port_tower(state, cfg):
    converted, _ = weights.convert_diffusers_state_dict(state, "clip")
    module = weights.text_encoder_module(weights._clip_config_from_json(cfg), converted,
                                         torch.device("cpu"), "test")
    return module.to(next(iter(state.values())).dtype).eval()


def test_unet_with_added_conditions_in_fp64():
    states = _states(dtype=torch.float64)
    unet = _port_unet(states["unet"])
    gen = torch.Generator().manual_seed(0)
    sample = torch.randn(2, 4, 8, 32, generator=gen, dtype=torch.float64)
    t = torch.tensor([981.0, 401.0], dtype=torch.float64)
    context = torch.randn(2, 77, 96, generator=gen, dtype=torch.float64)
    pooled = torch.randn(2, 48, generator=gen, dtype=torch.float64)
    time_ids = torch.tensor([[64.0, 256.0, 0.0, 0.0, 64.0, 256.0]] * 2, dtype=torch.float64)
    with torch.no_grad():
        got = unet(sample, t, context, pooled, time_ids)
    want = ref.unet_forward(states["unet"], UNET, sample, t, context, pooled, time_ids)
    assert _rel(got, want) < FP64_REL
    dropped = ref.unet_forward(_dropped_added_embedding(states["unet"]), UNET, sample, t,
                               context, pooled, time_ids)
    assert _rel(got, dropped) > 100 * FP64_REL
    with pytest.raises(ValueError, match="text_embeds and time_ids"):
        unet(sample, t, context)


def test_both_towers_penultimate_and_pooled_in_fp64():
    states = _states(dtype=torch.float64)
    ids = torch.tensor(HashTokenizer(vocab_size=1024)("lofi jazz piano")["input_ids"])
    for name, cfg in (("text_encoder", TOWER_1), ("text_encoder_2", TOWER_2)):
        tower = _port_tower(states[name], cfg)
        assert isinstance(tower.cfg, CLIPTextProjectionConfig) == (cfg is TOWER_2)
        with torch.no_grad():
            penultimate, pooled = tower.penultimate_and_pooled(ids, EOS)
        hidden, want_pooled = ref.clip_hidden_states(states[name], cfg, ids, EOS)
        assert _rel(penultimate, hidden[-2]) < FP64_REL
        assert _rel(penultimate, hidden[-1]) > 100 * FP64_REL  # the last hidden state
        if cfg is TOWER_2:
            assert _rel(pooled, want_pooled) < FP64_REL
        else:
            assert pooled is None
    context, pooled = ref.text_conditioning(states["text_encoder"], TOWER_1,
                                            states["text_encoder_2"], TOWER_2, ids, EOS)
    assert context.shape == (1, 77, 96) and pooled.shape == (1, 48)


def _write_checkpoint(root, states):
    for name, state in states.items():
        folder = root / name
        folder.mkdir(parents=True)
        (folder / "config.json").write_text(json.dumps(CFGS[name]))
        filename = "pytorch_model.bin" if name.startswith("text") else "diffusion_pytorch_model.bin"
        torch.save(state, folder / filename)
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(SCHEDULER))


def test_strict_loads_of_a_diffusers_layout(tmp_path):
    states = _states()
    for name in CFGS:
        kind = {"unet": "unet", "vae": "vae"}.get(name, "clip")
        converted, sources = weights.convert_diffusers_state_dict(states[name], kind)
        assert set(sources.values()) == set(states[name])  # every file key is used
    _write_checkpoint(tmp_path / "sdxl", states)
    bundle = weights.load_bundle(str(tmp_path / "sdxl"), device="cpu")
    assert isinstance(bundle.unet.cfg, UNetXLConfig)
    assert isinstance(bundle.text_encoder_2, CLIPTextModel)
    assert bundle.text_encoder_2.cfg.projection == 48
    assert bundle.scheduler_name == "euler"
    assert bundle.noise_config.timestep_spacing == "leading"
    assert hasattr(bundle.unet, "add_embedding")
    assert isinstance(bundle.unet.mid_block.attentions_0.proj_in, torch.nn.Linear)
    assert bundle.unet.up_blocks_0.attentions_2.depth == 2
    state = dict(states["text_encoder_2"])
    del state["text_projection.weight"]
    torch.save(state, tmp_path / "sdxl" / "text_encoder_2" / "pytorch_model.bin")
    with pytest.raises(ValueError, match="missing text_projection.weight"):
        weights.load_bundle(str(tmp_path / "sdxl"), device="cpu")


#: One request's image against the reference's, in uint8 levels: the same
#: float32 arithmetic in another order (the port's fused attention, channels
#: last, its bf16-free CPU path) moves a few pixels by a level at a guidance
#: that keeps the random model from amplifying it (1.5); each planted fault
#: moves the mean by several levels.
IMAGE_GAP = 0.5


def test_riffuse_audio_image_against_the_reference_euler(tmp_path):
    states = _states()
    _write_checkpoint(tmp_path / "sdxl", states)
    pipe = RiffusionPipeline.load_checkpoint(str(tmp_path / "sdxl"), device="cpu")
    width, height, steps = 256, 64, 10  # 10 steps at 0.75 runs 7 (riffusion's start)
    rng = np.random.default_rng(5)
    seed_image = Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype=np.uint8))
    inputs = InferenceInput(
        start=PromptInput(prompt="lofi jazz", seed=11, guidance=1.5),
        end=PromptInput(prompt="trance arps piano", seed=12, guidance=1.5),
        alpha=0.25, num_inference_steps=steps)
    image, segment = pipe.riffuse_audio(inputs, seed_image,
                                        params=SpectrogramParams(num_frequencies=height))
    assert len(segment.raw_data) > 0
    got = np.asarray(image).astype(np.float64)

    noise = GeneratorNoise(11, 12, torch.device("cpu"))
    shape = (1, 4, height // 8, width // 8)
    draws = {name: noise(name, shape, torch.device("cpu"))
             for name in ("vae_eps", "noise_a", "noise_b")}
    tokenizer = HashTokenizer(vocab_size=1024)
    ids = {k: torch.tensor(tokenizer(p)["input_ids"])
           for k, p in (("start", "lofi jazz"), ("end", "trance arps piano"))}
    pixels = torch.from_numpy(2.0 * (np.asarray(seed_image).astype(np.float32) / 255.0) - 1.0)
    pixels = pixels.permute(2, 0, 1)[None]

    def gap(states_, hidden=-2):
        want = ref.riffuse_image(states_, CFGS, ids, 0.25, pixels, draws, steps, 0.75, 1.5,
                                 EOS, hidden=hidden)
        return np.abs(got - want.astype(np.float64)).mean()

    assert gap(states) < IMAGE_GAP
    assert gap(dict(states, unet=_dropped_added_embedding(states["unet"]))) > IMAGE_GAP
    assert gap(states, hidden=-1) > IMAGE_GAP  # the last hidden state as the context
