"""
RiffusionPipeline — prompt-interpolated img2img audio generation on one
CUDA device (or the CPU, when asked for).

The counterpart of the single-request path of
riffusion_tpu/riffusion_pipeline.py: `load_checkpoint`, `embed_text`,
`embed_text_weighted`, `riffuse`, `riffuse_audio`, `preprocess_image`,
`preprocess_mask`. Where the JAX package traces one program
(VAE encode -> seed-noise slerp -> noising -> CFG denoise scan -> VAE decode
-> codec -> inverse mel -> Griffin-Lim), this runs the same steps eagerly,
with the denoise loop as a Python loop over `schedulers.step`.

Randomness. A request draws five tensors: the VAE reparameterization eps,
the two seed noises `noise_a` / `noise_b`, and the two uniform Griffin-Lim
phase tensors. All of them come from one `NoiseSource`, a callable
`(name, shape, device) -> tensor`. The default, `GeneratorNoise`, uses
device torch.Generators seeded from (start.seed, end.seed); a test passes
`FixedNoise` with the draws the JAX program made, so both packages see the
same numbers.

The UNet and CLIP run in bfloat16 on CUDA and float32 on the CPU; the VAE
and the DSP always run in float32 (TF32 off, torch_util.configure_numerics).

Each stage of a request runs inside a `torch.profiler.record_function` span
(riffusion.text, .vae_encode, .denoise, .vae_decode, .audio), which a
profiler attributes device time to (scripts/profile_torch_request.py); with
no profiler running a span costs a few microseconds.
"""

from __future__ import annotations

import functools
import typing as T

import numpy as np
import torch
from PIL import Image
from torch.profiler import record_function

from riffusion_tpu.audio.segment import AudioSegment
from riffusion_tpu.datatypes import InferenceInput
from riffusion_tpu.spectrogram_params import SpectrogramParams
from riffusion_tpu.util import audio_util
from riffusion_tpu_torch.diffusion import schedulers as sched
from riffusion_tpu_torch.external import prompt_weighting
from riffusion_tpu_torch.models.weights import ModelBundle, load_bundle
from riffusion_tpu_torch.ops import codec
from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter
from riffusion_tpu_torch.util import torch_util

NOISE_NAMES = ("vae_eps", "noise_a", "noise_b", "gl_real", "gl_imag")
NoiseSource = T.Callable[[str, T.Tuple[int, ...], torch.device], torch.Tensor]


def _derived_seed(seed: int, salt: int) -> int:
    """A 63-bit generator seed derived from (seed, salt)."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, salt]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class GeneratorNoise:
    """The default noise source: normal draws for the latents, uniform draws
    for the Griffin-Lim phase, from torch.Generators on the target device.

    noise_a depends on start.seed only and noise_b on end.seed only, so two
    requests that share a seed share that noise (what makes consecutive
    interpolation clips continuous). The VAE eps and the phase come from
    generators derived from start.seed, independent of noise_a."""

    def __init__(self, start_seed: int, end_seed: int, device: torch.device):
        def gen(seed: int) -> torch.Generator:
            return torch.Generator(device=device).manual_seed(seed)

        self._gens = {
            "vae_eps": gen(_derived_seed(start_seed, 11)),
            "noise_a": gen(int(start_seed)),
            "noise_b": gen(int(end_seed)),
            "gl": gen(_derived_seed(start_seed, 7)),
        }

    def __call__(self, name: str, shape: T.Tuple[int, ...], device: torch.device) -> torch.Tensor:
        if name in ("gl_real", "gl_imag"):
            return torch.rand(shape, generator=self._gens["gl"], device=device)
        return torch.randn(shape, generator=self._gens[name], device=device)


class FixedNoise:
    """A noise source that hands out given arrays (numpy or tensors), one per
    name, checking each shape."""

    def __init__(self, draws: T.Mapping[str, T.Any]):
        missing = set(NOISE_NAMES) - set(draws)
        if missing:
            raise ValueError(f"FixedNoise needs draws for {sorted(missing)}")
        self._draws = dict(draws)

    def __call__(self, name: str, shape: T.Tuple[int, ...], device: torch.device) -> torch.Tensor:
        value = torch.as_tensor(np.asarray(self._draws[name], dtype=np.float32))
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"noise {name!r} has shape {tuple(value.shape)}, expected {shape}")
        return value.to(device)


def _waveform_to_int16(waveform: torch.Tensor) -> torch.Tensor:
    """Peak-normalize a (C, L) waveform to int16 full scale on its device
    (the math of AudioSegment.from_float(normalize=True))."""
    peak = torch.max(torch.abs(waveform))
    scale = torch.where(peak > 0, 32767.0 / torch.clamp(peak, min=1e-30), torch.ones_like(peak))
    return torch.clamp(torch.round(waveform * scale), -32768, 32767).to(torch.int16)


class RiffusionPipeline:
    """Diffusion pipeline for audio spectrogram generation."""

    def __init__(
        self,
        bundle: ModelBundle,
        device: str = "cuda",
        noise_config: sched.NoiseConfig = sched.NoiseConfig(),
    ):
        self.bundle = bundle
        self.device = torch_util.check_device(device)
        if self.device.type == "cuda":
            torch_util.configure_numerics()
        self.noise_config = noise_config
        self.unet = bundle.unet.to(self.device).eval()
        self.vae = bundle.vae.to(self.device, torch.float32).eval()
        self.text_encoder = bundle.text_encoder.to(self.device).eval()
        self.tokenizer = bundle.tokenizer
        self._converters: T.Dict[SpectrogramParams, SpectrogramConverter] = {}

    @classmethod
    def load_checkpoint(
        cls,
        checkpoint: str,
        dtype: T.Optional[torch.dtype] = None,
        device: str = "cuda",
    ) -> "RiffusionPipeline":
        """Load from a checkpoint spec (models/weights.py:load_bundle).
        dtype=None is bfloat16 on CUDA; the CPU always runs float32."""
        resolved = torch_util.check_device(device)
        if resolved.type == "cpu":
            dtype = torch.float32
        elif dtype is None:
            dtype = torch.bfloat16
        return cls(load_bundle(checkpoint, device=resolved, dtype=dtype), device=str(resolved))

    # ---------------------------------------------------------- text encoding

    @torch.inference_mode()
    def _encode_77(self, ids: np.ndarray) -> torch.Tensor:
        return self.text_encoder(torch.as_tensor(ids, dtype=torch.long, device=self.device))

    @functools.lru_cache(maxsize=256)
    def embed_text(self, text: str) -> torch.Tensor:
        """Plain CLIP embedding of `text`, (1, 77, hidden)."""
        ids = np.asarray(
            self.tokenizer(
                text,
                padding="max_length",
                max_length=self.tokenizer.model_max_length,
                truncation=True,
            )["input_ids"],
            dtype=np.int64,
        )
        return self._encode_77(ids)

    @functools.lru_cache(maxsize=256)
    def embed_text_weighted(self, text: str) -> torch.Tensor:
        """Attention-weighted embedding (`(word:1.5)` syntax), (1, L, hidden)."""
        emb, _ = prompt_weighting.get_weighted_text_embeddings(
            self._encode_77, self.tokenizer, text, uncond_prompt=None, max_embeddings_multiples=3
        )
        return emb

    def _uncond_embedding(self, negative_prompt: T.Optional[str], seq_len: int) -> torch.Tensor:
        """Unconditional/negative embedding matched to the cond seq length."""
        text = negative_prompt or ""
        if seq_len == self.tokenizer.model_max_length:
            return self.embed_text(text)
        multiples = (seq_len - 2) // (self.tokenizer.model_max_length - 2)
        emb, _ = prompt_weighting.get_weighted_text_embeddings(
            self._encode_77, self.tokenizer, text, max_embeddings_multiples=multiples
        )
        return self._pad_seq(emb, seq_len)

    @staticmethod
    def _pad_seq(emb: torch.Tensor, seq: int) -> torch.Tensor:
        """Cut or pad (repeating the last token) to `seq` tokens."""
        if emb.shape[1] >= seq:
            return emb[:, :seq]
        pad = emb[:, -1:, :].expand(-1, seq - emb.shape[1], -1)
        return torch.cat([emb, pad], dim=1)

    def text_embeddings(self, inputs: InferenceInput, use_reweighting: bool = True) -> torch.Tensor:
        """(2, L, hidden): the unconditional (or negative) embedding and the
        alpha-interpolation of the start and end prompts' embeddings."""
        alpha = float(inputs.alpha)
        start, end = inputs.start, inputs.end
        embed = self.embed_text_weighted if use_reweighting else self.embed_text
        embed_start, embed_end = embed(start.prompt), embed(end.prompt)
        if embed_start.shape[1] != embed_end.shape[1]:
            seq = max(embed_start.shape[1], embed_end.shape[1])
            embed_start = self._pad_seq(embed_start, seq)
            embed_end = self._pad_seq(embed_end, seq)
        text_embedding = embed_start + alpha * (embed_end - embed_start)
        negative = start.negative_prompt if alpha < 0.5 else end.negative_prompt
        uncond = self._uncond_embedding(negative, text_embedding.shape[1])
        return torch.cat([uncond.to(text_embedding.dtype), text_embedding], dim=0)

    # ---------------------------------------------------------------- helpers

    def converter(self, params: SpectrogramParams) -> SpectrogramConverter:
        if params not in self._converters:
            self._converters[params] = SpectrogramConverter(params, device=str(self.device))
        return self._converters[params]

    def _denoise(
        self,
        plan: sched.SchedulerPlan,
        latents: torch.Tensor,
        text_emb: torch.Tensor,
        guidance: float,
        mask: T.Optional[torch.Tensor],
        init_latents: torch.Tensor,
        noise: torch.Tensor,
    ) -> torch.Tensor:
        """The classifier-free-guidance denoise loop: one UNet call at batch 2
        (unconditional, conditional) per plan step."""
        state = sched.init_state(plan, latents.shape, latents.dtype, self.device)
        for i in range(plan.num_steps):
            lat_in = sched.scale_model_input(plan, torch.cat([latents, latents], dim=0), i)
            t = torch.full((2,), int(plan.timesteps[i]), dtype=torch.int64, device=self.device)
            eps = self.unet(lat_in, t, text_emb)
            eps_u, eps_t = eps.chunk(2, dim=0)
            eps = eps_u + guidance * (eps_t - eps_u)
            latents, state = sched.step(plan, state, i, eps.to(latents.dtype), latents)
            if mask is not None:
                init_proper = sched.add_noise_at_index(plan, self.noise_config, init_latents, noise, i)
                latents = init_proper * mask + latents * (1.0 - mask)
        return latents

    @torch.inference_mode()
    def _run(
        self,
        inputs: InferenceInput,
        init_image: Image.Image,
        mask_image: T.Optional[Image.Image],
        use_reweighting: bool,
        fused_params: T.Optional[SpectrogramParams],
        noise: T.Optional[NoiseSource],
    ) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
        """The whole request on the device: returns the (H, W, 3) uint8 image
        and, with `fused_params`, the (C, L) int16 waveform."""
        scheduler_name = self.bundle.scheduler_name
        alpha = float(inputs.alpha)
        start, end = inputs.start, inputs.end
        num_steps = inputs.num_inference_steps
        guidance = start.guidance * (1.0 - alpha) + end.guidance * alpha
        if noise is None:
            noise = GeneratorNoise(start.seed, end.seed, self.device)
        dev = self.device

        with record_function("riffusion.text"):
            text_emb = self.text_embeddings(inputs, use_reweighting)

        image = torch.from_numpy(preprocess_image(init_image)).to(dev).permute(0, 3, 1, 2)
        height, width = image.shape[2], image.shape[3]
        mask = None
        if mask_image is not None:
            mask_np = preprocess_mask(mask_image, scale_factor=8, size=(width // 8, height // 8))
            mask = torch.from_numpy(mask_np).to(dev).permute(0, 3, 1, 2)

        strength = (1.0 - alpha) * start.denoising + alpha * end.denoising
        offset = self.noise_config.steps_offset
        init_timestep = min(int(num_steps * strength) + offset, num_steps)
        t_start = max(num_steps - init_timestep + offset, 0)
        full_plan = sched.make_plan(scheduler_name, num_steps, 0, self.noise_config)
        noise_timestep = int(full_plan.timesteps[-init_timestep])
        plan = sched.make_plan(scheduler_name, num_steps, t_start, self.noise_config)

        scale = self.bundle.vae_config.scaling_factor
        with record_function("riffusion.vae_encode"):
            mean, logvar = self.vae.encode_moments(image)
            shape = tuple(mean.shape)
            init_latents = scale * self.vae.sample(mean, logvar, noise("vae_eps", shape, dev))
            init_latents = init_latents.to(torch.float32)
        seed_noise = torch_util.slerp(
            alpha, noise("noise_a", shape, dev), noise("noise_b", shape, dev)
        )
        latents = sched.add_noise(self.noise_config, init_latents, seed_noise, noise_timestep)
        with record_function("riffusion.denoise"):
            latents = self._denoise(
                plan, latents, text_emb, guidance, mask, init_latents, seed_noise
            )

        with record_function("riffusion.vae_decode"):
            image_u8 = codec.image_u8_from_vae_output(self.vae.decode(latents / scale))
        if fused_params is None:
            return image_u8, None

        with record_function("riffusion.audio"):
            converter = self.converter(fused_params)
            codes = codec.codes_from_rgb_image(image_u8, stereo=fused_params.stereo)
            mel_amps = codec.spectrogram_from_codes(
                codes, fused_params.power_for_image, max_value=30e6
            )
            phase_shape = (mel_amps.shape[0], converter.n_active, mel_amps.shape[2])
            waveform = converter.waveform_from_mel_amplitudes(
                mel_amps,
                init_real=noise("gl_real", phase_shape, dev),
                init_imag=noise("gl_imag", phase_shape, dev),
            )
            return image_u8, _waveform_to_int16(waveform)

    # ------------------------------------------------------------- public API

    def riffuse(
        self,
        inputs: InferenceInput,
        init_image: Image.Image,
        mask_image: T.Optional[Image.Image] = None,
        use_reweighting: bool = True,
        noise: T.Optional[NoiseSource] = None,
    ) -> Image.Image:
        """Interpolated img2img generation -> spectrogram PIL image."""
        image_u8, _ = self._run(
            inputs, init_image, mask_image, use_reweighting, None, noise
        )
        return Image.fromarray(image_u8.cpu().numpy(), mode="RGB")

    def riffuse_audio(
        self,
        inputs: InferenceInput,
        init_image: Image.Image,
        mask_image: T.Optional[Image.Image] = None,
        use_reweighting: bool = True,
        params: T.Optional[SpectrogramParams] = None,
        apply_filters: bool = True,
        noise: T.Optional[NoiseSource] = None,
    ) -> T.Tuple[Image.Image, AudioSegment]:
        """Spectrogram image AND reconstructed audio; the image never goes
        through PIL on its way to Griffin-Lim."""
        params = params or SpectrogramParams()
        image_u8, waveform = self._run(
            inputs, init_image, mask_image, use_reweighting, params, noise
        )
        assert waveform is not None
        segment = AudioSegment(waveform.cpu().numpy().T, params.sample_rate)
        if apply_filters:
            segment = audio_util.apply_filters(segment, compression=False)
        return Image.fromarray(image_u8.cpu().numpy(), mode="RGB"), segment


# -------------------------------------------------------------- preprocessing


def preprocess_image(image: Image.Image) -> np.ndarray:
    """PIL image -> (1, H, W, 3) float32 in [-1, 1], resized to /32 stride."""
    w, h = image.size
    w, h = (x - x % 32 for x in (w, h))
    image = image.convert("RGB").resize((w, h), resample=Image.LANCZOS)
    arr = np.asarray(image).astype(np.float32) / 255.0
    return 2.0 * arr[None] - 1.0


def preprocess_mask(
    mask: Image.Image, scale_factor: int = 8, size: T.Optional[T.Tuple[int, int]] = None
) -> np.ndarray:
    """Mask PIL image -> (1, h, w, 4) float32; white=repaint -> 0 after the
    inversion."""
    mask = mask.convert("L")
    if size is None:
        w, h = mask.size
        w, h = (x - x % 32 for x in (w, h))
        size = (w // scale_factor, h // scale_factor)
    mask = mask.resize(size, resample=Image.NEAREST)
    arr = np.asarray(mask).astype(np.float32) / 255.0
    arr = 1.0 - arr  # repaint white, keep black
    return np.tile(arr[None, :, :, None], (1, 1, 1, 4))
