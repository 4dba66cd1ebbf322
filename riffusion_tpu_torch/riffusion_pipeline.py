"""
RiffusionPipeline — prompt-interpolated img2img audio generation on one
CUDA device (or the CPU, when asked for).

The counterpart of the riffuse paths of riffusion_tpu/riffusion_pipeline.py:
`load_checkpoint`, `embed_text`, `embed_text_weighted`, `riffuse`
(`interpolate_img2img`), `riffuse_audio`, `riffuse_audio_batch`, `txt2img`,
`img2img`, `preprocess_image`, `preprocess_mask`. Where the JAX package traces one
program (VAE encode -> seed-noise slerp -> noising -> CFG denoise scan ->
VAE decode -> codec -> inverse mel -> Griffin-Lim), this runs the same steps
eagerly, with the denoise loop as a Python loop over `schedulers.step`. A
single request is a batch of one: `_generate` runs N requests with the UNet
at batch 2N, and every entry point goes through it.

Randomness. A request draws five tensors: the VAE reparameterization eps,
the two seed noises `noise_a` / `noise_b`, and the two uniform Griffin-Lim
phase tensors; with euler_a also "ancestral", every step's noise at once,
(S, 1, C, h, w). `txt2img` draws "latents" (and "ancestral"). All of them
come from one `NoiseSource` per request, a callable `(name, shape, device)
-> tensor`. The default, `GeneratorNoise`, uses device torch.Generators
seeded from (start.seed, end.seed); a test passes `FixedNoise` with the
draws the JAX program made, so both packages see the same numbers. In a
batch, request i draws what it would draw alone.

The UNet and CLIP run in bfloat16 on CUDA and float32 on the CPU; the VAE
and the DSP always run in float32 (TF32 off, torch_util.configure_numerics).

Each stage of a request runs inside a `torch.profiler.record_function` span
(riffusion.text, .vae_encode, .denoise, .vae_decode, .audio), which a
profiler attributes device time to (scripts/profile_torch_request.py); with
no profiler running a span costs a few microseconds.
"""

from __future__ import annotations

import functools
import threading
import typing as T

import numpy as np
import torch
from PIL import Image
from torch.profiler import record_function

from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.diffusion import schedulers as sched
from riffusion_tpu_torch.external import prompt_weighting
from riffusion_tpu_torch.models.weights import ModelBundle, load_bundle
from riffusion_tpu_torch.ops import codec
from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import audio_util, torch_util

#: euler_a's per-step noise, and txt2img's starting latents: drawn only by
#: the paths that use them.
ANCESTRAL, LATENTS = "ancestral", "latents"
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
    interpolation clips continuous). The VAE eps, the phase, euler_a's
    per-step noise and txt2img's latents come from generators derived from
    start.seed with salts of their own, independent of noise_a and of one
    another."""

    def __init__(self, start_seed: int, end_seed: int, device: torch.device):
        def gen(seed: int) -> torch.Generator:
            return torch.Generator(device=device).manual_seed(seed)

        self._gens = {
            "vae_eps": gen(_derived_seed(start_seed, 11)),
            "noise_a": gen(int(start_seed)),
            "noise_b": gen(int(end_seed)),
            "gl": gen(_derived_seed(start_seed, 7)),
            ANCESTRAL: gen(_derived_seed(start_seed, 13)),
            LATENTS: gen(_derived_seed(start_seed, 17)),
        }

    def __call__(self, name: str, shape: T.Tuple[int, ...], device: torch.device) -> torch.Tensor:
        if name in ("gl_real", "gl_imag"):
            return torch.rand(shape, generator=self._gens["gl"], device=device)
        return torch.randn(shape, generator=self._gens[name], device=device)


class FixedNoise:
    """A noise source that hands out given arrays (numpy or tensors), one per
    name, checking each shape. A draw it lacks raises, naming the draw, when
    a path asks for it."""

    def __init__(self, draws: T.Mapping[str, T.Any]):
        self._draws = dict(draws)

    def __call__(self, name: str, shape: T.Tuple[int, ...], device: torch.device) -> torch.Tensor:
        if name not in self._draws:
            raise ValueError(f"FixedNoise has no draw {name!r} (it holds {sorted(self._draws)})")
        value = torch.as_tensor(np.asarray(self._draws[name], dtype=np.float32))
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"noise {name!r} has shape {tuple(value.shape)}, expected {shape}")
        return value.to(device)


def _waveform_to_int16(waveform: torch.Tensor) -> torch.Tensor:
    """Peak-normalize a (C, L) waveform, or each item of an (N, C, L) batch,
    to int16 full scale on its device (the math of
    AudioSegment.from_float(normalize=True))."""
    if waveform.dim() > 2:
        peak = torch.amax(torch.abs(waveform), dim=tuple(range(1, waveform.dim())), keepdim=True)
    else:
        peak = torch.max(torch.abs(waveform))
    scale = torch.where(peak > 0, 32767.0 / torch.clamp(peak, min=1e-30), torch.ones_like(peak))
    return torch.clamp(torch.round(waveform * scale), -32768, 32767).to(torch.int16)


@torch.inference_mode()
def _encode_ids(text_encoder: torch.nn.Module, device: torch.device,
                ids: np.ndarray) -> torch.Tensor:
    return text_encoder(torch.as_tensor(ids, dtype=torch.long, device=device))


def _embed_plain(tokenizer, encode: T.Callable, text: str) -> torch.Tensor:
    """Plain CLIP embedding of `text`, (1, 77, hidden)."""
    ids = np.asarray(
        tokenizer(
            text,
            padding="max_length",
            max_length=tokenizer.model_max_length,
            truncation=True,
        )["input_ids"],
        dtype=np.int64,
    )
    return encode(ids)


def _embed_weighted(tokenizer, encode: T.Callable, text: str) -> torch.Tensor:
    """Attention-weighted embedding (`(word:1.5)` syntax), (1, L, hidden)."""
    emb, _ = prompt_weighting.get_weighted_text_embeddings(
        encode, tokenizer, text, uncond_prompt=None, max_embeddings_multiples=3
    )
    return emb


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
        # embed_text and embed_text_weighted: each pipeline's own caches of
        # prompt embeddings. They hold the text encoder, not the pipeline, so
        # a pipeline that is dropped frees its weights.
        self._encode_77 = functools.partial(_encode_ids, self.text_encoder, self.device)
        self.embed_text = functools.lru_cache(maxsize=256)(
            functools.partial(_embed_plain, self.tokenizer, self._encode_77))
        self.embed_text_weighted = functools.lru_cache(maxsize=256)(
            functools.partial(_embed_weighted, self.tokenizer, self._encode_77))
        self._converters: T.Dict[SpectrogramParams, SpectrogramConverter] = {}
        # One program is queued on the device at a time (see _dispatch).
        self._dispatch_lock = threading.Lock()

    @classmethod
    def load_checkpoint(
        cls,
        checkpoint: str,
        dtype: T.Optional[torch.dtype] = None,
        device: str = "cuda",
        scheduler: T.Optional[str] = None,
    ) -> "RiffusionPipeline":
        """Load from a checkpoint spec (models/weights.py:load_bundle).
        dtype=None is bfloat16 on CUDA; the CPU always runs float32.
        `scheduler` replaces the bundle's default sampler (checked here)."""
        resolved = torch_util.check_device(device)
        if resolved.type == "cpu":
            dtype = torch.float32
        elif dtype is None:
            dtype = torch.bfloat16
        bundle = load_bundle(checkpoint, device=resolved, dtype=dtype)
        if scheduler:
            sched.make_plan(scheduler, 50)  # raises on an unknown name or option
            bundle.scheduler_name = scheduler
        return cls(bundle, device=str(resolved))

    # ---------------------------------------------------------- text encoding

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

    def _embedding_pair(
        self, inputs: InferenceInput, use_reweighting: bool
    ) -> T.Tuple[torch.Tensor, torch.Tensor]:
        """(unconditional or negative embedding, alpha-interpolation of the
        start and end prompts' embeddings), each (1, L, hidden)."""
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
        return uncond.to(text_embedding.dtype), text_embedding

    def text_embeddings(self, inputs: InferenceInput, use_reweighting: bool = True) -> torch.Tensor:
        """(2, L, hidden): the unconditional (or negative) embedding and the
        alpha-interpolation of the start and end prompts' embeddings."""
        return torch.cat(self._embedding_pair(inputs, use_reweighting), dim=0)

    # ---------------------------------------------------------------- helpers

    def converter(self, params: SpectrogramParams) -> SpectrogramConverter:
        if params not in self._converters:
            self._converters[params] = SpectrogramConverter(params, device=str(self.device))
        return self._converters[params]

    def _plan(
        self, scheduler_name: str, num_steps: int, strength: float
    ) -> T.Tuple[sched.SchedulerPlan, int]:
        """The img2img plan for a denoising strength, and the DDPM timestep
        that PNDM's start noising uses."""
        offset = self.noise_config.steps_offset
        init_timestep = min(int(num_steps * strength) + offset, num_steps)
        t_start = max(num_steps - init_timestep + offset, 0)
        full_plan = sched.make_plan(scheduler_name, num_steps, 0, self.noise_config)
        noise_timestep = int(full_plan.timesteps[-init_timestep])
        return sched.make_plan(scheduler_name, num_steps, t_start, self.noise_config), noise_timestep

    def _denoise(
        self,
        plan: sched.SchedulerPlan,
        latents: torch.Tensor,
        text_emb: torch.Tensor,
        guidance: torch.Tensor,
        mask: T.Optional[torch.Tensor],
        init_latents: T.Optional[torch.Tensor],
        noise: T.Optional[torch.Tensor],
        ancestral: T.Optional[torch.Tensor],
    ) -> torch.Tensor:
        """The classifier-free-guidance denoise loop over N latents: one UNet
        call at batch 2N ([unconditionals..., conditionals...]) per plan
        step, with per-item guidance (N, 1, 1, 1) in fp32. `ancestral` is an
        ancestral sampler's per-step noise, (S, N, C, h, w)."""
        n = latents.shape[0]
        state = sched.init_state(plan, latents.shape, latents.dtype, self.device,
                                 ancestral=ancestral)
        for i in range(plan.num_steps):
            lat_in = sched.scale_model_input(plan, torch.cat([latents, latents], dim=0), i)
            t = torch.full((2 * n,), int(plan.timesteps[i]), dtype=torch.int64, device=self.device)
            eps = self.unet(lat_in, t, text_emb)
            eps_u, eps_t = eps.chunk(2, dim=0)
            eps = eps_u + guidance * (eps_t - eps_u)
            latents, state = sched.step(plan, state, i, eps.to(latents.dtype), latents)
            if mask is not None:
                # re-noise in the scheduler's own working space
                init_proper = sched.add_noise_at_index(plan, self.noise_config, init_latents, noise, i)
                latents = init_proper * mask + latents * (1.0 - mask)
        return latents

    def _generate(
        self,
        inputs_list: T.Sequence[InferenceInput],
        init_images: T.Sequence[Image.Image],
        mask_image: T.Optional[Image.Image],
        use_reweighting: bool,
        fused_params: T.Optional[SpectrogramParams],
        noises: T.Optional[T.Sequence[NoiseSource]],
        scheduler: T.Optional[str],
    ) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
        """N requests as one program on the device: the (N, H, W, 3) uint8
        images and, with `fused_params`, the (N, C, L) int16 waveforms.
        `init_images` holds one shared seed image (encoded once) or one per
        request; one mask applies to every request. Request i draws its
        noise from noises[i] with the single request's names and shapes, so
        its result does not depend on its batch position."""
        n = len(inputs_list)
        steps = {inp.num_inference_steps for inp in inputs_list}
        if len(steps) != 1:
            raise ValueError(f"batch requires a single num_inference_steps (got {sorted(steps)})")
        strengths = [
            (1.0 - float(inp.alpha)) * inp.start.denoising + float(inp.alpha) * inp.end.denoising
            for inp in inputs_list
        ]
        # The start step is one for the whole batch; the DynamicBatcher
        # buckets strengths to 3 decimals, so that much spread is allowed.
        if max(strengths) - min(strengths) > 1e-3:
            raise ValueError(
                "batch requires a single denoising strength (got "
                f"{sorted(set(round(s, 4) for s in strengths))}); split the "
                "batch by strength or use serving.DynamicBatcher"
            )
        plan, noise_timestep = self._plan(
            scheduler or self.bundle.scheduler_name, steps.pop(), float(np.mean(strengths))
        )
        dev = self.device
        if noises is None:
            noises = [GeneratorNoise(inp.start.seed, inp.end.seed, dev) for inp in inputs_list]
        if len(noises) != n:
            raise ValueError(f"need one noise source per request: {len(noises)} for {n}")
        alphas = [float(inp.alpha) for inp in inputs_list]
        guidance = torch.tensor(
            [inp.start.guidance * (1.0 - a) + inp.end.guidance * a
             for inp, a in zip(inputs_list, alphas)],
            dtype=torch.float32, device=dev,
        ).view(n, 1, 1, 1)

        with record_function("riffusion.text"):
            pairs = [self._embedding_pair(inp, use_reweighting) for inp in inputs_list]
            seq = max(cond.shape[1] for _, cond in pairs)
            text_emb = torch.cat(
                [self._pad_seq(u, seq) for u, _ in pairs] + [self._pad_seq(c, seq) for _, c in pairs]
            )

        arrays = [preprocess_image(im) for im in init_images]
        if len({a.shape for a in arrays}) != 1:
            raise ValueError(f"init images must share one size: {sorted({a.shape for a in arrays})}")
        image = torch.from_numpy(np.concatenate(arrays)).to(dev).permute(0, 3, 1, 2)
        height, width = image.shape[2], image.shape[3]
        mask = None
        if mask_image is not None:
            mask_np = preprocess_mask(mask_image, scale_factor=8, size=(width // 8, height // 8))
            mask = torch.from_numpy(mask_np).to(dev).permute(0, 3, 1, 2)

        scale = self.bundle.vae_config.scaling_factor
        with record_function("riffusion.vae_encode"):
            mean, logvar = self.vae.encode_moments(image)
            shape = (1,) + tuple(mean.shape[1:])
            eps = torch.cat([nz("vae_eps", shape, dev) for nz in noises])
            init_latents = (scale * self.vae.sample(mean, logvar, eps)).to(torch.float32)
        seed_noise = torch.cat([
            torch_util.slerp(a, nz("noise_a", shape, dev), nz("noise_b", shape, dev))
            for a, nz in zip(alphas, noises)
        ])
        if plan.name in sched.SIGMA_BASED:
            # the k-diffusion samplers start at x0 + sigma_0 * eps
            latents = sched.add_noise_sigma(plan, init_latents, seed_noise, 0)
        else:
            latents = sched.add_noise(self.noise_config, init_latents, seed_noise, noise_timestep)
        ancestral = None
        if sched.draws_noise(plan):
            ancestral = torch.cat(
                [nz(ANCESTRAL, (plan.num_steps,) + shape, dev) for nz in noises], dim=1
            )
        with record_function("riffusion.denoise"):
            latents = self._denoise(
                plan, latents, text_emb, guidance, mask, init_latents, seed_noise, ancestral
            )

        with record_function("riffusion.vae_decode"):
            decoded = self.vae.decode(latents / scale)
            images_u8 = torch.stack(
                [codec.image_u8_from_vae_output(decoded[i:i + 1]) for i in range(n)]
            )
        if fused_params is None:
            return images_u8, None

        with record_function("riffusion.audio"):
            converter = self.converter(fused_params)
            codes = torch.cat(
                [codec.codes_from_rgb_image(im, stereo=fused_params.stereo) for im in images_u8]
            )
            mel_amps = codec.spectrogram_from_codes(
                codes, fused_params.power_for_image, max_value=30e6
            )  # (N * C, F, T): Griffin-Lim treats every row alike
            channels = mel_amps.shape[0] // n
            phase_shape = (channels, converter.n_active, mel_amps.shape[2])
            waveforms = converter.waveform_from_mel_amplitudes(
                mel_amps,
                init_real=torch.cat([nz("gl_real", phase_shape, dev) for nz in noises]),
                init_imag=torch.cat([nz("gl_imag", phase_shape, dev) for nz in noises]),
            )
            return images_u8, _waveform_to_int16(waveforms.view(n, channels, -1))

    @torch.inference_mode()
    def _dispatch(self, *args) -> T.Callable[[], T.Tuple[np.ndarray, T.Optional[np.ndarray]]]:
        """Queue `_generate(*args)` on the device and the copies of its
        results to the host; return a function that waits for the copies.

        On CUDA the copies go into pinned host memory behind an event, so
        the waiting function (the DynamicBatcher calls it from its finalizer
        thread) blocks on this batch only, not on work queued after it on
        the device's stream.

        Threads take turns here: a server thread's /run_inference_batch/
        and the batcher's worker never queue two programs at once, so the
        device holds one program's memory at a time and the kernel counters
        (ops.attention.COUNTS) count one program's launches together."""
        with self._dispatch_lock:
            outputs = self._generate(*args)
            if self.device.type != "cuda":
                return lambda: tuple(None if x is None else x.numpy() for x in outputs)
            host = tuple(
                None if x is None else torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in outputs
            )
            for h, x in zip(host, outputs):
                if x is not None:
                    h.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record()

        def wait() -> T.Tuple[np.ndarray, T.Optional[np.ndarray]]:
            done.synchronize()
            return tuple(None if h is None else h.numpy() for h in host)

        return wait

    # ------------------------------------------------------------- public API

    def riffuse(
        self,
        inputs: InferenceInput,
        init_image: Image.Image,
        mask_image: T.Optional[Image.Image] = None,
        use_reweighting: bool = True,
        scheduler: T.Optional[str] = None,
        *,
        noise: T.Optional[NoiseSource] = None,
    ) -> Image.Image:
        """Interpolated img2img generation -> spectrogram PIL image.
        `scheduler` overrides the bundle's (e.g. "unipc_k:rho=2")."""
        images, _ = self._dispatch(
            [inputs], [init_image], mask_image, use_reweighting, None,
            None if noise is None else [noise], scheduler,
        )()
        return Image.fromarray(images[0], mode="RGB")

    def interpolate_img2img(
        self,
        inputs: InferenceInput,
        init_image: Image.Image,
        mask_image: T.Optional[Image.Image] = None,
        use_reweighting: bool = True,
        scheduler: T.Optional[str] = None,
        *,
        noise: T.Optional[NoiseSource] = None,
    ) -> Image.Image:
        """The reference's name for `riffuse` (same program)."""
        return self.riffuse(inputs, init_image, mask_image, use_reweighting, scheduler, noise=noise)

    def riffuse_audio(
        self,
        inputs: InferenceInput,
        init_image: Image.Image,
        mask_image: T.Optional[Image.Image] = None,
        use_reweighting: bool = True,
        params: T.Optional[SpectrogramParams] = None,
        apply_filters: bool = True,
        scheduler: T.Optional[str] = None,
        *,
        noise: T.Optional[NoiseSource] = None,
    ) -> T.Tuple[Image.Image, AudioSegment]:
        """Spectrogram image AND reconstructed audio; the image never goes
        through PIL on its way to Griffin-Lim. A batch of one."""
        return self.riffuse_audio_batch(
            [inputs], init_image, params=params, use_reweighting=use_reweighting,
            apply_filters=apply_filters, mask_image=mask_image, scheduler=scheduler,
            noises=None if noise is None else [noise],
        )[0]

    def riffuse_audio_batch(
        self,
        inputs_list: T.Sequence[InferenceInput],
        init_image: T.Union[Image.Image, T.Sequence[Image.Image]],
        params: T.Optional[SpectrogramParams] = None,
        use_reweighting: bool = True,
        apply_filters: bool = True,
        async_dispatch: bool = False,
        mask_image: T.Optional[Image.Image] = None,
        scheduler: T.Optional[str] = None,
        noises: T.Optional[T.Sequence[NoiseSource]] = None,
    ) -> T.Union[
        T.List[T.Tuple[Image.Image, AudioSegment]],
        T.Callable[[], T.List[T.Tuple[Image.Image, AudioSegment]]],
    ]:
        """Run N riffuse requests as one batched program (the UNet at batch
        2N). All requests share num_inference_steps and, to 1e-3, the
        denoising strength (ValueError otherwise). `init_image` is one
        shared seed image or a sequence of N of one size; `mask_image` is
        one mask for every request; `noises` gives each request its noise
        source (default: GeneratorNoise of its seeds).

        With async_dispatch=True the work is queued and a zero-argument
        `finalize` is returned that waits for this batch's results and
        builds them, so a caller can queue the next batch first."""
        params = params or SpectrogramParams()
        images = [init_image] if isinstance(init_image, Image.Image) else list(init_image)
        if len(images) not in (1, len(inputs_list)):
            raise ValueError(f"need one init image or {len(inputs_list)}, got {len(images)}")
        wait = self._dispatch(
            inputs_list, images, mask_image, use_reweighting, params, noises, scheduler
        )

        def finalize() -> T.List[T.Tuple[Image.Image, AudioSegment]]:
            images_np, waveforms_np = wait()
            results = []
            for image_np, waveform_np in zip(images_np, waveforms_np):
                segment = AudioSegment(waveform_np.T, params.sample_rate)
                if apply_filters:
                    segment = audio_util.apply_filters(segment, compression=False)
                results.append((Image.fromarray(image_np, mode="RGB"), segment))
            return results

        return finalize if async_dispatch else finalize()

    # --------------------------------------------------------- txt2img/img2img

    def _txt2img(
        self, prompt: str, negative_prompt: T.Optional[str], num_steps: int, guidance: float,
        width: int, height: int, scheduler: str, noise: NoiseSource,
    ) -> torch.Tensor:
        """One text-to-image program: the (H, W, 3) uint8 image on the device."""
        plan = sched.make_plan(scheduler, num_steps, 0, self.noise_config)
        dev = self.device
        with record_function("riffusion.text"):
            cond = self.embed_text_weighted(prompt)
            uncond = self._uncond_embedding(negative_prompt, cond.shape[1]).to(cond.dtype)
            text_emb = torch.cat([uncond, cond], dim=0)
        shape = (1, self.unet.cfg.in_channels, height // 8, width // 8)
        latents = noise(LATENTS, shape, dev).to(torch.float32) * plan.init_noise_sigma
        ancestral = noise(ANCESTRAL, (plan.num_steps,) + shape, dev) \
            if sched.draws_noise(plan) else None
        g = torch.full((1, 1, 1, 1), float(guidance), dtype=torch.float32, device=dev)
        with record_function("riffusion.denoise"):
            latents = self._denoise(plan, latents, text_emb, g, None, None, None, ancestral)
        with record_function("riffusion.vae_decode"):
            decoded = self.vae.decode(latents / self.bundle.vae_config.scaling_factor)
            return codec.image_u8_from_vae_output(decoded)

    def txt2img(
        self,
        prompt: str,
        negative_prompt: T.Optional[str] = None,
        seed: int = 42,
        num_inference_steps: int = 30,
        guidance: float = 7.0,
        width: int = 512,
        height: int = 512,
        scheduler: T.Optional[str] = None,
        *,
        noise: T.Optional[NoiseSource] = None,
    ) -> Image.Image:
        """Plain text-to-image generation: the denoise loop from pure noise
        at the plan's init_noise_sigma, the weighted prompt against the
        negative one. `noise` draws "latents" (and euler_a's "ancestral");
        by default GeneratorNoise of `seed`."""
        noise = noise or GeneratorNoise(seed, seed, self.device)
        with self._dispatch_lock, torch.inference_mode():
            image = self._txt2img(
                prompt, negative_prompt, num_inference_steps, guidance, width, height,
                scheduler or self.bundle.scheduler_name, noise,
            ).cpu().numpy()
        return Image.fromarray(image, mode="RGB")

    def img2img(
        self,
        prompt: str,
        init_image: Image.Image,
        denoising_strength: float = 0.5,
        negative_prompt: T.Optional[str] = None,
        seed: int = 42,
        num_inference_steps: int = 30,
        guidance: float = 7.0,
        scheduler: T.Optional[str] = None,
        *,
        noise: T.Optional[NoiseSource] = None,
    ) -> Image.Image:
        """Single-prompt img2img: `riffuse` at alpha 0 with the same prompt at
        both ends (slerp(0, a, b) is a)."""
        prompt_input = PromptInput(prompt=prompt, seed=seed, negative_prompt=negative_prompt,
                                   denoising=denoising_strength, guidance=guidance)
        inputs = InferenceInput(start=prompt_input, end=prompt_input, alpha=0.0,
                                num_inference_steps=num_inference_steps)
        return self.riffuse(inputs, init_image, scheduler=scheduler, noise=noise)


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
