"""
RiffusionPipeline — prompt-interpolated img2img audio generation on one
CUDA device (or the CPU, when asked for).

The counterpart of the riffuse paths of riffusion_tpu/riffusion_pipeline.py:
`load_checkpoint`, `embed_text`, `embed_text_weighted`, `riffuse`
(`interpolate_img2img`), `riffuse_audio`, `riffuse_audio_batch`, `txt2img`,
`txt2img_audio_batch`, `img2img`, `img2img_magic_mix`, `warmstart_report`,
`preprocess_image`, `preprocess_mask`. Where the JAX package traces one
program (VAE encode -> seed-noise slerp -> noising -> CFG denoise scan ->
VAE decode -> codec -> inverse mel -> Griffin-Lim), this runs the same steps
as torch operations, with the denoise loop as a Python loop over
`schedulers.step`. A single request is a batch of one: `_generate` runs N
riffuse requests with the UNet at batch 2N, `_txt2img_program` N prompts
from pure noise, and both share the denoise loop, the VAE decode and the
audio tail (codec, inverse mel, Griffin-Lim, int16). With a mesh,
`riffuse_audio_batch` runs this rank's share of a data-parallel batch and
gathers the clips (riffusion_tpu_torch/parallel/); a tensor-parallel
request swaps in a split copy of the UNet (parallel/tp_serving.py).

Each program is split as JAX's `_build_call` splits it. Its host part
(`_riffuse_call`, and the first half of `_txt2img_program` and
`_magic_mix_program`) picks the plan, embeds the text, prepares the image
and the mask, uploads the guidance and slerp weights and draws every noise;
its device program (`_riffuse_device`, `_txt2img_device`,
`_magic_mix_device`) is a pure function of those tensors whose Python
choices come from a key with JAX's names and parts (`_aot_key`: riffuse,
riffuse_batch, txt2img, txt2img_batch, magic_mix). On the card the store
(aot.py, `graph_store`) captures the device program into a CUDA graph on
its key's first call and replays it after; on the CPU, under
RIFFUSION_TPU_NO_AOT=1, and on the parallel/ paths it runs eagerly.

Randomness. A request draws five tensors: the VAE reparameterization eps,
the two seed noises `noise_a` / `noise_b`, and the two uniform Griffin-Lim
phase tensors; with euler_a also "ancestral", every step's noise at once,
(S, 1, C, h, w). `txt2img` draws "latents" (and "ancestral"), and with
audio the phase; MagicMix draws "vae_eps", "noise" (the q-sample noise of
the original) and "ancestral". All of them
come from one `NoiseSource` per request, a callable `(name, shape, device)
-> tensor`. The default, `GeneratorNoise`, uses device torch.Generators
seeded from (start.seed, end.seed); a test passes `FixedNoise` with the
draws the JAX program made, so both packages see the same numbers. In a
batch, request i draws what it would draw alone.

The UNet and CLIP run in bfloat16 on CUDA and float32 on the CPU; the VAE
and the DSP always run in float32 (TF32 off, torch_util.configure_numerics).

Stable Diffusion XL (a bundle with `text_encoder_2`) runs the same riffuse
programs with its own conditioning: the context is both towers'
penultimate hidden states side by side (768 + 1280 wide), the pooled
vector is the second tower's projected end-of-text state, both walk in
alpha together, an empty negative prompt is zeros (SDXL's
force_zeros_for_empty_prompt), and the time ids are the seed image's size
as original and target with no crop. The UNet takes the pooled vectors and
the time ids beside the context (`_denoise`'s `added`). txt2img, MagicMix
and the tensor-parallel paths take SD v1 bundles only.

Text embeddings are cached twice: per pipeline (an lru cache per kind) and
across processes on disk (embed_cache.py, keyed on the bundle's
checkpoint_id), so a restarted server reads its boot prompts off disk.
`embed_cache_counts` gives the disk cache's hits and misses.

Spans (tracing.py, each a `torch.profiler.record_function` range).
`riffuse_audio` and `riffuse_audio_batch` run inside `riffusion.call`, with
children `riffusion.prepare` (the host part, `riffusion.text` inside it,
and SDXL's second tower in `riffusion.text.encoder_2` inside that),
`riffusion.launch` (the device program queued: a graph's replay, or the
eager program), `riffusion.readback` (the wait for the results' copies) and
`riffusion.finish` (PIL images, AudioSegments, the filters; with
`async_dispatch` these two open when `finalize` is called). The device
program's stages are `riffusion.vae_encode`, `.denoise`, `.vae_decode` and
`.audio`: a profiler attributes an eager run's device time to them
(`python -m riffusion_tpu_torch.profile request`), and a graph captured with
RIFFUSION_TPU_TRACE=1 times each of them on the card at every replay
(aot.py). With the switch off and no profiler running a span costs a few
microseconds.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import time
import typing as T
import weakref

import numpy as np
import torch
from PIL import Image

from riffusion_tpu_torch import aot, embed_cache, tracing
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.diffusion import schedulers as sched
from riffusion_tpu_torch.external import prompt_weighting
from riffusion_tpu_torch.models.weights import ModelBundle, load_bundle
from riffusion_tpu_torch.ops import attention as attention_ops
from riffusion_tpu_torch.ops import codec
from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import audio_util, torch_util

#: euler_a's per-step noise, txt2img's starting latents and MagicMix's
#: q-sample noise: drawn only by the paths that use them.
ANCESTRAL, LATENTS, MIX_NOISE = "ancestral", "latents", "noise"
NoiseSource = T.Callable[[str, T.Tuple[int, ...], torch.device], torch.Tensor]


#: The Griffin-Lim iterations that JAX's single-request key names (its
#: `_riffuse_program` default; the iterations the audio runs come from the
#: spectrogram parameters, also in the key).
_NUM_GL_ITERS = 32


def _aot_key(name: str, *parts: T.Any) -> str:
    """Readable, filesystem-safe key of a program's configuration: the
    port's copy of riffusion_tpu/riffusion_pipeline.py `_aot_key`. Long or
    structured parts (SpectrogramParams) are folded into a short digest."""
    toks = []
    for p in parts:
        s = "none" if p is None else str(p)
        if len(s) > 24 or not s.replace("-", "").replace(".", "").isalnum():
            s = hashlib.sha256(s.encode()).hexdigest()[:10]
        toks.append(s)
    return "-".join([name] + toks)


class _Program(T.NamedTuple):
    """What a host part hands to the device: `fn`, a pure function of the
    tensors (or None) in `args`, whose Python choices all come from `key`;
    without a key it runs eagerly."""

    key: T.Optional[str]
    fn: T.Callable
    args: T.Tuple[T.Optional[torch.Tensor], ...]


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
    per-step noise, txt2img's latents and MagicMix's noise come from
    generators derived from start.seed with salts of their own, independent
    of noise_a and of one another."""

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
            MIX_NOISE: gen(_derived_seed(start_seed, 19)),
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


class _TwoTowers:
    """SDXL's text conditioning from its two towers, for ids of one 77-token
    chunk: `context(ids)` is both towers' penultimate hidden states side by
    side (1, 77, hidden + hidden_2), `pooled(ids)` the second tower's pooled
    output (1, projection). Both come from one run of each tower, kept for
    the last 256 chunks, so the pooled vector of a prompt whose context was
    just encoded costs nothing."""

    def __init__(self, first: torch.nn.Module, second: torch.nn.Module, device: torch.device,
                 eos_token_id: int):
        self.first, self.second, self.device, self.eos = first, second, device, eos_token_id
        self._run = functools.lru_cache(maxsize=256)(self._encode)

    @torch.inference_mode()
    def _encode(self, ids: T.Tuple[int, ...]) -> T.Tuple[torch.Tensor, torch.Tensor]:
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        context, _ = self.first.penultimate_and_pooled(tokens, self.eos)
        with tracing.span("riffusion.text.encoder_2"):
            tracing.count("text_encoder_2_calls")
            context_2, pooled = self.second.penultimate_and_pooled(tokens, self.eos)
        return torch.cat([context, context_2.to(context.dtype)], dim=-1), pooled

    def context(self, ids: np.ndarray) -> torch.Tensor:
        return torch.cat([self._run(tuple(int(i) for i in row))[0] for row in np.asarray(ids)])

    def pooled(self, ids: np.ndarray) -> torch.Tensor:
        return torch.cat([self._run(tuple(int(i) for i in row))[1] for row in np.asarray(ids)])


class _DiskCachedEmbeddings:
    """Routes an embedding through the cross-process disk cache
    (embed_cache.py): a fresh process reads its boot prompts off disk
    instead of running the text encoder. Keyed on the checkpoint's identity
    and the environment's fingerprint, so a weight or code change is a clean
    miss. A hit comes back on `device` in `dtype`. Counts the lookups that
    hit and missed; a bundle without a checkpoint_id (built directly) is
    not cached."""

    def __init__(self, checkpoint_id: str, dtype: torch.dtype, device: torch.device):
        self.checkpoint_id, self.dtype, self.device = checkpoint_id, dtype, device
        self.hits = self.misses = 0
        self._count_lock = threading.Lock()  # server threads embed concurrently

    def __call__(self, kind: str, text: str, compute: T.Callable[[], torch.Tensor]) -> torch.Tensor:
        key = None
        if self.checkpoint_id and embed_cache.enabled():
            key = embed_cache.entry_key(self.checkpoint_id, self.dtype, kind, text,
                                        device=self.device)
            hit = embed_cache.get(key)
            with self._count_lock:
                if hit is not None:
                    self.hits += 1
                else:
                    self.misses += 1
            if hit is not None:
                return hit.to(self.device, self.dtype)
        emb = compute()
        if key is not None:
            embed_cache.put(key, emb)
        return emb


def _plain_ids(tokenizer, text: str) -> np.ndarray:
    """(1, 77) ids of `text`, padded and truncated to the tokenizer's length."""
    return np.asarray(
        tokenizer(
            text,
            padding="max_length",
            max_length=tokenizer.model_max_length,
            truncation=True,
        )["input_ids"],
        dtype=np.int64,
    )


def _embed_plain(tokenizer, encode: T.Callable, disk: _DiskCachedEmbeddings,
                 text: str) -> torch.Tensor:
    """Plain CLIP embedding of `text`, (1, 77, hidden)."""
    return disk("plain", text, lambda: encode(_plain_ids(tokenizer, text)))


def _embed_pooled(tokenizer, towers: _TwoTowers, disk: _DiskCachedEmbeddings,
                  text: str) -> torch.Tensor:
    """SDXL's pooled text embedding of `text`, (1, projection), from its
    plain ids (a weighted prompt's first chunk is those ids)."""
    return disk("pooled", text, lambda: towers.pooled(_plain_ids(tokenizer, text)))


#: The 77-token chunks a weighted prompt may span.
_WEIGHTED_MULTIPLES = 3


def _embed_weighted(tokenizer, encode: T.Callable, disk: _DiskCachedEmbeddings,
                    text: str) -> torch.Tensor:
    """Attention-weighted embedding (`(word:1.5)` syntax), (1, L, hidden)."""

    def compute() -> torch.Tensor:
        emb, _ = prompt_weighting.get_weighted_text_embeddings(
            encode, tokenizer, text, uncond_prompt=None,
            max_embeddings_multiples=_WEIGHTED_MULTIPLES,
        )
        return emb

    return disk("weighted", text, compute)


class RiffusionPipeline:
    """Diffusion pipeline for audio spectrogram generation."""

    def __init__(
        self,
        bundle: ModelBundle,
        device: str = "cuda",
        noise_config: T.Optional[sched.NoiseConfig] = None,
    ):
        self.bundle = bundle
        self.device = torch_util.check_device(device)
        if self.device.type == "cuda":
            torch_util.configure_numerics()
        self.noise_config = noise_config or bundle.noise_config or sched.NoiseConfig()
        # NHWC inside (models/unet.py), on every device, before any capture
        self.unet = bundle.unet.to(self.device, memory_format=torch.channels_last).eval()
        self.vae = bundle.vae.to(self.device, torch.float32).eval()
        self.text_encoder = bundle.text_encoder.to(self.device).eval()
        self.tokenizer = bundle.tokenizer
        # embed_text and embed_text_weighted: each pipeline's own caches of
        # prompt embeddings, over the disk cache. They hold the text encoder,
        # not the pipeline, so a pipeline that is dropped frees its weights.
        self._encode_77 = functools.partial(_encode_ids, self.text_encoder, self.device)
        self._embed_disk_cached = _DiskCachedEmbeddings(
            bundle.checkpoint_id, bundle.dtype, self.device)
        # SDXL: both towers make the context; embed_pooled, the pooled vector
        self.text_encoder_2 = None
        self.embed_pooled = None
        if bundle.text_encoder_2 is not None:
            self.text_encoder_2 = bundle.text_encoder_2.to(self.device).eval()
            towers = _TwoTowers(self.text_encoder, self.text_encoder_2, self.device,
                                self.tokenizer.eos_token_id)
            self._encode_77 = towers.context
            self.embed_pooled = functools.lru_cache(maxsize=256)(functools.partial(
                _embed_pooled, self.tokenizer, towers, self._embed_disk_cached))
        self.embed_text = functools.lru_cache(maxsize=256)(functools.partial(
            _embed_plain, self.tokenizer, self._encode_77, self._embed_disk_cached))
        self.embed_text_weighted = functools.lru_cache(maxsize=256)(functools.partial(
            _embed_weighted, self.tokenizer, self._encode_77, self._embed_disk_cached))
        # embed_text_weighted's token length, from the tokenizer alone
        self._weighted_length = functools.lru_cache(maxsize=256)(functools.partial(
            prompt_weighting.weighted_embedding_length, self.tokenizer,
            max_embeddings_multiples=_WEIGHTED_MULTIPLES))
        self._converters: T.Dict[SpectrogramParams, SpectrogramConverter] = {}
        # One program is queued on the device at a time (see _dispatch).
        self._dispatch_lock = threading.Lock()
        # The device programs captured as CUDA graphs, by key (aot.py)
        self.graph_store = aot.GraphStore()

    @classmethod
    def load_checkpoint(
        cls,
        checkpoint: str,
        use_traced_unet: bool = True,
        channels_last: bool = False,
        dtype: T.Optional[torch.dtype] = None,
        device: str = "cuda",
        local_files_only: bool = True,
        cache_dir: T.Optional[str] = None,
        scheduler: T.Optional[str] = None,
    ) -> "RiffusionPipeline":
        """Load from a checkpoint spec (models/weights.py:load_bundle), with
        the JAX package's parameters in its order. `use_traced_unet`,
        `channels_last`, `local_files_only` and `cache_dir` are accepted for
        the reference's callers and dropped, as the JAX package drops them
        (nothing is traced or downloaded; the serving UNet is always NHWC
        inside, whatever `channels_last` says). dtype=None is bfloat16 on CUDA;
        the CPU always runs float32. `scheduler` replaces the bundle's
        default sampler (checked here)."""
        del use_traced_unet, channels_last, local_files_only, cache_dir
        resolved = torch_util.check_device(device)
        if resolved.type == "cpu":
            dtype = torch.float32
        elif dtype is None:
            dtype = torch.bfloat16
        bundle = load_bundle(checkpoint, dtype, device=resolved)
        if scheduler:
            sched.make_plan(scheduler, 50)  # raises on an unknown name or option
            bundle.scheduler_name = scheduler
        return cls(bundle, device=str(resolved))

    # ---------------------------------------------------------- text encoding

    @property
    def embed_cache_counts(self) -> T.Dict[str, int]:
        """The disk cache's lookups by this pipeline that hit and missed."""
        return {"hits": self._embed_disk_cached.hits, "misses": self._embed_disk_cached.misses}

    def _uncond_embedding(self, negative_prompt: T.Optional[str], seq_len: int) -> torch.Tensor:
        """Unconditional/negative embedding matched to the cond seq length."""
        text = negative_prompt or ""
        if seq_len == self.tokenizer.model_max_length:
            return self.embed_text(text)
        multiples = (seq_len - 2) // (self.tokenizer.model_max_length - 2)

        def compute() -> torch.Tensor:
            emb, _ = prompt_weighting.get_weighted_text_embeddings(
                self._encode_77, self.tokenizer, text, max_embeddings_multiples=multiples
            )
            return emb

        return self._pad_seq(self._embed_disk_cached(f"uncond:{multiples}", text, compute), seq_len)

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
        if self.text_encoder_2 is not None and not negative:  # force_zeros_for_empty_prompt
            return torch.zeros_like(text_embedding), text_embedding
        uncond = self._uncond_embedding(negative, text_embedding.shape[1])
        return uncond.to(text_embedding.dtype), text_embedding

    def _pooled_pair(self, inputs: InferenceInput) -> T.Tuple[torch.Tensor, torch.Tensor]:
        """SDXL's pooled text embeddings, as `_embedding_pair` pairs the
        contexts: (the negative prompt's, zeros for an empty one; the
        alpha-interpolation of the start and end prompts'), each
        (1, projection)."""
        alpha = float(inputs.alpha)
        start, end = self.embed_pooled(inputs.start.prompt), self.embed_pooled(inputs.end.prompt)
        cond = start + alpha * (end - start)
        negative = inputs.start.negative_prompt if alpha < 0.5 else inputs.end.negative_prompt
        return (self.embed_pooled(negative) if negative else torch.zeros_like(cond)), cond

    def _embedding_length(self, inputs: InferenceInput, use_reweighting: bool) -> int:
        """The token length of _embedding_pair(inputs)'s embeddings, from the
        tokenizer alone (no text encoder runs)."""
        if not use_reweighting:
            return self.tokenizer.model_max_length
        return max(self._weighted_length(p.prompt) for p in (inputs.start, inputs.end))

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
        return img2img_plan(scheduler_name, num_steps, strength, self.noise_config)

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
        blend: T.Optional[T.Callable[[int, torch.Tensor], torch.Tensor]] = None,
        unet: T.Optional[torch.nn.Module] = None,
        added: T.Tuple[torch.Tensor, ...] = (),
    ) -> torch.Tensor:
        """The classifier-free-guidance denoise loop over N latents: one UNet
        call at batch 2N ([unconditionals..., conditionals...]) per plan
        step, with per-item guidance (N, 1, 1, 1) in fp32. `ancestral` is an
        ancestral sampler's per-step noise, (S, N, C, h, w); `blend(i,
        latents)` edits the latents before step i (MagicMix); `unet`
        replaces the pipeline's (a tensor-parallel copy,
        parallel/tp_serving.py); `added` holds SDXL's added conditions for
        the 2N rows, (pooled text embeddings, time ids)."""
        unet = self.unet if unet is None else unet
        n = latents.shape[0]
        state = sched.init_state(plan, latents.shape, latents.dtype, self.device,
                                 ancestral=ancestral)
        for i in range(plan.num_steps):
            if blend is not None:
                latents = blend(i, latents)
            lat_in = sched.scale_model_input(plan, torch.cat([latents, latents], dim=0), i)
            t = torch.full((2 * n,), int(plan.timesteps[i]), dtype=torch.int64, device=self.device)
            eps = unet(lat_in, t, text_emb, *added)
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
        *,
        share: T.Optional[T.Tuple[int, int]] = None,
        unet: T.Optional[torch.nn.Module] = None,
        routed_batch: T.Optional[int] = None,
        strength: T.Optional[float] = None,
        name: str = "riffuse_batch",
    ) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
        """N requests as one program on the device: the (N, H, W, 3) uint8
        images and, with `fused_params`, the (N, C, L) int16 waveforms. The
        host part (`_riffuse_call`) and then the device program through the
        store (`_run_program`); `name` is the key's ("riffuse" for a single
        request's call, as the JAX package keys its `_riffuse_program`)."""
        with tracing.span("riffusion.prepare"):
            program = self._riffuse_call(
                inputs_list, init_images, mask_image, use_reweighting, fused_params, noises,
                scheduler, share=share, unet=unet, routed_batch=routed_batch, strength=strength,
                name=name,
            )
        return self._run_program(program)

    def _riffuse_call(
        self,
        inputs_list: T.Sequence[InferenceInput],
        init_images: T.Sequence[Image.Image],
        mask_image: T.Optional[Image.Image],
        use_reweighting: bool,
        fused_params: T.Optional[SpectrogramParams],
        noises: T.Optional[T.Sequence[NoiseSource]],
        scheduler: T.Optional[str],
        *,
        share: T.Optional[T.Tuple[int, int]] = None,
        unet: T.Optional[torch.nn.Module] = None,
        routed_batch: T.Optional[int] = None,
        strength: T.Optional[float] = None,
        name: str = "riffuse_batch",
    ) -> _Program:
        """The host part of N riffuse requests, as JAX's `_build_call`: the
        plan, the text embeddings, the image and the mask, the guidance and
        slerp weights, and every noise draw; and the device program
        (`_riffuse_device`) that takes them. `init_images` holds one shared
        seed image (encoded once) or one per request; one mask applies to
        every request. Request i draws its noise from noises[i] with the
        single request's names and shapes, so its result does not depend on
        its batch position, nor on whether its program was captured or
        replayed.

        With `share` (start, stop), only those requests run (a rank's share
        of a data-parallel batch), as they would in the whole batch: the
        start step comes from the whole batch's strengths, the text is
        padded to its longest prompt (its length from the tokenizer: only
        the share's text is encoded), and the attention sites route at its
        UNet batch, 2N. `unet` replaces the pipeline's UNet;
        `routed_batch` the UNet batch the sites route at, and `strength`
        the batch's denoising strength (FrameSweep passes both). A call
        with any of these four (the parallel/ paths) has no key: it runs
        eagerly, as the JAX package sends those paths to a plain jit."""
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
        scheduler_name = scheduler or self.bundle.scheduler_name
        num_steps = steps.pop()
        batch_strength = float(np.mean(strengths)) if strength is None else strength
        plan, noise_timestep = self._plan(scheduler_name, num_steps, batch_strength)
        dev = self.device
        if noises is not None and len(noises) != n:
            raise ValueError(f"need one noise source per request: {len(noises)} for {n}")
        start, stop = share if share is not None else (0, n)
        rows = slice(start, stop)
        with tracing.span("riffusion.text"):
            seq = max(self._embedding_length(inp, use_reweighting) for inp in inputs_list)
            inputs_list = inputs_list[rows]
            pairs = [self._embedding_pair(inp, use_reweighting) for inp in inputs_list]
            pooled = ([self._pooled_pair(inp) for inp in inputs_list]
                      if self.text_encoder_2 is not None else None)
        per_item_image = len(init_images) > 1
        if per_item_image:
            init_images = init_images[rows]
        if noises is None:
            noises = [GeneratorNoise(inp.start.seed, inp.end.seed, dev) for inp in inputs_list]
        else:
            noises = noises[rows]
        routed = 2 * n if routed_batch is None else routed_batch
        n = len(inputs_list)
        alphas = [float(inp.alpha) for inp in inputs_list]
        guidance = torch.tensor(
            [inp.start.guidance * (1.0 - a) + inp.end.guidance * a
             for inp, a in zip(inputs_list, alphas)],
            dtype=torch.float32, device=dev,
        ).view(n, 1, 1, 1)
        # slerp's (t, 1 - t) per request, the difference taken in float64 as
        # a Python float's is
        weights = torch.tensor([[a, 1.0 - a] for a in alphas], dtype=torch.float32, device=dev)
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

        text_embeds = time_ids = None
        if pooled is not None:  # SDXL: original and target size the image's, no crop
            text_embeds = torch.cat([u for u, _ in pooled] + [c for _, c in pooled])
            time_ids = torch.tensor([[height, width, 0, 0, height, width]] * (2 * n),
                                    dtype=torch.float32, device=dev)

        shape = self._latent_shape(height, width)
        vae_eps, noise_a, noise_b = (torch.cat([nz(draw, shape, dev) for nz in noises])
                                     for draw in ("vae_eps", "noise_a", "noise_b"))
        ancestral = None
        if sched.draws_noise(plan):
            ancestral = torch.cat(
                [nz(ANCESTRAL, (plan.num_steps,) + shape, dev) for nz in noises], dim=1
            )
        gl_real, gl_imag = self._phase_draws(fused_params, width, noises)
        key = None
        if share is None and unet is None and routed_batch is None and strength is None:
            t_start = img2img_start(num_steps, batch_strength, self.noise_config)[0]
            config = (scheduler_name, num_steps, t_start, noise_timestep, f"{height}x{width}",
                      f"L{seq}")
            key = (_aot_key("riffuse", *config, f"m{int(mask is not None)}",
                            repr(fused_params), _NUM_GL_ITERS) if name == "riffuse" else
                   _aot_key("riffuse_batch", *config, f"b{n}", repr(fused_params),
                            f"p{int(per_item_image)}", f"m{int(mask is not None)}"))
        program = functools.partial(RiffusionPipeline._riffuse_device, weakref.proxy(self),
                                    plan, noise_timestep, fused_params, routed, unet)
        return _Program(key, program, (text_emb, image, mask, guidance, weights, vae_eps,
                                       noise_a, noise_b, ancestral, gl_real, gl_imag,
                                       text_embeds, time_ids))

    def _riffuse_device(
        self, plan: sched.SchedulerPlan, noise_timestep: int,
        fused_params: T.Optional[SpectrogramParams], routed_batch: int,
        unet: T.Optional[torch.nn.Module], text_emb: torch.Tensor, image: torch.Tensor,
        mask: T.Optional[torch.Tensor], guidance: torch.Tensor, weights: torch.Tensor,
        vae_eps: torch.Tensor, noise_a: torch.Tensor, noise_b: torch.Tensor,
        ancestral: T.Optional[torch.Tensor], gl_real: T.Optional[torch.Tensor],
        gl_imag: T.Optional[torch.Tensor], text_embeds: T.Optional[torch.Tensor] = None,
        time_ids: T.Optional[torch.Tensor] = None,
    ) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
        """The device program of N riffuse requests, a pure function of its
        tensors: VAE encode, the seed noises' slerp, noising, the denoise
        loop, the VAE decode and the audio tail. Its Python arguments (the
        plan, the noising timestep, the spectrogram parameters, the routed
        batch, a replacement UNet) come from the call's key. SDXL's added
        conditions (`text_embeds`, `time_ids`) are None for SD v1."""
        scale = self.bundle.vae_config.scaling_factor
        with tracing.stage("riffusion.vae_encode"):
            mean, logvar = self.vae.encode_moments(image)
            init_latents = (scale * self.vae.sample(mean, logvar, vae_eps)).to(torch.float32)
        seed_noise = torch.cat([
            torch_util.slerp(weights[i, 0], noise_a[i:i + 1], noise_b[i:i + 1],
                             one_minus_t=weights[i, 1])
            for i in range(weights.shape[0])
        ])
        if plan.name in sched.SIGMA_BASED:
            # the k-diffusion samplers start at x0 + sigma_0 * eps
            latents = sched.add_noise_sigma(plan, init_latents, seed_noise, 0)
        else:
            latents = sched.add_noise(self.noise_config, init_latents, seed_noise, noise_timestep)
        with tracing.stage("riffusion.denoise"), attention_ops.route_batch(routed_batch):
            latents = self._denoise(
                plan, latents, text_emb, guidance, mask, init_latents, seed_noise, ancestral,
                unet=unet, added=() if text_embeds is None else (text_embeds, time_ids),
            )
        return self._decode_and_audio(latents, fused_params, gl_real, gl_imag)

    def _latent_shape(self, height: int, width: int) -> T.Tuple[int, int, int, int]:
        """One request's latent shape for an image of height x width."""
        cfg = self.bundle.vae_config
        factor = 2 ** (len(cfg.block_out_channels) - 1)
        return (1, cfg.latent_channels, height // factor, width // factor)

    def _phase_draws(
        self, fused_params: T.Optional[SpectrogramParams], width: int,
        noises: T.Sequence[NoiseSource],
    ) -> T.Tuple[T.Optional[torch.Tensor], T.Optional[torch.Tensor]]:
        """Each request's Griffin-Lim phase, "gl_real" and "gl_imag" of
        (C, n_active, width), concatenated over the requests (None, None
        without audio)."""
        if fused_params is None:
            return None, None
        shape = (2 if fused_params.stereo else 1, self.converter(fused_params).n_active, width)
        return tuple(torch.cat([nz(draw, shape, self.device) for nz in noises])
                     for draw in ("gl_real", "gl_imag"))

    def _decode_and_audio(
        self, latents: torch.Tensor, fused_params: T.Optional[SpectrogramParams],
        gl_real: T.Optional[torch.Tensor], gl_imag: T.Optional[torch.Tensor],
    ) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
        """The tail every generating program shares: the VAE decode of N
        latents to (N, H, W, 3) uint8 images and, with `fused_params`, the
        codec -> inverse mel -> Griffin-Lim -> int16 waveforms (N, C, L)
        from the drawn phase (`_phase_draws`)."""
        n = latents.shape[0]
        with tracing.stage("riffusion.vae_decode"):
            decoded = self.vae.decode(latents / self.bundle.vae_config.scaling_factor)
            images_u8 = torch.stack(
                [codec.image_u8_from_vae_output(decoded[i:i + 1]) for i in range(n)]
            )
        if fused_params is None:
            return images_u8, None

        with tracing.stage("riffusion.audio"):
            converter = self.converter(fused_params)
            codes = torch.cat(
                [codec.codes_from_rgb_image(im, stereo=fused_params.stereo) for im in images_u8]
            )
            mel_amps = codec.spectrogram_from_codes(
                codes, fused_params.power_for_image, max_value=30e6
            )  # (N * C, F, T): Griffin-Lim treats every row alike
            channels = mel_amps.shape[0] // n
            waveforms = converter.waveform_from_mel_amplitudes(
                mel_amps, init_real=gl_real, init_imag=gl_imag)
            return images_u8, _waveform_to_int16(waveforms.view(n, channels, -1))

    def _run_program(self, program: _Program) -> T.Any:
        """A device program through the store (aot.py): captured on its key's
        first call and replayed after, on the card with the store on; run
        eagerly on the CPU, without a key, or under RIFFUSION_TPU_NO_AOT=1."""
        if program.key is None or not aot.captures(self.device):
            return aot.eager(program.fn)(*program.args)
        return self.graph_store.program(program.key, program.fn)(*program.args)

    def _dispatch(
        self, *args, **kwargs
    ) -> T.Callable[[], T.Tuple[np.ndarray, T.Optional[np.ndarray]]]:
        """`_dispatch_program` of `_generate(*args, **kwargs)`."""
        return self._dispatch_program(self._generate, *args, **kwargs)

    @torch.inference_mode()
    def _dispatch_program(
        self, program: T.Callable, *args, **kwargs
    ) -> T.Callable[[], T.Tuple[np.ndarray, T.Optional[np.ndarray]]]:
        """Queue `program(*args)` (a host part and its device program) on
        the device and the copies of its results (images, waveforms or None)
        to the host; return a function that waits for the copies.

        On CUDA the copies go into pinned host memory behind an event, so
        the waiting function (the DynamicBatcher calls it from its finalizer
        thread) blocks on this batch only, not on work queued after it on
        the device's stream; it waits under aot.CAPTURE_LOCK, so that it
        never synchronises while a graph is being captured.

        Threads take turns here: a server thread's /run_inference_batch/
        and the batcher's worker never queue two programs at once, so the
        device holds one program's memory at a time, the kernel counters
        (ops.kernels.COUNTS) count one program's launches together, and
        the store's graphs, which share one memory pool, replay one at a
        time with their outputs copied out before the next (aot.py)."""
        with self._dispatch_lock:
            outputs = program(*args, **kwargs)
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
            with tracing.span("riffusion.readback"), aot.CAPTURE_LOCK:
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
            None if noise is None else [noise], scheduler, name="riffuse",
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
        through PIL on its way to Griffin-Lim. A batch of one, under the
        single request's key ("riffuse", as JAX's `_riffuse_program`)."""
        params = params or SpectrogramParams()
        with tracing.span("riffusion.call"):
            images_np, waveforms_np = self._dispatch(
                [inputs], [init_image], mask_image, use_reweighting, params,
                None if noise is None else [noise], scheduler, name="riffuse",
            )()
            return self._results(images_np, waveforms_np, params, apply_filters)[0]

    def riffuse_audio_batch(
        self,
        inputs_list: T.Sequence[InferenceInput],
        init_image: T.Union[Image.Image, T.Sequence[Image.Image]],
        params: T.Optional[SpectrogramParams] = None,
        use_reweighting: bool = True,
        apply_filters: bool = True,
        mesh: T.Optional[T.Any] = None,
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

        With `mesh` (a parallel.mesh DeviceMesh with a "data" axis) the
        batch is data-parallel: every rank of the mesh calls this with the
        same arguments, runs its contiguous share of the requests (ranks
        that share a data index run the same share) with each request's own
        noise source, and the images and waveforms are gathered over the
        "data" axis, so every rank returns all N results, as the JAX
        package's single controller does. N must be a multiple of the
        "data" axis (ValueError otherwise).

        With async_dispatch=True the work is queued and a zero-argument
        `finalize` is returned that waits for this batch's results (and,
        with a mesh, gathers them: every rank must call it) and builds
        them, so a caller can queue the next batch first."""
        params = params or SpectrogramParams()
        images = [init_image] if isinstance(init_image, Image.Image) else list(init_image)
        if len(images) not in (1, len(inputs_list)):
            raise ValueError(f"need one init image or {len(inputs_list)}, got {len(images)}")
        share = None
        if mesh is not None:
            from riffusion_tpu_torch.parallel import mesh as mesh_mod

            self._check_mesh(mesh)
            share = mesh_mod.data_share(mesh, len(inputs_list))
        with tracing.span("riffusion.call"):
            wait = self._dispatch(
                inputs_list, images, mask_image, use_reweighting, params, noises, scheduler,
                share=share,
            )

            def finalize() -> T.List[T.Tuple[Image.Image, AudioSegment]]:
                images_np, waveforms_np = wait()
                if mesh is not None:
                    images_np, waveforms_np = (
                        mesh_mod.gather_rows(torch.from_numpy(x).to(self.device), mesh)
                        .cpu().numpy() for x in (images_np, waveforms_np)
                    )
                return self._results(images_np, waveforms_np, params, apply_filters)

            return finalize if async_dispatch else finalize()

    def _check_mesh(self, mesh: T.Any) -> None:
        """A mesh's collectives run on the pipeline's device type."""
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot serve a pipeline on "
                             f"{self.device}")

    @staticmethod
    def _results(
        images_np: np.ndarray, waveforms_np: np.ndarray, params: SpectrogramParams,
        apply_filters: bool,
    ) -> T.List[T.Tuple[Image.Image, AudioSegment]]:
        """(PIL image, AudioSegment) per row of a program's uint8 images and
        int16 (N, C, L) waveforms, the filters applied on request."""
        results = []
        with tracing.span("riffusion.finish"):
            for image_np, waveform_np in zip(images_np, waveforms_np):
                segment = AudioSegment(waveform_np.T, params.sample_rate)
                if apply_filters:
                    segment = audio_util.apply_filters(segment, compression=False)
                results.append((Image.fromarray(image_np, mode="RGB"), segment))
        return results

    # --------------------------------------------------------- txt2img/img2img

    def _txt2img_program(
        self, prompts: T.Sequence[str], negative_prompts: T.Sequence[T.Optional[str]],
        guidances: T.Sequence[float], num_steps: int, width: int, height: int, scheduler: str,
        fused_params: T.Optional[SpectrogramParams], noises: T.Sequence[NoiseSource],
        name: str = "txt2img_batch",
    ) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
        """N text-to-image generations as one program on the device: each
        weighted prompt against its negative one, the UNet at batch 2N with
        per-item guidance; the (N, H, W, 3) uint8 images and, with
        `fused_params`, the (N, C, L) int16 waveforms. Request i draws
        "latents" (and euler_a's "ancestral", and the phase) from noises[i]
        with a single request's shapes. The host part here, the device
        program (`_txt2img_device`) through the store under JAX's key:
        "txt2img" for `txt2img`'s single image, else "txt2img_batch"."""
        n = len(prompts)
        plan = sched.make_plan(scheduler, num_steps, 0, self.noise_config)
        dev = self.device
        with tracing.span("riffusion.text"):
            conds = [self.embed_text_weighted(p) for p in prompts]
            seq = max(c.shape[1] for c in conds)
            conds = [self._pad_seq(c, seq) for c in conds]
            unconds = [self._uncond_embedding(neg, seq).to(conds[0].dtype)
                       for neg in negative_prompts]
            text_emb = torch.cat(unconds + conds, dim=0)
        shape = (1, self.unet.cfg.in_channels, height // 8, width // 8)
        latents = torch.cat([nz(LATENTS, shape, dev) for nz in noises])
        ancestral = None
        if sched.draws_noise(plan):
            ancestral = torch.cat([nz(ANCESTRAL, (plan.num_steps,) + shape, dev) for nz in noises],
                                  dim=1)
        guidance = torch.tensor([float(g) for g in guidances], dtype=torch.float32,
                                device=dev).view(n, 1, 1, 1)
        gl_real, gl_imag = self._phase_draws(fused_params, width, noises)
        config = (scheduler, num_steps, f"{height}x{width}", f"L{seq}")
        key = (_aot_key("txt2img", *config) if name == "txt2img" else
               _aot_key("txt2img_batch", *config, f"b{n}", repr(fused_params)))
        program = functools.partial(RiffusionPipeline._txt2img_device, weakref.proxy(self),
                                    plan, fused_params)
        return self._run_program(_Program(key, program, (text_emb, latents, guidance,
                                                         ancestral, gl_real, gl_imag)))

    def _txt2img_device(
        self, plan: sched.SchedulerPlan, fused_params: T.Optional[SpectrogramParams],
        text_emb: torch.Tensor, latents: torch.Tensor, guidance: torch.Tensor,
        ancestral: T.Optional[torch.Tensor], gl_real: T.Optional[torch.Tensor],
        gl_imag: T.Optional[torch.Tensor],
    ) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
        """The device program of N text-to-image generations: the drawn
        latents at the plan's init_noise_sigma, the denoise loop, the VAE
        decode and the audio tail."""
        latents = latents.to(torch.float32) * plan.init_noise_sigma
        with tracing.stage("riffusion.denoise"):
            latents = self._denoise(plan, latents, text_emb, guidance, None, None, None, ancestral)
        return self._decode_and_audio(latents, fused_params, gl_real, gl_imag)

    def txt2img_audio_batch(
        self,
        prompts: T.Sequence[str],
        negative_prompts: T.Optional[T.Sequence[T.Optional[str]]] = None,
        seeds: T.Optional[T.Sequence[int]] = None,
        num_inference_steps: int = 30,
        guidances: T.Optional[T.Sequence[float]] = None,
        width: int = 512,
        height: int = 512,
        scheduler: T.Optional[str] = None,
        params: T.Optional[SpectrogramParams] = None,
        apply_filters: bool = True,
        *,
        noises: T.Optional[T.Sequence[NoiseSource]] = None,
    ) -> T.List[T.Tuple[Image.Image, T.Optional[AudioSegment]]]:
        """N text-to-audio generations as one program (the UNet at batch
        2N): images, and with `params` the audio through the fused codec ->
        inverse mel -> Griffin-Lim tail; with `params=None` only images (the
        audio slot is None). Seeds default to 42, 43, ...; guidances to 7.
        `noises` gives each request its noise source (default:
        GeneratorNoise of its seed), so request i of a batch is prompt i
        alone."""
        n = len(prompts)
        negative_prompts = list(negative_prompts) if negative_prompts is not None else [None] * n
        seeds = list(seeds) if seeds is not None else list(range(42, 42 + n))
        guidances = list(guidances) if guidances is not None else [7.0] * n
        if not (len(negative_prompts) == len(seeds) == len(guidances) == n):
            raise ValueError("need one negative prompt, seed and guidance per prompt")
        if noises is None:
            noises = [GeneratorNoise(s, s, self.device) for s in seeds]
        if len(noises) != n:
            raise ValueError(f"need one noise source per prompt: {len(noises)} for {n}")
        return self._txt2img_results(prompts, negative_prompts, guidances, num_inference_steps,
                                     width, height, scheduler, params, apply_filters, noises,
                                     "txt2img_batch")

    def _txt2img_results(
        self, prompts: T.Sequence[str], negative_prompts: T.Sequence[T.Optional[str]],
        guidances: T.Sequence[float], num_steps: int, width: int, height: int,
        scheduler: T.Optional[str], params: T.Optional[SpectrogramParams], apply_filters: bool,
        noises: T.Sequence[NoiseSource], name: str,
    ) -> T.List[T.Tuple[Image.Image, T.Optional[AudioSegment]]]:
        images_np, waveforms_np = self._dispatch_program(
            self._txt2img_program, prompts, negative_prompts, guidances, num_steps,
            width, height, scheduler or self.bundle.scheduler_name, params, noises, name,
        )()
        if waveforms_np is None:
            return [(Image.fromarray(im, mode="RGB"), None) for im in images_np]
        return self._results(images_np, waveforms_np, params, apply_filters)

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
        by default GeneratorNoise of `seed`. A batch of one, without audio,
        under JAX's "txt2img" key."""
        noise = noise or GeneratorNoise(seed, seed, self.device)
        return self._txt2img_results(
            [prompt], [negative_prompt], [guidance], num_inference_steps, width, height,
            scheduler, None, False, [noise], "txt2img",
        )[0][0]

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

    # ------------------------------------------------------------- magic mix

    def _magic_mix_program(
        self, prompt: str, init_image: Image.Image, num_steps: int, guidance: float,
        scheduler: str, t_start: int, noise_timestep: int, kmin_t: int, mix_factor: float,
        noise: NoiseSource,
    ) -> T.Tuple[torch.Tensor, None]:
        """One MagicMix program: the (1, H, W, 3) uint8 image on the device.
        The host part here, the device program (`_magic_mix_device`) through
        the store under JAX's "magic_mix" key."""
        plan = sched.make_plan(scheduler, num_steps, t_start, self.noise_config)
        dev = self.device
        with tracing.span("riffusion.text"):
            cond = self.embed_text_weighted(prompt)
            uncond = self._uncond_embedding(None, cond.shape[1]).to(cond.dtype)
            text_emb = torch.cat([uncond, cond], dim=0)
        image = torch.from_numpy(preprocess_image(init_image)).to(dev).permute(0, 3, 1, 2)
        height, width = image.shape[2], image.shape[3]
        shape = self._latent_shape(height, width)
        vae_eps, q_noise = noise("vae_eps", shape, dev), noise(MIX_NOISE, shape, dev)
        ancestral = noise(ANCESTRAL, (plan.num_steps,) + shape, dev) \
            if sched.draws_noise(plan) else None
        g = torch.full((1, 1, 1, 1), float(guidance), dtype=torch.float32, device=dev)
        key = _aot_key("magic_mix", scheduler, num_steps, t_start, noise_timestep,
                       f"{height}x{width}", f"L{text_emb.shape[1]}", kmin_t, mix_factor)
        program = functools.partial(RiffusionPipeline._magic_mix_device, weakref.proxy(self),
                                    plan, noise_timestep, kmin_t, mix_factor)
        return self._run_program(_Program(key, program, (text_emb, image, g, vae_eps, q_noise,
                                                         ancestral)))

    def _magic_mix_device(
        self, plan: sched.SchedulerPlan, noise_timestep: int, kmin_t: int, mix_factor: float,
        text_emb: torch.Tensor, image: torch.Tensor, guidance: torch.Tensor,
        vae_eps: torch.Tensor, q_noise: torch.Tensor, ancestral: T.Optional[torch.Tensor],
    ) -> T.Tuple[torch.Tensor, None]:
        """The device program of one MagicMix request: the original's
        latent, its noising at the start, and the denoise loop with the
        q-sampled original blended in while t > kmin."""
        with tracing.stage("riffusion.vae_encode"):
            mean, logvar = self.vae.encode_moments(image)
            orig = self.bundle.vae_config.scaling_factor * self.vae.sample(mean, logvar, vae_eps)
            orig = orig.to(torch.float32)
        if plan.name in sched.SIGMA_BASED:
            latents = sched.add_noise_sigma(plan, orig, q_noise, 0)
        else:
            latents = sched.add_noise(self.noise_config, orig, q_noise, noise_timestep)

        def blend(i: int, lat: torch.Tensor) -> torch.Tensor:
            # layout from the image while t > kmin: the q-sampled original,
            # from the program's own tensors and the plan's Python floats
            if int(plan.timesteps[i]) <= kmin_t:
                return lat
            q_sampled = sched.add_noise_at_index(plan, self.noise_config, orig, q_noise, i)
            return q_sampled * (1.0 - mix_factor) + lat * mix_factor

        with tracing.stage("riffusion.denoise"):
            latents = self._denoise(plan, latents, text_emb, guidance, None, None, None, ancestral,
                                    blend=blend)
        return self._decode_and_audio(latents, None, None, None)

    def img2img_magic_mix(
        self,
        prompt: str,
        init_image: Image.Image,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.0,
        seed: int = 42,
        kmin: float = 0.3,
        kmax: float = 0.5,
        mix_factor: float = 0.5,
        scheduler: T.Optional[str] = None,
        *,
        noise: T.Optional[NoiseSource] = None,
    ) -> Image.Image:
        """MagicMix (Liew et al. 2022): the layout from the image, the
        semantics from the prompt. The trajectory starts at the first plan
        position whose timestep is <= kmax * 1000 (searched in the space
        that position slices, schedulers.slice_anchor_timesteps), from the
        original's latent noised there; while a step's timestep is above
        kmin * 1000 the q-sampled original is blended in with weight
        1 - mix_factor. CFG at UNet batch 2. `noise` draws "vae_eps",
        "noise" (the q-sample noise) and euler_a's "ancestral"; by default
        GeneratorNoise of `seed`."""
        scheduler = scheduler or self.bundle.scheduler_name
        t_start, noise_timestep, kmin_t = self._magic_mix_start(
            scheduler, num_inference_steps, kmin, kmax)
        noise = noise or GeneratorNoise(seed, seed, self.device)
        images, _ = self._dispatch_program(
            self._magic_mix_program, prompt, init_image, num_inference_steps, guidance_scale,
            scheduler, t_start, noise_timestep, kmin_t, float(mix_factor), noise,
        )()
        return Image.fromarray(images[0], mode="RGB")

    def _magic_mix_start(
        self, scheduler: str, num_steps: int, kmin: float, kmax: float
    ) -> T.Tuple[int, int, int]:
        """(t_start, the timestep the start noise is at, kmin's timestep):
        the first plan position whose timestep is <= kmax * 1000, searched in
        the space that t_start slices."""
        n_train = self.noise_config.num_train_timesteps
        kmin_t, kmax_t = int(kmin * n_train), int(kmax * n_train)
        ts = sched.slice_anchor_timesteps(scheduler, num_steps, self.noise_config)
        t_start = int(np.argmax(ts <= kmax_t)) if np.any(ts <= kmax_t) else len(ts) - 1
        return t_start, int(ts[t_start]), kmin_t

    # ------------------------------------------------------------ warm start

    def warmstart_report(
        self,
        inputs: InferenceInput,
        init_image: Image.Image,
        params: T.Optional[SpectrogramParams] = None,
    ) -> T.Dict[str, T.Any]:
        """A first request timed by stage, for restart diagnostics:

        - host_prep_s: the request's host part (`_riffuse_call`: the text
          encode, whose disk-cache hits and misses are `embed_cache_hits` /
          `embed_cache_misses`, the plan, the image and the noise draws);
        - weights_ready_s: a synchronised read of one element of the
          largest UNet and VAE tensors;
        - kernel_build_s: what ops/kernels.py's loader spent on the
          forward kernels (nvcc, or loading an earlier build), with
          kernel_source "built" or "cached" by whether csrc/build/ already
          held them ("none" on the CPU, which runs no kernel);
        - source, warmup_s, capture_s: how the request's CUDA graph was
          obtained (aot.GraphProgram.stage_report): "captured" now (its
          warm-up run and its capture) or "replayed" (captured earlier:
          both 0); "eager" with both 0 on the CPU or with the store off;
        - trace_lower_s, compile_s, aot_load_s: JAX's names for the same
          stages, so that a caller written against JAX's report reads this
          one: the warm-up's seconds, the capture's, and 0.0 (a restart
          cannot load a graph from disk, aot.py);
        - execute_s: the request through readback (a replay on the card)."""
        from riffusion_tpu_torch.ops import kernels

        params = params or SpectrogramParams()
        report: T.Dict[str, T.Any] = {}
        disk = self._embed_disk_cached
        hits, misses = disk.hits, disk.misses
        t0 = time.perf_counter()
        with torch.inference_mode():
            program = self._riffuse_call([inputs], [init_image], None, True, params, None, None,
                                         name="riffuse")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        report["host_prep_s"] = time.perf_counter() - t0
        report["embed_cache_hits"] = disk.hits - hits
        report["embed_cache_misses"] = disk.misses - misses

        t0 = time.perf_counter()
        for module in (self.unet, self.vae):
            largest = max(module.parameters(), key=lambda p: p.numel())
            float(largest.detach().reshape(-1)[0])
        report["weights_ready_s"] = time.perf_counter() - t0

        if self.device.type == "cuda":
            names = kernels.FORWARD_KERNELS
            cached = kernels.built_on_disk(names)
            t0 = time.perf_counter()
            kernels.build_kernels(names)
            report["kernel_build_s"] = time.perf_counter() - t0
            report["kernel_source"] = "cached" if cached else "built"
        else:
            report["kernel_build_s"] = 0.0
            report["kernel_source"] = "none"

        if aot.captures(self.device):
            with self._dispatch_lock, torch.inference_mode():
                stage = self.graph_store.program(program.key, program.fn).stage_report(
                    *program.args)
            report.update(source=stage["source"], warmup_s=stage["warmup_s"],
                          capture_s=stage["capture_s"])
        else:
            report.update(source="eager", warmup_s=0.0, capture_s=0.0)
        report.update(trace_lower_s=report["warmup_s"], compile_s=report["capture_s"],
                      aot_load_s=0.0)

        t0 = time.perf_counter()
        self.riffuse_audio(inputs, init_image, params=params)
        report["execute_s"] = time.perf_counter() - t0
        return report


def img2img_start(
    num_steps: int, strength: float, noise_config: sched.NoiseConfig = sched.NoiseConfig(),
) -> T.Tuple[int, int]:
    """(t_start, init_timestep) of an img2img run: the plan position it
    starts at, and how many steps from the end its start noise sits."""
    offset = noise_config.steps_offset
    init_timestep = min(int(num_steps * strength) + offset, num_steps)
    return max(num_steps - init_timestep + offset, 0), init_timestep


def img2img_plan(
    scheduler_name: str, num_steps: int, strength: float,
    noise_config: sched.NoiseConfig = sched.NoiseConfig(),
) -> T.Tuple[sched.SchedulerPlan, int]:
    """The img2img plan for a denoising strength, and the DDPM timestep
    that PNDM's start noising uses."""
    t_start, init_timestep = img2img_start(num_steps, strength, noise_config)
    full_plan = sched.make_plan(scheduler_name, num_steps, 0, noise_config)
    noise_timestep = int(full_plan.timesteps[-init_timestep])
    return sched.make_plan(scheduler_name, num_steps, t_start, noise_config), noise_timestep


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
