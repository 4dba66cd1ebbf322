"""
Command line tools of the port, with the JAX package's commands and flags
(riffusion_tpu/cli.py, itself the reference's riffusion/cli.py surface on
argparse). Every flag comes from a command function's keyword arguments, as
the JAX package builds them; `--device` defaults to `cuda`, and the CPU is
used only when asked for (`--device cpu`).

    python -m riffusion_tpu_torch.cli text-to-audio --prompt "church bells" \\
        --audio out.wav --image out.png --checkpoint DIR
    python -m riffusion_tpu_torch.cli stream --prompt-start "lofi beat" \\
        --prompt-end "synthwave" --audio stream.wav --num-clips 16 --batch 8 --fast \\
        --checkpoint DIR

Commands:
- DSP: audio-to-image, image-to-audio, print-exif, sample-clips,
  audio-to-images-batch, sample-clips-batch. The spectrogram converters run
  on `--device`; the batch commands read and write files from a thread pool.
- text-to-audio: `txt2img_audio_batch` of one prompt, fused through the
  audio tail.
- stream: a prompt-interpolation walk of `--num-clips` clips through
  `riffuse_audio_batch` in batches of `--batch`, double-buffered (batch k+1
  is queued before batch k is read back), crossfade-stitched into one
  track; prints the realtime factor, timed after one warm-up launch per
  distinct batch size. `--fast` serves at serving.FAST_PRESET.
- finetune: builds the latent dataset when there is none, trains with EMA
  and resume, and exports a checkpoint that loads with
  --checkpoint <output-dir>/export.
"""

from __future__ import annotations

import argparse
import inspect
import os
import random
import time
import typing as T
from multiprocessing.pool import ThreadPool
from pathlib import Path

import numpy as np
from PIL import Image

from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.spectrogram_image_converter import SpectrogramImageConverter
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import image_util


def audio_to_image(
    *,
    audio: str,
    image: str,
    step_size_ms: int = 10,
    num_frequencies: int = 512,
    min_frequency: int = 0,
    max_frequency: int = 10000,
    window_duration_ms: int = 100,
    padded_duration_ms: int = 400,
    power_for_image: float = 0.25,
    stereo: bool = False,
    device: str = "cuda",
) -> None:
    """Compute a spectrogram image from a waveform."""
    segment = AudioSegment.from_file(audio)

    params = SpectrogramParams(
        sample_rate=segment.frame_rate,
        stereo=stereo,
        window_duration_ms=window_duration_ms,
        padded_duration_ms=padded_duration_ms,
        step_size_ms=step_size_ms,
        min_frequency=min_frequency,
        max_frequency=max_frequency,
        num_frequencies=num_frequencies,
        power_for_image=power_for_image,
    )

    converter = SpectrogramImageConverter(params=params, device=device)
    pil_image = converter.spectrogram_image_from_audio(segment)
    pil_image.save(image, exif=pil_image.getexif(), format="PNG")
    print(f"Wrote {image}")


def print_exif(*, image: str) -> None:
    """Print the params of a spectrogram image as saved in the exif data."""
    pil_image = Image.open(image)
    exif_data = image_util.exif_from_image(pil_image)
    for name, value in exif_data.items():
        print(f"{name:<20} = {value:>15}")


def image_to_audio(*, image: str, audio: str, device: str = "cuda") -> None:
    """Reconstruct an audio clip from a spectrogram image."""
    pil_image = Image.open(image)

    img_exif = pil_image.getexif()
    try:
        params = SpectrogramParams.from_exif(exif=img_exif)
    except (KeyError, AttributeError):
        print("WARNING: Could not find spectrogram parameters in exif data. Using defaults.")
        params = SpectrogramParams()

    converter = SpectrogramImageConverter(params=params, device=device)
    segment = converter.audio_from_spectrogram_image(pil_image)

    extension = Path(audio).suffix[1:]
    segment.export(audio, format=extension)
    print(f"Wrote {audio} ({segment.duration_seconds:.2f} seconds)")


def sample_clips(
    *,
    audio: str,
    output_dir: str,
    num_clips: int = 1,
    duration_ms: int = 5120,
    mono: bool = False,
    extension: str = "wav",
    seed: int = -1,
) -> None:
    """Slice an audio file into randomly-placed clips of the given duration."""
    if seed >= 0:
        np.random.seed(seed)

    segment = AudioSegment.from_file(audio)
    if mono:
        segment = segment.set_channels(1)

    output_dir_path = Path(output_dir)
    if not output_dir_path.exists():
        output_dir_path.mkdir(parents=True)

    segment_duration_ms = int(segment.duration_seconds * 1000)
    for i in range(num_clips):
        clip_start_ms = np.random.randint(0, segment_duration_ms - duration_ms)
        clip = segment[clip_start_ms : clip_start_ms + duration_ms]

        clip_name = f"clip_{i}_start_{clip_start_ms}_ms_duration_{duration_ms}_ms.{extension}"
        clip_path = output_dir_path / clip_name
        clip.export(clip_path, format=extension)
        print(f"Wrote {clip_path}")


def _run_pool(fn: T.Callable[[Path], None], paths: T.Sequence[Path],
              num_threads: T.Optional[int]) -> None:
    """`fn` over `paths` from a thread pool, with a count as they finish."""
    with ThreadPool(processes=num_threads) as pool:
        for done, _ in enumerate(pool.imap_unordered(fn, paths), start=1):
            print(f"\r{done}/{len(paths)}", end="", flush=True)
    print()


def audio_to_images_batch(
    *,
    audio_dir: str,
    output_dir: str,
    image_extension: str = "jpg",
    step_size_ms: int = 10,
    num_frequencies: int = 512,
    min_frequency: int = 0,
    max_frequency: int = 10000,
    power_for_image: float = 0.25,
    mono: bool = False,
    sample_rate: int = 44100,
    device: str = "cuda",
    num_threads: T.Optional[int] = None,
    limit: int = -1,
) -> None:
    """Process a directory of audio clips into spectrogram images, multi-threaded."""
    audio_paths = sorted(Path(audio_dir).glob("*"))
    if limit > 0:
        audio_paths = audio_paths[:limit]

    output_path = Path(output_dir)
    output_path.mkdir(parents=True, exist_ok=True)

    params = SpectrogramParams(
        step_size_ms=step_size_ms,
        num_frequencies=num_frequencies,
        min_frequency=min_frequency,
        max_frequency=max_frequency,
        power_for_image=power_for_image,
        stereo=not mono,
        sample_rate=sample_rate,
    )
    converter = SpectrogramImageConverter(params=params, device=device)

    def process_one(audio_path: Path) -> None:
        try:
            segment = AudioSegment.from_file(str(audio_path))
        except Exception:
            return

        if mono and segment.channels != 1:
            segment = segment.set_channels(1)
        elif not mono and segment.channels != 2:
            segment = segment.set_channels(2)

        if segment.frame_rate != params.sample_rate:
            segment = segment.set_frame_rate(params.sample_rate)

        image = converter.spectrogram_image_from_audio(segment)

        image_path = output_path / f"{audio_path.stem}.{image_extension}"
        image_format = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}[image_extension]
        image.save(image_path, exif=image.getexif(), format=image_format)

    _run_pool(process_one, audio_paths, num_threads)


def sample_clips_batch(
    *,
    audio_dir: str,
    output_dir: str,
    num_clips_per_file: int = 1,
    duration_ms: int = 5120,
    mono: bool = False,
    extension: str = "mp3",
    num_threads: T.Optional[int] = None,
    glob: str = "*",
    limit: int = -1,
    seed: int = -1,
) -> None:
    """Sample short clips from a directory of audio files, multi-threaded."""
    audio_paths = sorted(Path(audio_dir).glob(glob))
    audio_paths = [p for p in audio_paths if p.suffix != ".json"]
    if limit > 0:
        audio_paths = audio_paths[:limit]

    output_path = Path(output_dir)
    output_path.mkdir(parents=True, exist_ok=True)

    if seed >= 0:
        random.seed(seed)
        np.random.seed(seed)

    def process_one(audio_path: Path) -> None:
        try:
            segment = AudioSegment.from_file(str(audio_path))
        except Exception:
            return

        if mono:
            segment = segment.set_channels(1)

        segment_duration_ms = int(segment.duration_seconds * 1000)
        for i in range(num_clips_per_file):
            try:
                clip_start_ms = np.random.randint(0, segment_duration_ms - duration_ms)
            except ValueError:
                continue

            clip = segment[clip_start_ms : clip_start_ms + duration_ms]
            clip_name = (
                f"{audio_path.stem}_{i}_"
                f"start_{clip_start_ms}_ms_dur_{duration_ms}_ms.{extension}"
            )
            clip.export(output_path / clip_name, format=extension)

    _run_pool(process_one, audio_paths, num_threads)


def text_to_audio(
    *,
    prompt: str,
    audio: str,
    image: str = "",
    negative_prompt: str = "",
    seed: int = 42,
    num_inference_steps: int = 30,
    guidance: float = 7.0,
    width: int = 512,
    checkpoint: str = "riffusion/riffusion-model-v1",
    device: str = "cuda",
    scheduler: str = "pndm",
) -> None:
    """Generate audio from a text prompt: one batched program produces the
    spectrogram image and the waveform."""
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    pipeline = RiffusionPipeline.load_checkpoint(checkpoint, device=device)
    results = pipeline.txt2img_audio_batch(
        prompts=[prompt],
        negative_prompts=[negative_prompt or None],
        seeds=[seed],
        num_inference_steps=num_inference_steps,
        guidances=[guidance],
        width=width,
        scheduler=scheduler,
        params=SpectrogramParams(),
    )
    img, segment = results[0]
    ext = Path(audio).suffix.lstrip(".") or "wav"
    segment.export(audio, format=ext)
    print(f"Wrote {audio} ({segment.duration_seconds:.2f} s)")
    if image:
        img.save(image, exif=img.getexif(), format="PNG")
        print(f"Wrote {image}")


def stream(
    *,
    prompt_start: str,
    audio: str,
    prompt_end: str = "",
    num_clips: int = 8,
    batch: int = 4,
    num_inference_steps: int = 50,
    denoising: float = 0.75,
    guidance: float = 7.0,
    seed: int = 42,
    seed_image_id: str = "og_beat",
    crossfade_ms: float = 200.0,
    fast: bool = False,
    scheduler: str = "",
    seed_image: str = "",
    num_frequencies: int = 512,
    checkpoint: str = "riffusion/riffusion-model-v1",
    device: str = "cuda",
) -> None:
    """Real-time streaming generation: walk the prompt-interpolation latent
    space in `num_clips` clips, generating batch k+1 on the device while
    batch k is read back and stitched on the host. The clips are crossfaded
    into one track; the realtime factor is timed after one warm-up launch
    per distinct batch size. --fast serves every clip at the serving FAST
    preset (serving.FAST_PRESET)."""
    if num_clips < 1 or batch < 1:
        raise SystemExit("stream: --num-clips and --batch must be >= 1")

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.server import SEED_IMAGES_DIR
    from riffusion_tpu_torch.util import audio_util

    pipeline = RiffusionPipeline.load_checkpoint(checkpoint, device=device)
    params = SpectrogramParams(num_frequencies=num_frequencies)
    seed_path = seed_image or str(Path(SEED_IMAGES_DIR) / f"{seed_image_id}.png")
    init_image = Image.open(seed_path).convert("RGB")

    sched_name: T.Optional[str] = scheduler or None
    steps = num_inference_steps
    if fast:
        from riffusion_tpu_torch.serving import FAST_PRESET

        sched_name = FAST_PRESET["scheduler"]
        steps = FAST_PRESET["steps"]

    end_prompt = prompt_end or prompt_start
    alphas = np.linspace(0.0, 1.0, num_clips) if num_clips > 1 else np.asarray([0.0])
    reqs = [
        InferenceInput(
            start=PromptInput(prompt=prompt_start, seed=seed, denoising=denoising,
                              guidance=guidance),
            end=PromptInput(prompt=end_prompt, seed=seed + 1, denoising=denoising,
                            guidance=guidance),
            alpha=float(a),
            num_inference_steps=steps,
        )
        for a in alphas
    ]
    chunks = [reqs[i:i + batch] for i in range(0, len(reqs), batch)]

    def launch(chunk, async_dispatch=False):
        return pipeline.riffuse_audio_batch(chunk, init_image, params=params,
                                            scheduler=sched_name, async_dispatch=async_dispatch)

    # warm-up before the clock: the kernels' first build and load, and
    # every batch size's first run, are a process's one-time cost
    t_warm = time.perf_counter()
    launch(chunks[0])
    if len(chunks[-1]) != len(chunks[0]):
        launch(chunks[-1])
    warm_s = time.perf_counter() - t_warm

    t0 = time.perf_counter()
    segments: T.List[AudioSegment] = []
    # double-buffer: queue chunk k+1 before finalizing chunk k, so the
    # device computes while the host reads back and stitches
    fin_prev = launch(chunks[0], async_dispatch=True)
    for chunk in chunks[1:]:
        fin_next = launch(chunk, async_dispatch=True)
        segments.extend(seg for _, seg in fin_prev())
        fin_prev = fin_next
    segments.extend(seg for _, seg in fin_prev())
    track = audio_util.stitch_segments(segments, crossfade_s=crossfade_ms / 1000.0)
    wall = time.perf_counter() - t0

    ext = Path(audio).suffix.lstrip(".") or "wav"
    track.export(audio, format=ext)
    rt = track.duration_seconds / wall
    print(
        f"Wrote {audio}: {track.duration_seconds:.2f} s of audio in {wall:.2f} s "
        f"({rt:.2f}x realtime{'' if rt >= 1 else ' — BELOW realtime'}; "
        f"one-time warmup {warm_s:.1f} s)"
    )


def finetune(
    *,
    checkpoint: str,
    output_dir: str,
    audio_dir: str = "",
    dataset_dir: str = "",
    prompt: str = "",
    prompts_json: str = "",
    steps: int = 1000,
    batch_size: int = 4,
    learning_rate: float = 1e-5,
    ema_decay: float = 0.999,
    checkpoint_every: int = 500,
    clip_duration_ms: int = 5120,
    num_frequencies: int = 512,
    seed: int = 0,
    device: str = "cuda",
) -> None:
    """Fine-tune the UNet on a directory of audio, then export it. Under
    torchrun every rank trains its share of a sharded step (run_finetune's
    mesh); rank 0 builds the dataset and reports."""
    import torch.distributed as dist

    from riffusion_tpu_torch.parallel.mesh import backend_for, init_distributed
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.training import FinetuneConfig, build_latent_dataset, run_finetune

    if not audio_dir and not dataset_dir:
        raise SystemExit("finetune: pass --audio-dir and/or --dataset-dir")
    sharded = "RANK" in os.environ and "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if sharded:
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        init_distributed(backend_for(device, ranks_here))
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *args, **kwargs: None)
    try:
        dataset_path = Path(dataset_dir) if dataset_dir else Path(output_dir) / "dataset"
        built = (dataset_path / "meta.json").exists()
        if not built and not audio_dir:
            raise SystemExit(f"no dataset at {dataset_path} and no --audio-dir given")
        if rank0 and not built:
            say(f"Building latent dataset from {audio_dir} into {dataset_path} ...")
            pipeline = RiffusionPipeline.load_checkpoint(checkpoint, device=device)
            meta = build_latent_dataset(
                pipeline,
                audio_dir,
                dataset_path,
                params=SpectrogramParams(num_frequencies=num_frequencies),
                prompts_json=prompts_json or None,
                default_prompt=prompt or None,
                clip_duration_ms=clip_duration_ms,
            )
            say(f"Dataset: {meta.num_clips} clips, {len(meta.prompts)} unique prompts")
            del pipeline  # release device memory before training starts
        if dist.is_initialized():
            dist.barrier()  # the other ranks wait for rank 0's dataset

        stats = run_finetune(
            FinetuneConfig(
                checkpoint=checkpoint,
                dataset_dir=str(dataset_path),
                output_dir=output_dir,
                steps=steps,
                batch_size=batch_size,
                learning_rate=learning_rate,
                ema_decay=ema_decay,
                checkpoint_every=checkpoint_every,
                seed=seed,
                device=device,
            ),
            log=say,
        )
        say(
            f"Fine-tune done: {stats['steps']} steps, loss "
            f"{stats['first_loss']:.5f} -> {stats['final_loss']:.5f}; "
            f"export at {stats['export_dir']}"
        )
    finally:
        if sharded:
            dist.destroy_process_group()


# ----------------------------------------------------------------- dispatch

# the annotations as strings (this module postpones their evaluation)
_FLAG_TYPES = {"bool": bool, "int": int, "T.Optional[int]": int, "float": float}

COMMANDS = [
    text_to_audio,
    audio_to_image,
    image_to_audio,
    sample_clips,
    print_exif,
    audio_to_images_batch,
    sample_clips_batch,
    stream,
    finetune,
]


def _add_command(subparsers: argparse._SubParsersAction, fn) -> None:
    """One subcommand named after `fn`, one flag per keyword argument, typed
    by its annotation: a bool is --x / --no-x, an int (optional or not) or
    a float is parsed as one, the rest are strings; an argument without a
    default is required."""
    name = fn.__name__.replace("_", "-")
    doc = (fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__ else ""
    sub = subparsers.add_parser(name, help=doc, description=doc)
    for pname, param in inspect.signature(fn).parameters.items():
        flag = "--" + pname.replace("_", "-")
        required = param.default is inspect.Parameter.empty
        default = None if required else param.default
        kind = _FLAG_TYPES.get(str(param.annotation), str)
        if kind is bool:
            sub.add_argument(flag, action=argparse.BooleanOptionalAction, default=bool(default))
        else:
            sub.add_argument(flag, type=kind, required=required, default=default)
    sub.set_defaults(_fn=fn)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="riffusion_tpu_torch.cli",
                                     description="riffusion_tpu_torch command line tools")
    subparsers = parser.add_subparsers(dest="command", required=True)
    for fn in COMMANDS:
        _add_command(subparsers, fn)
    return parser


def main(argv: T.Optional[T.Sequence[str]] = None) -> None:
    args = vars(build_parser().parse_args(argv))
    fn = args.pop("_fn")
    args.pop("command", None)
    fn(**args)


if __name__ == "__main__":
    main()
