"""
JSON inference server on the port's pipeline, with the JAX package's HTTP
surface (riffusion_tpu/server.py):

- POST /run_inference/ with an InferenceInput body answers an
  InferenceOutput JSON with data-URI image and audio;
- POST /run_inference_batch/ with {"requests": [InferenceInput, ...]}
  answers {"outputs": [InferenceOutput, ...]}, the requests run as one
  batched program (one seed image, one step count, one mask or none, one
  denoising strength);
- GET /health reports liveness, GET /stats the request and batching
  counters.

Malformed JSON, an input that does not decode, an unknown seed or mask
image id, and a batch that breaks the rules above give 400.

Each POST runs inside a `riffusion.request` span (tracing.py; a new id per
request), with children `riffusion.front.decode` (the body's JSON and
InferenceInput, then the seed and mask images), `riffusion.call` (the
pipeline's, or the wait for the batcher), `riffusion.front.encode` (JPEG,
WAV or MP3, base64 and the response's JSON) and `riffusion.front.send`.

Without --dynamic-batching the server is single-threaded: one request at a
time owns the device. With it, a thread per connection parses and encodes,
and concurrent /run_inference/ requests join a serving.DynamicBatcher, whose
one worker thread runs them; --serving-preset fast (the default) runs them
at the strength-gated FAST preset, parity at each request's own scheduler
and steps. A /run_inference_batch/ request runs on its own HTTP thread; the
pipeline queues one program on the device at a time, so it takes turns with
the batcher's worker.

    python -m riffusion_tpu_torch.server --checkpoint random:full --device cuda \\
        --dynamic-batching --max-batch 16

--checkpoint also takes a local diffusers-layout directory (riffusion-model-v1's
layout; its scheduler config names the default sampler) or a directory
written by either package's save_native (models/weights.py:load_bundle).
--ssl-certificate and --ssl-key (PEM files) serve HTTPS; a certificate
without a key is refused. `run_app` logs to the console and to server.log.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import logging
import ssl
import threading
import time
import typing as T
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from socketserver import ThreadingMixIn

import numpy as np
import PIL.Image

from riffusion_tpu_torch import tracing
from riffusion_tpu_torch.audio.segment import _ffmpeg_path
from riffusion_tpu_torch.datatypes import InferenceInput, InferenceOutput, PromptInput
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.serving import FAST_PRESET, DynamicBatcher
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import base64_util
from riffusion_tpu_torch.util.dataclass_util import DecodeError, from_dict

# Global pipeline (single-model server, as in the JAX package)
PIPELINE: T.Optional[RiffusionPipeline] = None

SEED_IMAGES_DIR = Path(Path(__file__).resolve().parent.parent, "seed_images")

logger = logging.getLogger("riffusion_tpu_torch.server")


def _encode_output(image: PIL.Image.Image, segment) -> dict:
    """Encode one (image, segment) result as an InferenceOutput dict."""
    audio_bytes = io.BytesIO()
    if _ffmpeg_path() is not None:
        segment.export(audio_bytes, format="mp3")
        audio_mime = "audio/mpeg"
    else:
        segment.export(audio_bytes, format="wav")
        audio_mime = "audio/wav"

    image_bytes = io.BytesIO()
    image.save(image_bytes, exif=image.getexif(), format="JPEG")
    image_bytes.seek(0)

    return dataclasses.asdict(InferenceOutput(
        image="data:image/jpeg;base64," + base64_util.encode(image_bytes),
        audio=f"data:{audio_mime};base64," + base64_util.encode(audio_bytes),
        duration_s=segment.duration_seconds,
    ))


def _load_images(
    seed_images_dir: T.Union[str, Path], seed_id: str, mask_id: T.Optional[str]
) -> T.Union[T.Tuple[PIL.Image.Image, T.Optional[PIL.Image.Image], SpectrogramParams],
             T.Tuple[str, int]]:
    """(seed image, mask image or None, spectrogram params), or (error, 400)."""
    init_image_path = Path(seed_images_dir, f"{seed_id}.png")
    if not init_image_path.is_file():
        return f"Invalid seed image: {seed_id}", 400
    init_image = PIL.Image.open(str(init_image_path)).convert("RGB")

    mask_image: T.Optional[PIL.Image.Image] = None
    if mask_id:
        mask_image_path = Path(seed_images_dir, f"{mask_id}.png")
        if not mask_image_path.is_file():
            return f"Invalid mask image: {mask_id}", 400
        mask_image = PIL.Image.open(str(mask_image_path)).convert("RGB")

    # Mel-bin count must equal the generated image height (512 for the
    # standard seed images; derived so smaller test models work too).
    num_frequencies = init_image.height - init_image.height % 32
    params = SpectrogramParams(
        min_frequency=0, max_frequency=10000, num_frequencies=num_frequencies
    )
    return init_image, mask_image, params


def compute_request(
    inputs: InferenceInput,
    pipeline: RiffusionPipeline,
    seed_images_dir: T.Union[str, Path],
    batcher: T.Optional[DynamicBatcher] = None,
) -> T.Union[str, T.Tuple[str, int]]:
    """Run one inference request; returns a JSON string or (error, status).
    With `batcher`, the request joins its coalescing queue."""
    with tracing.span("riffusion.front.decode"):
        loaded = _load_images(seed_images_dir, inputs.seed_image_id, inputs.mask_image_id)
    if len(loaded) == 2:  # (error, status)
        return loaded  # type: ignore[return-value]
    init_image, mask_image, params = loaded
    if batcher is not None:
        with tracing.span("riffusion.call"):
            image, segment = batcher.submit(
                inputs, init_image, mask_image, params,
                seed_image_id=inputs.seed_image_id, mask_image_id=inputs.mask_image_id,
            )
    else:
        image, segment = pipeline.riffuse_audio(
            inputs, init_image=init_image, mask_image=mask_image, params=params,
            apply_filters=True,
        )
    with tracing.span("riffusion.front.encode"):
        return json.dumps(_encode_output(image, segment))


def compute_batch_request(
    inputs_list: T.List[InferenceInput],
    pipeline: RiffusionPipeline,
    seed_images_dir: T.Union[str, Path],
) -> T.Union[str, T.Tuple[str, int]]:
    """Run N requests as one batched program; returns {"outputs": [...]}
    JSON or (error, status). The route has checked that they share one seed
    image, one step count and one mask id."""
    with tracing.span("riffusion.front.decode"):
        loaded = _load_images(
            seed_images_dir, inputs_list[0].seed_image_id, inputs_list[0].mask_image_id
        )
    if len(loaded) == 2:  # (error, status)
        return loaded  # type: ignore[return-value]
    init_image, mask_image, params = loaded
    try:
        results = pipeline.riffuse_audio_batch(
            inputs_list, init_image, params=params, mask_image=mask_image
        )
    except ValueError as exception:  # e.g. mixed denoising strengths
        return str(exception), 400
    with tracing.span("riffusion.front.encode"):
        return json.dumps(
            {"outputs": [_encode_output(image, segment) for image, segment in results]}
        )


class _Handler(BaseHTTPRequestHandler):
    """POST /run_inference/ and /run_inference_batch/, GET /health and
    /stats, OPTIONS for CORS preflight."""

    server_version = "riffusion_tpu_torch"

    def _send(self, status: int, body: bytes, content_type: str = "application/json"):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Headers", "Content-Type")
        self.send_header("Access-Control-Allow-Methods", "POST, OPTIONS")
        self.end_headers()
        self.wfile.write(body)

    def do_OPTIONS(self):  # noqa: N802 - http.server naming
        self._send(204, b"")

    def do_GET(self):  # noqa: N802
        route = self.path.rstrip("/")
        if route == "/health":
            body = {"status": "ok", "model_loaded": PIPELINE is not None}
            self._send(200, json.dumps(body).encode())
        elif route == "/stats":
            with self.server.stats_lock:  # type: ignore[attr-defined]
                stats = dict(self.server.request_stats)  # type: ignore[attr-defined]
            batcher = self.server.batcher  # type: ignore[attr-defined]
            if batcher is not None:
                stats["batching"] = dict(batcher.stats)
            self._send(200, json.dumps(stats).encode())
        else:
            self._send(404, b"Not found", "text/plain")

    def do_POST(self):  # noqa: N802
        route = self.path.rstrip("/")
        if route not in ("/run_inference", "/run_inference_batch"):
            self._send(404, b"Not found", "text/plain")
            return
        with tracing.span("riffusion.request", root=True):
            status, body, content_type = self._post(route)
            with tracing.span("riffusion.front.send"):
                self._send(status, body, content_type)

    def _post(self, route: str) -> T.Tuple[int, bytes, str]:
        """(status, body, content type) of a POST to `route`."""
        start_time = time.time()
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)

        with tracing.span("riffusion.front.decode"):
            try:
                json_data = json.loads(data)
            except json.JSONDecodeError as exception:
                return 400, str(exception).encode(), "text/plain"
            logger.info(json_data)
            if route == "/run_inference":
                try:
                    inputs = from_dict(InferenceInput, json_data)
                except DecodeError as exception:
                    return 400, str(exception).encode(), "text/plain"

        if route == "/run_inference_batch":
            result = self._handle_batch(json_data)
        else:
            result = compute_request(
                inputs=inputs,
                pipeline=PIPELINE,
                seed_images_dir=self.server.seed_images_dir,  # type: ignore[attr-defined]
                batcher=self.server.batcher,  # type: ignore[attr-defined]
            )
        elapsed = time.time() - start_time
        logger.info(f"Request took {elapsed:.2f} s")
        with self.server.stats_lock:  # type: ignore[attr-defined]
            stats = self.server.request_stats  # type: ignore[attr-defined]
            stats["requests"] = stats.get("requests", 0) + 1
            stats["total_seconds"] = round(stats.get("total_seconds", 0.0) + elapsed, 3)

        if isinstance(result, tuple):
            body, status = result
            return status, body.encode(), "text/plain"
        return 200, result.encode(), "application/json"

    def _handle_batch(self, json_data) -> T.Union[str, T.Tuple[str, int]]:
        """{"requests": [InferenceInput, ...]} sharing num_inference_steps,
        seed_image_id, mask_image_id (or none) and denoising strength."""
        if not isinstance(json_data, dict) or "requests" not in json_data:
            return 'expected {"requests": [...]}', 400
        try:
            with tracing.span("riffusion.front.decode"):
                inputs_list = [from_dict(InferenceInput, r) for r in json_data["requests"]]
        except DecodeError as exception:
            return str(exception), 400
        if not inputs_list:
            return "empty batch", 400
        if len({i.seed_image_id for i in inputs_list}) != 1:
            return "batch requires a single seed_image_id", 400
        if len({i.num_inference_steps for i in inputs_list}) != 1:
            return "batch requires a single num_inference_steps", 400
        if len({i.mask_image_id or "" for i in inputs_list}) != 1:
            return "batch requires a single shared mask_image_id (or none)", 400
        return compute_batch_request(
            inputs_list,
            pipeline=PIPELINE,
            seed_images_dir=self.server.seed_images_dir,  # type: ignore[attr-defined]
        )

    def log_message(self, fmt, *args):  # route http.server chatter to logging
        logger.info("%s - %s", self.address_string(), fmt % args)


class RiffusionServer(HTTPServer):
    """HTTPServer carrying the seed-image directory, the batcher (None when
    unbatched) and the request counters (single-threaded)."""

    def __init__(self, addr, seed_images_dir: T.Union[str, Path] = SEED_IMAGES_DIR):
        super().__init__(addr, _Handler)
        self.seed_images_dir = seed_images_dir
        self.batcher: T.Optional[DynamicBatcher] = None
        self.request_stats: T.Dict[str, T.Any] = {}
        self.stats_lock = threading.Lock()  # handler threads under ThreadingMixIn


class RiffusionThreadingServer(ThreadingMixIn, RiffusionServer):
    """Thread-per-connection front for dynamic batching: HTTP threads parse
    and encode, /run_inference/ requests run on the batcher's worker thread,
    and /run_inference_batch/ on its HTTP thread, one program on the device
    at a time (RiffusionPipeline._dispatch)."""

    daemon_threads = True


def _warmup(pipeline: RiffusionPipeline, seed_images_dir: T.Union[str, Path], steps: int,
            batch_sizes: T.Sequence[int], batch_steps: int,
            batch_scheduler: T.Optional[str]) -> None:
    """Run the standard request, and a batch of each size, once: each one's
    program is captured into its CUDA graph (riffusion_tpu_torch/aot.py;
    the warm-up run builds the kernels and sets up cuDNN, cuBLAS and cuFFT),
    so that the first request of each key replays it. The counterpart of
    the JAX server fetching its programs while the model loads."""
    seed_path = Path(seed_images_dir) / "og_beat.png"
    if seed_path.exists():
        init = PIL.Image.open(seed_path).convert("RGB")
    else:
        init = PIL.Image.fromarray(np.full((512, 512, 3), 128, np.uint8), mode="RGB")
    params = SpectrogramParams(
        min_frequency=0, max_frequency=10000, num_frequencies=init.height - init.height % 32
    )

    def request(i: int, num_steps: int) -> InferenceInput:
        return InferenceInput(start=PromptInput(prompt="warmup", seed=i),
                              end=PromptInput(prompt="warmup", seed=100 + i),
                              alpha=0.5, num_inference_steps=num_steps)

    logger.info("warmup: the standard request...")
    pipeline.riffuse_audio(request(0, steps), init_image=init, params=params)
    if batch_sizes:  # the batcher runs a lone request as one riffuse_audio
        logger.info("warmup: a lone request of the batcher's...")
        pipeline.riffuse_audio(request(0, batch_steps), init_image=init, params=params,
                               scheduler=batch_scheduler)
    for size in batch_sizes:
        logger.info(f"warmup: a batch of {size}...")
        pipeline.riffuse_audio_batch([request(i, batch_steps) for i in range(size)], init,
                                     params=params, scheduler=batch_scheduler)
    logger.info("warmup complete")


def create_app(
    *,
    checkpoint: str = "random:full",
    device: str = "cuda",
    host: str = "127.0.0.1",
    port: int = 3013,
    seed_images_dir: T.Union[str, Path] = SEED_IMAGES_DIR,
    scheduler: T.Optional[str] = None,
    no_traced_unet: bool = False,
    warmup: bool = False,
    warmup_steps: int = 50,
    dynamic_batching: bool = False,
    batch_window_ms: float = 150.0,
    max_batch: int = 8,
    serving_preset: str = "fast",
    ssl_certificate: T.Optional[str] = None,
    ssl_key: T.Optional[str] = None,
) -> RiffusionServer:
    """Load the model into PIPELINE and bind the server (port 0 picks a free
    one). `scheduler` replaces the bundle's default (the checkpoint's, or
    "pndm"); with `dynamic_batching`, concurrent requests are coalesced
    (serving.DynamicBatcher), at the strength-gated FAST preset when
    `serving_preset` is "fast" or as each request asks when it is
    "parity". With `ssl_certificate` and `ssl_key` (PEM files) the
    listening socket speaks TLS; a certificate without a key is refused."""
    if ssl_certificate and not ssl_key:
        raise ValueError("--ssl-certificate needs --ssl-key")
    global PIPELINE
    PIPELINE = RiffusionPipeline.load_checkpoint(
        checkpoint=checkpoint, use_traced_unet=not no_traced_unet, device=device,
        scheduler=scheduler,
    )
    fast = serving_preset == "fast"
    if warmup:
        sizes = [s for s in (2, 4, 8, 16) if s <= max_batch] if dynamic_batching else []
        _warmup(PIPELINE, seed_images_dir, warmup_steps, sizes,
                FAST_PRESET["steps"] if fast else warmup_steps,
                FAST_PRESET["scheduler"] if fast else None)

    if dynamic_batching:
        preset_kwargs = (
            dict(scheduler=FAST_PRESET["scheduler"], steps_override=FAST_PRESET["steps"],
                 strength_gated=True)
            if fast else {}
        )
        server: RiffusionServer = RiffusionThreadingServer(
            (host, port), seed_images_dir=seed_images_dir
        )
        server.batcher = DynamicBatcher(
            PIPELINE, max_batch=max_batch, window_ms=batch_window_ms, **preset_kwargs
        )
        logger.info(
            f"dynamic batching on (window {batch_window_ms} ms, max {max_batch}, "
            f"preset {serving_preset})"
        )
    else:
        server = RiffusionServer((host, port), seed_images_dir=seed_images_dir)
    if ssl_certificate:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(ssl_certificate, ssl_key)
        server.socket = ctx.wrap_socket(server.socket, server_side=True)
    return server


def run_app(**kwargs) -> None:
    """`create_app(**kwargs)`, then serve until interrupted, logging to the
    console and to server.log in the working directory."""
    logging.basicConfig(level=logging.INFO)
    logging.getLogger().addHandler(logging.FileHandler("server.log"))
    server = create_app(**kwargs)
    host, port = server.server_address[:2]
    scheme = "https" if kwargs.get("ssl_certificate") else "http"
    logger.info(f"Serving on {scheme}://{host}:{port} (checkpoint={kwargs.get('checkpoint')})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.server_close()
    finally:
        if server.batcher is not None:
            server.batcher.shutdown()


def parse_args(argv: T.Optional[T.Sequence[str]] = None) -> T.Dict[str, T.Any]:
    """The command line as create_app's keyword arguments."""
    parser = argparse.ArgumentParser(description="riffusion_tpu_torch inference server")
    parser.add_argument("--checkpoint", default="random:full",
                        help="'random:full' or 'random:tiny' (random weights), a local "
                             "diffusers-layout directory, or a directory written by either "
                             "package's save_native (a fine-tune's export among them)")
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=3013)
    parser.add_argument("--seed-images-dir", default=str(SEED_IMAGES_DIR))
    parser.add_argument("--scheduler", default=None,
                        help="default sampler (else the checkpoint's), e.g. pndm, ddim, "
                             "lms, euler, euler_a, dpmpp, unipc_k:rho=2")
    parser.add_argument("--no-traced-unet", action="store_true",
                        help="accepted for the reference's command line; no effect")
    parser.add_argument("--warmup", action="store_true",
                        help="capture the standard request's program (and each batch "
                             "size's) into its CUDA graph at startup")
    parser.add_argument("--warmup-steps", type=int, default=50)
    parser.add_argument("--dynamic-batching", action="store_true",
                        help="coalesce concurrent requests into batched programs")
    parser.add_argument("--batch-window-ms", type=float, default=150.0)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--serving-preset", choices=("fast", "parity"), default="fast",
                        help="with --dynamic-batching: 'fast' runs requests at the "
                             "strength-gated FAST preset (serving.FAST_PRESET); "
                             "'parity' honors each request's steps and scheduler")
    parser.add_argument("--ssl-certificate", default=None,
                        help="PEM certificate: serve HTTPS (needs --ssl-key)")
    parser.add_argument("--ssl-key", default=None, help="PEM private key of --ssl-certificate")
    args = parser.parse_args(argv)
    if args.ssl_certificate and not args.ssl_key:
        parser.error("--ssl-certificate needs --ssl-key")
    return dict(
        checkpoint=args.checkpoint,
        device=args.device,
        host=args.host,
        port=args.port,
        seed_images_dir=args.seed_images_dir,
        scheduler=args.scheduler,
        no_traced_unet=args.no_traced_unet,
        warmup=args.warmup,
        warmup_steps=args.warmup_steps,
        dynamic_batching=args.dynamic_batching,
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
        serving_preset=args.serving_preset,
        ssl_certificate=args.ssl_certificate,
        ssl_key=args.ssl_key,
    )


def main(argv: T.Optional[T.Sequence[str]] = None) -> None:
    run_app(**parse_args(argv))


if __name__ == "__main__":
    main()
