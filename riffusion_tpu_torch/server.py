"""
JSON inference server on the port's pipeline: POST /run_inference/ with an
InferenceInput body answers an InferenceOutput JSON with data-URI image and
audio; GET /health reports liveness. Malformed JSON, an input that does not
decode, and an unknown seed or mask image id give 400.

The counterpart of the unbatched path of riffusion_tpu/server.py, on the
stdlib http.server, single-threaded: one request at a time owns the device.
Dynamic batching is not ported yet.

    python -m riffusion_tpu_torch.server --checkpoint random:full --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import logging
import time
import typing as T
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import PIL.Image

from riffusion_tpu.audio.segment import _ffmpeg_path
from riffusion_tpu.datatypes import InferenceInput, InferenceOutput
from riffusion_tpu.spectrogram_params import SpectrogramParams
from riffusion_tpu.util import base64_util
from riffusion_tpu.util.dataclass_util import DecodeError, from_dict
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

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


def compute_request(
    inputs: InferenceInput,
    pipeline: RiffusionPipeline,
    seed_images_dir: T.Union[str, Path],
) -> T.Union[str, T.Tuple[str, int]]:
    """Run one inference request; returns a JSON string or (error, status)."""
    init_image_path = Path(seed_images_dir, f"{inputs.seed_image_id}.png")
    if not init_image_path.is_file():
        return f"Invalid seed image: {inputs.seed_image_id}", 400
    init_image = PIL.Image.open(str(init_image_path)).convert("RGB")

    mask_image: T.Optional[PIL.Image.Image] = None
    if inputs.mask_image_id:
        mask_image_path = Path(seed_images_dir, f"{inputs.mask_image_id}.png")
        if not mask_image_path.is_file():
            return f"Invalid mask image: {inputs.mask_image_id}", 400
        mask_image = PIL.Image.open(str(mask_image_path)).convert("RGB")

    # Mel-bin count must equal the generated image height (512 for the
    # standard seed images; derived so smaller test models work too).
    num_frequencies = init_image.height - init_image.height % 32
    params = SpectrogramParams(
        min_frequency=0, max_frequency=10000, num_frequencies=num_frequencies
    )
    image, segment = pipeline.riffuse_audio(
        inputs, init_image=init_image, mask_image=mask_image, params=params, apply_filters=True
    )
    return json.dumps(_encode_output(image, segment))


class _Handler(BaseHTTPRequestHandler):
    """POST /run_inference/, GET /health, OPTIONS for CORS preflight."""

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
        if self.path.rstrip("/") == "/health":
            body = {"status": "ok", "model_loaded": PIPELINE is not None}
            self._send(200, json.dumps(body).encode())
        else:
            self._send(404, b"Not found", "text/plain")

    def do_POST(self):  # noqa: N802
        if self.path.rstrip("/") != "/run_inference":
            self._send(404, b"Not found", "text/plain")
            return
        start_time = time.time()
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)

        try:
            json_data = json.loads(data)
        except json.JSONDecodeError as exception:
            self._send(400, str(exception).encode(), "text/plain")
            return

        logger.info(json_data)
        try:
            inputs = from_dict(InferenceInput, json_data)
        except DecodeError as exception:
            self._send(400, str(exception).encode(), "text/plain")
            return
        result = compute_request(
            inputs=inputs,
            pipeline=PIPELINE,
            seed_images_dir=self.server.seed_images_dir,  # type: ignore[attr-defined]
        )
        logger.info(f"Request took {time.time() - start_time:.2f} s")

        if isinstance(result, tuple):
            body, status = result
            self._send(status, body.encode(), "text/plain")
        else:
            self._send(200, result.encode())

    def log_message(self, fmt, *args):  # route http.server chatter to logging
        logger.info("%s - %s", self.address_string(), fmt % args)


class RiffusionServer(HTTPServer):
    """HTTPServer carrying the seed-image directory (single-threaded)."""

    def __init__(self, addr, seed_images_dir: T.Union[str, Path] = SEED_IMAGES_DIR):
        super().__init__(addr, _Handler)
        self.seed_images_dir = seed_images_dir


def run_app(
    *,
    checkpoint: str = "random:full",
    device: str = "cuda",
    host: str = "127.0.0.1",
    port: int = 3013,
    seed_images_dir: T.Union[str, Path] = SEED_IMAGES_DIR,
) -> None:
    """Load the model and serve until interrupted."""
    logging.basicConfig(level=logging.INFO)

    global PIPELINE
    PIPELINE = RiffusionPipeline.load_checkpoint(checkpoint=checkpoint, device=device)
    server = RiffusionServer((host, port), seed_images_dir=seed_images_dir)
    logger.info(f"Serving on http://{host}:{port} (checkpoint={checkpoint})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.server_close()


def main(argv: T.Optional[T.Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="riffusion_tpu_torch inference server")
    parser.add_argument("--checkpoint", default="random:full",
                        help="'random:full' or 'random:tiny' (random weights)")
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=3013)
    parser.add_argument("--seed-images-dir", default=str(SEED_IMAGES_DIR))
    args = parser.parse_args(argv)
    run_app(
        checkpoint=args.checkpoint,
        device=args.device,
        host=args.host,
        port=args.port,
        seed_images_dir=args.seed_images_dir,
    )


if __name__ == "__main__":
    main()
