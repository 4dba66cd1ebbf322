"""
Replicate/Cog predictor over the port: the counterpart of
integrations/cog_riffusion.py. Random seeds when none are set, a single
prompt collapses to alpha 0, and the outputs are wav and jpeg file paths
(in the temporary directory). The cog package is optional: a minimal
stand-in keeps the predictor importable and testable without it.
"""

from __future__ import annotations

import random
import tempfile
import typing as T
from pathlib import Path

import PIL.Image

try:  # pragma: no cover - cog only exists in Replicate images
    from cog import BasePredictor, Input
    from cog import Path as CogPath
except ImportError:

    class BasePredictor:  # type: ignore[no-redef]
        def setup(self) -> None: ...

    def Input(default=None, description: str = "", **kwargs):  # type: ignore[no-redef]
        return default

    CogPath = Path  # type: ignore[assignment,misc]

from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.spectrogram_image_converter import SpectrogramImageConverter
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

MODEL_ID = "riffusion/riffusion-model-v1"
DEVICE = "cuda"
SEED_IMAGES_DIR = Path(__file__).resolve().parents[2] / "seed_images"
SEED_IMAGE_IDS = ["og_beat", "agile", "marim", "motorway", "vibes"]


class RiffusionPredictor(BasePredictor):
    """Replicate predictor for riffusion_tpu_torch."""

    def setup(self, local_files_only: bool = True) -> None:
        self.model = RiffusionPipeline.load_checkpoint(
            checkpoint=MODEL_ID, device=DEVICE, local_files_only=local_files_only
        )

    def predict(
        self,
        prompt_a: str = Input(default="funky synth solo", description="Start prompt"),
        denoising: float = Input(default=0.75, ge=0, le=1),
        prompt_b: T.Optional[str] = Input(default=None, description="End prompt"),
        alpha: float = Input(default=0.5, ge=0, le=1),
        num_inference_steps: int = Input(default=50, ge=1),
        seed_image_id: str = Input(default="vibes"),
    ) -> T.Dict[str, T.Any]:
        """Run one prompt-interpolation generation; returns file paths."""
        seed_a = random.randint(0, 2**32 - 1)
        seed_b = random.randint(0, 2**32 - 1)

        if not prompt_b:  # no transition
            prompt_b = prompt_a
            alpha = 0.0

        inputs = InferenceInput(
            alpha=float(alpha),
            num_inference_steps=num_inference_steps,
            seed_image_id=seed_image_id,
            start=PromptInput(prompt=prompt_a, seed=seed_a, denoising=denoising),
            end=PromptInput(prompt=prompt_b, seed=seed_b, denoising=denoising),
        )

        init_image = PIL.Image.open(SEED_IMAGES_DIR / f"{seed_image_id}.png").convert("RGB")
        image = self.model.riffuse(inputs, init_image=init_image, mask_image=None)

        params = SpectrogramParams(min_frequency=0, max_frequency=10000)
        converter = SpectrogramImageConverter(params=params, device=str(self.model.device))
        segment = converter.audio_from_spectrogram_image(image)

        out_dir = Path(tempfile.gettempdir())
        wav_path = out_dir / "gen_sound.wav"
        jpeg_path = out_dir / "gen_image.jpeg"
        segment.export(wav_path, format="wav")
        image.save(jpeg_path, exif=image.getexif(), format="JPEG")

        return {"audio": CogPath(wav_path), "spectrogram": CogPath(jpeg_path)}
