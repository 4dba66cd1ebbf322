"""
Public API datatypes: the port's own copy of riffusion_tpu/datatypes.py
(same field names, defaults and JSON shapes, held to it by
tests/test_torch_host.py), so clients of either server work unchanged
against the other.
"""

from __future__ import annotations

import typing as T
from dataclasses import dataclass


@dataclass(frozen=True)
class PromptInput:
    """Parameters for one end of interpolation."""

    # Text prompt fed into the CLIP model
    prompt: str

    # Random seed for denoising
    seed: int

    # Negative prompt to avoid (optional)
    negative_prompt: T.Optional[str] = None

    # Denoising strength
    denoising: float = 0.75

    # Classifier-free guidance strength
    guidance: float = 7.0


@dataclass(frozen=True)
class InferenceInput:
    """
    Parameters for a single run of the model, interpolating between a start
    and end set of PromptInputs. This is the request body of the JSON server.
    """

    # Start point of interpolation
    start: PromptInput

    # End point of interpolation
    end: PromptInput

    # Interpolation alpha in [0, 1]: 0 = fully start, 1 = fully end
    alpha: float

    # Number of denoising steps
    num_inference_steps: int = 50

    # Which seed image to use
    seed_image_id: str = "og_beat"

    # ID of mask image to use
    mask_image_id: T.Optional[str] = None


@dataclass(frozen=True)
class InferenceOutput:
    """Response from the model inference server."""

    # base64 encoded spectrogram image as a JPEG
    image: str

    # base64 encoded audio clip (MP3 when an encoder is available, else WAV)
    audio: str

    # The duration of the audio clip
    duration_s: float
