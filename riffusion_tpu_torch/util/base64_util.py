"""Base64 helpers for API responses (a copy of riffusion_tpu/util/base64_util.py)."""

import base64
import io


def encode(buffer: io.BytesIO) -> str:
    """Encode the contents of a BytesIO as a base64 string."""
    return base64.b64encode(buffer.getvalue()).decode("ascii")
