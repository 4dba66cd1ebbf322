"""
Baseten/Truss deployment wrapper over the port: the counterpart of
integrations/baseten.py. A Model class whose load() and predict() go
through the port's server.compute_request. The truss runtime imports this
module; it does not need truss itself.
"""

from __future__ import annotations

import logging
import typing as T
from pathlib import Path

from riffusion_tpu_torch.datatypes import InferenceInput
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.server import compute_request
from riffusion_tpu_torch.util.dataclass_util import DecodeError, from_dict


class Model:
    """Truss-compatible model wrapper. `config` may name "checkpoint"
    (default riffusion/riffusion-model-v1), "device" (default cuda) and
    "seed_images_dir"."""

    def __init__(self, **kwargs) -> None:
        self._data_dir = kwargs.get("data_dir")
        self._config = kwargs.get("config", {})
        self._pipeline: T.Optional[RiffusionPipeline] = None
        self._seed_images_dir = Path(
            self._config.get("seed_images_dir", Path(__file__).resolve().parents[2] / "seed_images")
        )

    def load(self) -> None:
        checkpoint = self._config.get("checkpoint", "riffusion/riffusion-model-v1")
        device = self._config.get("device", "cuda")
        self._pipeline = RiffusionPipeline.load_checkpoint(
            checkpoint=checkpoint, device=device
        )

    def preprocess(self, request: T.Dict) -> T.Dict:
        return request

    def predict(self, request: T.Dict) -> T.Dict[str, T.List]:
        """Run inference on a batch of InferenceInput dicts; a malformed one
        gives {"error": ...} in its place."""
        if self._pipeline is None:
            raise RuntimeError("call load() first")
        instances = request.get("instances") or [request]
        outputs = []
        for instance in instances:
            try:
                inputs = from_dict(InferenceInput, instance)
            except DecodeError as e:
                logging.info(str(e))
                outputs.append({"error": str(e)})
                continue
            result = compute_request(
                inputs=inputs,
                pipeline=self._pipeline,
                seed_images_dir=self._seed_images_dir,
            )
            if isinstance(result, tuple):
                outputs.append({"error": result[0]})
            else:
                outputs.append(result)
        return {"predictions": outputs}

    def postprocess(self, request: T.Dict) -> T.Dict:
        return request
