"""
The system under test of the SDXL cells, composed from riffusion_tpu_torch's
own pieces the way its server composes them, with weights that the
benchmark makes in memory (no checkpoint is written); sut.py composes SD v1
and is left as it is:

- `weights(config, seed, device)`: diffusers-layout state dicts of the
  configuration's UNet, VAE and both text towers, drawn on the device from
  the seed (reference/sdxl.py's shapes), in the dtypes the configuration
  serves them in;
- `pipeline(config, states, device)`: those state dicts through the port's
  diffusers conversion (models/weights.py, strict loads) into a
  ModelBundle with its second tower, the scheduler and noise schedule the
  configuration's scheduler config names, and a RiffusionPipeline;
- `seed_images(config, params, root)`: the cell's seed image, tiled along
  time in memory and written under `root` for the server to read by id.
"""

from __future__ import annotations

import typing as T
from pathlib import Path

import numpy as np
import torch

from bench_port import sut
from bench_port.reference import sd, sdxl

MODELS = ("unet", "vae", "text_encoder", "text_encoder_2")
LEAVES = {"unet": sdxl.unet_leaves, "vae": sd.vae_leaves, "text_encoder": sdxl.clip_leaves,
          "text_encoder_2": sdxl.clip_leaves}

#: diffusers scheduler classes the SDXL cells name -> the port's samplers
SCHEDULERS = {"EulerDiscreteScheduler": "euler"}


def model_seed(seed: int, model: str) -> int:
    """The generator seed of one model's weights under a run's seed."""
    salt = MODELS.index(model) + 1
    return int(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFF, salt, 21]).generate_state(1)[0])


def weights(config: T.Mapping[str, T.Any], seed: int, device
            ) -> T.Dict[str, T.Dict[str, torch.Tensor]]:
    """{model: diffusers state dict} in the configuration's dtypes."""
    return {m: sd.make_weights(LEAVES[m](config[m]), model_seed(seed, m), device,
                               sut.DTYPES[config["precision"][m]]) for m in MODELS}


def pipeline(config: T.Mapping[str, T.Any], states: T.Mapping[str, T.Mapping[str, torch.Tensor]],
             device: str):
    """A RiffusionPipeline holding `states`, converted and loaded strictly by
    the port."""
    from riffusion_tpu_torch.diffusion.schedulers import NoiseConfig
    from riffusion_tpu_torch.models import weights as port_weights
    from riffusion_tpu_torch.models.tokenizer import HashTokenizer
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    dev = torch.device(device)
    precision = config["precision"]
    cfgs = (port_weights._unet_config_from_json(dict(config["unet"])),
            port_weights._vae_config_from_json(dict(config["vae"])),
            port_weights._clip_config_from_json(dict(config["text_encoder"])))
    modules = port_weights.build_modules(cfgs, dev)
    for module, (model, kind) in zip(modules, (("unet", "unet"), ("vae", "vae"),
                                               ("text_encoder", "clip"))):
        converted, _ = port_weights.convert_diffusers_state_dict(states[model], kind)
        module.load_state_dict(converted, strict=True)
    converted, _ = port_weights.convert_diffusers_state_dict(states["text_encoder_2"], "clip")
    second = port_weights.text_encoder_module(
        port_weights._clip_config_from_json(dict(config["text_encoder_2"])), converted, dev,
        "text_encoder_2")
    unet, vae, first = modules
    scheduler = config["scheduler"]
    bundle = port_weights.ModelBundle(
        unet=unet.to(sut.DTYPES[precision["unet"]]).eval(), vae=vae.to(torch.float32).eval(),
        text_encoder=first.to(sut.DTYPES[precision["text_encoder"]]).eval(),
        tokenizer=HashTokenizer(vocab_size=config["text_encoder"]["vocab_size"]),
        scheduler_name=SCHEDULERS[scheduler["_class_name"]],
        text_encoder_2=second.to(sut.DTYPES[precision["text_encoder_2"]]).eval(),
        noise_config=NoiseConfig(timestep_spacing=scheduler["timestep_spacing"],
                                 steps_offset=scheduler["steps_offset"]))
    return RiffusionPipeline(bundle, device=device)


def seed_image(params: T.Mapping[str, T.Any]) -> np.ndarray:
    """The cell's seed image (H, W, 3) uint8: bench_port/inputs' image tiled
    `tile` times along time."""
    from PIL import Image

    base = np.asarray(Image.open(sut.INPUTS / f"{params['seed_image']}.png").convert("RGB"))
    return sdxl.tiled(base, params["tile"])


def write_seed_image(params: T.Mapping[str, T.Any], root: Path) -> T.Tuple[int, int]:
    """The seed image under `root` as `<seed_image_id>.png`, where the server
    reads it; returns its (height, width)."""
    from PIL import Image

    pixels = seed_image(params)
    Image.fromarray(pixels).save(Path(root) / f"{params['seed_image_id']}.png")
    return pixels.shape[0], pixels.shape[1]
