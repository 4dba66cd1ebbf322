"""
The system under test, composed from riffusion_tpu_torch's own pieces the
way its server and its fine-tuning driver compose them, with weights that
the benchmark makes in memory (no checkpoint is written):

- `weights(config, seed, device)`: diffusers-layout state dicts of the
  configuration's UNet, VAE and CLIP text encoder, drawn on the device from
  the seed (reference/sd.py), in the dtypes the configuration serves or
  trains them in;
- `pipeline(config, states, device)`: those state dicts through the port's
  diffusers conversion (models/weights.py) into a ModelBundle and a
  RiffusionPipeline;
- `server(pipeline)`: the HTTP server as `create_app` builds it without
  dynamic batching.
"""

from __future__ import annotations

import typing as T
from pathlib import Path

import numpy as np
import torch

from bench_port.reference import sd

INPUTS = Path(__file__).resolve().parent / "inputs"

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_seed(seed: int, model: str) -> int:
    """The generator seed of one model's weights under a run's seed."""
    salt = {"unet": 1, "vae": 2, "text_encoder": 3}[model]
    return int(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFF, salt]).generate_state(1)[0])


LEAVES = {"unet": sd.unet_leaves, "vae": sd.vae_leaves, "text_encoder": sd.clip_leaves}


def weights(config: T.Mapping[str, T.Any], seed: int, device, models=("unet", "vae",
            "text_encoder")) -> T.Dict[str, T.Dict[str, torch.Tensor]]:
    """{model: diffusers state dict} in the configuration's dtypes."""
    return {m: sd.make_weights(LEAVES[m](config[m]), model_seed(seed, m), device,
                               DTYPES[config["precision"][m]]) for m in models}


def pipeline(config: T.Mapping[str, T.Any], states: T.Mapping[str, T.Mapping[str, torch.Tensor]],
             device: str):
    """A RiffusionPipeline holding `states`, converted by the port."""
    from riffusion_tpu_torch.models import weights as port_weights
    from riffusion_tpu_torch.models.tokenizer import HashTokenizer
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    cfgs = (port_weights._unet_config_from_json(dict(config["unet"])),
            port_weights._vae_config_from_json(dict(config["vae"])),
            port_weights._clip_config_from_json(dict(config["text_encoder"])))
    modules = port_weights.build_modules(cfgs, torch.device(device))
    for module, (model, kind) in zip(modules, (("unet", "unet"), ("vae", "vae"),
                                               ("text_encoder", "clip"))):
        converted, _ = port_weights.convert_diffusers_state_dict(states[model], kind)
        module.load_state_dict(converted, strict=True)
    unet, vae, clip = modules
    precision = config["precision"]
    bundle = port_weights.ModelBundle(
        unet=unet.to(DTYPES[precision["unet"]]).eval(), vae=vae.to(torch.float32).eval(),
        text_encoder=clip.to(DTYPES[precision["text_encoder"]]).eval(),
        tokenizer=HashTokenizer(vocab_size=config["text_encoder"]["vocab_size"]),
        scheduler_name=config["scheduler"])
    return RiffusionPipeline(bundle, device=device)


def server(pipe):
    """The server of `pipe` on a free port of 127.0.0.1, composed as
    riffusion_tpu_torch.server.create_app composes it without dynamic
    batching."""
    from riffusion_tpu_torch import server as port_server

    port_server.PIPELINE = pipe
    return port_server.RiffusionServer(("127.0.0.1", 0), seed_images_dir=INPUTS)


def unet_module(config: T.Mapping[str, T.Any], state: T.Mapping[str, torch.Tensor], device):
    """The port's UNet holding `state` (the fine-tuning driver's bundle.unet)."""
    from riffusion_tpu_torch.models import weights as port_weights
    from riffusion_tpu_torch.models.unet import UNet2DCondition

    cfg = port_weights._unet_config_from_json(dict(config["unet"]))
    with torch.device("meta"):
        module = UNet2DCondition(cfg)
    module = module.to_empty(device=torch.device(device))
    converted, _ = port_weights.convert_diffusers_state_dict(state, "unet")
    module.load_state_dict(converted, strict=True)
    return module
