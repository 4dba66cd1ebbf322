"""
Model bundles: configs, modules with weights, tokenizer, scheduler id.

The counterpart of riffusion_tpu/models/weights.py for the specs the port
loads so far:

- "random:tiny" / "random:full": deterministic random weights with the
  right architecture, synthesized directly on the target device with a
  torch.Generator. The statistics follow the JAX package's random bundle:
  weights ~ N(0, 1/fan_in) with fan_in counted in the JAX layout (all dims
  but the output dim; the vocabulary size for embeddings), zero biases, unit
  norm scales. The values differ from the JAX bundle's (another generator).
- A directory written by `save_native` (the fine-tuning export among
  them): `riffusion_tpu_torch.json` with the three configs under the JAX
  package's names ("unet", "vae", "clip", "scheduler"; keys a port config
  does not have, such as the UNet's sample_size, are ignored) and one
  torch.save state dict per model (`unet.pt`, `vae.pt`, `clip.pt`), plus a
  CLIP BPE vocabulary when the directory has one (`tokenizer/`).
- `from_jax_params`: the JAX package's parameter trees (as numpy) -> this
  package's state dicts, so that both packages run the same weights in the
  tests.

Loading diffusers checkpoints, and the JAX package's own native export
(msgpack), is later work.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing as T
from pathlib import Path

import numpy as np
import torch
from torch import nn

from riffusion_tpu_torch.models.tokenizer import CLIPTokenizer, HashTokenizer
from riffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from riffusion_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from riffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig


@dataclasses.dataclass
class ModelBundle:
    """Everything the pipeline needs. The modules already hold their weights,
    on their device and in their dtype."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: T.Any
    scheduler_name: str = "pndm"

    @property
    def vae_config(self) -> VAEConfig:
        return self.vae.cfg


def configs(size: str) -> T.Tuple[UNetConfig, VAEConfig, CLIPTextConfig]:
    if size == "tiny":
        return UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
    if size == "full":
        return UNetConfig(), VAEConfig(), CLIPTextConfig()
    raise ValueError(f"Unknown random bundle size: {size!r} (use tiny/full)")


def build_modules(
    size: T.Union[str, T.Tuple[UNetConfig, VAEConfig, CLIPTextConfig]], device: torch.device
) -> T.Tuple[UNet2DCondition, AutoencoderKL, CLIPTextModel]:
    """Modules of the given geometry ("tiny", "full" or three configs),
    allocated on `device` without initializing (their weights come from
    `randomize_` or a state dict)."""
    unet_cfg, vae_cfg, clip_cfg = configs(size) if isinstance(size, str) else size
    with torch.device("meta"):
        modules = (UNet2DCondition(unet_cfg), AutoencoderKL(vae_cfg), CLIPTextModel(clip_cfg))
    return tuple(m.to_empty(device=device) for m in modules)  # type: ignore[return-value]


def _jax_fan_in(module: nn.Module, shape: torch.Size) -> int:
    """fan_in of a weight as the JAX random bundle counts it: the product of
    all but the last dim of the JAX-layout tensor."""
    if isinstance(module, nn.Conv2d):  # OIHW -> HWIO: H * W * I
        return int(shape[1] * shape[2] * shape[3])
    if isinstance(module, nn.Linear):  # (out, in) -> (in, out): in
        return int(shape[1])
    if isinstance(module, nn.Embedding):  # (num, dim), same in both
        return int(shape[0])
    raise TypeError(f"no fan-in rule for {type(module).__name__}")


@torch.no_grad()
def randomize_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter in place: N(0, 1/fan_in) weights, zero biases,
    unit norm scales."""
    for sub in module.modules():
        for name, param in sub.named_parameters(recurse=False):
            if name == "bias":
                param.zero_()
            elif isinstance(sub, (nn.GroupNorm, nn.LayerNorm)):
                param.fill_(1.0)
            else:
                std = 1.0 / np.sqrt(max(_jax_fan_in(sub, param.shape), 1))
                param.normal_(0.0, std, generator=generator)


def random_bundle(
    size: str = "tiny", seed: int = 0, device: T.Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
) -> ModelBundle:
    """Deterministic random-weight bundle. UNet and CLIP in `dtype`, the VAE
    always in fp32 (as the pipeline serves it)."""
    device = torch.device(device)
    unet, vae, clip = build_modules(size, device)
    for i, module in enumerate((unet, vae, clip)):
        generator = torch.Generator(device=device).manual_seed(seed * 3 + i)
        randomize_(module, generator)
    unet.to(dtype)
    clip.to(dtype)
    return ModelBundle(
        unet=unet.eval(),
        vae=vae.eval(),
        text_encoder=clip.eval(),
        tokenizer=HashTokenizer(vocab_size=clip.cfg.vocab_size),
    )


NATIVE_META = "riffusion_tpu_torch.json"
_MODELS = ("unet", "vae", "clip")


def save_native(bundle: ModelBundle, out_dir: T.Union[str, Path]) -> None:
    """Write `bundle` to `out_dir` in the port's native layout (the module
    docstring): the configs as JSON and one state dict per model, each in
    the dtype its module holds."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    modules = dict(zip(_MODELS, (bundle.unet, bundle.vae, bundle.text_encoder)))
    meta = {name: dataclasses.asdict(m.cfg) for name, m in modules.items()}
    meta["scheduler"] = bundle.scheduler_name
    (out / NATIVE_META).write_text(json.dumps(meta, indent=2))
    for name, module in modules.items():
        torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
                   out / f"{name}.pt")


def _config(cls, fields: T.Mapping[str, T.Any]):
    """A config dataclass from JSON fields: lists become tuples, fields the
    class does not have are ignored."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items() if k in names})


def load_native(
    root: T.Union[str, Path], device: T.Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
) -> ModelBundle:
    """Load a `save_native` directory onto `device`: UNet and CLIP in
    `dtype`, the VAE in fp32; the directory's CLIP vocabulary when it has
    one, else the hash tokenizer."""
    root = Path(root)
    device = torch.device(device)
    meta = json.loads((root / NATIVE_META).read_text())
    cfgs = (_config(UNetConfig, meta["unet"]), _config(VAEConfig, meta["vae"]),
            _config(CLIPTextConfig, meta["clip"]))
    modules = build_modules(cfgs, device)
    for name, module in zip(_MODELS, modules):
        state = torch.load(root / f"{name}.pt", map_location=device, weights_only=True)
        module.load_state_dict(state, strict=True)
    unet, vae, clip = modules
    try:
        tokenizer: T.Any = CLIPTokenizer.from_pretrained(str(root))
    except FileNotFoundError:
        tokenizer = HashTokenizer(vocab_size=clip.cfg.vocab_size)
    return ModelBundle(
        unet=unet.to(dtype).eval(), vae=vae.to(torch.float32).eval(),
        text_encoder=clip.to(dtype).eval(), tokenizer=tokenizer,
        scheduler_name=meta.get("scheduler", "pndm"),
    )


def load_bundle(
    checkpoint: str, device: T.Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.float32
) -> ModelBundle:
    """Resolve a checkpoint spec: "random:tiny" / "random:full" (seed 0), or
    a directory written by `save_native`."""
    if checkpoint.startswith("random:"):
        return random_bundle(checkpoint.split(":", 1)[1], device=device, dtype=dtype)
    if os.path.isfile(os.path.join(checkpoint, NATIVE_META)):
        return load_native(checkpoint, device=device, dtype=dtype)
    raise FileNotFoundError(
        f"Cannot resolve checkpoint {checkpoint!r}: the port loads 'random:tiny', "
        f"'random:full' and directories written by save_native ({NATIVE_META}); diffusers "
        "checkpoints and the JAX package's msgpack export are not ported yet"
    )


# ------------------------------------------------------------ JAX -> torch


def _flatten(tree: T.Mapping[str, T.Any], prefix: str = "") -> T.Dict[str, np.ndarray]:
    out: T.Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, T.Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _to_torch_entry(path: str, value: np.ndarray) -> T.Tuple[str, np.ndarray]:
    """One flax leaf -> (state dict key, array in torch layout)."""
    stem, leaf = path.rsplit(".", 1)
    if leaf == "kernel":
        if value.ndim == 4:  # conv HWIO -> OIHW
            return f"{stem}.weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:  # dense (in, out) -> linear (out, in)
            return f"{stem}.weight", value.T
        raise ValueError(f"unexpected kernel rank {value.ndim} at {path}")
    if leaf in ("scale", "embedding"):  # norm scale, nn.Embed table
        return f"{stem}.weight", value
    if leaf == "bias":
        return path, value
    raise ValueError(f"unexpected parameter leaf {leaf!r} at {path}")


def state_dict_from_jax(params: T.Mapping[str, T.Any]) -> T.Dict[str, torch.Tensor]:
    """A flax parameter tree -> a state dict for the same-named torch module."""
    out = {}
    for path, value in _flatten(params).items():
        key, arr = _to_torch_entry(path, value)
        out[key] = torch.tensor(np.ascontiguousarray(arr))
    return out


def from_jax_params(
    unet: T.Mapping[str, T.Any], vae: T.Mapping[str, T.Any], clip: T.Mapping[str, T.Any]
) -> T.Tuple[T.Dict[str, torch.Tensor], T.Dict[str, torch.Tensor], T.Dict[str, torch.Tensor]]:
    """The JAX package's UNet, VAE and CLIP parameter trees (numpy leaves)
    -> this package's state dicts. Dense (in, out) becomes Linear (out, in),
    conv HWIO becomes OIHW, norm `scale` and embedding tables become
    `weight`, and the nested flax paths become dotted module names."""
    return state_dict_from_jax(unet), state_dict_from_jax(vae), state_dict_from_jax(clip)


def bundle_from_jax_params(
    size: str,
    unet: T.Mapping[str, T.Any],
    vae: T.Mapping[str, T.Any],
    clip: T.Mapping[str, T.Any],
    device: T.Union[str, torch.device] = "cpu",
) -> ModelBundle:
    """A float32 bundle holding the JAX package's weights (strict: every
    parameter must be matched by name and shape)."""
    device = torch.device(device)
    modules = build_modules(size, device)
    for module, sd in zip(modules, from_jax_params(unet, vae, clip)):
        module.load_state_dict(sd, strict=True)
    u, v, c = modules
    return ModelBundle(
        unet=u.eval(), vae=v.eval(), text_encoder=c.eval(),
        tokenizer=HashTokenizer(vocab_size=c.cfg.vocab_size),
    )
