"""
Model bundles: configs, modules with weights, tokenizer, scheduler id.

The counterpart of riffusion_tpu/models/weights.py. `load_bundle` resolves:

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
- A directory written by the JAX package's `save_native`:
  `riffusion_tpu.json` (the same configs) and one flax msgpack tree per
  model (`unet.msgpack`, ...), read by models/formats.py.
- A local diffusers-layout checkpoint (riffusion-model-v1's layout): unet/,
  vae/ and text_encoder/ each with a config.json and a safetensors or
  torch .bin weight file, the sampler named by scheduler/scheduler_config.json,
  and a CLIP BPE vocabulary under tokenizer/. Its keys are renamed to the
  JAX package's flax paths (the renames are copies of the JAX package's,
  the old VAE attention names `query`/`key`/`value`/`proj_attn` among them)
  and go through `state_dict_from_jax` like the JAX trees.

Every loaded state dict must match its module key for key and shape (a
missing, extra or misshapen key raises, naming it); the UNet and CLIP are
then cast to the requested dtype and the VAE kept in fp32.

`from_jax_params`: the JAX package's parameter trees (numpy or tensors) ->
this package's state dicts, so that both packages run the same weights in
the tests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import typing as T
from pathlib import Path

import numpy as np
import torch
from torch import nn

from riffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from riffusion_tpu_torch.models.formats import read_flax_msgpack, read_safetensors
from riffusion_tpu_torch.models.tokenizer import CLIPTokenizer, HashTokenizer
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


def _native_configs(meta: T.Mapping[str, T.Any]) -> T.Tuple[UNetConfig, VAEConfig, CLIPTextConfig]:
    """The three configs of either package's native meta file."""
    return (_config(UNetConfig, meta["unet"]), _config(VAEConfig, meta["vae"]),
            _config(CLIPTextConfig, meta["clip"]))


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
    states = [torch.load(root / f"{name}.pt", map_location=device, weights_only=True)
              for name in _MODELS]
    return _assemble(root, _native_configs(meta), states, meta.get("scheduler", "pndm"),
                     device, dtype)


def _check_state_dict(module: nn.Module, state: T.Mapping[str, torch.Tensor], what: str,
                      sources: T.Optional[T.Mapping[str, str]] = None) -> None:
    """Raise ValueError naming every missing, extra or misshapen key (with the
    file's own name for it, where it was renamed)."""
    sources = sources or {}
    want = module.state_dict()

    def named(key: str) -> str:
        return f"{key} (file key {sources[key]})" if key in sources else key

    problems = [f"missing {k}" for k in want if k not in state]
    problems += [f"unexpected {named(k)}" for k in state if k not in want]
    problems += [f"shape of {named(k)}: {tuple(v.shape)} in the file, {tuple(want[k].shape)} "
                 "in the model" for k, v in state.items()
                 if k in want and tuple(v.shape) != tuple(want[k].shape)]
    if problems:
        raise ValueError(f"{what}: the weights do not fit the model: " + "; ".join(problems))


def _assemble(
    root: Path, cfgs: T.Tuple[UNetConfig, VAEConfig, CLIPTextConfig],
    states: T.Sequence[T.Mapping[str, torch.Tensor]], scheduler_name: str,
    device: torch.device, dtype: torch.dtype,
    sources: T.Sequence[T.Optional[T.Mapping[str, str]]] = (None, None, None),
) -> ModelBundle:
    """Modules of `cfgs` on `device` holding `states` (checked, then loaded
    strictly); UNet and CLIP cast to `dtype`, the VAE in fp32; the CLIP
    vocabulary under `root` when it has one, else the hash tokenizer."""
    modules = build_modules(cfgs, device)
    for name, module, state, source in zip(_MODELS, modules, states, sources):
        _check_state_dict(module, state, f"{root}: {name}", source)
        module.load_state_dict(state, strict=True)
    unet, vae, clip = modules
    try:
        tokenizer: T.Any = CLIPTokenizer.from_pretrained(str(root))
    except FileNotFoundError:
        tokenizer = HashTokenizer(vocab_size=clip.cfg.vocab_size)
    return ModelBundle(
        unet=unet.to(dtype).eval(), vae=vae.to(torch.float32).eval(),
        text_encoder=clip.to(dtype).eval(), tokenizer=tokenizer,
        scheduler_name=scheduler_name,
    )


# ------------------------------------------------ the JAX package's msgpack export

JAX_NATIVE_META = "riffusion_tpu.json"


def load_jax_native(
    root: T.Union[str, Path], device: T.Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
) -> ModelBundle:
    """Load a directory written by the JAX package's `save_native`
    (riffusion_tpu/models/weights.py): its configs and flax msgpack trees,
    converted by `from_jax_params`."""
    root = Path(root)
    meta = json.loads((root / JAX_NATIVE_META).read_text())
    trees = [read_flax_msgpack(root / f"{name}.msgpack") for name in _MODELS]
    return _assemble(root, _native_configs(meta), from_jax_params(*trees),
                     meta.get("scheduler", "pndm"), torch.device(device), dtype)


# ----------------------------------------------------- diffusers-layout checkpoints
#
# The key renames are copies of riffusion_tpu/models/weights.py's: a diffusers
# key -> the JAX package's flax path ("a/b/c"), or None to skip it.


def _rename_unet_key(key: str) -> T.Optional[str]:
    if key.endswith(("attn1.to_out.1.weight", "attn2.to_out.1.bias")):
        return None
    k = key
    k = k.replace("transformer_blocks.", "blocks_")
    k = k.replace(".to_out.0.", ".to_out.")
    k = k.replace("ff.net.0.proj", "ff.proj_in")
    k = k.replace("ff.net.2", "ff.proj_out")
    # index flattening: down_blocks.0 -> down_blocks_0, resnets.1 -> resnets_1 ...
    k = re.sub(r"\.(\d+)", r"_\1", k)
    return k.replace(".", "/")


def _rename_vae_key(key: str) -> T.Optional[str]:
    k = key
    # the old (diffusers <= 0.9) attention names -> the new ones
    k = k.replace("mid_block.attentions.0.query", "mid_block.attentions.0.to_q")
    k = k.replace("mid_block.attentions.0.key", "mid_block.attentions.0.to_k")
    k = k.replace("mid_block.attentions.0.value", "mid_block.attentions.0.to_v")
    k = k.replace("mid_block.attentions.0.proj_attn", "mid_block.attentions.0.to_out")
    k = k.replace("mid_block.attentions.0.norm", "mid_block.attentions.0.group_norm")
    k = k.replace(".to_out.0.", ".to_out.")
    k = k.replace("mid_block.attentions.0", "mid_block.attentions_0__ATT")
    k = re.sub(r"\.(\d+)", r"_\1", k)
    k = k.replace("attentions_0__ATT", "attentions_0")
    # encoder/decoder sub-blocks -> the flax module's flat names
    k = re.sub(r"(encoder|decoder)/?", r"\1.", k.replace("/", "."))
    k = k.replace("..", ".")
    parts = k.split(".")
    if parts[0] in ("encoder", "decoder"):
        # down_blocks_0.resnets_0 -> down_blocks_0_resnets_0 etc
        merged: T.List[str] = []
        for p in parts[1:-1]:
            if merged and (
                p.startswith(("resnets_", "downsamplers_", "upsamplers_"))
                and merged[-1].startswith(("down_blocks_", "up_blocks_"))
            ):
                merged[-1] = merged[-1] + "_" + p
            else:
                merged.append(p)
        k = "/".join([parts[0]] + merged + [parts[-1]])
    elif parts[0] == "quant_conv":
        k = "/".join(["encoder"] + parts)
    elif parts[0] == "post_quant_conv":
        k = "/".join(["decoder"] + parts)
    else:
        k = "/".join(parts)
    k = k.replace("mid_block_resnets", "mid_block/resnets")
    return k.replace("mid_block_attentions", "mid_block/attentions")


def _rename_clip_key(key: str) -> T.Optional[str]:
    if not key.startswith("text_model."):
        return None
    k = key[len("text_model."):]
    if k.startswith("embeddings.position_ids"):
        return None
    k = k.replace("embeddings.token_embedding", "token_embedding")
    k = k.replace("embeddings.position_embedding", "position_embedding")
    k = k.replace("encoder.layers.", "layers_")
    k = k.replace(".mlp.", ".")
    k = re.sub(r"layers_(\d+)\.", r"layers_\1/", k)
    return k.replace(".", "/")


_RENAMES = {"unet": _rename_unet_key, "vae": _rename_vae_key, "clip": _rename_clip_key}


def convert_diffusers_state_dict(
    state: T.Mapping[str, torch.Tensor], kind: str
) -> T.Tuple[T.Dict[str, torch.Tensor], T.Dict[str, str]]:
    """A diffusers/transformers state dict ("unet", "vae" or "clip") -> (the
    port's state dict, {port key: file key}). The port's modules keep torch's
    layout and the flax module names, so a file key's port key is its
    renamed flax path with dots, and its tensor is the file's."""
    rename = _RENAMES[kind]
    out: T.Dict[str, torch.Tensor] = {}
    sources: T.Dict[str, str] = {}
    for key, value in state.items():
        flax_path = rename(key)
        if flax_path is None:
            continue
        port_key = flax_path.replace("/", ".")
        if port_key in out:
            raise ValueError(f"{kind}: file keys {sources[port_key]} and {key} both map to "
                             f"{port_key}")
        out[port_key], sources[port_key] = value.contiguous(), key
    return out, sources


_WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "model.safetensors",
    "diffusion_pytorch_model.bin",
    "pytorch_model.bin",
)


def _load_torch_weights(folder: Path, kind: str) -> T.Dict[str, torch.Tensor]:
    """A model subfolder's weights, safetensors preferred; CPU tensors in the
    file's dtype (a safetensors file's keys that the renames skip are not
    decoded)."""
    for name in _WEIGHT_FILES:
        path = folder / name
        if path.exists():
            if name.endswith(".safetensors"):
                return read_safetensors(path, keep=lambda k: _RENAMES[kind](k) is not None)
            return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"No torch weights found in {folder} (looked for {_WEIGHT_FILES})")


def _unet_config_from_json(cfg: dict) -> UNetConfig:
    down_types = cfg.get("down_block_types", ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
    return UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        attention_head_dim=cfg.get("attention_head_dim", 8),
        cross_attn_blocks=tuple(t.startswith("CrossAttn") for t in down_types),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        freq_shift=cfg.get("freq_shift", 0),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
    )


def _vae_config_from_json(cfg: dict) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def _clip_config_from_json(cfg: dict) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        num_layers=cfg.get("num_hidden_layers", 12),
        num_heads=cfg.get("num_attention_heads", 12),
        max_positions=cfg.get("max_position_embeddings", 77),
        intermediate_size=cfg.get("intermediate_size", 3072),
    )


#: diffusers scheduler classes -> the port's sampler names; any other class
#: is served with pndm, as the JAX package does.
SCHEDULER_CLASSES = {
    "PNDMScheduler": "pndm",
    "DDIMScheduler": "ddim",
    "LMSDiscreteScheduler": "lms",
    "EulerDiscreteScheduler": "euler",
    "EulerAncestralDiscreteScheduler": "euler_a",
    "DPMSolverMultistepScheduler": "dpmpp",
}


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text(encoding="utf-8"))


def diffusers_scheduler_name(root: T.Union[str, Path]) -> str:
    """The sampler that scheduler/scheduler_config.json names ("pndm" when
    there is none, or for a class the port does not map)."""
    path = Path(root) / "scheduler" / "scheduler_config.json"
    if not path.exists():
        return "pndm"
    return SCHEDULER_CLASSES.get(_read_json(path).get("_class_name", "PNDMScheduler"), "pndm")


def load_diffusers_checkpoint(
    root: T.Union[str, Path], device: T.Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
) -> ModelBundle:
    """Load a local diffusers-layout checkpoint directory onto `device`."""
    root = Path(root)
    cfgs = (_unet_config_from_json(_read_json(root / "unet" / "config.json")),
            _vae_config_from_json(_read_json(root / "vae" / "config.json")),
            _clip_config_from_json(_read_json(root / "text_encoder" / "config.json")))
    converted = [
        convert_diffusers_state_dict(_load_torch_weights(root / folder, kind), kind)
        for folder, kind in (("unet", "unet"), ("vae", "vae"), ("text_encoder", "clip"))
    ]
    return _assemble(root, cfgs, [c[0] for c in converted], diffusers_scheduler_name(root),
                     torch.device(device), dtype, sources=[c[1] for c in converted])


def load_bundle(
    checkpoint: str, device: T.Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.float32
) -> ModelBundle:
    """Resolve a checkpoint spec, as the JAX package's `load_bundle` does:
    "random:tiny" / "random:full" (seed 0); a directory holding the port's
    export (riffusion_tpu_torch.json), the JAX package's (riffusion_tpu.json),
    or a diffusers layout (a unet/ subfolder), tried in that order."""
    if checkpoint.startswith("random:"):
        return random_bundle(checkpoint.split(":", 1)[1], device=device, dtype=dtype)
    if os.path.isdir(checkpoint):
        if os.path.isfile(os.path.join(checkpoint, NATIVE_META)):
            return load_native(checkpoint, device=device, dtype=dtype)
        if os.path.isfile(os.path.join(checkpoint, JAX_NATIVE_META)):
            return load_jax_native(checkpoint, device=device, dtype=dtype)
        if os.path.isdir(os.path.join(checkpoint, "unet")):
            return load_diffusers_checkpoint(checkpoint, device=device, dtype=dtype)
    raise FileNotFoundError(
        f"Cannot resolve checkpoint {checkpoint!r}: expected 'random:tiny', 'random:full', a "
        f"directory written by save_native ({NATIVE_META}) or by the JAX package's "
        f"({JAX_NATIVE_META}), or a diffusers-layout directory (unet/, vae/, text_encoder/); "
        "nothing is downloaded"
    )


# ------------------------------------------------------------ JAX -> torch


def _flatten(tree: T.Mapping[str, T.Any], prefix: str = "") -> T.Dict[str, T.Any]:
    """Dotted paths -> leaves (tensors as they are, anything else as numpy)."""
    out: T.Dict[str, T.Any] = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, T.Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value if isinstance(value, torch.Tensor) else np.asarray(value)
    return out


def _to_torch_entry(path: str, value):
    """One flax leaf (numpy or tensor) -> (state dict key, leaf in torch
    layout)."""
    stem, leaf = path.rsplit(".", 1)
    if leaf == "kernel":
        if value.ndim == 4:  # conv HWIO -> OIHW
            axes = (3, 2, 0, 1)
            return f"{stem}.weight", (value.permute(*axes) if isinstance(value, torch.Tensor)
                                      else value.transpose(*axes))
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
        out[key] = (arr.contiguous() if isinstance(arr, torch.Tensor)
                    else torch.tensor(np.ascontiguousarray(arr)))
    return out


def from_jax_params(
    unet: T.Mapping[str, T.Any], vae: T.Mapping[str, T.Any], clip: T.Mapping[str, T.Any]
) -> T.Tuple[T.Dict[str, torch.Tensor], T.Dict[str, torch.Tensor], T.Dict[str, torch.Tensor]]:
    """The JAX package's UNet, VAE and CLIP parameter trees (numpy or tensor
    leaves) -> this package's state dicts. Dense (in, out) becomes Linear (out, in),
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
