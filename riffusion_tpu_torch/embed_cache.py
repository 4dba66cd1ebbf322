"""
Disk cache for CLIP text embeddings, the port's copy of
riffusion_tpu/embed_cache.py.

A fresh serving process would otherwise re-encode its boot prompts: tokenize,
run the text encoder, read back. Embeddings are small ((1, 77, 768) is about
230 KB) and fully determined by (CLIP weights, model code, device, compute
dtype, text), so a restart can read them off disk instead of touching the
text encoder at all.

Each key hashes an environment fingerprint (a digest of this package's
Python and CUDA sources, the torch version, the device type and, on the
card, its name) with the checkpoint's identity (ModelBundle.checkpoint_id),
the dtype, the kind of embedding and the text, so a stale entry cannot be
hit.

Format: one .npz per entry holding the fp32 value (lossless for bf16 and
fp16 outputs) and the dtype's name; np.load runs with allow_pickle off, and
the value is cast back to its dtype through torch. Writes are atomic
renames. A corrupt entry is dropped and recomputed, a failed write logs a
warning: the cache is an optimization, never load-bearing.

    RIFFUSION_TPU_NO_EMBED_CACHE=1      disables it
    RIFFUSION_TPU_EMBED_CACHE_DIR=DIR   stores it in DIR
                                        (default ~/.cache/riffusion_tpu_torch/embeds)
"""

from __future__ import annotations

import functools
import hashlib
import logging
import os
import tempfile
import typing as T
from pathlib import Path

import numpy as np
import torch

_LOG = logging.getLogger(__name__)
_PACKAGE = Path(__file__).resolve().parent


def enabled() -> bool:
    return not os.environ.get("RIFFUSION_TPU_NO_EMBED_CACHE")


def cache_dir() -> str:
    return os.environ.get(
        "RIFFUSION_TPU_EMBED_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "riffusion_tpu_torch", "embeds"),
    )


@functools.lru_cache(maxsize=1)
def _source_digest() -> str:
    """Digest of the package's .py files and csrc/ kernel sources (not the
    built objects under csrc/build/)."""
    h = hashlib.sha256()
    files = sorted(p for p in _PACKAGE.rglob("*.py")
                   if "build" not in p.relative_to(_PACKAGE).parts)
    files += sorted(p for p in (_PACKAGE / "csrc").glob("*") if p.is_file())
    for path in files:
        h.update(str(path.relative_to(_PACKAGE)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def fingerprint(device: T.Union[str, torch.device]) -> str:
    """The environment an embedding was computed in: the package's sources,
    torch's version, the device type and, on CUDA, the card's name."""
    device = torch.device(device)
    parts = [_source_digest(), torch.__version__, device.type]
    if device.type == "cuda":
        parts.append(torch.cuda.get_device_name(device))
    return "|".join(parts)


def entry_key(checkpoint_id: str, dtype: torch.dtype, kind: str, text: str, *,
              device: T.Union[str, torch.device]) -> str:
    """Digest of everything the embedding depends on. `kind` separates the
    plain, weighted and unconditional encodes of one text."""
    raw = "\x00".join([fingerprint(device), checkpoint_id, str(dtype), kind, text])
    return hashlib.sha256(raw.encode()).hexdigest()[:24]


def get(key: str) -> T.Optional[torch.Tensor]:
    """The stored embedding as a CPU tensor in its dtype, or None."""
    if not enabled():
        return None
    path = os.path.join(cache_dir(), key + ".npz")
    try:
        with np.load(path) as z:  # allow_pickle defaults to False
            value = z["value"]
            dtype = getattr(torch, str(z["dtype"]))
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"not a dtype: {dtype!r}")
        return torch.from_numpy(np.array(value, np.float32)).to(dtype)
    except FileNotFoundError:
        return None
    except Exception as exc:  # a corrupt entry: drop it, recompute
        _LOG.warning("embed cache entry %s unreadable (%s); ignoring", key, exc)
        try:
            os.unlink(path)
        except OSError:
            pass
        return None


def put(key: str, value: torch.Tensor) -> None:
    if not enabled():
        return
    try:
        d = cache_dir()
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    value=value.detach().to("cpu", torch.float32).numpy(),
                    dtype=np.str_(str(value.dtype).removeprefix("torch.")),
                )
            os.replace(tmp, os.path.join(d, key + ".npz"))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except Exception as exc:  # never let the cache fail a request
        _LOG.warning("embed cache write failed (%s); continuing uncached", exc)
