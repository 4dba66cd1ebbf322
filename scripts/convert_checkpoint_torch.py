"""
One-time conversion of a diffusers-layout checkpoint to the PyTorch port's
native export (riffusion_tpu_torch.json and one .pt state dict per model),
which `RiffusionPipeline.load_checkpoint(DIR)` and the server's
--checkpoint read first.

Usage:
    python scripts/convert_checkpoint_torch.py /path/to/diffusers-checkpoint /path/to/output

The weights keep the dtypes the source files hold as the loader reads them
(fp32: load_diffusers_checkpoint's default); the conversion runs on the
CPU. The tokenizer files are copied, so the export is self-contained.
"""

import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    src, dst = sys.argv[1], sys.argv[2]

    from riffusion_tpu_torch.models.weights import load_diffusers_checkpoint, save_native

    print(f"converting {src} ...")
    bundle = load_diffusers_checkpoint(src, device="cpu")
    save_native(bundle, dst)

    # carry the tokenizer files over so that the export is self-contained
    tok_dir = Path(src) / "tokenizer"
    if tok_dir.is_dir():
        for name in ("vocab.json", "merges.txt"):
            if (tok_dir / name).exists():
                shutil.copy(tok_dir / name, Path(dst) / name)
    print(f"wrote the native checkpoint to {dst}")


if __name__ == "__main__":
    main()
