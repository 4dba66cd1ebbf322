"""
Batch text-to-audio from a JSON spec, the counterpart of
riffusion_tpu/streamlit/tasks/text_to_audio_batch.py: {params, entries[]}
where each entry has a prompt and optional overrides; optionally writes the
outputs plus an index.json manifest to a directory.
"""

from __future__ import annotations

import json
import typing as T
from pathlib import Path

# Example input JSON
EXAMPLE_INPUT = {
    "params": {
        "checkpoint": "riffusion/riffusion-model-v1",
        "num_inference_steps": 50,
        "guidance": 7.0,
        "width": 512,
    },
    "entries": [
        {"prompt": "Church bells"},
        {"prompt": "electronic beats", "negative_prompt": "drums", "seed": 123},
        {"prompt": "classical violin concerto", "seed": 7},
    ],
}

DEFAULT_PARAMS = {
    "num_inference_steps": 50,
    "guidance": 7.0,
    "width": 512,
    "scheduler": "PNDMScheduler",
}


def run_batch(
    data: T.Mapping[str, T.Any],
    device: str = "cuda",
    output_dir: T.Optional[T.Union[str, Path]] = None,
    extension: str = "wav",
) -> T.List[T.Dict[str, T.Any]]:
    """Execute a batch spec; returns manifest entries. If output_dir is set,
    saves images/audio and an index.json."""
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.streamlit import util as streamlit_util

    params = {**DEFAULT_PARAMS, **data.get("params", {})}
    entries = data.get("entries", [])
    checkpoint = params.get("checkpoint", streamlit_util.DEFAULT_CHECKPOINT)

    out_path: T.Optional[Path] = None
    if output_dir is not None:
        out_path = Path(output_dir)
        out_path.mkdir(parents=True, exist_ok=True)

    # one batched program for the whole spec, images and audio together
    # (the UNet at batch 2N, fused through the audio tail)
    pipeline = streamlit_util.load_riffusion_checkpoint(
        checkpoint=checkpoint, device=device
    )
    results = pipeline.txt2img_audio_batch(
        prompts=[e["prompt"] for e in entries],
        negative_prompts=[e.get("negative_prompt", "") or None for e in entries],
        seeds=[int(e.get("seed", 42)) for e in entries],
        num_inference_steps=int(params["num_inference_steps"]),
        guidances=[float(params["guidance"])] * len(entries),
        width=int(params["width"]),
        height=512,
        scheduler=streamlit_util.scheduler_name(params["scheduler"]),
        params=SpectrogramParams(),
    )

    manifest = []
    for i, entry in enumerate(entries):
        prompt = entry["prompt"]
        seed = int(entry.get("seed", 42))
        negative_prompt = entry.get("negative_prompt", "")
        image, segment = results[i]
        record: T.Dict[str, T.Any] = {
            "index": i,
            "prompt": prompt,
            "negative_prompt": negative_prompt,
            "seed": seed,
        }
        if out_path is not None:
            stem = f"{i:03d}_{prompt.replace(' ', '_')[:40]}"
            image_path = out_path / f"{stem}.png"
            audio_path = out_path / f"{stem}.{extension}"
            image.save(image_path, exif=image.getexif(), format="PNG")
            segment.export(audio_path, format=extension)
            record["image"] = image_path.name
            record["audio"] = audio_path.name
        record["_image_obj"] = image
        record["_segment_obj"] = segment
        manifest.append(record)

    if out_path is not None:
        index = [{k: v for k, v in r.items() if not k.startswith("_")} for r in manifest]
        with open(out_path / "index.json", "w", encoding="utf-8") as fh:
            json.dump(index, fh, indent=2)
    return manifest


def render() -> None:
    import streamlit as st

    from riffusion_tpu_torch.streamlit import util as streamlit_util

    st.set_page_config(layout="wide", page_icon="🎸")
    st.subheader("📜 Text to Audio Batch")
    st.write("Generate audio in batch from a JSON file of prompts.")

    device = streamlit_util.select_device()
    extension = streamlit_util.select_audio_extension()

    with st.expander("Example input JSON"):
        st.json(EXAMPLE_INPUT)

    json_file = st.file_uploader("Upload JSON", type=["json"])
    output_dir = st.text_input("Output directory (optional)")

    if not json_file:
        st.info("Upload a JSON file to get started")
        return

    data = json.loads(json_file.read())
    manifest = run_batch(
        data, device=device, output_dir=output_dir or None, extension=extension
    )
    for record in manifest:
        st.write(f"#### {record['index']}: {record['prompt']} (seed {record['seed']})")
        st.image(record["_image_obj"])
        streamlit_util.display_and_download_audio(
            record["_segment_obj"],
            name=f"batch_{record['index']}",
            extension=extension,
        )
    if output_dir:
        st.success(f"Wrote outputs + index.json to {output_dir}")
