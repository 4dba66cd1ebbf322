"""
The port's HTTP server (riffusion_tpu_torch/server.py) in-process on the
CPU with random:tiny: a real socket and real requests, mirroring
tests/test_server.py for the unbatched surface (POST /run_inference/,
GET /health, 400 on bad input, InferenceOutput JSON with data-URI payloads).
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
from PIL import Image

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch import server as server_mod
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.server import RiffusionServer


@pytest.fixture(scope="module")
def running_server(tmp_path_factory):
    seed_dir = tmp_path_factory.mktemp("seeds")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
        seed_dir / "og_beat.png"
    )
    Image.fromarray(np.full((64, 64), 200, np.uint8)).save(seed_dir / "test_mask.png")

    server_mod.PIPELINE = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    srv = RiffusionServer(("127.0.0.1", 0), seed_images_dir=seed_dir)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    server_mod.PIPELINE = None


def _post(url: str, payload: bytes, route: str = "/run_inference/"):
    req = urllib.request.Request(
        url + route, data=payload, headers={"Content-Type": "application/json"}
    )
    return urllib.request.urlopen(req, timeout=300)


def _valid_payload(**overrides):
    body = {
        "start": {"prompt": "church bells", "seed": 42},
        "end": {"prompt": "techno", "seed": 123},
        "alpha": 0.5,
        "num_inference_steps": 2,
        "seed_image_id": "og_beat",
    }
    body.update(overrides)
    return json.dumps(body).encode()


def _post_error(url: str, payload: bytes, route: str = "/run_inference/"):
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(url, payload, route)
    return exc_info.value.code, exc_info.value.read().decode()


def test_run_inference_happy_path(running_server):
    resp = _post(running_server, _valid_payload())
    assert resp.status == 200
    out = json.loads(resp.read())
    assert set(out) == {"image", "audio", "duration_s"}
    assert out["image"].startswith("data:image/jpeg;base64,")
    img = Image.open(io.BytesIO(base64.b64decode(out["image"].split(",", 1)[1])))
    assert img.size == (64, 64)
    # 64 spectrogram columns at a 10 ms hop: 0.63 s of audio
    assert abs(out["duration_s"] - 0.63) < 0.02
    if out["audio"].startswith("data:audio/wav;base64,"):
        with wave.open(io.BytesIO(base64.b64decode(out["audio"].split(",", 1)[1]))) as w:
            samples = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        assert samples.size > 0 and np.abs(samples.astype(int)).max() > 0


def test_run_inference_with_mask(running_server):
    assert _post(running_server, _valid_payload(mask_image_id="test_mask")).status == 200


def test_health(running_server):
    resp = urllib.request.urlopen(running_server + "/health", timeout=30)
    assert json.loads(resp.read()) == {"status": "ok", "model_loaded": True}


@pytest.mark.parametrize(
    "payload,message",
    [
        (b"{not json", ""),
        (json.dumps({"alpha": 0.5}).encode(), "missing required field"),
        (json.dumps({**json.loads(_valid_payload()), "bogus": 1}).encode(), ""),
        (_valid_payload(seed_image_id="nope"), "Invalid seed image"),
        (_valid_payload(mask_image_id="nope"), "Invalid mask image"),
    ],
    ids=["malformed-json", "missing-field", "unknown-field", "bad-seed", "bad-mask"],
)
def test_bad_request_400(running_server, payload, message):
    code, body = _post_error(running_server, payload)
    assert code == 400
    assert message in body


def test_wrong_route_404(running_server):
    code, _ = _post_error(running_server, b"{}", route="/other/")
    assert code == 404
    code, _ = _post_error(running_server, _valid_payload(), route="/run_inference_batch/")
    assert code == 404
