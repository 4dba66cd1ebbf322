"""
The port's HTTP server (riffusion_tpu_torch/server.py) in-process on the
CPU with random:tiny: a real socket and real requests, mirroring
tests/test_server.py: POST /run_inference/ and /run_inference_batch/, GET
/health and /stats, 400 on bad input, InferenceOutput JSON with data-URI
payloads, and the threading server with a DynamicBatcher; the TLS flags
and server.log.
"""

import base64
import io
import json
import logging
import ssl
import subprocess
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch import server as server_mod
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.serving import DynamicBatcher
from riffusion_tpu_torch.server import RiffusionServer, RiffusionThreadingServer


@pytest.fixture(scope="module")
def running_server(tmp_path_factory):
    seed_dir = tmp_path_factory.mktemp("seeds")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
        seed_dir / "og_beat.png"
    )
    Image.fromarray(np.full((64, 64), 200, np.uint8)).save(seed_dir / "test_mask.png")
    Image.fromarray(np.full((64, 64, 3), 90, np.uint8)).save(seed_dir / "other_seed.png")

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


def _check_output(out, size=64):
    img = Image.open(io.BytesIO(base64.b64decode(out["image"].split(",", 1)[1])))
    assert img.size == (size, size)
    assert abs(out["duration_s"] - 0.63) < 0.02


def _batch_payload(n=3, **overrides):
    reqs = [json.loads(_valid_payload(**overrides)) for _ in range(n)]
    for i, r in enumerate(reqs):
        r["start"]["seed"] = 42 + i
    return reqs


def test_run_inference_batch(running_server):
    reqs = _batch_payload(mask_image_id="test_mask")
    resp = _post(running_server, json.dumps({"requests": reqs}).encode(),
                 route="/run_inference_batch/")
    assert resp.status == 200
    outputs = json.loads(resp.read())["outputs"]
    assert len(outputs) == 3
    for out in outputs:
        _check_output(out)
    assert len({out["image"] for out in outputs}) == 3  # three seeds, three images


def _mixed(field, value):
    reqs = _batch_payload(2)
    reqs[1][field] = value
    return reqs


@pytest.mark.parametrize(
    "body,message",
    [
        ([], "expected"),
        ({"requests": []}, "empty batch"),
        ({"requests": [{"alpha": 0.5}]}, "missing required field"),
        ({"requests": _mixed("seed_image_id", "other_seed")}, "single seed_image_id"),
        ({"requests": _mixed("num_inference_steps", 3)}, "single num_inference_steps"),
        ({"requests": _mixed("mask_image_id", "test_mask")}, "single shared mask_image_id"),
        ({"requests": _batch_payload(2, seed_image_id="nope")}, "Invalid seed image"),
        ({"requests": _batch_payload(2, mask_image_id="nope")}, "Invalid mask image"),
        ({"requests": [json.loads(_valid_payload()),
                       json.loads(_valid_payload(end={"prompt": "x", "seed": 1,
                                                      "denoising": 0.5}))]},
         "single denoising strength"),
    ],
    ids=["not-a-dict", "empty", "bad-request", "mixed-seed-ids", "mixed-steps", "mixed-masks",
         "bad-seed", "bad-mask", "mixed-strengths"],
)
def test_run_inference_batch_400(running_server, body, message):
    code, text = _post_error(running_server, json.dumps(body).encode(),
                             route="/run_inference_batch/")
    assert code == 400
    assert message in text


def test_stats(running_server):
    _post(running_server, _valid_payload())
    stats = json.loads(urllib.request.urlopen(running_server + "/stats", timeout=30).read())
    assert stats["requests"] >= 1 and stats["total_seconds"] > 0
    assert "batching" not in stats  # no batcher on the plain server


def test_programs_take_turns_on_the_device(running_server, monkeypatch):
    """A /run_inference_batch/ thread and the batcher's worker both dispatch
    through the pipeline: their programs never run at the same time."""
    pipe = server_mod.PIPELINE
    active, overlaps = [0], []
    out = np.zeros((1, 64, 64, 3), np.uint8)

    def generate(*args):
        active[0] += 1
        overlaps.append(active[0])
        threading.Event().wait(0.05)
        active[0] -= 1
        return torch.from_numpy(out), None

    monkeypatch.setattr(pipe, "_generate", generate)
    threads = [threading.Thread(target=lambda: pipe._dispatch()()) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert overlaps == [1, 1, 1, 1]


def test_dynamic_batching_server(running_server, tmp_path):
    """The threading server with a batcher: concurrent /run_inference/
    requests come back 200 each, as one launch; /stats shows it."""
    seed_dir = tmp_path
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(seed_dir / "og_beat.png")
    srv = RiffusionThreadingServer(("127.0.0.1", 0), seed_images_dir=seed_dir)
    srv.batcher = DynamicBatcher(server_mod.PIPELINE, max_batch=4, window_ms=1500)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        statuses = [None] * 3

        def post(i):
            with _post(url, _valid_payload(start={"prompt": "a", "seed": i})) as resp:
                statuses[i] = resp.status
                _check_output(json.loads(resp.read()))

        posts = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=300)
        assert statuses == [200, 200, 200]
        stats = json.loads(urllib.request.urlopen(url + "/stats", timeout=30).read())
        assert stats["requests"] == 3
        assert stats["batching"]["launches"] == 1
        assert stats["batching"]["batched_requests"] == 3
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.shutdown()


# ------------------------------------------------------------ TLS and the log


def test_tls_flags_parse_and_a_certificate_needs_a_key():
    """--ssl-certificate / --ssl-key reach create_app (as the JAX server's
    flags of the same names); a certificate without a key is refused by the
    parser and by create_app, before any model is loaded."""
    args = server_mod.parse_args(["--ssl-certificate", "c.pem", "--ssl-key", "k.pem"])
    assert (args["ssl_certificate"], args["ssl_key"]) == ("c.pem", "k.pem")
    assert server_mod.parse_args([])["ssl_certificate"] is None
    with pytest.raises(SystemExit):
        server_mod.parse_args(["--ssl-certificate", "c.pem"])
    with pytest.raises(ValueError, match="needs --ssl-key"):
        server_mod.create_app(checkpoint="random:nonexistent", ssl_certificate="c.pem")


def _self_signed(tmp_path):
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
                    "-subj", "/CN=localhost", "-keyout", str(key), "-out", str(cert)],
                   check=True, capture_output=True, timeout=60)
    return cert, key


def test_https_and_server_log(tmp_path, monkeypatch, caplog):
    """run_app with a self-signed certificate: the listening socket speaks
    TLS (GET /health over HTTPS), and the log goes to server.log in the
    working directory."""
    caplog.set_level(logging.INFO)  # what run_app's basicConfig sets outside pytest
    cert, key = _self_signed(tmp_path)
    monkeypatch.chdir(tmp_path)
    ready, bound = threading.Event(), {}
    create_app = server_mod.create_app

    def create_and_report(**kwargs):
        srv = create_app(**kwargs)
        bound["server"] = srv
        ready.set()
        return srv

    monkeypatch.setattr(server_mod, "create_app", create_and_report)
    kwargs = server_mod.parse_args(["--checkpoint", "random:tiny", "--device", "cpu",
                                    "--port", "0", "--ssl-certificate", str(cert),
                                    "--ssl-key", str(key)])
    thread = threading.Thread(target=server_mod.run_app, kwargs=kwargs, daemon=True)
    root = logging.getLogger()
    handlers = list(root.handlers)
    thread.start()
    try:
        assert ready.wait(120)
        srv = bound["server"]
        ctx = ssl.create_default_context(cafile=str(cert))
        ctx.check_hostname = False
        url = f"https://127.0.0.1:{srv.server_address[1]}/health"
        with urllib.request.urlopen(url, context=ctx, timeout=30) as resp:
            assert resp.status == 200
        with pytest.raises(OSError):  # plain HTTP is not spoken (reset or refused)
            urllib.request.urlopen(url.replace("https", "http"), timeout=30)
        srv.shutdown()
        thread.join(timeout=30)
        log = (tmp_path / "server.log").read_text()
        assert "Serving on https://" in log
    finally:
        for handler in set(root.handlers) - set(handlers):
            root.removeHandler(handler)
            handler.close()
        server_mod.PIPELINE = None
