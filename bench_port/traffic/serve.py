"""
Serving traffic: closed-loop clients sending `POST /run_inference/` to the
port's HTTP server, in this process, over a socket on 127.0.0.1.

The cell's `params` say how many clients there are and what the requests
are: each client plays a listener of the riffusion app, walking from one
prompt to the next in steps of `alphas`, a fresh seed at each prompt, the
prompts drawn from `words`. Every request has the same shape (one 512x512
seed image, prompts of at most 75 tokens, the same steps and strength), so
every seed gives the same work in another order.

Set-up: weights from the seed, the pipeline and the server; then
`warmup_requests` rounds of requests from every client (their own seeds),
which capture every program key the window uses. The window runs for the
run's seconds; requests in flight when it closes are waited for and
checked, and not timed. Then the server stops, the program's memory is
freed, and a sample of the window's clips, drawn from the seed, is checked
against the plain reference (bench_port/check_serve.py).
"""

from __future__ import annotations

import base64
import gc
import http.client
import io
import json
import threading
import time
import typing as T
import urllib.request
import wave

import numpy as np

from bench_port import check_serve, count, harness, sut


def request_stream(params: T.Mapping[str, T.Any], seed: int, stream: int
                   ) -> T.Iterator[T.Dict[str, T.Any]]:
    """One listener's requests: alpha walks between consecutive prompts."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, stream])
    words = params["words"]
    lo, hi = params["prompt_words"]

    def prompt() -> T.Dict[str, T.Any]:
        n = int(rng.integers(lo, hi + 1))
        text = " ".join(words[i] for i in rng.choice(len(words), size=n, replace=False))
        return {"prompt": text, "seed": int(rng.integers(0, 2 ** 31 - 1)),
                "denoising": params["denoising"], "guidance": params["guidance"]}

    current = prompt()
    while True:
        following = prompt()
        for alpha in params["alphas"]:
            yield {"start": current, "end": following, "alpha": alpha,
                   "num_inference_steps": params["num_inference_steps"],
                   "seed_image_id": params["seed_image_id"]}
        current = following


def request_key(body: T.Mapping[str, T.Any]) -> T.Tuple:
    s, e = body["start"], body["end"]
    return (s["prompt"], s["seed"], e["prompt"], e["seed"], float(body["alpha"]))


def _input_key(inputs) -> T.Tuple:
    return (inputs.start.prompt, inputs.start.seed, inputs.end.prompt, inputs.end.seed,
            float(inputs.alpha))


def decode_response(payload: bytes, size: T.Tuple[int, int]) -> str:
    """The audio format of a valid InferenceOutput body; raises ValueError
    where the body does not decode to a `size` image and a clip."""
    from PIL import Image

    out = json.loads(payload)
    head, data = out["image"].split(",", 1)
    if head != "data:image/jpeg;base64":
        raise ValueError(f"image is {head}")
    image = Image.open(io.BytesIO(base64.b64decode(data)))
    image.load()
    if image.size != size:
        raise ValueError(f"image of {image.size}, expected {size}")
    head, data = out["audio"].split(",", 1)
    blob = base64.b64decode(data)
    if head == "data:audio/wav;base64":
        with wave.open(io.BytesIO(blob)) as w:
            if w.getnframes() <= 0:
                raise ValueError("empty wav")
        return "wav"
    if head == "data:audio/mpeg;base64" and len(blob) > 0:
        return "mp3"
    raise ValueError(f"audio is {head} of {len(blob)} bytes")


class _Clients:
    """Closed-loop clients: each sends its next request when the last one's
    response has been read whole, until `stop` is set, and appends its
    record to `requests`."""

    def __init__(self, url: str, streams: T.List[T.Iterator[dict]], size,
                 requests: T.List[harness.Request], spans: T.List):
        self.url, self.streams, self.size = url, streams, size
        self.requests, self.spans = requests, spans
        self.stop = threading.Event()
        self.bodies: T.Dict[T.Tuple, dict] = {}
        self.formats: T.Dict[str, int] = {}
        self.lock = threading.Lock()
        self.threads = [threading.Thread(target=self._loop, args=(i,), daemon=True)
                        for i in range(len(streams))]

    def send(self, body: dict) -> harness.Request:
        with harness.span(self.spans, "request (the HTTP front outside the call)"):
            return self._send(body)

    def _send(self, body: dict) -> harness.Request:
        req = harness.Request(key=request_key(body), sent=time.monotonic())
        http = urllib.request.Request(self.url, data=json.dumps(body).encode(),
                                      headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(http, timeout=300) as resp:
                payload = resp.read()
            req.done = time.monotonic()
            fmt = decode_response(payload, self.size)
            req.ok = True
            with self.lock:
                self.formats[fmt] = self.formats.get(fmt, 0) + 1
        except (OSError, ValueError, KeyError, http.client.HTTPException) as exc:
            req.done = req.done or time.monotonic()
            req.error = f"{type(exc).__name__}: {exc}"[:300]
        return req

    def _loop(self, i: int) -> None:
        stream = self.streams[i]
        while not self.stop.is_set():
            body = next(stream)
            with self.lock:
                self.bodies[request_key(body)] = body
            req = self.send(body)
            with self.lock:
                self.requests.append(req)

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def join(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        for t in self.threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        return not any(t.is_alive() for t in self.threads)


def run(record: harness.Record) -> None:
    import torch
    from PIL import Image

    params, cfg = record.cell["params"], record.config
    device = record.device
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    states = sut.weights(cfg, record.seed, device)
    pipe = sut.pipeline(cfg, states, device)
    size = Image.open(sut.INPUTS / f"{params['seed_image_id']}.png").size
    record.notes["evaluations"] = count.serving_evaluations(
        cfg["scheduler"], params["num_inference_steps"], params["denoising"])

    served: T.Dict[T.Tuple, T.Tuple[np.ndarray, np.ndarray]] = {}
    server_s: T.Dict[T.Tuple, float] = {}
    srv = sut.server(pipe)
    call = pipe.riffuse_audio

    def timed(inputs, *args, **kwargs):
        t0 = time.monotonic()
        with harness.span(record.spans, "the call the server hands it to (riffuse_audio)"):
            image, segment = call(inputs, *args, **kwargs)
        key = _input_key(inputs)
        server_s[key] = time.monotonic() - t0
        served[key] = (np.asarray(image), segment.raw_data[:, 0].copy())
        return image, segment

    pipe.riffuse_audio = timed
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/run_inference/"
    clients = params["clients"]
    try:
        warm = _Clients(url, [request_stream(params, record.seed, 1000 + i)
                              for i in range(clients)], size, [], [])
        for _ in range(params["warmup_requests"]):
            rounds = [threading.Thread(target=lambda s=s: warm.send(next(s)))
                      for s in warm.streams]
            for t in rounds:
                t.start()
            for t in rounds:
                t.join()
        served.clear()
        server_s.clear()
        harness.sync(device)

        loop = _Clients(url, [request_stream(params, record.seed, i) for i in range(clients)],
                        size, record.requests, record.spans)
        t0 = time.monotonic()
        record.setup_s = t0 - record.started
        trace = harness.WindowTrace(record.trace, t0 + record.seconds)
        trace.poll()
        loop.start()
        while time.monotonic() < t0 + record.seconds:
            time.sleep(0.02)
            trace.poll()
        t1 = time.monotonic()
        loop.stop.set()
        record.window = (t0, t1)
        record.traced_from = trace.t0
        trace.finish()
        if not loop.join(timeout=120):
            record.notes["clients_left"] = "some requests never came back"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    harness.sync(device)
    record.memory_peak_bytes = harness.memory_peak(device)
    record.device_trace = trace.result
    for req in record.requests:
        req.server_s = server_s.get(req.key, float("nan"))
    record.attempted = len(record.requests)
    record.failed = sum(not r.ok for r in record.requests) + len(loop.threads) * (
        "clients_left" in record.notes)
    record.counters["graphs"] = [rep for prog in pipe.graph_store.programs.values()
                                 for rep in prog.reports()]
    ok = [r for r in record.requests if r.ok]
    record.notes.update(
        requests={"sent": len(record.requests), "succeeded": len(ok),
                  "failed": len(record.requests) - len(ok),
                  "errors": sorted({r.error for r in record.requests if not r.ok})[:5]},
        audio_format=loop.formats)

    # free the program, then the check
    del srv, call, pipe
    from riffusion_tpu_torch import server as port_server

    port_server.PIPELINE = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    bodies = {k: b for k, b in loop.bodies.items() if k in served}
    check_serve.check(record, states, bodies, served)
