"""
The port's spans and stage times (riffusion_tpu_torch/tracing.py) on the
CPU: spans nest, carry their parent and their request or step id, and
lie inside their parent (its self time is what they leave); the ring's
bound and its drop count; with the switch off nothing is recorded, yet the
profiler still sees the range; the read rule of a replay's stage times
against events that have not completed (counted unread, never read
stale); the store's capture records a pair of events per stage only with
the switch on (CudaGraphs.timing_event, through a CPU stand-in); and the
spans of a served request and of a fine-tuning step on random:tiny.
"""

import functools
import json
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image
from torch.autograd import DeviceType

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch import aot, tracing
from riffusion_tpu_torch import server as server_mod
from riffusion_tpu_torch.models.weights import random_bundle
from riffusion_tpu_torch.ops.kernels import COUNTS
from riffusion_tpu_torch.parallel.train import DiffusionTrainer
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.training.finetune import ema_update


@pytest.fixture
def traced(monkeypatch):
    """The switch on, and the process's tracer empty before and after."""
    monkeypatch.setenv("RIFFUSION_TPU_TRACE", "1")
    tracing.reset()
    yield tracing.TRACER
    tracing.reset()


def _by_name(export):
    out = {}
    for s in export["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_spans_nest_with_parent_id_and_self_time(traced):
    with tracing.span("outer"):
        with tracing.span("inner"):
            with tracing.span("leaf"):
                pass
        with tracing.span("inner"):
            pass
    with tracing.span("outer"):  # no span open: a new id
        with tracing.span("request", root=True):  # a root inside: a new id too
            pass
    found = _by_name(tracing.export())
    (first, second), (request,) = found["outer"], found["request"]
    inner, (leaf,) = found["inner"], found["leaf"]
    assert first["parent"] is None and second["parent"] is None
    assert [s["parent"] for s in inner] == ["outer", "outer"] and leaf["parent"] == "inner"
    assert request["parent"] == "outer"
    assert len({first["id"], second["id"], request["id"]}) == 3
    assert {s["id"] for s in inner + [leaf]} == {first["id"]}
    assert {s["thread"] for s in found["inner"]} == {threading.get_ident()}
    for child, parent in [(inner[0], first), (inner[1], first), (leaf, inner[0])]:
        assert parent["start_ns"] <= child["start_ns"]
        assert child["start_ns"] + child["dur_ns"] <= parent["start_ns"] + parent["dur_ns"]
    self_ns = first["dur_ns"] - sum(s["dur_ns"] for s in inner)
    assert 0 <= self_ns <= first["dur_ns"]
    totals = tracing.export()["totals"]
    assert totals["inner"]["count"] == 2 and totals["outer"]["count"] == 2
    assert totals["outer"]["s"] == pytest.approx((first["dur_ns"] + second["dur_ns"]) / 1e9)


def test_spans_of_threads_keep_their_own_stack(traced):
    ids = {}

    def work(i):
        with tracing.span("request", root=True):
            ids[i] = traced.current_id()
            with tracing.span("child"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    children = _by_name(tracing.export())["child"]
    assert sorted(c["id"] for c in children) == sorted(ids.values())
    assert len(set(ids.values())) == 4 and {c["parent"] for c in children} == {"request"}


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setenv("RIFFUSION_TPU_TRACE", "1")
    tracer = tracing.Tracer(capacity=5)
    for i in range(8):
        with tracer.span(f"s{i}"):
            pass
    out = tracer.export()
    assert [s["name"] for s in out["spans"]] == [f"s{i}" for i in range(3, 8)]
    assert out["counters"]["dropped"] == 3
    assert sum(t["count"] for t in out["totals"].values()) == 8  # the aggregates drop nothing
    tracer.reset()
    assert tracer.export()["spans"] == [] and tracer.export()["counters"]["dropped"] == 0


@pytest.mark.parametrize("value", [None, "", "0"])
def test_off_records_nothing_yet_enters_record_function(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("RIFFUSION_TPU_TRACE", raising=False)
    else:
        monkeypatch.setenv("RIFFUSION_TPU_TRACE", value)
    tracer = tracing.Tracer()
    assert not tracing.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("riffusion.off_span"), tracer.stage("riffusion.off_stage"):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert {"riffusion.off_span", "riffusion.off_stage"} <= names
    out = tracer.export()
    assert out["spans"] == [] and out["totals"] == {} and out["replays"] == []
    assert out["counters"] == dict.fromkeys(out["counters"], 0)


class FakeEvent:
    """A timing event whose completion the test sets; reading the time of
    one that has not completed fails, as cudaEventElapsedTime does."""

    def __init__(self, clock):
        self.clock, self.recorded = clock, 0

    def record(self):
        self.recorded += 1

    def query(self):
        return self.clock["done"]

    def elapsed_time(self, end):
        if not (self.clock["done"]):
            raise RuntimeError("the event has not completed")
        return self.clock["ms"].get((id(self), id(end)), 1.0)


def _stage_pairs(clock, names):
    pairs = [(n, FakeEvent(clock), FakeEvent(clock)) for n in names]
    clock["ms"] = {}
    return pairs


def test_replay_times_read_one_launch_behind_and_never_stale(traced):
    clock = {"done": False}
    pairs = _stage_pairs(clock, ["a", "b", "a"])
    times = tracing.StageTimes("key", pairs)

    def write(ms):  # what a replay leaves in the events
        clock["ms"] = {(id(s), id(e)): v for (_, s, e), v in zip(pairs, ms)}

    times.read()  # nothing replayed yet: nothing read, nothing counted
    assert traced.export()["counters"]["stage_read"] == 0
    with tracing.span("riffusion.request", root=True):
        first = traced.current_id()
        write([1.0, 2.0, 3.0])
        times.replayed(123)
    times.read()  # still running at the next launch: unread, never read
    replay = traced.export()["replays"][-1]
    assert replay == {"key": "key", "id": first, "start_ns": 123, "stages": None}
    write([10.0, 20.0, 30.0])  # the next replay writes the events
    times.replayed(456)
    clock["done"] = True
    times.read()
    out = traced.export()
    assert out["replays"][-1]["stages"] == {"a": 40.0, "b": 20.0}  # summed by name
    assert out["replays"][-1]["start_ns"] == 456 and out["replays"][-1]["id"] is None
    assert out["counters"]["stage_read"] == 1 and out["counters"]["stage_unread"] == 1
    assert out["stages"] == {"a": {"count": 1, "s": 0.04}, "b": {"count": 1, "s": 0.02}}
    times.read()  # read once only
    assert traced.export()["counters"]["stage_read"] == 1


class StandInGraphs(aot.CudaGraphs):
    """The store's card side on the CPU: a "graph" is the program with its
    static buffers, a replay runs it again into the static outputs, and a
    stage's timing event is a FakeEvent, completed."""

    def __init__(self):
        super().__init__()
        self.clock = {"done": True, "ms": {}}
        self.events = []

    def pool(self):
        return None

    def warmup(self, fn, args):
        return fn(*args)

    def capture(self, fn, args, pool):
        outputs = fn(*args)
        return (fn, args, outputs), outputs

    def replay(self, graph):
        fn, args, outputs = graph
        for static, x in zip(aot._tensors(outputs), aot._tensors(fn(*args))):
            static.copy_(x)

    def timing_event(self):
        event = FakeEvent(self.clock)
        self.events.append(event)
        return event


def _staged(x, y):
    with tracing.stage("riffusion.one"):
        x = x * 2.0
    with tracing.stage("riffusion.two"):
        y = y + x
    return y, None


@pytest.mark.parametrize("switch", ["1", None])
def test_a_capture_records_two_events_a_stage_only_with_the_switch(monkeypatch, switch):
    if switch is None:
        monkeypatch.delenv("RIFFUSION_TPU_TRACE", raising=False)
    else:
        monkeypatch.setenv("RIFFUSION_TPU_TRACE", switch)
    tracing.reset()
    COUNTS.reset()
    graphs = StandInGraphs()
    program = aot.GraphProgram(_staged, "staged", graphs=graphs)
    args = (torch.ones(3), torch.zeros(3))
    out, _ = program(*args)  # the capture
    (entry,) = program._captured.values()
    if switch is None:
        for _ in range(3):
            out, _ = program(*args)
        assert torch.equal(out, torch.full((3,), 2.0))
        assert graphs.events == [] and entry.stages is None and tracing.export()["spans"] == []
        return
    assert [n for n, _, _ in entry.stages.pairs] == ["riffusion.one", "riffusion.two"]
    assert len(graphs.events) == 4 and all(e.recorded == 1 for e in graphs.events)
    for (_, start, end), ms in zip(entry.stages.pairs, (1.5, 2.5)):
        graphs.clock["ms"][(id(start), id(end))] = ms
    for _ in range(3):  # each launch reads the replay before it
        out, _ = program(*args)
    assert torch.equal(out, torch.full((3,), 2.0))
    result = tracing.export()
    assert result["counters"] == {"dropped": 0, "replays_dropped": 0, "stage_read": 2,
                                  "stage_unread": 0, "text_encoder_2_calls": 0,
                                  "allreduce_calls": 0, "group_norm_launches": 0,
                                  "group_norm_library_calls": 0, "launches": 0,
                                  "k1_ws_launches": 0, "plain_self_sites": 0,
                                  "adamw_launches": 0}
    assert [r["stages"] for r in result["replays"]] == [{"riffusion.one": 1.5,
                                                         "riffusion.two": 2.5}] * 2
    assert result["stages"]["riffusion.one"] == {"count": 2, "s": 0.003}
    assert result["totals"]["riffusion.launch"]["count"] == 4


def test_the_launch_span_times_every_call(traced):
    program = aot.GraphProgram(_staged, "k", graphs=StandInGraphs())
    for _ in range(3):
        program(torch.ones(2), torch.ones(2))
    launches = _by_name(tracing.export())["riffusion.launch"]
    assert len(launches) == 3 and all(s["dur_ns"] > 0 for s in launches)
    assert "replay_s" not in program.reports()[0]


def _seed_dir(tmp_path):
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)
                    ).save(tmp_path / "og_beat.png")
    return tmp_path


def test_a_served_request_spans(traced, tmp_path):
    """One POST on random:tiny: every span of the request shares its id and
    nests as server.py and riffusion_pipeline.py say."""
    server_mod.PIPELINE = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    srv = server_mod.RiffusionServer(("127.0.0.1", 0), seed_images_dir=_seed_dir(tmp_path))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        body = (b'{"start": {"prompt": "bells", "seed": 1}, "end": {"prompt": "techno", '
                b'"seed": 2}, "alpha": 0.5, "num_inference_steps": 2, '
                b'"seed_image_id": "og_beat"}')
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/run_inference/",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200 and resp.read()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        server_mod.PIPELINE = None
    found = _by_name(tracing.export())
    (request,) = found["riffusion.request"]
    assert request["parent"] is None
    expected = {
        "riffusion.front.decode": "riffusion.request", "riffusion.call": "riffusion.request",
        "riffusion.front.encode": "riffusion.request", "riffusion.front.send": "riffusion.request",
        "riffusion.prepare": "riffusion.call", "riffusion.launch": "riffusion.call",
        "riffusion.finish": "riffusion.call", "riffusion.text": "riffusion.prepare",
        "riffusion.vae_encode": "riffusion.launch", "riffusion.denoise": "riffusion.launch",
        "riffusion.vae_decode": "riffusion.launch", "riffusion.audio": "riffusion.launch",
    }
    for name, parent in expected.items():
        assert {(s["parent"], s["id"]) for s in found[name]} == {(parent, request["id"])}, name
    assert len(found["riffusion.front.decode"]) == 2  # the body, then the seed image
    (call,) = found["riffusion.call"]
    assert sum(s["dur_ns"] for s in found["riffusion.launch"]) < call["dur_ns"]


def test_a_fine_tuning_step_spans(traced):
    """A step at bf16 compute on the CPU: the step's spans share its id, a
    new one each step; each EMA update's launch and stage share an id of
    their own."""
    unet = random_bundle("tiny", seed=0, device="cpu").unet
    trainer = DiffusionTrainer(device="cpu", learning_rate=1e-3, dtype=torch.bfloat16)
    trainer.init_from(unet)
    params = dict(trainer.master.named_parameters())
    ema = {n: p.detach().clone() for n, p in params.items()}
    ema_step = trainer.program("ema_update", functools.partial(ema_update, ema, params, 0.9))
    rng = np.random.default_rng(0)
    for _ in range(2):
        trainer.step(rng.standard_normal((1, 8, 8, 4)), rng.standard_normal((1, 77, 64)),
                     generator=torch.Generator().manual_seed(0))
        ema_step()
    found = _by_name(tracing.export())
    steps = found["riffusion.train.step"]
    assert len(steps) == 2 and len({s["id"] for s in steps}) == 2
    for name, parent in {"riffusion.train.upload": "riffusion.train.step",
                         "riffusion.launch": "riffusion.train.step",
                         "riffusion.train.copy": "riffusion.launch",
                         "riffusion.train.forward": "riffusion.launch",
                         "riffusion.train.backward": "riffusion.launch",
                         "riffusion.train.grads": "riffusion.launch",
                         "riffusion.train.optimizer": "riffusion.launch"}.items():
        ours = [s for s in found[name] if s["id"] in {s["id"] for s in steps}]
        assert sorted((s["parent"], s["id"]) for s in ours) == sorted(
            (parent, s["id"]) for s in steps), name
    emas = found["riffusion.train.ema"]
    launches = [s for s in found["riffusion.launch"] if s["parent"] is None]
    assert len(emas) == 2 and {s["parent"] for s in emas} == {"riffusion.launch"}
    assert sorted(s["id"] for s in emas) == sorted(s["id"] for s in launches)
    assert not {s["id"] for s in emas} & {s["id"] for s in steps}


def test_a_dataset_batch_span(traced, tmp_path):
    from riffusion_tpu_torch.training.dataset import LatentDataset

    rng = np.random.default_rng(0)
    np.savez(tmp_path / "shard_00000.npz", mean=rng.standard_normal((4, 8, 8, 4)).astype(
        np.float16), logvar=np.full((4, 8, 8, 4), -4.0, np.float16),
        ctx=np.zeros(4, np.int32))
    np.save(tmp_path / "contexts.npy", np.zeros((1, 77, 16), np.float16))
    (tmp_path / "meta.json").write_text(
        '{"num_clips": 4, "latent_shape": [8, 8, 4], "context_shape": [77, 16], '
        '"scaling_factor": 0.18215, "num_shards": 1, "prompts": ["p"], "params": {}}')
    batches = LatentDataset(tmp_path).batches(2, seed=0)
    for _ in range(3):
        next(batches)
    spans = _by_name(tracing.export())["riffusion.data.batch"]
    assert len(spans) == 3 and {s["parent"] for s in spans} == {None}
    assert len({s["id"] for s in spans}) == 3


def _device_event(name, start, end, device_type=DeviceType.CUDA, is_user_annotation=False):
    """A profiler's device event, as riffusion_tpu_torch.profile reads one."""
    return types.SimpleNamespace(
        name=name, device_type=device_type, is_user_annotation=is_user_annotation,
        time_range=types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start))


def test_profile_train_parts_keep_the_backward():
    """The train profile's parts of an eager step, on the device ranges a card
    gives (µs): the spans around the stages (the step, its upload, the
    launches) contain every kernel, yet take none; the backward's kernels,
    launched on autograd's thread, start in no stage's range and form their
    own part; AdamW's kernels lie in its own annotation's range (the
    innermost), not in riffusion.train.optimizer's, and count as that
    stage's."""
    from riffusion_tpu_torch import profile

    annotations = [_device_event(*a) for a in (
        ("riffusion.train.step", 0, 90), ("riffusion.train.upload", 0, 5),
        ("riffusion.launch", 5, 90), ("riffusion.train.copy", 6, 8),
        ("riffusion.train.forward", 12, 20), ("riffusion.train.backward", 30, 31),
        ("riffusion.train.grads", 61, 65), ("Optimizer.step#AdamW.step", 72, 80),
        ("riffusion.launch", 95, 99),
        ("riffusion.train.ema", 96, 99))]
    kernels = [_device_event("k", *k) for k in (
        (6, 8), (12, 20), (30, 31), (32, 40), (41, 55), (61, 65), (72, 80), (96, 99))]
    assert profile.kernel_ms_by_part(annotations, kernels) == {
        "riffusion.train.copy": 2e-3, "riffusion.train.forward": 8e-3,
        "riffusion.train.backward": 1e-3, profile.BACKWARD: 22e-3,
        "riffusion.train.grads": 4e-3, "riffusion.train.optimizer": 8e-3,
        "riffusion.train.ema": 3e-3}


def test_profile_device_summary():
    """The profiler's summary of a window, on a card's event layout (µs):
    the busy time is the kernels' and copies' time, not the device ranges
    of the annotations around them; the riffusion.* spans keep their host
    and device time apart; a kernel's time goes to the table's __global__
    name it runs, whatever the instance's template arguments; the top
    kernels come by time."""
    from riffusion_tpu_torch import profile

    host = DeviceType.CPU
    bf16_48 = "void riff::attention_fwd_bf16_kernel<48, 40, 2, false>(riff::Params)"
    bf16_80 = "void riff::attention_fwd_bf16_kernel<80, 80, 2, false>(riff::Params)"
    events = [_device_event(*e) for e in (
        ("riffusion.denoise", 0, 900, host), ("riffusion.denoise", 10, 800),
        ("riffusion.vae_decode", 900, 1000, host),
        ("Optimizer.step#AdamW.step", 0, 1000, DeviceType.CUDA, True),
        (bf16_48, 10, 110), (bf16_80, 120, 170),
        ("void riffgn::group_norm_apply_kernel<__nv_bfloat16>(x)", 200, 220),
        ("void riffgn::group_norm_apply_kernel<__nv_bfloat16>(x)", 230, 250),
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 300, 700),
        ("Memcpy HtoD (Pageable -> Device)", 800, 810))]
    out = profile.device_summary(types.SimpleNamespace(events=lambda: events), 2e-3)
    assert out["device_busy_ms"] == pytest.approx(0.6)
    assert out["device_idle_share"] == pytest.approx(0.7)
    assert out["device_ops"] == 6
    assert out["stages"] == {"riffusion.denoise": {"host_span_ms": 0.9, "device_span_ms": 0.79},
                             "riffusion.vae_decode": {"host_span_ms": 0.1}}
    assert list(out["kernel_ms"]) == ["attention_fwd_bf16_kernel", "group_norm_apply_kernel"]
    assert out["kernel_ms"]["attention_fwd_bf16_kernel"]["ms"] == pytest.approx(0.15)
    assert out["kernel_ms"]["group_norm_apply_kernel"] == {"ms": pytest.approx(0.04), "count": 2}
    assert [(k["name"], k["count"]) for k in out["top_kernels"]] == [
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 1), (bf16_48, 1), (bf16_80, 1),
        ("void riffgn::group_norm_apply_kernel<__nv_bfloat16>(x)", 2),
        ("Memcpy HtoD (Pageable -> Device)", 1)]
    idle = profile.device_summary(types.SimpleNamespace(events=lambda: events[:3]), 2e-3)
    assert (idle["device_ops"], idle["device_idle_share"]) == (0, None)


def test_export_is_plain_data(traced):
    with tracing.span("a"):
        pass
    assert json.loads(json.dumps(tracing.export()))["totals"]["a"]["count"] == 1
