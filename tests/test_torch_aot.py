"""
The port's whole-request programs and their store (riffusion_tpu_torch/
aot.py, the host part / device program split of riffusion_pipeline.py)
against the JAX package's, on the CPU at the tiny geometry:

- the keys: each program's key equals the string the JAX package's
  `_aot_key` builds for the same request (riffuse, riffuse_batch, txt2img,
  txt2img_batch, magic_mix), read from the AotProgram it would run;
- the split: the host part plus the device program equal, bit for bit, the
  unsplit program (a copy of the port's `_generate` before the split, kept
  here as the reference) on the same noises, and stay within
  tests/test_torch_pipeline.py's bounds of JAX's `_riffuse_program`;
- the hoisted constants: the scheduler tables and the STFT window and
  envelope, uploaded once, give the same steps as a fresh upload per call;
- the store's bookkeeping, with a stand-in for the card's graphs (a
  "graph" that runs the program again on its static buffers): one capture
  per signature, new inputs give the new result, ops.kernels.COUNTS per
  replay equal to an eager call's, a failed capture raising with the key
  and the operation, and the RIFFUSION_TPU_NO_AOT switch.

The captures on the card: tests/test_torch_aot_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch.overrides import TorchFunctionMode

from torch_port_util import jax_twin, torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu import aot as jax_aot
from riffusion_tpu import riffusion_pipeline as jax_pipeline
from riffusion_tpu_torch import aot, tracing
from riffusion_tpu_torch import riffusion_pipeline as pipeline
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.diffusion import schedulers as sched
from riffusion_tpu_torch.models.weights import bundle_from_jax_params
from riffusion_tpu_torch.ops import attention, codec
from riffusion_tpu_torch.ops.kernels import COUNTS, Counts
from riffusion_tpu_torch.ops.stft import get_stft_kernel
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import torch_util

SIZE = 64
PARAMS = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=SIZE)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pipes():
    jp = jax_pipeline.RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    bundle = bundle_from_jax_params(
        "tiny", jp.unet_params, jp.vae_params, jp.clip_params, device="cpu"
    )
    return jp, pipeline.RiffusionPipeline(bundle, device="cpu")


def _image(seed: int = 0) -> Image.Image:
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8), mode="RGB")


def _mask() -> Image.Image:
    return Image.fromarray(np.tile(np.array([0, 255] * (SIZE // 2), np.uint8), (SIZE, 1)))


def _request(i: int = 0, steps: int = 6, alpha: float = 0.3, guidance: float = 1.75,
             denoising: float = 0.75) -> InferenceInput:
    return InferenceInput(
        start=PromptInput(prompt=f"church bells {i}", seed=42 + i, negative_prompt="noise",
                          guidance=guidance, denoising=denoising),
        end=PromptInput(prompt=f"techno {i}", seed=123 + i, guidance=guidance,
                        denoising=denoising),
        alpha=alpha, num_inference_steps=steps)


# ------------------------------------------------------------------- keys


class _Stop(Exception):
    pass


def _jax_key(monkeypatch, call) -> str:
    """The key of the AotProgram the JAX package's `call` would run."""
    seen = []

    def record(self, *args):
        seen.append(self.key)
        raise _Stop

    monkeypatch.setattr(jax_aot.AotProgram, "__call__", record)
    with pytest.raises(_Stop):
        call()
    return seen[0]


def _port_key(monkeypatch, pipe, call) -> str:
    """The key of the device program the port's `call` would run."""
    seen = []

    def record(program):
        seen.append(program.key)
        raise _Stop

    monkeypatch.setattr(pipe, "_run_program", record)
    with pytest.raises(_Stop):
        call()
    return seen[0]


def test_aot_key_matches_jax():
    """The port's copy of `_aot_key`, short parts kept and long or
    structured ones folded into a digest."""
    parts = [("pndm", 50, 12, 251, "512x512", "L77", "m0", repr(PARAMS), 32),
             ("unipc_k:rho=2", 16, 4, 0.5, None, "b16", "p1", -3),
             ("magic_mix-x", 1.25, "a" * 30)]
    for p in parts:
        assert pipeline._aot_key("riffuse", *p) == jax_pipeline._aot_key("riffuse", *p)
    assert repr(PARAMS) == repr(jax_twin(PARAMS))


CALLS = {
    # name: (JAX call, the port's call), each given (jax pipeline, port pipeline)
    "riffuse": (
        lambda jp: jp.riffuse_audio(jax_twin(_request()), _image(), params=jax_twin(PARAMS)),
        lambda tp: tp.riffuse_audio(_request(), _image(), params=PARAMS)),
    "riffuse-mask-pndm": (
        lambda jp: jp.riffuse_audio(jax_twin(_request(steps=50)), _image(), mask_image=_mask(),
                                    params=jax_twin(PARAMS), scheduler="pndm"),
        lambda tp: tp.riffuse_audio(_request(steps=50), _image(), mask_image=_mask(),
                                    params=PARAMS, scheduler="pndm")),
    "riffuse-image-only": (
        lambda jp: jp.riffuse(jax_twin(_request()), _image(), scheduler="euler_a"),
        lambda tp: tp.riffuse(_request(), _image(), scheduler="euler_a")),
    "riffuse_batch": (
        lambda jp: jp.riffuse_audio_batch([jax_twin(_request(i)) for i in range(3)], _image(),
                                          params=jax_twin(PARAMS), scheduler="unipc_k:rho=2"),
        lambda tp: tp.riffuse_audio_batch([_request(i) for i in range(3)], _image(),
                                          params=PARAMS, scheduler="unipc_k:rho=2")),
    "riffuse_batch-per-item-mask": (
        lambda jp: jp.riffuse_audio_batch([jax_twin(_request(i, denoising=0.6))
                                           for i in range(2)], [_image(0), _image(1)],
                                          params=jax_twin(PARAMS), mask_image=_mask()),
        lambda tp: tp.riffuse_audio_batch([_request(i, denoising=0.6) for i in range(2)],
                                          [_image(0), _image(1)], params=PARAMS,
                                          mask_image=_mask())),
    "txt2img": (
        lambda jp: jp.txt2img("synth", negative_prompt="hiss", num_inference_steps=5,
                              width=SIZE, height=SIZE, scheduler="euler_a"),
        lambda tp: tp.txt2img("synth", negative_prompt="hiss", num_inference_steps=5,
                              width=SIZE, height=SIZE, scheduler="euler_a")),
    "txt2img_batch": (
        lambda jp: jp.txt2img_audio_batch(["a", "b c"], num_inference_steps=5, width=SIZE,
                                          height=SIZE, scheduler="pndm",
                                          params=jax_twin(PARAMS)),
        lambda tp: tp.txt2img_audio_batch(["a", "b c"], num_inference_steps=5, width=SIZE,
                                          height=SIZE, scheduler="pndm", params=PARAMS)),
    "txt2img_batch-images-only": (
        lambda jp: jp.txt2img_audio_batch(["a"], num_inference_steps=5, width=SIZE,
                                          height=SIZE, scheduler="dpmpp"),
        lambda tp: tp.txt2img_audio_batch(["a"], num_inference_steps=5, width=SIZE,
                                          height=SIZE, scheduler="dpmpp")),
    "magic_mix": (
        lambda jp: jp.img2img_magic_mix("bells", _image(), num_inference_steps=50,
                                        scheduler="pndm"),
        lambda tp: tp.img2img_magic_mix("bells", _image(), num_inference_steps=50,
                                        scheduler="pndm")),
    "magic_mix-karras": (
        lambda jp: jp.img2img_magic_mix("bells", _image(), num_inference_steps=20,
                                        kmin=0.2, kmax=0.6, mix_factor=0.25,
                                        scheduler="unipc_k:rho=2"),
        lambda tp: tp.img2img_magic_mix("bells", _image(), num_inference_steps=20,
                                        kmin=0.2, kmax=0.6, mix_factor=0.25,
                                        scheduler="unipc_k:rho=2")),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_keys_match_jax(pipes, monkeypatch, case):
    """Each program's key is the string the JAX package stores the same
    request's program under."""
    jp, tp = pipes
    jax_call, port_call = CALLS[case]
    want = _jax_key(monkeypatch, lambda: jax_call(jp))
    got = _port_key(monkeypatch, tp, lambda: port_call(tp))
    assert got == want
    assert got.split("-")[0] == case.split("-")[0]


# ------------------------------------------------------------------ the split


def _unsplit_generate(pipe, inputs_list, init_images, mask_image, fused_params, noises,
                      scheduler):
    """The port's `_generate` before the split (host work and device work
    interleaved, the slerp on Python floats, each noise drawn where it is
    used), on the pipeline's modules: the reference the split must equal."""
    n = len(inputs_list)
    strengths = [(1.0 - float(i.alpha)) * i.start.denoising + float(i.alpha) * i.end.denoising
                 for i in inputs_list]
    plan, noise_timestep = pipe._plan(scheduler, inputs_list[0].num_inference_steps,
                                      float(np.mean(strengths)))
    dev = pipe.device
    seq = max(pipe._embedding_length(i, True) for i in inputs_list)
    pairs = [pipe._embedding_pair(i, True) for i in inputs_list]
    alphas = [float(i.alpha) for i in inputs_list]
    guidance = torch.tensor([i.start.guidance * (1.0 - a) + i.end.guidance * a
                             for i, a in zip(inputs_list, alphas)],
                            dtype=torch.float32, device=dev).view(n, 1, 1, 1)
    text_emb = torch.cat([pipe._pad_seq(u, seq) for u, _ in pairs]
                         + [pipe._pad_seq(c, seq) for _, c in pairs])
    arrays = [pipeline.preprocess_image(im) for im in init_images]
    image = torch.from_numpy(np.concatenate(arrays)).to(dev).permute(0, 3, 1, 2)
    height, width = image.shape[2], image.shape[3]
    mask = None
    if mask_image is not None:
        mask = torch.from_numpy(pipeline.preprocess_mask(
            mask_image, scale_factor=8, size=(width // 8, height // 8))).to(dev).permute(0, 3, 1, 2)
    scale = pipe.bundle.vae_config.scaling_factor
    mean, logvar = pipe.vae.encode_moments(image)
    shape = (1,) + tuple(mean.shape[1:])
    eps = torch.cat([nz("vae_eps", shape, dev) for nz in noises])
    init_latents = (scale * pipe.vae.sample(mean, logvar, eps)).to(torch.float32)
    seed_noise = torch.cat([torch_util.slerp(a, nz("noise_a", shape, dev),
                                             nz("noise_b", shape, dev))
                            for a, nz in zip(alphas, noises)])
    if plan.name in sched.SIGMA_BASED:
        latents = sched.add_noise_sigma(plan, init_latents, seed_noise, 0)
    else:
        latents = sched.add_noise(pipe.noise_config, init_latents, seed_noise, noise_timestep)
    ancestral = None
    if sched.draws_noise(plan):
        ancestral = torch.cat([nz(pipeline.ANCESTRAL, (plan.num_steps,) + shape, dev)
                               for nz in noises], dim=1)
    with attention.route_batch(2 * n):
        latents = pipe._denoise(plan, latents, text_emb, guidance, mask, init_latents,
                                seed_noise, ancestral)
    decoded = pipe.vae.decode(latents / scale)
    images_u8 = torch.stack([codec.image_u8_from_vae_output(decoded[i:i + 1])
                             for i in range(n)])
    converter = pipe.converter(fused_params)
    codes = torch.cat([codec.codes_from_rgb_image(im, stereo=fused_params.stereo)
                       for im in images_u8])
    mel_amps = codec.spectrogram_from_codes(codes, fused_params.power_for_image, max_value=30e6)
    channels = mel_amps.shape[0] // n
    phase_shape = (channels, converter.n_active, mel_amps.shape[2])
    waveforms = converter.waveform_from_mel_amplitudes(
        mel_amps, init_real=torch.cat([nz("gl_real", phase_shape, dev) for nz in noises]),
        init_imag=torch.cat([nz("gl_imag", phase_shape, dev) for nz in noises]))
    return images_u8, pipeline._waveform_to_int16(waveforms.view(n, channels, -1))


@pytest.mark.parametrize("scheduler,masked,per_item", [
    ("pndm", False, False), ("euler_a", True, False), ("unipc_k:rho=2", False, True),
    ("dpmpp", True, True)])
def test_split_program_equals_the_unsplit_one(pipes, scheduler, masked, per_item):
    """The host part plus the device program, through `_generate`, give the
    unsplit program's images and waveforms bit for bit on the same noises
    (GeneratorNoise, so every draw comes from the requests' seeds)."""
    _, tp = pipes
    reqs = [_request(i, steps=5, alpha=0.15 + 0.3 * i) for i in range(3)]
    images = [_image(i) for i in range(3)] if per_item else [_image()]
    mask = _mask() if masked else None

    def noises():
        return [pipeline.GeneratorNoise(r.start.seed, r.end.seed, CPU) for r in reqs]

    with torch.inference_mode():
        ref = _unsplit_generate(tp, reqs, images, mask, PARAMS, noises(), scheduler)
        program = tp._riffuse_call(reqs, images, mask, True, PARAMS, noises(), scheduler)
        split = program.fn(*program.args)
        through = tp._generate(reqs, images, mask, True, PARAMS, noises(), scheduler)
    assert program.key.startswith("riffuse_batch-")
    for want, got, again in zip(ref, split, through):
        assert torch.equal(got, want) and torch.equal(again, want)


def test_split_program_matches_jax_riffuse_program(pipes):
    """The split program, its device half called directly, against JAX's
    `_riffuse_program` on the JAX program's draws, within
    tests/test_torch_pipeline.py's bounds: every pixel within one level and
    99% equal, the waveform's relative L2 error under 0.35."""
    import jax

    jp, tp = pipes
    inputs = _request(alpha=0.3)
    image_j, audio_j = jp.riffuse_audio(jax_twin(inputs), _image(), params=jax_twin(PARAMS),
                                        apply_filters=False)
    keys = jax_pipeline.request_keys(42, 123)
    latent = (1, SIZE // 8, SIZE // 8, 4)
    n_active = tp.converter(PARAMS).n_active
    kr, ki = jax.random.split(keys[3])
    draws = {name: np.array(jax.random.normal(k, latent, jnp.float32)).transpose(0, 3, 1, 2)
             for name, k in zip(("vae_eps", "noise_a", "noise_b"), keys[:3])}
    draws["gl_real"] = np.array(jax.random.uniform(kr, (1, n_active, SIZE), jnp.float32))
    draws["gl_imag"] = np.array(jax.random.uniform(ki, (1, n_active, SIZE), jnp.float32))
    with torch.inference_mode():
        program = tp._riffuse_call([inputs], [_image()], None, True, PARAMS,
                                   [pipeline.FixedNoise(draws)], None, name="riffuse")
        images_u8, waveforms = program.fn(*program.args)
    a = np.asarray(image_j, np.int16)
    b = images_u8[0].numpy().astype(np.int16)
    assert a.shape == b.shape == (SIZE, SIZE, 3)
    assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.99
    wj = audio_j.raw_data.astype(np.float64)
    wt = waveforms[0].numpy().T.astype(np.float64)
    assert wj.shape == wt.shape
    assert np.linalg.norm(wt - wj) / np.linalg.norm(wj) < 0.35


# ------------------------------------------------------ the hoisted constants


@pytest.mark.parametrize("name,steps,t_start", [("pndm", 12, 3), ("lms", 8, 2), ("unipc", 8, 0),
                                                ("unipc_k:rho=2", 16, 4)])
def test_device_tables_give_the_per_call_steps(monkeypatch, name, steps, t_start):
    """Every step with the plan's tables uploaded once equals the step with
    a fresh upload of the row per call (the per-step copy it replaces),
    and each table is uploaded once."""
    plan = sched.make_plan(name, steps, t_start)
    rng = np.random.default_rng(1)
    shape = (2, 4, 3, 3)
    sample = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    outputs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(plan.num_steps)]

    def run():
        x, state = sample, sched.init_state(plan, shape, torch.float32, CPU)
        trail = []
        for i, eps in enumerate(outputs):
            x, state = sched.step(plan, state, i, eps, x)
            trail.append(x)
        return trail

    hoisted = run()
    tables = dict(plan._device)
    assert tables and run() and plan._device == tables  # uploaded once, kept
    monkeypatch.setattr(sched.SchedulerPlan, "device_table", lambda self, table, like:
                        torch.as_tensor(self.coeffs[table], dtype=like.dtype, device=like.device))
    for a, b in zip(hoisted, run()):
        assert torch.equal(a, b)


def test_stft_constants_give_the_per_call_transforms(monkeypatch):
    """stft and istft with the window and the overlap-add envelope kept on
    the device equal them with a fresh upload per call; each is uploaded
    once per device."""
    kernel = get_stft_kernel(256, 200, 50, 80)
    rng = np.random.default_rng(2)
    wav = torch.from_numpy(rng.standard_normal((2, 2000)).astype(np.float32))
    real, imag = kernel.stft(wav)
    out = kernel.istft(real, imag)
    assert kernel.window(CPU) is kernel.window(torch.device("cpu"))
    frames = real.shape[-1]
    assert kernel.ola_envelope(frames, CPU) is kernel.ola_envelope(frames, CPU)
    monkeypatch.setattr(type(kernel), "window",
                        lambda self, device: torch.from_numpy(self._window_np.copy()).to(device))
    monkeypatch.setattr(type(kernel), "ola_envelope", lambda self, n, device: torch.from_numpy(
        self._ola_envelope(n).copy()).to(device))
    real2, imag2 = kernel.stft(wav)
    assert torch.equal(real, real2) and torch.equal(imag, imag2)
    assert torch.equal(out, kernel.istft(real2, imag2))


def test_slerp_with_tensor_weights_equals_float_weights():
    """The device program's slerp, t and 1 - t as float32 tensors (1 - t
    taken in float64 on the host), equals the slerp on a Python float, in
    the slerp and the near-parallel lerp branch."""
    rng = np.random.default_rng(3)
    v0 = torch.from_numpy(rng.standard_normal((1, 4, 8, 8)).astype(np.float32))
    for t in (0.1, 0.3, 0.7, 0.37, 1.0 / 3.0):
        w = torch.tensor([t, 1.0 - t], dtype=torch.float32)
        for v1 in (torch.from_numpy(rng.standard_normal((1, 4, 8, 8)).astype(np.float32)),
                   v0 + 1e-4 * v0):
            assert torch.equal(torch_util.slerp(w[0], v0, v1, one_minus_t=w[1]),
                               torch_util.slerp(t, v0, v1))


# ------------------------------------------------------------ the store


class _HostSync(TorchFunctionMode):
    """Refuses Tensor.item, as a CUDA stream capture refuses a host sync."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.item:
            raise RuntimeError("operation not permitted when stream is capturing")
        return func(*args, **(kwargs or {}))


class StandInGraphs(aot.CudaGraphs):
    """The store's card side on the CPU, for its bookkeeping: a "graph" is
    the program with its static buffers, and a replay runs it again into
    the static outputs without counting (a real replay runs no Python). A
    capture refuses a host sync."""

    def __init__(self):
        super().__init__()
        self.captures = self.replays = 0
        self.pools = []

    def pool(self):
        return "the pool"

    def warmup(self, fn, args):
        return fn(*args)

    def capture(self, fn, args, pool):
        self.pools.append(pool)
        self.captures += 1
        with _HostSync():
            outputs = fn(*args)
        return (fn, args, outputs), outputs

    def replay(self, graph):
        fn, args, outputs = graph
        before = COUNTS.snapshot()
        fresh = fn(*args)
        COUNTS.restore(before)
        for static, x in zip(aot._tensors(outputs), aot._tensors(fresh)):
            static.copy_(x)
        self.replays += 1


def _program(x, y):
    q = torch.cat([x, y], dim=2)  # (b, s, h*d), 2 heads of 8
    out = attention.attention(q, q, q, num_heads=2, scale=0.5)
    return out * 2.0, None


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, 5, 8)).astype(np.float32))
                 for _ in range(2))


def test_store_captures_once_per_signature_and_replays_new_inputs():
    store = aot.GraphStore(StandInGraphs())
    program = store.program("k", _program)
    assert store.program("k", None) is program
    a, b, c = _inputs(0), _inputs(1), _inputs(2, b=3)
    out_a = program(*a)
    assert torch.equal(out_a[0], _program(*a)[0]) and out_a[1] is None
    out_b = program(*b)
    assert torch.equal(out_b[0], _program(*b)[0])
    assert not torch.equal(out_a[0], out_b[0])
    assert (store.graphs.captures, store.graphs.replays, len(program)) == (1, 1, 1)
    program(*c)  # another signature: its own capture
    assert (store.graphs.captures, store.graphs.replays, len(program)) == (2, 1, 2)
    store.program("other key", _program)(*a)
    assert store.graphs.pools == ["the pool"] * 3  # one pool for the store's captures
    again = program(*a)
    assert torch.equal(again[0], out_a[0]) and store.graphs.replays == 2
    assert not torch.equal(out_b[0], again[0])  # a returned output is a copy


def test_counts_per_replay_equal_an_eager_call():
    program = aot.GraphProgram(_program, "k", graphs=StandInGraphs())
    COUNTS.reset()
    _program(*_inputs(0))
    eager = COUNTS.snapshot()
    assert eager["plain_calls"] == 1
    for seed in range(3):  # the capturing call, then two replays
        COUNTS.reset()
        program(*_inputs(seed))
        assert COUNTS.snapshot() == eager


def test_stage_report(monkeypatch):
    program = aot.GraphProgram(_program, "k", graphs=StandInGraphs())
    first = program.stage_report(*_inputs(0))
    assert first["source"] == "captured" and first["key"] == "k"
    assert first["warmup_s"] > 0 and first["capture_s"] > 0 and first["nodes"] is None
    monkeypatch.setenv("RIFFUSION_TPU_TRACE", "1")
    tracing.reset()
    program(*_inputs(1))  # the replay's host time: its riffusion.launch span
    (launch,) = tracing.export()["spans"]
    tracing.reset()
    assert launch["name"] == "riffusion.launch" and launch["dur_ns"] > 0
    second = program.stage_report(*_inputs(0))
    assert (second["source"], second["warmup_s"], second["capture_s"]) == ("replayed", 0.0, 0.0)


def test_a_failed_capture_raises_with_the_key_and_the_operation():
    def synced(x, y):
        scale = float((x * y).sum().item())  # a host sync inside the program
        return x * scale, None

    program = aot.GraphProgram(synced, "riffuse-sync", graphs=StandInGraphs())
    COUNTS.reset()
    with pytest.raises(aot.CaptureError, match=r"riffuse-sync failed at .*item.*not permitted"):
        program(*_inputs(0))
    assert COUNTS.snapshot() == Counts().snapshot()
    assert len(program) == 0
    with pytest.raises(TypeError, match="tensors or None"):
        program(1.0, None)


def test_the_switch_and_the_device(monkeypatch):
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
    assert aot.enabled() and aot.captures(torch.device("cuda", 0))
    assert not aot.captures(CPU)
    monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    assert not aot.enabled() and not aot.captures(torch.device("cuda", 0))


def test_pipeline_requests_through_the_store(pipes, monkeypatch):
    """A pipeline whose programs go through the store (the stand-in's
    graphs, here on the CPU): the first request of a key captures, the next
    replays with its own inputs, both equal to the eager results bit for
    bit with the eager counts; a batch's key is a program of its own; with
    RIFFUSION_TPU_NO_AOT=1 nothing is captured or replayed."""
    _, tp = pipes
    graphs = StandInGraphs()
    monkeypatch.setattr(tp, "graph_store", aot.GraphStore(graphs))
    monkeypatch.setattr(aot, "captures", lambda device: aot.enabled())
    monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    reqs = [_request(i, steps=4) for i in range(3)]
    COUNTS.reset()
    eager = [tp.riffuse_audio(r, _image(), params=PARAMS, scheduler="euler") for r in reqs]
    eager_counts = COUNTS.plain_calls
    eager_batch = tp.riffuse_audio_batch(reqs[:2], _image(), params=PARAMS, scheduler="euler")
    assert (graphs.captures, graphs.replays) == (0, 0)
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT")
    COUNTS.reset()
    stored = [tp.riffuse_audio(r, _image(), params=PARAMS, scheduler="euler") for r in reqs]
    assert COUNTS.plain_calls == eager_counts
    assert (graphs.captures, graphs.replays) == (1, 2)
    batch = tp.riffuse_audio_batch(reqs[:2], _image(), params=PARAMS, scheduler="euler")
    assert (graphs.captures, graphs.replays) == (2, 2)
    assert sorted(k.split("-")[0] for k in tp.graph_store.programs) == ["riffuse",
                                                                       "riffuse_batch"]
    for (ie, se), (ig, sg) in zip(eager + eager_batch, stored + batch):
        np.testing.assert_array_equal(np.asarray(ig), np.asarray(ie))
        np.testing.assert_array_equal(sg.raw_data, se.raw_data)
