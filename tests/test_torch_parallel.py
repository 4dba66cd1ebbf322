"""
The port's multi-device serving (riffusion_tpu_torch/parallel/, and
riffuse_audio_batch's `mesh`) on the CPU, in a world of two gloo ranks
spawned once for the module (parallel.mesh.spawn_world, with a time limit
so that a hang fails the test), against the port on one process and the
JAX package's single-device and batch programs on the same weights and
noise (the JAX side runs here, in the parent; the ranks import no JAX).

- `factor_mesh_shape` against JAX's; `make_mesh` without a process group
  raises; `param_spec` against JAX's `param_spec` on the tiny UNet, leaf by
  leaf through the port's names (GEGLU's per-half cut, the replicated
  convolutions), and the rows of the cut tensors each rank holds.
- `riffuse_audio_tp` at tp 2: its UNet against the whole UNet in fp64 (a
  wiring test: 1e-10 of the output's scale), the clip against the port on
  one process and against JAX's `riffuse_audio`, each at
  test_torch_pipeline.py's image tolerance (every pixel within one uint8
  level, at least 99% equal; mel magnitudes equal to 1e-6 where the pixels
  are).
- `riffuse_audio_batch(mesh=)` of 4 at d = 2 (also `async_dispatch` in its
  positional place, and a (data 1, model 2) mesh whose ranks share the
  data index) against the unsharded port and JAX's batch, at
  test_riffuse_audio_batch_matches_jax's tolerance; a batch of 3 refused.
- `FrameSweep` with a mesh (3 alphas padded to 4) and without, against
  JAX's `FrameSweep(pipe, None)` on its draws, at the same image tolerance.
- The interpolation page's mesh condition.
- Which attention each site routes to: a sharded batch routes at its
  global UNet batch, a frame sweep at one frame's 2 (counted with the gate's
  sequence thresholds scaled to the 64 px tiny model: see _ROUTE_SCALE).
- On one process: a share encodes only its own text, padded to the whole
  batch's longest prompt (its length from the tokenizer); a sweep's frames
  under an ancestral sampler take their slices of one draw.

Guidance 1.25-2: the random tiny UNet amplifies float32 rounding at high
guidance (ROADMAP.md's traps).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import jax_twin, torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.ops import codec
from riffusion_tpu_torch.parallel import mesh as mesh_mod
from riffusion_tpu_torch.parallel.train import Split, param_spec, shard_tensor
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

SIZE = 64
PARAMS = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=SIZE)
STEPS = 6
WORLD_TIMEOUT_S = 300.0
SWEEP_ALPHAS = [0.0, 0.4, 0.9]
# The gate's thresholds, scaled so that the 64 px tiny model (self-attention
# at seq 64, 16, 4 and 1) reaches every route: K2 at seq 64 above batch 8,
# K1 at seq 16 and at seq 64 up to batch 8, plain below.
_ROUTE_SCALE = {"ROW_SEQ_MIN": 64, "ROW_BLOCK_Q": 64, "FLASH_SEQ_MIN": 16}


def _seed_image():
    rng = np.random.default_rng(0)
    return Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8), mode="RGB")


def _inputs(i=0, alpha=0.3, guidance=1.75):
    return InferenceInput(
        start=PromptInput(prompt=f"church bells {i}", seed=42 + i, guidance=guidance),
        end=PromptInput(prompt="techno", seed=123 + i, guidance=guidance + 0.1 * i),
        alpha=alpha,
        num_inference_steps=STEPS,
    )


def _batch():
    # guidance from 1.25: at 1.75, request 1 alone puts the port's unsharded
    # batch and JAX's a level apart on 1.35% of pixels (the amplification
    # above, sharding aside)
    return [_inputs(i, alpha=0.2 * i, guidance=1.25) for i in range(4)]


# ------------------------------------------------------------ the world's work


def _world_checks(rank, world_size, trees, draws):
    """Every rank's share of the module's checks; returns numpy results."""
    from riffusion_tpu_torch.models.weights import bundle_from_jax_params
    from riffusion_tpu_torch.ops import attention as attention_ops
    from riffusion_tpu_torch.parallel.sweep import FrameSweep
    from riffusion_tpu_torch.parallel.tp_serving import riffuse_audio_tp, tensor_parallel_unet
    from riffusion_tpu_torch.parallel.train import shard_params
    from riffusion_tpu_torch.riffusion_pipeline import FixedNoise, RiffusionPipeline
    from riffusion_tpu_torch.streamlit.tasks.interpolation import sweep_mesh

    pipe = RiffusionPipeline(bundle_from_jax_params("tiny", *trees, device="cpu"), device="cpu")
    image = _seed_image()
    model = mesh_mod.make_mesh((2,), ("model",))
    data = mesh_mod.make_mesh((2,), ("data",))
    shared = mesh_mod.make_mesh((1, 2), ("data", "model"))
    out = {"rank": rank}

    def clips(results):
        return [(np.asarray(im), seg.raw_data) for im, seg in results]

    # tensor parallel: the UNet in fp64 against the whole UNet, then a clip
    unet64 = copy.deepcopy(pipe.unet).double()
    tp64 = tensor_parallel_unet(unet64, model)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, generator=gen, dtype=torch.float64)
    ctx = torch.randn(2, 77, 64, generator=gen, dtype=torch.float64)
    t = torch.tensor([999, 500])
    with torch.inference_mode():
        ref, got = unet64(x, t, ctx), tp64(x, t, ctx)
    out["tp_fp64"] = float((got - ref).abs().max() / ref.abs().max())
    out["tp_heads"] = sorted({m.num_heads for m in tp64.modules() if hasattr(m, "num_heads")})
    out["shards"] = {k: v.numpy() for k, v in shard_params(pipe.unet, model).items()
                     if k.startswith("down_blocks_0.attentions_0.blocks_0.")}
    tp_img, tp_seg = riffuse_audio_tp(pipe, _inputs(), image, model, params=PARAMS,
                                      apply_filters=False, noise=FixedNoise(draws["single"]))
    single_img, _ = pipe.riffuse_audio(_inputs(), image, params=PARAMS, apply_filters=False,
                                       noise=FixedNoise(draws["single"]))
    out["tp"] = (np.asarray(tp_img), tp_seg.raw_data, np.asarray(single_img))

    # data parallel: the batch of 4 at d = 2, async, on a mesh whose two
    # ranks share the data index, and the refusal of a batch of 3
    def noises():
        return [FixedNoise(d) for d in draws["batch"]]

    kw = dict(params=PARAMS, apply_filters=False)
    out["dp"] = clips(pipe.riffuse_audio_batch(_batch(), image, mesh=data, noises=noises(), **kw))
    finalize = pipe.riffuse_audio_batch(_batch(), image, PARAMS, True, False, data, True,
                                        noises=noises())
    out["dp_async"] = clips(finalize())
    out["dp_shared"] = clips(pipe.riffuse_audio_batch(_batch(), image, mesh=shared,
                                                      noises=noises(), **kw))
    out["unsharded"] = clips(pipe.riffuse_audio_batch(_batch(), image, noises=noises(), **kw))
    out["shares"] = [clip for rows in (slice(0, 2), slice(2, 4)) for clip in clips(
        pipe.riffuse_audio_batch(_batch()[rows], image, noises=noises()[rows], **kw))]
    try:
        pipe.riffuse_audio_batch(_batch()[:3], image, mesh=data, **kw)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)

    # the frame sweep, with the mesh and without
    sweep = dict(prompt_start="church bells", prompt_end="techno", seed_start=42, seed_end=123,
                 init_image=image, alphas=SWEEP_ALPHAS, num_inference_steps=STEPS,
                 guidance_start=1.75, guidance_end=2.0)
    out["sweep_mesh"] = FrameSweep(pipe, data).interpolate(**sweep,
                                                            noise=FixedNoise(draws["sweep"]))
    out["sweep"] = FrameSweep(pipe).interpolate(**sweep, noise=FixedNoise(draws["sweep"]))
    out["sweep_shares"] = np.concatenate([
        FrameSweep(pipe).interpolate(**{**sweep, "alphas": alphas},
                                     noise=FixedNoise(draws["sweep"]))
        for alphas in (SWEEP_ALPHAS[:2], SWEEP_ALPHAS[2:] * 2)])

    # the interpolation page's mesh
    page = sweep_mesh(4, "cpu")
    out["page"] = (None if page is None else (page.mesh_dim_names, tuple(page.shape)),
                   sweep_mesh(3, "cpu"))

    # the routes each attention site takes, counted at the scaled gate
    for name, value in _ROUTE_SCALE.items():
        setattr(attention_ops, name, value)
    counts = {}
    ops = dict(_attention_ops_table())

    def counting(route, fn):
        def wrapped(*a, **k):
            counts[route] = counts.get(route, 0) + 1
            return fn(*a, **k)
        return wrapped

    table = _attention_ops_table()
    for route, fn in ops.items():
        table[route] = counting(route, fn)
    try:
        six = [dataclasses.replace(_inputs(i, alpha=0.1 * i), num_inference_steps=2)
               for i in range(6)]
        pipe.riffuse_audio_batch(six, image, mesh=data, **kw)
        out["routes_dp"], counts = counts, {}
        pipe.riffuse_audio_batch(six[:2], image, **kw)
        out["routes_small"], counts = counts, {}
        FrameSweep(pipe).interpolate(**{**sweep, "alphas": [0.1 * i for i in range(6)],
                                        "num_inference_steps": 2})
        out["routes_sweep"] = counts
        out["evaluations"] = pipe._plan("pndm", 2, 0.75)[0].num_steps
    finally:
        table.update(ops)
    return out


def _attention_ops_table():
    from riffusion_tpu_torch.models import layers

    return layers._ATTENTION_OPS


# ----------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def jax_pipe():
    from riffusion_tpu import riffusion_pipeline as jax_pipeline

    return jax_pipeline.RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")


def _latent(key):
    import jax
    import jax.numpy as jnp

    return np.array(jax.random.normal(key, (1, SIZE // 8, SIZE // 8, 4), jnp.float32)
                    ).transpose(0, 3, 1, 2)


def _request_draws(start_seed, end_seed, n_active):
    """The draws the JAX program makes from request_keys, in the port's
    layouts."""
    import jax
    import jax.numpy as jnp
    from riffusion_tpu import riffusion_pipeline as jax_pipeline

    keys = jax_pipeline.request_keys(start_seed, end_seed)
    kr, ki = jax.random.split(keys[3])
    phase = (1, n_active, SIZE)
    return {
        "vae_eps": _latent(keys[0]), "noise_a": _latent(keys[1]), "noise_b": _latent(keys[2]),
        "gl_real": np.array(jax.random.uniform(kr, phase, jnp.float32)),
        "gl_imag": np.array(jax.random.uniform(ki, phase, jnp.float32)),
    }


@pytest.fixture(scope="module")
def world(jax_pipe):
    import jax

    from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter

    n_active = SpectrogramConverter(PARAMS, device="cpu").n_active
    trees = tuple(jax.tree.map(np.asarray, t)
                  for t in (jax_pipe.unet_params, jax_pipe.vae_params, jax_pipe.clip_params))
    single = _request_draws(42, 123, n_active)
    draws = {
        "single": single,
        "batch": [_request_draws(i.start.seed, i.end.seed, n_active) for i in _batch()],
        "sweep": {k: single[k] for k in ("vae_eps", "noise_a", "noise_b")},
    }
    results = mesh_mod.spawn_world(_world_checks, 2, (trees, draws), backend="gloo",
                                   timeout_s=WORLD_TIMEOUT_S)
    return {"ranks": results, "draws": draws}


def _assert_images_agree(a_img, b_img):
    """One uint8 level everywhere, equal on at least 99% of pixels."""
    a, b = np.asarray(a_img, np.int16), np.asarray(b_img, np.int16)
    assert a.shape == b.shape
    stats = (int(np.abs(a - b).max()), float((a == b).mean()))
    assert stats[0] <= 1 and stats[1] >= 0.99, stats


def _assert_mels_agree(a_img, b_img):
    """Mel magnitudes decoded from the two images agree where their pixels
    do (rtol 1e-6)."""
    a, b = np.asarray(a_img), np.asarray(b_img)
    mel_a, mel_b = (
        codec.spectrogram_from_codes(
            codec.codes_from_rgb_image(torch.from_numpy(np.array(x)), False), 0.25, 30e6
        ).numpy()
        for x in (a, b)
    )
    same = np.flip(a[..., 0] == b[..., 0], axis=0)[None]
    np.testing.assert_allclose(mel_a[same], mel_b[same], rtol=1e-6)


# -------------------------------------------------------------- the mesh


@pytest.mark.parametrize("num_axes", [1, 2, 3])
def test_factor_mesh_shape_matches_jax(num_axes):
    from riffusion_tpu.parallel import mesh as jax_mesh

    for n in range(1, 9):
        assert mesh_mod.factor_mesh_shape(n, num_axes) == jax_mesh.factor_mesh_shape(n, num_axes)


def test_dryrun_spawns_its_world(capsys):
    """python -m riffusion_tpu_torch.parallel.dryrun --n 2: two gloo ranks
    run the sharded batch and the tensor-parallel request on random:tiny."""
    from riffusion_tpu_torch.parallel import dryrun

    assert dryrun.main(["--n", "2"]) == 0
    out = capsys.readouterr().out
    assert "sharded serving batch OK, 2 requests" in out
    assert "tensor-parallel serving OK, 0.63 s clip" in out


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        mesh_mod.make_mesh(axis_names=("data",))
    with pytest.raises(RuntimeError, match="RANK"):
        mesh_mod.init_distributed()


# ------------------------------------------------------- the tensor-parallel layout


def _jax_rule(spec):
    """A JAX PartitionSpec of a Dense kernel or bias -> the torch dim it
    cuts (the kernel is (in, out), the weight (out, in)), or None."""
    names = tuple(spec)
    if "model" not in names:
        return None
    axis = names.index("model")
    return {(1, 2): 0, (0, 2): 1, (0, 1): 0}[(axis, len(names) or 1)]


def test_param_spec_matches_jax_leaf_by_leaf(jax_pipe):
    import jax
    from riffusion_tpu.parallel.train import param_spec as jax_param_spec
    from riffusion_tpu_torch.models.weights import _to_torch_entry, build_modules

    unet, _, _ = build_modules("tiny", torch.device("cpu"))
    state = unet.state_dict()
    seen, kinds = set(), {"column": 0, "row": 0, "bias": 0, "geglu": 0, "whole": 0}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_pipe.unet_params)[0]:
        keys = tuple(k.key for k in path)
        name, _ = _to_torch_entry(".".join(keys), np.asarray(leaf))
        ours, theirs = param_spec(name, state[name]), jax_param_spec(keys, leaf)
        seen.add(name)
        if name.endswith("ff.proj_in.bias"):
            # JAX keeps this bias whole (GSPMD slices it where it is added);
            # the port cuts it with its weight, half by half
            assert _jax_rule(theirs) is None and ours == Split(0, 2), name
            kinds["geglu"] += 1
            continue
        dim = _jax_rule(theirs)
        if dim is None:
            assert ours is None, name
            kinds["whole"] += 1
            continue
        halves = 2 if name.endswith("ff.proj_in.weight") else 1
        assert ours == Split(dim, halves), (name, ours, theirs)
        kinds["bias" if keys[-1] == "bias" else ("row" if dim == 1 else "column")] += 1
    assert seen == set(state)
    assert all(kinds.values()), kinds
    # Transformer2D's 1x1 convolutions stay whole, as flax's 4-D nn.Conv kernels
    assert param_spec("down_blocks_0.attentions_0.proj_in.weight",
                      state["down_blocks_0.attentions_0.proj_in.weight"]) is None
    assert param_spec("down_blocks_0.attentions_0.proj_in.bias",
                      state["down_blocks_0.attentions_0.proj_in.bias"]) is None


def test_the_rows_each_rank_holds():
    """GEGLU's proj_in weight (2 * inner, dim) holds [value | gate] rows: at
    tp 2 rank r holds value rows [r * inner / 2, (r + 1) * inner / 2) and
    the same gate rows, inner further on; a column-split weight holds its
    rank's contiguous output rows, a row-split one its input columns."""
    inner, dim = 8, 3
    weight = torch.arange(2 * inner * dim).view(2 * inner, dim)
    for r in range(2):
        rows = list(range(r * 4, r * 4 + 4)) + list(range(inner + r * 4, inner + r * 4 + 4))
        assert torch.equal(shard_tensor(weight, Split(0, 2), r, 2), weight[rows])
        assert torch.equal(shard_tensor(weight, Split(0), r, 2), weight[r * 8:(r + 1) * 8])
        assert torch.equal(shard_tensor(weight.T, Split(1), r, 2), weight.T[:, r * 8:(r + 1) * 8])
    with pytest.raises(ValueError, match="does not split"):
        shard_tensor(torch.zeros(6, 2), Split(0, 2), 0, 2)


def test_shard_params_in_the_world(world, jax_pipe):
    """Each rank's shard_params is its slice of the tiny UNet's weights by
    param_spec (the first transformer block's), and the two ranks' slices
    put back together are the whole."""
    from riffusion_tpu_torch.models.weights import state_dict_from_jax

    whole = state_dict_from_jax(jax_pipe.unet_params)
    ranks = world["ranks"]
    names = sorted(ranks[0]["shards"])
    assert any(n.endswith("ff.proj_in.weight") for n in names)
    for name in names:
        split = param_spec(name, whole[name])
        for r in range(2):
            np.testing.assert_array_equal(ranks[r]["shards"][name],
                                          shard_tensor(whole[name], split, r, 2).numpy())
        joined = np.concatenate([ranks[r]["shards"][name] for r in range(2)], axis=split.dim)
        assert joined.shape == tuple(whole[name].shape)


# ------------------------------------------------------------- tensor parallel


def test_tp_unet_wiring_fp64(world):
    """The tensor-parallel UNet (1 of 2 heads per rank, row-split sums
    all-reduced) against the whole UNet on the same fp64 inputs: equal to
    1e-10 of the output's largest value."""
    for out in world["ranks"]:
        assert out["tp_heads"] == [1]
        assert out["tp_fp64"] < 1e-10, out["tp_fp64"]


def test_riffuse_audio_tp_matches_single_device_and_jax(world, jax_pipe):
    (img0, wave0, single0), (img1, wave1, _) = (r["tp"] for r in world["ranks"])
    np.testing.assert_array_equal(img0, img1)  # every rank returns the same clip
    np.testing.assert_array_equal(wave0, wave1)
    _assert_images_agree(img0, single0)
    image_j, audio_j = jax_pipe.riffuse_audio(
        jax_twin(_inputs()), _seed_image(), params=jax_twin(PARAMS), apply_filters=False)
    _assert_images_agree(image_j, img0)
    _assert_mels_agree(image_j, img0)
    wj, wt = audio_j.raw_data.astype(np.float64), wave0.astype(np.float64)
    assert wj.shape == wt.shape and np.abs(wt).max() > 30000
    assert np.linalg.norm(wt - wj) / np.linalg.norm(wj) < 0.35


# ------------------------------------------------------------- data parallel


def test_sharded_batch_matches_unsharded_and_jax(world, jax_pipe):
    """Every rank returns all 4 clips. The sharded batch (sync and async)
    is, bit for bit, the two shares run unsharded as batches of 2 (each
    share runs as it would in the whole batch: the start step of the whole
    batch's strengths, its text length); ranks that share the data index
    each run the whole batch, bit for bit the unsharded batch of 4. (The
    shares and the whole differ in the CPU's sum order at UNet batch 4 and
    8, which the random tiny UNet amplifies to a level on about 1% of
    pixels.) Against JAX's batch at the image tolerance: JAX's batch of 4
    against the unsharded port, JAX's batches of 2 against the shares."""
    ranks = world["ranks"]

    def assert_equal(a, b):
        assert len(a) == len(b) == 4
        for (a_img, a_wave), (b_img, b_wave) in zip(a, b):
            np.testing.assert_array_equal(a_img, b_img)
            np.testing.assert_array_equal(a_wave, b_wave)

    for out in ranks:
        assert_equal(out["dp"], ranks[0]["shares"])
        assert_equal(out["dp_async"], ranks[0]["shares"])
        assert_equal(out["dp_shared"], ranks[0]["unsharded"])
    # JAX's batch of 4 against the unsharded port, and JAX's batches of 2
    # (the shares' UNet batch) against the sharded port
    jax_batch = [jax_twin(x) for x in _batch()]
    kw = dict(params=jax_twin(PARAMS), apply_filters=False)
    whole_j = jax_pipe.riffuse_audio_batch(jax_batch, _seed_image(), **kw)
    shares_j = [clip for rows in (slice(0, 2), slice(2, 4))
                for clip in jax_pipe.riffuse_audio_batch(jax_batch[rows], _seed_image(), **kw)]
    for out_j, out_t in ((whole_j, ranks[0]["unsharded"]), (shares_j, ranks[0]["dp"])):
        for (image_j, audio_j), (image_t, wave_t) in zip(out_j, out_t):
            _assert_images_agree(image_j, image_t)
            _assert_mels_agree(image_j, image_t)
            assert audio_j.raw_data.shape == wave_t.shape
            assert np.abs(wave_t.astype(int)).max() > 30000


def test_sharded_batch_must_divide(world):
    for out in world["ranks"]:
        assert out["refusal"] and "not divisible by data axis 2" in out["refusal"]


# ---------------------------------------------------------------- frame sweep


def test_frame_sweep_matches_jax(world, jax_pipe):
    """FrameSweep with a mesh (3 alphas padded to 4, the extra dropped): on
    both ranks, bit for bit the two shares swept alone ([0, 0.4] and the
    padded [0.9, 0.9]); without a mesh, the same frames at the image
    tolerance (UNet batch 6 against 4: another sum order). JAX's
    FrameSweep(pipe, None) on the same draws: the image tolerance."""
    from riffusion_tpu.parallel.sweep import FrameSweep as JaxFrameSweep

    ranks = world["ranks"]
    frames = ranks[0]["sweep"]
    assert frames.shape == (len(SWEEP_ALPHAS), SIZE, SIZE, 3) and frames.dtype == np.uint8
    for out in ranks:
        np.testing.assert_array_equal(out["sweep_mesh"], ranks[0]["sweep_shares"][:3])
        np.testing.assert_array_equal(out["sweep"], frames)
        for a, b in zip(out["sweep_mesh"], frames):
            _assert_images_agree(a, b)
    jax_frames = JaxFrameSweep(jax_pipe, None).interpolate(
        "church bells", "techno", 42, 123, _seed_image(), SWEEP_ALPHAS,
        num_inference_steps=STEPS, guidance_start=1.75, guidance_end=2.0)
    assert jax_frames.shape == frames.shape
    for a, b in zip(jax_frames, frames):
        _assert_images_agree(a, b)


def test_interpolation_page_mesh_condition(world):
    """Under a world of 2 the page builds the ("data",) mesh when the alpha
    count divides by 2, and none otherwise; outside a world, none."""
    from riffusion_tpu_torch.streamlit.tasks.interpolation import sweep_mesh

    for out in world["ranks"]:
        assert out["page"] == ((("data",), (2,)), None)
    assert sweep_mesh(4, "cpu") is None


# -------------------------------------------------------------------- routes


def test_routes_at_the_global_batch(world):
    """With the gate scaled to the 64 px model, each UNet evaluation has 3
    self-attention sites at seq 64, 3 at seq 16 and 4 below, and 10
    cross-attention sites. A batch of 6 sharded over 2 ranks is UNet batch 6
    on each rank but 12 in all: its seq-64 sites take K2, as JAX's gate
    sends the global batch, where 2 requests alone (UNet batch 4) take K1.
    A sweep of 6 frames (UNet batch 12 on one process) routes as one frame
    (UNet batch 2), as JAX's vmapped frame program: K1."""
    for out in world["ranks"]:
        e = out["evaluations"]
        assert out["routes_dp"] == {"row": 3 * e, "flash": 3 * e, "plain": 14 * e}
        assert out["routes_small"] == {"flash": 6 * e, "plain": 14 * e}
        assert out["routes_sweep"] == {"flash": 6 * e, "plain": 14 * e}


# ------------------------------------------------- a share's text, a sweep's noise


@pytest.fixture(scope="module")
def cpu_pipe():
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    return RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")


def test_embedding_length_from_the_tokenizer(cpu_pipe):
    """_embedding_length, from the tokenizer alone, equals the length of
    the embeddings _embedding_pair encodes, for prompts of one to four
    77-token chunks (three at most) and without reweighting."""
    lengths = set()
    for words in (3, 80, 160, 400):
        inputs = dataclasses.replace(_inputs(), start=PromptInput(prompt="bell " * words, seed=1))
        for reweight in (True, False):
            uncond, cond = cpu_pipe._embedding_pair(inputs, reweight)
            assert cpu_pipe._embedding_length(inputs, reweight) == cond.shape[1] == uncond.shape[1]
            lengths.add(cond.shape[1])
    assert lengths == {77, 154, 231}


def test_a_share_encodes_only_its_text(cpu_pipe, monkeypatch):
    """A rank's share encodes its own requests' text, and pads it to the
    whole batch's longest prompt (here request 3's, two chunks, outside
    the share)."""
    reqs = _batch()
    reqs[3] = dataclasses.replace(reqs[3], start=PromptInput(prompt="bell " * 80, seed=7))
    encoded, seen = [], {}
    pair = cpu_pipe._embedding_pair

    class Stop(Exception):
        pass

    def counting_pair(inputs, use_reweighting):
        encoded.append(inputs.start.prompt)
        return pair(inputs, use_reweighting)

    def stop_at_denoise(plan, latents, text_emb, *args, **kwargs):
        seen["text"] = tuple(text_emb.shape)
        raise Stop

    monkeypatch.setattr(cpu_pipe, "_embedding_pair", counting_pair)
    monkeypatch.setattr(cpu_pipe, "_denoise", stop_at_denoise)
    with pytest.raises(Stop):
        cpu_pipe._generate(reqs, [_seed_image()], None, True, None, None, None, share=(0, 2))
    assert encoded == [r.start.prompt for r in reqs[:2]]
    assert seen["text"][:2] == (4, 154)


def test_frame_sweep_gives_each_frame_its_ancestral_slice(cpu_pipe):
    """With an ancestral sampler a sweep's frames share the seed image's
    sample and the seed noises, and frame i takes slice i of one (S, F, C,
    h, w) "ancestral" draw: bit-equal to the same frames as requests of a
    batch, each with its own noise source holding those draws."""
    from riffusion_tpu_torch.parallel.sweep import FrameSweep
    from riffusion_tpu_torch.riffusion_pipeline import FixedNoise

    steps, denoising, alphas = 4, 0.6, [0.0, 0.5, 1.0]
    plan, _ = cpu_pipe._plan("euler_a", steps, denoising)
    rng = np.random.default_rng(5)
    latent = (1, 4, SIZE // 8, SIZE // 8)
    draws = {k: rng.standard_normal(latent) for k in ("vae_eps", "noise_a", "noise_b")}
    draws["ancestral"] = rng.standard_normal((plan.num_steps, len(alphas)) + latent[1:])
    pipe = copy.copy(cpu_pipe)
    pipe.bundle = dataclasses.replace(cpu_pipe.bundle, scheduler_name="euler_a")
    frames = FrameSweep(pipe).interpolate(
        "church bells", "techno", 42, 123, _seed_image(), alphas, num_inference_steps=steps,
        denoising=denoising, guidance_start=1.5, guidance_end=1.5, noise=FixedNoise(draws))
    requests = [InferenceInput(start=PromptInput(prompt="church bells", seed=42, guidance=1.5,
                                                 denoising=denoising),
                               end=PromptInput(prompt="techno", seed=123, guidance=1.5,
                                               denoising=denoising),
                               alpha=a, num_inference_steps=steps) for a in alphas]
    noises = [FixedNoise({**{k: draws[k] for k in ("vae_eps", "noise_a", "noise_b")},
                          "ancestral": draws["ancestral"][:, i:i + 1]})
              for i in range(len(alphas))]
    images, _ = pipe._dispatch(requests, [_seed_image()], None, True, None, noises, "euler_a")()
    assert frames.shape == (len(alphas), SIZE, SIZE, 3)
    np.testing.assert_array_equal(frames, images)
    assert not np.array_equal(frames[0], frames[2])
