"""
Shared fixture for the port's CPU tests (tests/test_torch_*.py).

The suite runs under pytest-xdist with several workers on a few cores. Each
torch process would start one intra-op thread per core, and the workers'
thread pools then compete for the same cores and slow every test in the
run. The port's tests use tiny shapes, so one thread each is enough; the
fixture restores the previous count after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def jax_twin(obj):
    """The JAX package's dataclass holding the same fields as one of the
    port's (InferenceInput, PromptInput, SpectrogramParams), for the JAX side
    of a comparison: each package is called with its own types."""
    import dataclasses

    from riffusion_tpu import datatypes, spectrogram_params
    from riffusion_tpu.util.dataclass_util import from_dict

    cls = {
        "InferenceInput": datatypes.InferenceInput,
        "PromptInput": datatypes.PromptInput,
        "SpectrogramParams": spectrogram_params.SpectrogramParams,
    }[type(obj).__name__]
    return from_dict(cls, dataclasses.asdict(obj))


def jax_ancestral_draws(keys, num_steps, item_shape):
    """The noise the JAX package's euler_a stepper draws from per-item keys
    (N, 2): at each step every key splits into (next key, subkey) and the
    subkey draws at (1,) + item_shape. Returns (num_steps, N) + item_shape
    float32 numpy, in the layout drawn."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    draws = []
    for _ in range(num_steps):
        splits = jax.vmap(jax.random.split)(keys)
        keys, subs = splits[:, 0], splits[:, 1]
        draws.append(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (1,) + tuple(item_shape), jnp.float32))(subs)[:, 0]))
    return np.stack(draws)
