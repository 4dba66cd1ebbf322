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
