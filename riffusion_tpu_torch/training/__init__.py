"""Fine-tuning on one device: the latent dataset and the training driver
(the counterpart of riffusion_tpu/training)."""

from riffusion_tpu_torch.training.dataset import (  # noqa: F401
    LatentDataset,
    build_latent_dataset,
)
from riffusion_tpu_torch.training.finetune import (  # noqa: F401
    FinetuneConfig,
    run_finetune,
)
