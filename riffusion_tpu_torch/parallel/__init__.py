"""Multi-device execution over torch.distributed: process groups and
device meshes (mesh.py), the differentiable collectives (comm.py), the
tensor-parallel layout of the UNet's linear layers (train.py `param_spec` /
`shard_params`), tensor-parallel serving of one request (tp_serving.py),
the sequence-parallel UNet (seq.py), the sharded fine-tuning step over a
("data", "model", "seq") mesh (train.py `DiffusionTrainer(mesh=)`,
`dryrun_train_step`), the data-parallel frame sweep (sweep.py) and the
multi-process dryrun (dryrun.py); `riffuse_audio_batch(mesh=...)` is the
data-parallel batch. The counterpart of riffusion_tpu/parallel/, SPMD
where the JAX package runs a single controller."""

from riffusion_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
