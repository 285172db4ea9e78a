"""Data pipeline (counterpart of ``deepspeed_tpu/runtime/data_pipeline/``).
Ported so far: the epoch-shuffled global-batch sampler. Curriculum
sampling, the indexed dataset and random-LTD come with a later slice."""
from .data_sampler import DistributedBatchSampler  # noqa: F401
