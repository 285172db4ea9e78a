"""FastGen-style serving (``deepspeed_tpu/inference`` counterpart): the
ragged engine over a paged KV pool and its host-side state."""
from .engine_v2 import InferenceEngineV2, RaggedInferenceConfig  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .ragged import (BlockedAllocator, SequenceDescriptor,  # noqa: F401
                     StateManager, StepPlan)
from .scheduler import SplitFuseScheduler  # noqa: F401
from .weights import params_from_jax  # noqa: F401
