"""ZeRO over ``torch.distributed``: the plan (:mod:`.planner`), the
partitioned state of stages 1-3 (:mod:`.partition`), the host optimizer of
ZeRO-Offload (:mod:`.offload`) and ZeRO-Infinity's layer streamer
(:mod:`.infinity`). Counterpart of ``deepspeed_tpu/runtime/zero/``."""
