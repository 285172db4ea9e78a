"""ZeRO over ``torch.distributed``: the plan (:mod:`.planner`) and the
partitioned state of stages 1-3 (:mod:`.partition`). Counterpart of
``deepspeed_tpu/runtime/zero/`` without its offload modules
(``offload.py``, ``infinity.py``: ROADMAP queue 1, item 3)."""
