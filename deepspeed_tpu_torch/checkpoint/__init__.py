"""Checkpoint tooling (counterpart of ``deepspeed_tpu/checkpoint/``).

- ``manifest``: the integrity core (size+crc32 manifests, verified-tag
  resolution, the ``weight_version`` content digest);
- ``universal``: ``zero_to_fp32`` (one fp32 ``.npz``),
  ``ds_to_universal`` (per-parameter atom files) and
  ``UniversalCheckpoint`` over the port's checkpoints
  (``runtime/checkpointing.py``), which are global logical tensors, so
  resharding happens at load.
"""
from .manifest import (  # noqa: F401
    file_crc32,
    manifest_digest,
    resolve_tag,
    tag_status,
    write_file_atomic,
    write_manifest,
)
from .universal import (  # noqa: F401
    UniversalCheckpoint,
    ds_to_universal,
    get_fp32_state_dict_from_zero_checkpoint,
    zero_to_fp32,
)
