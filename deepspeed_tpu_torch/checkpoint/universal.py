"""Offline converters over the port's checkpoints (reference
deepspeed/checkpoint/ds_to_universal.py:469, deepspeed/utils/zero_to_fp32.py).

Counterpart of ``deepspeed_tpu/checkpoint/universal.py``. The port's
checkpoints are already global logical tensors, one ``.npy`` each
(``runtime/checkpointing.py``), so these read files, not shards.

Run as CLIs:
    python -m deepspeed_tpu_torch.checkpoint.universal zero_to_fp32 <ckpt_dir> <out.npz>
    python -m deepspeed_tpu_torch.checkpoint.universal ds_to_universal <ckpt_dir> <out_dir>
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..utils.logging import logger
from ..utils.naming import safe_filename as _atom_name



def stored_to_fp32(a: np.ndarray, dtype_name: str) -> np.ndarray:
    """fp32 values of a stored tensor (bf16 kept as its uint16 bits by
    ``runtime/checkpointing.py``, widened exactly)."""
    if dtype_name == "bfloat16":
        return (np.asarray(a, np.uint16).astype(np.uint32) << 16).view(
            np.float32)
    return np.asarray(a, np.float32)


def _resolve_tag(ckpt_dir: str, tag: str | None) -> str:
    if tag is None:
        latest = os.path.join(ckpt_dir, "latest")
        if os.path.exists(latest):
            with open(latest) as f:
                tag = f.read().strip()
        elif os.path.isdir(os.path.join(ckpt_dir, "state")):
            return ckpt_dir  # already a tag dir
        else:
            raise FileNotFoundError(f"no 'latest' under {ckpt_dir}; pass a tag")
    return os.path.join(ckpt_dir, tag)


def _read_sections(path: str) -> dict[str, dict[str, np.ndarray]]:
    """``{section: {dotted name: fp32 array}}`` of a tag dir (bf16
    parameters widened exactly), plus the 0-d entries under ``""``."""
    state = os.path.join(path, "state")
    with open(os.path.join(state, "index.json")) as f:
        index = json.load(f)
    out: dict[str, dict[str, np.ndarray]] = {"": {}}
    for key, ent in index.items():
        a = np.load(os.path.join(state, ent["file"]), mmap_mode="r")
        if ent.get("scalar"):
            out[""][key] = np.asarray(a)
            continue
        section, name = key.split(".", 1)
        out.setdefault(section, {})[name] = stored_to_fp32(a, ent["dtype"])
    return out


# ---------------------------------------------------------------------------
def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                             tag: str | None = None
                                             ) -> dict[str, np.ndarray]:
    """Reference utils/zero_to_fp32.py same-named API: the consolidated
    fp32 weights as a flat {dotted_name: ndarray} dict. Prefers the fp32
    master; falls back to widening the compute params."""
    path = _resolve_tag(ckpt_dir, tag)
    tree = _read_sections(path)
    src = tree.get("master") or tree.get("params")
    if src is None:
        raise ValueError(f"{path}: checkpoint has neither master nor params")
    return {k: np.array(v, np.float32) for k, v in src.items()}


def zero_to_fp32(ckpt_dir: str, output_file: str, tag: str | None = None) -> str:
    """CLI body: write a single .npz with the consolidated fp32 weights."""
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    np.savez(output_file, **sd)
    total = sum(v.size for v in sd.values())
    logger.info(f"zero_to_fp32: {len(sd)} tensors, {total / 1e6:.1f} M params "
                f"→ {output_file}")
    return output_file


# ---------------------------------------------------------------------------
def ds_to_universal(ckpt_dir: str, out_dir: str, tag: str | None = None,
                    include_optimizer: bool = True) -> str:
    """Per-parameter atom files (reference ds_to_universal.py:469; the
    extract and merge phases are unnecessary: the checkpoint is already
    logical)."""
    path = _resolve_tag(ckpt_dir, tag)
    tree = _read_sections(path)
    os.makedirs(out_dir, exist_ok=True)
    index: dict[str, dict] = {}
    sections = ["params", "master"] + (
        ["opt_mu", "opt_nu"] if include_optimizer else [])
    for section in sections:
        for key, arr in tree.get(section, {}).items():
            fname = f"{section}.{_atom_name(key)}.npy"
            np.save(os.path.join(out_dir, fname), arr)
            index[f"{section}.{key}"] = {
                "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    if include_optimizer and "opt_step" in tree[""]:
        np.save(os.path.join(out_dir, "opt_step.npy"), tree[""]["opt_step"])
        index["opt_step"] = {"file": "opt_step.npy", "shape": [],
                             "dtype": "int32"}
    meta_src = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_src):
        with open(meta_src) as f:
            meta = json.load(f)
    with open(os.path.join(out_dir, "universal_index.json"), "w") as f:
        json.dump({"atoms": index, "meta": meta}, f, indent=2)
    logger.info(f"ds_to_universal: {len(index)} atoms → {out_dir}")
    return out_dir


class UniversalCheckpoint:
    """Reader for an atom directory (reference universal_checkpoint.py:22
    load_hp_checkpoint_state role)."""

    def __init__(self, atom_dir: str):
        with open(os.path.join(atom_dir, "universal_index.json")) as f:
            idx = json.load(f)
        self.atom_dir = atom_dir
        self.index: dict[str, dict] = idx["atoms"]
        self.meta: dict = idx.get("meta", {})

    def keys(self):
        return self.index.keys()

    def load(self, key: str) -> np.ndarray:
        return np.load(os.path.join(self.atom_dir, self.index[key]["file"]))

    def load_section(self, section: str) -> dict[str, np.ndarray]:
        """Nested tree of one section ('params', 'master', ...)."""
        out: dict = {}
        prefix = section + "."
        for key in self.index:
            if not key.startswith(prefix):
                continue
            node = out
            parts = key[len(prefix):].split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = self.load(key)
        return out


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3 or argv[0] not in ("zero_to_fp32", "ds_to_universal"):
        print(__doc__)
        return 2
    cmd, src, dst = argv[0], argv[1], argv[2]
    tag = argv[3] if len(argv) > 3 else None
    if cmd == "zero_to_fp32":
        zero_to_fp32(src, dst, tag)
    else:
        ds_to_universal(src, dst, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
