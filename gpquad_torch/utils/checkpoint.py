"""Checkpoint / resume; port of ``gpquad/utils/checkpoint.py``.

A checkpoint is a directory: the tree of tensors (nested dicts) in
``tree.pt`` by ``torch.save``, read back with ``torch.load(weights_only=
True)``, and the JSON metadata sidecar ``gpquad_meta.json``, returned as
``tree["__metadata__"]``.  Complex tensors are saved as they are (gpquad
splits them into real and imaginary parts for Orbax).

``save_efgp`` / ``restore_efgp`` carry gpquad's state of the ``EFGP``
facade: the raw hypers, the last gradient's beta (the CG warm start), the
metadata (names, eps, the scalar options, the training log without its
gradients); in place of gpquad's PRNG key, the state of the facade's
``torch.Generator``, under the generator's device type.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "save_efgp",
           "restore_efgp"]

TREE_FILE = "tree.pt"
META_FILE = "gpquad_meta.json"


def _to_cpu(node):
    """The tree with every tensor (and numpy array) as a CPU tensor."""
    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, np.ndarray):
        return torch.as_tensor(node).clone()
    return node


def save_checkpoint(path, tree: Dict[str, Any], *,
                    metadata: Optional[Dict] = None):
    """Save a tree of tensors (nested dicts; numpy arrays are saved as
    tensors) and a JSON metadata sidecar to the directory ``path``,
    replacing a checkpoint there.  Returns the absolute path."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(_to_cpu(tree), path / TREE_FILE)
    meta_p = path / META_FILE
    if metadata is not None:
        meta_p.write_text(json.dumps(metadata))
    elif meta_p.exists():
        meta_p.unlink()
    return path


def restore_checkpoint(path, *, device="cuda") -> Dict[str, Any]:
    """The tree saved at ``path``, its tensors on ``device``, with the
    sidecar (if any) as ``tree["__metadata__"]``."""
    from ..models.efgp import resolve_device
    path = Path(path).absolute()
    tree = torch.load(path / TREE_FILE, map_location=resolve_device(device),
                      weights_only=True)
    meta_p = path / META_FILE
    if meta_p.exists():
        tree["__metadata__"] = json.loads(meta_p.read_text())
    return tree


# ---------------------------------------------------------------------------
# EFGP model convenience wrappers
# ---------------------------------------------------------------------------

def save_efgp(model, path):
    """Persist an :class:`gpquad_torch.EFGP`'s learnable and warm-start
    state."""
    tree = {
        "raw": model.params.raw,
        "generator": {model.generator.device.type:
                      model.generator.get_state()},
    }
    if model._last_gradient_beta is not None:
        tree["last_gradient_beta"] = model._last_gradient_beta
    meta = {
        "names": list(model.params.names),
        "eps": model.eps,
        "opts": {k: v for k, v in model.opts.items()
                 if isinstance(v, (int, float, str, bool, type(None)))},
        "training_log": {k: v for k, v in model.training_log.items()
                         if k != "gradients"},
    }
    return save_checkpoint(path, tree, metadata=meta)


def restore_efgp(model, path):
    """Restore state saved by :func:`save_efgp` into ``model`` (same data
    and kernel family), on the model's device.  The generator's state is
    restored into the model's generator, which must be on a device of the
    saved one's type.  Returns the model."""
    tree = restore_checkpoint(path, device=model.device)
    model.params = model.params.replace_raw(
        tree["raw"].to(model.params.raw.dtype))
    if "generator" in tree:
        (kind, state), = tree["generator"].items()
        if kind != model.generator.device.type:
            raise ValueError(
                f"the checkpoint holds a {kind} generator's state; this "
                f"model's generator is on {model.generator.device.type}")
        model.generator.set_state(state.cpu())
    if "last_gradient_beta" in tree:
        model._last_gradient_beta = tree["last_gradient_beta"]
    meta = tree.get("__metadata__", {})
    if meta.get("training_log"):
        model.training_log = meta["training_log"]
    model._state = None          # force refit with restored hypers
    model._fitted_raw = None
    return model
