"""Checkpoint directories: local paths and the local Hugging Face hub cache.

Port of ``vap_tpu/utils/hub.py``. ``variant_weight_files`` and
``component_config_kwargs`` are copied as they are. ``resolve_model_dir``
keeps its contract (a local directory passes through; a hub id resolves
only from the local cache, never the network; anything else raises
``FileNotFoundError``), but reads the cache's layout itself instead of
calling ``huggingface_hub``: the cache root is ``cache_dir``, else
``HF_HUB_CACHE``, else ``HF_HOME/hub``, else ``~/.cache/huggingface/hub``;
the id ``org/name`` is ``models--org--name``, whose ``refs/<revision>``
(``main`` by default) names the snapshot ``snapshots/<commit>``; a commit
hash given as the revision names the snapshot directly.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

_COMMIT = re.compile(r"^[0-9a-f]{40}$")


def hub_cache_dir(cache_dir: Optional[str] = None) -> str:
    if cache_dir:
        return cache_dir
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def _cached_snapshot(repo_id: str, revision: Optional[str], cache_dir: Optional[str]) -> str:
    parts = repo_id.split("/")
    if not 1 <= len(parts) <= 2 or not all(parts) or ".." in parts:
        raise ValueError(f"malformed repo id {repo_id!r}")
    repo = os.path.join(hub_cache_dir(cache_dir), "models--" + "--".join(parts))
    if not os.path.isdir(repo):
        raise FileNotFoundError(f"no {repo}")
    revision = revision or "main"
    ref = os.path.join(repo, "refs", revision)
    if os.path.isfile(ref):
        with open(ref) as f:
            commit = f.read().strip()
    elif _COMMIT.match(revision):
        commit = revision
    else:
        raise FileNotFoundError(f"revision {revision!r} is not cached under {repo}")
    snapshot = os.path.join(repo, "snapshots", commit)
    if not os.path.isdir(snapshot):
        raise FileNotFoundError(f"snapshot {commit} of {repo_id!r} is not cached")
    return snapshot


def resolve_model_dir(path_or_id: str, revision: Optional[str] = None,
                      cache_dir: Optional[str] = None) -> str:
    """A local directory path -> itself; anything else is treated as a hub
    repo id and resolved from the local hub cache (never the network)."""
    if os.path.isdir(path_or_id):
        return path_or_id
    try:
        return _cached_snapshot(path_or_id, revision, cache_dir)
    except Exception as e:  # not cached / malformed id
        raise FileNotFoundError(
            f"{path_or_id!r} is not a local directory and is not in the local "
            f"huggingface cache (revision={revision!r}, cache_dir={cache_dir!r}). "
            f"Download it on a connected machine first: {e}") from e


# --- copied from vap_tpu/utils/hub.py:37-64 ---------------------------------
def variant_weight_files(directory: str, variant: Optional[str] = None,
                         suffix: str = ".safetensors") -> List[str]:
    """Weight files under `directory`, honoring diffusers variant naming:
    with variant 'fp16', `model.fp16.safetensors` is preferred and the
    non-variant `model.safetensors` is used only when no variant file
    exists (diffusers from_pretrained variant semantics)."""
    names = sorted(f for f in os.listdir(directory) if f.endswith(suffix))
    if not names:
        raise FileNotFoundError(f"no {suffix} weight files under {directory}")
    if variant:
        # 'model.fp16.safetensors' / sharded 'model.fp16-00001-of-00002.safetensors'
        tagged = [f for f in names if f".{variant}{suffix}" in f
                  or f".{variant}-" in f]
        if tagged:
            return [os.path.join(directory, f) for f in tagged]
    # untagged stems ('model', 'model-00001-of-00002') contain no dot
    untagged = [f for f in names if "." not in f[: -len(suffix)]]
    if untagged:
        return [os.path.join(directory, f) for f in untagged]
    # variant-only directory: falling back to ALL files would merge weights
    # of different variants (last-write-wins) — only safe when a single
    # variant tag is present
    tags = {f[: -len(suffix)].split(".")[1].split("-")[0] for f in names}
    if len(tags) > 1:
        raise FileNotFoundError(
            f"{directory} holds only variant-tagged weights for multiple "
            f"variants {sorted(tags)}; pass variant= to pick one")
    return [os.path.join(directory, f) for f in names]


# --- copied from vap_tpu/utils/hub.py:67-88 ---------------------------------
def component_config_kwargs(cfg_cls, directory: Optional[str]) -> dict:
    """Read a component dir's config.json and keep only keys that are fields
    of cfg_cls (diffusers config files carry extra HF metadata), tuplifying
    lists so frozen dataclass configs stay hashable. Lets real checkpoints
    override the released-config defaults (e.g. block_idx_with_mot_ref,
    use_learned_positional_embeddings) instead of trusting hardcoded values."""
    import dataclasses
    import json

    if not directory:
        return {}
    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        raw = json.load(f)
    names = {f.name for f in dataclasses.fields(cfg_cls)}

    def tuplify(v):
        return tuple(v) if isinstance(v, list) else v

    return {k: tuplify(v) for k, v in raw.items() if k in names}
