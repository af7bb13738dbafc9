"""``--dataset_config``: build the (combined) dataset a ``training.json``
describes.

Port of ``vap_tpu/data/config.py`` (``DatasetAnnotationWrapper`` :28,
``build_dataset_from_entry`` :67, ``build_datasets_from_config`` :155). The
dataset's kind follows the training type: ``video_as_prompt_mot`` builds the
VAP dataset whatever the entry's ``dataset_type``; ``lora`` builds the
auto-detected video layout. An entry's keys (buckets, ``frames_selection``,
``meta_df_name``, ``id_token``, ...) override the global flags; an unknown
key raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

_ENTRY_KEYS = {
    "data_root", "dataset_file", "dataset_type", "caption_options",
    "meta_df_name", "video_resolution_buckets", "image_resolution_buckets",
    "reshape_mode", "frames_selection", "remove_common_llm_caption_prefixes",
    "id_token", "_comment",
}


class DatasetAnnotationWrapper:
    """Attach a dataset's own buckets and frame selection to each of its
    samples, for the trainer's bucket fit; the state is the wrapped
    dataset's."""

    def __init__(self, dataset, annotations: Dict[str, Any]):
        self.dataset = dataset
        self.annotations = annotations
        self.infinite = getattr(dataset, "infinite", False)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for sample in self.dataset:
            yield {**sample, **self.annotations}

    def state_dict(self):
        return self.dataset.state_dict()

    def load_state_dict(self, state):
        self.dataset.load_state_dict(state)


def _tuplify_buckets(b):
    return tuple(tuple(int(x) for x in row) for row in b)


def _annotations(entry: Dict[str, Any]) -> Dict[str, Any]:
    ann = {}
    if "video_resolution_buckets" in entry:
        ann["_resolution_buckets"] = _tuplify_buckets(entry["video_resolution_buckets"])
    if "image_resolution_buckets" in entry:
        ann["_image_resolution_buckets"] = _tuplify_buckets(entry["image_resolution_buckets"])
    if "frames_selection" in entry:
        ann["_frames_selection"] = str(entry["frames_selection"])
    return ann


def build_dataset_from_entry(entry: Dict[str, Any], args, *, family: str,
                             shard_index: int = 0, num_shards: int = 1):
    """One entry of the ``datasets`` list -> a stateful iterable dataset."""
    from .generic import DatasetPreprocessingWrapper

    unknown = set(entry) - _ENTRY_KEYS
    if unknown:
        raise ValueError(f"unknown dataset_config keys: {sorted(unknown)} "
                         f"(valid: {sorted(_ENTRY_KEYS - {'_comment'})})")
    if entry.get("caption_options"):
        raise ValueError("dataset_config caption_options is not supported; "
                         "use caption .txt files / metadata columns")
    if entry.get("reshape_mode", "bicubic") != "bicubic":
        raise ValueError(f"reshape_mode {entry['reshape_mode']!r} is not implemented "
                         "(bicubic only, matching this build's resize path)")
    if entry.get("data_root") and entry.get("dataset_file"):
        raise ValueError("dataset_config entry: data_root and dataset_file are mutually "
                         "exclusive")
    dataset_file = entry.get("dataset_file")
    if dataset_file:
        # a metadata file: its directory is the media root
        if not os.path.isfile(dataset_file):
            raise ValueError(f"dataset_file {dataset_file!r} is not a file")
        root = os.path.dirname(os.path.abspath(dataset_file))
    else:
        root = entry.get("data_root") or args.data_root
    if not root:
        raise ValueError("dataset_config entry needs data_root (or --data_root)")
    dataset_type = entry.get("dataset_type", "video")
    if dataset_type not in ("video", "image"):
        raise ValueError(f"dataset_type must be video|image, got {dataset_type!r}")
    id_token = entry.get("id_token", args.id_token)
    strip = entry.get("remove_common_llm_caption_prefixes",
                      args.remove_common_llm_caption_prefixes)

    if args.training_type == "video_as_prompt_mot":
        from .dataset import VideoAsPromptDataset

        ds = VideoAsPromptDataset(
            root,
            meta_df_name=(os.path.basename(dataset_file) if dataset_file
                          else entry.get("meta_df_name", args.meta_df_name)),
            infinite=True,
            sample_ref_videos_num=args.sample_ref_videos_num,
            mask_ref_ratio=args.mask_ref_ratio,
            mask_caption_ratio=args.mask_caption_ratio,
            alignment_score_threshold=args.alignment_score_threshold,
            baseline_single_condition=args.baseline_single_condition,
            ablation_scaling_data_num=args.ablation_scaling_data_num,
            shard_index=shard_index,
            num_shards=num_shards,
            seed=args.seed + shard_index,
        )
        if strip or id_token:
            ds = DatasetPreprocessingWrapper(ds, id_token=id_token,
                                             remove_common_llm_caption_prefixes=strip)
    else:
        from .generic import initialize_dataset

        if dataset_file and not os.path.basename(dataset_file).startswith("metadata"):
            raise ValueError(
                "generic dataset_file must be a metadata.{csv,json,jsonl} file "
                f"(auto-detected by initialize_dataset); got {dataset_file!r} — "
                "use data_root for folder/caption-pair/webdataset layouts")
        ds = initialize_dataset(root, dataset_type, infinite=True)
        if num_shards > 1:
            ds._items = ds._items[shard_index::num_shards]
        ds = DatasetPreprocessingWrapper(ds, id_token=id_token,
                                         remove_common_llm_caption_prefixes=strip)

    ann = _annotations(entry)
    return DatasetAnnotationWrapper(ds, ann) if ann else ds


def build_datasets_from_config(path: str, args, *, family: str,
                               shard_index: int = 0, num_shards: int = 1):
    """A ``training.json`` -> its dataset, combined when it lists several."""
    with open(path) as f:
        cfg = json.load(f)
    entries = cfg.get("datasets")
    if not isinstance(entries, list) or not entries:
        raise ValueError(f"{path} must contain a non-empty 'datasets' list")
    datasets = [build_dataset_from_entry(e, args, family=family, shard_index=shard_index,
                                         num_shards=num_shards) for e in entries]
    if len(datasets) == 1:
        return datasets[0]
    from .generic import CombinedDataset

    return CombinedDataset(datasets, shuffle=True)
