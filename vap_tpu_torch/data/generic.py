"""The plain-finetune video datasets (the non-VAP layouts).

Port of the video half of ``vap_tpu/data/generic.py``:
``remove_llm_prefixes`` :73, ``_StatefulIterable`` :84, the four video
layouts ``initialize_dataset`` (:451) detects, in its order:

  1. a metadata file (``metadata.csv`` / ``.jsonl`` / ``.json``) ->
     ``VideoFolderDataset`` (:244)
  2. ``.tar`` shards -> ``VideoWebDataset`` (:308, stdlib ``tarfile``)
  3. caption / video file pairs (``a.txt`` + ``a.mp4``) ->
     ``VideoCaptionFilePairDataset`` (:150)
  4. ``caption.txt`` + ``video.txt`` lists ->
     ``VideoFileCaptionFileListDataset`` (:193)

and ``DatasetPreprocessingWrapper`` (:322: ``id_token``, the LLM
caption-prefix strip; its column renames and drops, which no caller sets,
are left out) and ``CombinedDataset`` (:404).
Every dataset is an iterable, endless when ``infinite``, whose state is its
sample index; videos come out float32 [-1, 1] [F, H, W, 3].

``ControlDatasetWrapper`` (:361) adds the control signal of control
training to each sample.

Not ported: the image datasets and ``load_image``, which come with the image
families.
"""

from __future__ import annotations

import json
import os
import random
import tarfile
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import video as _video
from .dataset import read_csv_records

SUPPORTED_VIDEO_EXTENSIONS = ("mp4", "mov")
COMMON_CAPTION_FILES = ("caption.txt", "captions.txt", "prompt.txt", "prompts.txt")
COMMON_VIDEO_FILES = ("video.txt", "videos.txt")
METADATA_FILES = ("metadata.csv", "metadata.jsonl", "metadata.json")

_BEGINNINGS = ("This video", "The video", "This clip", "The clip", "The animation",
               "This image", "The image", "This picture", "The picture")
_CONTINUATIONS = ("shows", "depicts", "features", "captures", "highlights",
                  "introduces", "presents")
COMMON_LLM_START_PHRASES = (
    "In the video,", "In this video,", "In this video clip,", "In the clip,", "Caption:",
    *(f"{b} {c}" for b in _BEGINNINGS for c in _CONTINUATIONS),
)


def _load_video_norm(path: str) -> np.ndarray:
    frames, _ = _video.load_video(path)
    return _video.normalize_video(frames)


def remove_llm_prefixes(caption: str) -> str:
    """Strip one common LLM-captioner lead-in."""
    c = caption.lstrip()
    for phrase in COMMON_LLM_START_PHRASES:
        if c.startswith(phrase):
            c = c[len(phrase):].lstrip()
            break
    return c


class _StatefulIterable:
    """Index-resumable iteration over ``self._items``, one sample per item
    from ``_make_sample``."""

    def __init__(self, infinite: bool = False):
        self.infinite = infinite
        self._items: List[Any] = []
        self._sample_index = 0

    def state_dict(self) -> Dict[str, int]:
        return {"sample_index": self._sample_index}

    def load_state_dict(self, state: Dict[str, int]):
        self._sample_index = state["sample_index"]

    def __len__(self) -> int:
        return len(self._items)

    def _make_sample(self, item) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            start = self._sample_index % max(len(self._items), 1)
            for item in self._items[start:]:
                self._sample_index += 1
                yield self._make_sample(item)
            if not self.infinite:
                break
            self._sample_index = 0


def _find_media_for_caption(caption_path: str, extensions: Sequence[str]) -> Optional[str]:
    base = os.path.splitext(caption_path)[0]
    found = [f"{base}.{ext}" for ext in extensions if os.path.exists(f"{base}.{ext}")]
    if len(found) > 1:
        raise ValueError(f"multiple data files for caption {caption_path}: {found}")
    return found[0] if found else None


class VideoCaptionFilePairDataset(_StatefulIterable):
    """``a.txt`` + ``a.{mp4,mov}`` pairs."""

    def __init__(self, root: str, infinite: bool = False):
        super().__init__(infinite)
        self.root = root
        for fname in sorted(os.listdir(root)):
            if not fname.endswith(".txt"):
                continue
            media = _find_media_for_caption(os.path.join(root, fname), SUPPORTED_VIDEO_EXTENSIONS)
            if media:
                self._items.append((os.path.join(root, fname), media))

    def _make_sample(self, item) -> Dict[str, Any]:
        caption_path, media_path = item
        with open(caption_path) as f:
            caption = f.read().strip()
        return {"caption": caption, "video": _load_video_norm(media_path)}


class VideoFileCaptionFileListDataset(_StatefulIterable):
    """``caption.txt`` + ``video.txt``, line-aligned lists."""

    def __init__(self, root: str, infinite: bool = False):
        super().__init__(infinite)
        self.root = root
        caption_files = [f for f in COMMON_CAPTION_FILES if os.path.exists(os.path.join(root, f))]
        media_files = [f for f in COMMON_VIDEO_FILES if os.path.exists(os.path.join(root, f))]
        if len(caption_files) != 1:
            raise FileNotFoundError(
                f"need exactly one of {COMMON_CAPTION_FILES} in {root}, found {caption_files}")
        if len(media_files) != 1:
            raise FileNotFoundError(
                f"need exactly one of {COMMON_VIDEO_FILES} in {root}, found {media_files}")
        with open(os.path.join(root, caption_files[0])) as f:
            captions = f.read().splitlines()
        with open(os.path.join(root, media_files[0])) as f:
            media = [os.path.join(root, line) for line in f.read().splitlines()]
        if len(captions) != len(media):
            raise ValueError(f"{len(captions)} captions != {len(media)} media files")
        self._items = list(zip(captions, media))

    def _make_sample(self, item) -> Dict[str, Any]:
        caption, media_path = item
        return {"caption": caption, "video": _load_video_norm(media_path)}


def _read_metadata_rows(root: str) -> List[Dict[str, Any]]:
    for name in METADATA_FILES:
        path = os.path.join(root, name)
        if not os.path.exists(path):
            continue
        if name.endswith(".csv"):
            return read_csv_records(path)
        with open(path) as f:
            if name.endswith(".jsonl"):
                return [json.loads(line) for line in f if line.strip()]
            return json.load(f)
    raise FileNotFoundError(f"no metadata.{{csv,jsonl,json}} in {root}")


class VideoFolderDataset(_StatefulIterable):
    """The videofolder layout: a metadata file with ``file_name`` and
    ``caption`` (or ``text``, ``prompt``) columns; other columns pass
    through."""

    def __init__(self, root: str, infinite: bool = False):
        super().__init__(infinite)
        self.root = root
        self._items = _read_metadata_rows(root)

    def _make_sample(self, row) -> Dict[str, Any]:
        row = dict(row)
        fname = row.pop("file_name", None) or row.pop("video", None)
        caption = row.pop("caption", row.pop("text", row.pop("prompt", "")))
        sample = {"caption": str(caption),
                  "video": _load_video_norm(os.path.join(self.root, str(fname)))}
        sample.update(row)
        return sample


_WDS_CAPTION_KEYS = ("txt", "text", "caption", "captions", "prompt", "prompts",
                     "short_caption", "long_caption", "description", "descriptions")


class VideoWebDataset(_StatefulIterable):
    """WebDataset-style ``.tar`` shards: a caption entry (``.txt`` or
    ``.json``) and a video entry paired by their shared basename."""

    def __init__(self, root: str, infinite: bool = False):
        super().__init__(infinite)
        self.root = root
        shards = []
        for dirpath, _, files in os.walk(root):
            shards += [os.path.join(dirpath, f) for f in files if f.endswith(".tar")]
        if not shards:
            raise FileNotFoundError(f"no .tar shards under {root}")
        self._items = []
        for shard in sorted(shards):
            with tarfile.open(shard) as tf:
                keys = sorted({os.path.splitext(n)[0] for n in tf.getnames()
                               if os.path.splitext(n)[1].lstrip(".") in SUPPORTED_VIDEO_EXTENSIONS})
            self._items += [(shard, key) for key in keys]

    def _make_sample(self, item) -> Dict[str, Any]:
        shard, key = item
        caption, media = "", None
        with tarfile.open(shard) as tf:
            for name in tf.getnames():
                base, ext = os.path.splitext(name)
                if base != key:
                    continue
                ext = ext.lstrip(".")
                if ext in SUPPORTED_VIDEO_EXTENSIONS:
                    media = tf.extractfile(name).read()
                elif ext in _WDS_CAPTION_KEYS:
                    caption = tf.extractfile(name).read().decode().strip()
                elif ext == "json":
                    meta = json.loads(tf.extractfile(name).read())
                    for ck in _WDS_CAPTION_KEYS:
                        if ck in meta:
                            caption = str(meta[ck])
                            break
        if media is None:
            raise ValueError(f"no media for key {key} in {shard}")
        # the decoders read files: spill the entry to a temporary one
        with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
            f.write(media)
            f.flush()
            return {"caption": caption, "video": _load_video_norm(f.name)}


class DatasetPreprocessingWrapper(_StatefulIterable):
    """The LLM caption-prefix strip, then the ``id_token`` prefix; the state
    is the wrapped dataset's."""

    def __init__(self, dataset, *, id_token: Optional[str] = None,
                 remove_common_llm_caption_prefixes: bool = False):
        self.dataset = dataset
        self.id_token = id_token
        self.remove_prefixes = remove_common_llm_caption_prefixes
        self.infinite = getattr(dataset, "infinite", False)

    def __len__(self):
        return len(self.dataset)

    def state_dict(self):
        return self.dataset.state_dict()

    def load_state_dict(self, state):
        self.dataset.load_state_dict(state)

    def __iter__(self):
        for sample in self.dataset:
            caption = sample.get("caption", "")
            if self.remove_prefixes:
                caption = remove_llm_prefixes(caption)
            if self.id_token:
                caption = f"{self.id_token} {caption}"
            sample["caption"] = caption
            yield sample


class ControlDatasetWrapper(_StatefulIterable):
    """Each sample with its control signal (``ControlDatasetWrapper``,
    ``vap_tpu/data/generic.py:361``): ``canny`` computes per-frame edges on
    the host (``training/control.py`` ``canny_control``, OpenCV); ``none``
    copies the video; ``custom`` expects a ``control_video`` (or
    ``control_image``) column in the dataset and raises without one. A
    sample that has its control already keeps it. The state is the wrapped
    dataset's. (Image samples are not ported: the image datasets come with
    the image families.)"""

    def __init__(self, dataset, control_type: str = "canny"):
        from ..training.args import CONTROL_TYPES

        if control_type not in CONTROL_TYPES:
            raise ValueError(f"unknown control_type {control_type!r}")
        self.dataset = dataset
        self.control_type = control_type
        self.infinite = getattr(dataset, "infinite", False)

    def __len__(self):
        return len(self.dataset)

    def state_dict(self):
        return self.dataset.state_dict()

    def load_state_dict(self, state):
        self.dataset.load_state_dict(state)

    def __iter__(self):
        from ..training.control import canny_control

        for sample in self.dataset:
            has_control = "control_image" in sample or "control_video" in sample
            if self.control_type == "custom":
                if not has_control:
                    raise ValueError("control_type=custom requires control_image/control_video "
                                     "columns in the dataset")
            elif not has_control and "video" in sample:
                sample["control_video"] = (canny_control(sample["video"])
                                           if self.control_type == "canny"
                                           else sample["video"].copy())
            yield sample


class CombinedDataset(_StatefulIterable):
    """Several datasets taken in turn into a buffer of ``buffer_size``
    samples, shuffled (``shuffle``) and emitted when full."""

    def __init__(self, datasets: List, buffer_size: int = 8, shuffle: bool = False,
                 seed: int = 0):
        self.datasets = datasets
        self.buffer_size = buffer_size
        self.shuffle = shuffle
        self.infinite = any(getattr(d, "infinite", False) for d in datasets)
        self._rng = random.Random(seed)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def state_dict(self):
        return {"datasets": [d.state_dict() for d in self.datasets]}

    def load_state_dict(self, state):
        for d, s in zip(self.datasets, state["datasets"]):
            d.load_state_dict(s)

    def __iter__(self):
        iters = [iter(d) for d in self.datasets]
        buffer: List = []
        while iters:
            for it in list(iters):
                try:
                    buffer.append(next(it))
                except StopIteration:
                    iters.remove(it)
                if len(buffer) >= self.buffer_size:
                    if self.shuffle:
                        self._rng.shuffle(buffer)
                    yield from buffer
                    buffer = []
        yield from buffer


def _has_caption_pairs(root: str) -> bool:
    return any(name.endswith(".txt") and _find_media_for_caption(
        os.path.join(root, name), SUPPORTED_VIDEO_EXTENSIONS) for name in os.listdir(root))


def initialize_dataset(root: str, dataset_type: str = "video", infinite: bool = False):
    """The local video layout under ``root``, detected in JAX's order."""
    if dataset_type == "image":
        raise NotImplementedError("the image datasets are not ported to PyTorch yet: they come "
                                  "with the image families")
    if dataset_type != "video":
        raise ValueError(f"dataset_type must be image|video, got {dataset_type}")
    if not os.path.isdir(root):
        raise FileNotFoundError(f"{root} is not a local directory (hub datasets need network "
                                "access; download locally first)")
    if any(os.path.exists(os.path.join(root, m)) for m in METADATA_FILES):
        return VideoFolderDataset(root, infinite)
    if any(f.endswith(".tar") for _, _, fs in os.walk(root) for f in fs):
        return VideoWebDataset(root, infinite)
    if _has_caption_pairs(root):
        return VideoCaptionFilePairDataset(root, infinite)
    if any(os.path.exists(os.path.join(root, f)) for f in COMMON_VIDEO_FILES):
        return VideoFileCaptionFileListDataset(root, infinite)
    raise ValueError(f"could not infer dataset layout under {root}: expected a metadata file, "
                     ".tar shards, caption/media file pairs, or caption/media list files")
