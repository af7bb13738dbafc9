"""Video-As-Prompt datasets: rows of a CSV, resumable.

Port of ``vap_tpu/data/dataset.py`` (``filter_and_update_refs`` :32,
``_read_csv_rows`` :61, ``_decode_resampled`` :72, ``_ref_resample_indices``
:80, ``VideoAsPromptDataset`` :92, ``DPO_STAGE_SCHEDULE`` :192,
``VideoAsPromptDPODataset`` :198, ``VideoAsPromptValidationDataset`` :382):
``vap_data.csv`` rows (``video_paths``, ``tar_video_caption``,
``ref_video_paths`` as a JSON list, ``kind``, ``split``,
``reference_alignment_score``), each video decoded, resampled to 16 fps and
normalised to float32 [-1, 1] [F, H, W, 3]; per sample a random choice of
``sample_ref_videos_num`` references, reference dropout at
``mask_ref_ratio`` and caption dropout at ``mask_caption_ratio``. The draws
are JAX's, draw for draw: ``random.Random(shuffle_seed)`` shuffles and
repairs the rows, ``random.Random(seed)`` (``seed + shard_index`` in the
trainer) chooses and masks; ``state_dict`` holds the sample index and that
generator's state, so a resumed run replays the stream of an uninterrupted
one. The DPO dataset builds win / lose pairs by score, draw for draw as
JAX's does (see ``VideoAsPromptDPODataset``).

The CSV is read with the standard library, not pandas, to the rows pandas
gives (``read_csv`` then ``to_dict("records")``): a column whose cells all
read as integers holds ints, as numbers floats, as True / False bools;
pandas' missing-value spellings (an empty cell, "NA", "nan", ...) read as a
float NaN, which makes an integer column float; other cells stay strings.
"""

from __future__ import annotations

import csv
import json
import os
import random
import re
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from . import video as _video

TARGET_FPS = 16

# pandas' default missing-value spellings (pandas.io.parsers STR_NA_VALUES)
NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"})
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT = re.compile(r"^\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\s*$",
                    re.IGNORECASE)
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})


def _column(cells: List[str]) -> List[Any]:
    """One column's cells as pandas types them."""
    present = [c for c in cells if c not in NA_VALUES]
    nan = float("nan")
    if present and all(_INT.match(c) for c in present):
        if len(present) == len(cells):
            return [int(c) for c in cells]
        return [nan if c in NA_VALUES else float(int(c)) for c in cells]
    if all(_FLOAT.match(c) for c in present):  # all missing reads as float NaN too
        return [nan if c in NA_VALUES else float(c) for c in cells]
    if present and all(c in _TRUE or c in _FALSE for c in present):
        return [nan if c in NA_VALUES else c in _TRUE for c in cells]
    return [nan if c in NA_VALUES else c for c in cells]


def read_csv_records(path: str) -> List[Dict[str, Any]]:
    """``pandas.read_csv(path).to_dict("records")``, for the files this
    repository reads: a header row, then one row a record."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return []
    header, body = rows[0], [r for r in rows[1:] if r]
    columns = [_column([r[i] if i < len(r) else "" for r in body]) for i in range(len(header))]
    return [{name: col[j] for name, col in zip(header, columns)} for j in range(len(body))]


def filter_and_update_refs(rows: List[Dict[str, Any]], alignment_score_threshold: float,
                           seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Drop rows below the alignment-score threshold (and rows whose
    ``_valid`` is not positive: a NaN drops its row); repair rows whose
    references were all dropped with a random same-``kind`` replacement."""
    rng = random.Random(seed)
    alive = [r for r in rows
             if r.get("_valid", 1) > 0 and r["reference_alignment_score"] > alignment_score_threshold]
    alive_paths = {str(r["video_paths"]) for r in alive}
    pools_by_kind: Dict[str, List[str]] = {}
    for r in alive:
        pools_by_kind.setdefault(r["kind"], []).append(str(r["video_paths"]))

    out = []
    for r in alive:
        self_path = str(r["video_paths"])
        refs = [p for p in r["ref_video_paths"] if p in alive_paths and p != self_path]
        if not refs:
            pool = [p for p in pools_by_kind.get(r["kind"], []) if p != self_path]
            if not pool:
                continue
            refs = [rng.choice(pool)]
        r = dict(r)
        r["ref_video_paths"] = refs
        out.append(r)
    return out


def _read_csv_rows(path: str) -> List[Dict[str, Any]]:
    rows = read_csv_records(path)
    for r in rows:
        if isinstance(r.get("ref_video_paths"), str):
            r["ref_video_paths"] = json.loads(r["ref_video_paths"])
    return rows


def _ref_resample_indices(source_fps: float, target_fps: float, n: int) -> np.ndarray:
    """The reference's resample (round, then drop repeats)."""
    if abs(source_fps - target_fps) < 1e-6:
        return np.arange(n)
    num_target = int(n * (target_fps / source_fps))
    if num_target < 1:
        return np.array([n // 2])
    idx = np.round(np.linspace(0, n - 1, num=num_target)).astype(int)
    _, uniq = np.unique(idx, return_index=True)
    return idx[np.sort(uniq)]


def _decode_resampled(path: str) -> np.ndarray:
    frames, fps = _video.load_video(path)
    if abs(fps - TARGET_FPS) > 1e-3:
        frames = frames[_ref_resample_indices(fps, TARGET_FPS, len(frames))]
    return _video.normalize_video(frames)


class VideoAsPromptDataset:
    """The VAP training stream; its state is the consumed-sample index and
    the draws' generator."""

    def __init__(self, root: str, meta_df_name: str = "vap_data.csv", infinite: bool = False,
                 sample_ref_videos_num: int = 1, mask_ref_ratio: float = 0.0,
                 mask_caption_ratio: float = 0.02, alignment_score_threshold: float = 5.0,
                 baseline_single_condition: Optional[str] = None,
                 ablation_scaling_data_num: int = 99_999_999, shuffle_seed: int = 42,
                 shard_index: int = 0, num_shards: int = 1, seed: int = 0):
        self.root = root
        self.infinite = infinite
        self.sample_ref_videos_num = sample_ref_videos_num
        self.mask_ref_ratio = mask_ref_ratio
        self.mask_caption_ratio = mask_caption_ratio

        rows = _read_csv_rows(os.path.join(root, meta_df_name))
        if baseline_single_condition is not None:
            rows = [r for r in rows if r["kind"] == baseline_single_condition]
        rows = [r for r in rows if r.get("split", "train") == "train"]
        random.Random(shuffle_seed).shuffle(rows)
        rows = filter_and_update_refs(rows, alignment_score_threshold, seed=shuffle_seed)
        rows = rows[: min(len(rows), ablation_scaling_data_num)]
        self._global_rows = rows
        self._shard = (shard_index, num_shards)
        self.rows = rows[shard_index::num_shards]  # this data-parallel shard's rows

        self.caption_by_path = {str(r["video_paths"]): r["tar_video_caption"] for r in rows}
        self.kind_by_path = {str(r["video_paths"]): r["kind"] for r in rows}
        self._sample_index = 0
        self._rng = random.Random(seed)

    def state_dict(self) -> Dict[str, Any]:
        """JSON-serialisable: the sample index and the draws' generator."""
        v, internal, gauss = self._rng.getstate()
        return {"sample_index": self._sample_index, "rng_state": [v, list(internal), gauss]}

    def load_state_dict(self, state: Dict[str, Any]):
        self._sample_index = state["sample_index"]
        rs = state.get("rng_state")
        if rs is not None:
            self._rng.setstate((rs[0], tuple(rs[1]), rs[2]))

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            start = self._sample_index % max(len(self.rows), 1)
            for row in self.rows[start:]:
                self._sample_index += 1
                try:
                    sample = self._make_sample(row)
                except (OSError, ValueError):
                    continue
                yield sample
            if not self.infinite:
                break

    def _make_sample(self, row: Dict[str, Any]) -> Dict[str, Any]:
        video = _decode_resampled(os.path.join(self.root, str(row["video_paths"])))
        refs, ref_captions, effect_types = [], [], []
        chosen = self._rng.sample(list(row["ref_video_paths"]),
                                  min(self.sample_ref_videos_num, len(row["ref_video_paths"])))
        for ref_name in chosen:
            if self._rng.random() < self.mask_ref_ratio and refs:
                continue
            refs.append(_decode_resampled(os.path.join(self.root, ref_name)))
            ref_captions.append(str(self.caption_by_path.get(ref_name, "")).strip())
            effect_types.append(self.kind_by_path.get(ref_name, row["kind"]))

        caption = row["tar_video_caption"]
        if self._rng.random() < self.mask_caption_ratio:
            caption = ""
            ref_captions = [""] * len(ref_captions)
        return {"video": video, "caption": caption, "ref_videos": refs,
                "caption_mot_ref": ref_captions, "effect_types": effect_types,
                "kind": row["kind"]}


DPO_STAGE_SCHEDULE = (
    {"epochs": 2, "pos_min": 90, "neg_max": 10},
    {"epochs": 10_000, "pos_min": 80, "neg_max": 30},
)
# the pair weight's constants (JAX's defaults, which no recipe changes)
DPO_WEIGHT_ALPHA = 1.0
DPO_WEIGHT_BETA = 0.02
DPO_WEIGHT_EPS = 1e-8
DPO_FREQ_BIN_WIDTH = 10
DPO_FREQ_SMOOTHING = 0.0


class VideoAsPromptDPODataset(VideoAsPromptDataset):
    """Win / lose preference pairs for DPO, built per row from
    ``reference_alignment_score`` (JAX's ``VideoAsPromptDPODataset``):

      * a staged curriculum by epoch (``DPO_STAGE_SCHEDULE``: 2 epochs at
        (pos_min, neg_max) = (90, 10), then (80, 30), each floored to its
        decade) picks the win from {score >= pos_min} and the lose from
        {score <= neg_max, not the win} within the row's kind;
      * the reference video from the score-100 pool of the kind, else from
        80 < score < 100, never the win or the lose;
      * the pair weight ((|s_win - s_lose| DPO_WEIGHT_BETA) /
        max(sqrt(p_win p_lose), DPO_WEIGHT_EPS)) ** DPO_WEIGHT_ALPHA, p the
        share of all videos in the video's score bin (``DPO_FREQ_BIN_WIDTH``
        wide, plus ``DPO_FREQ_SMOOTHING``).

    The rows are filtered at threshold 0 whatever the SFT threshold; the
    pools, captions, kinds and scores come from every split; the train rows
    are cut to a multiple of 48 (when there are 16 or more) before the
    shard. A row whose pools are empty is skipped. A CSV that carries
    ``win_video_paths`` / ``lose_video_paths`` (and optionally
    ``dpo_weight``) gives its pairs as they are. The draws come from the
    base class's generator in JAX's order; ``state_dict`` is the base
    class's (the stage follows from the sample index)."""

    def __init__(self, root: str, **kw):
        kw["alignment_score_threshold"] = 0.0
        super().__init__(root, **kw)
        meta = kw.get("meta_df_name", "vap_data.csv")
        self._all_rows = filter_and_update_refs(_read_csv_rows(os.path.join(root, meta)), 0.0,
                                                seed=kw.get("shuffle_seed", 42))

        self._explicit_pairs = bool(self.rows) and "win_video_paths" in self.rows[0]
        if self._explicit_pairs:
            return
        # the cut applies to the global train rows, before the shard: cutting
        # each shard could leave one empty and its endless stream spinning
        g = self._global_rows
        if len(g) >= 16:
            g = g[: len(g) - (len(g) % 48)]
        shard_index, num_shards = self._shard
        self._global_rows = g
        self.rows = g[shard_index::num_shards]

        self.score_by_path = {str(r["video_paths"]): float(r["reference_alignment_score"])
                              for r in self._all_rows}
        self.caption_by_path = {str(r["video_paths"]): r["tar_video_caption"]
                                for r in self._all_rows}
        self.kind_by_path = {str(r["video_paths"]): r["kind"] for r in self._all_rows}
        by_kind: Dict[str, List[str]] = {}
        for p, kind in self.kind_by_path.items():
            by_kind.setdefault(kind, []).append(p)
        s = self.score_by_path
        self.pos_pools = {kind: {d: [v for v in vids if s[v] >= d] for d in range(0, 101, 10)}
                          for kind, vids in by_kind.items()}
        self.neg_pools = {kind: {d: [v for v in vids if s[v] <= d] for d in range(0, 101, 10)}
                          for kind, vids in by_kind.items()}
        self.ref_pool_eq100 = {kind: [v for v in vids if s[v] == 100]
                               for kind, vids in by_kind.items()}
        self.ref_pool_80_100 = {kind: [v for v in vids if 80 < s[v] < 100]
                                for kind, vids in by_kind.items()}

        counts = {i: DPO_FREQ_SMOOTHING for i in range(100 // DPO_FREQ_BIN_WIDTH + 1)}
        for score in s.values():
            counts[self._bin(score)] += 1.0
        total = sum(counts.values()) or 1.0
        self.prob_by_path = {p: counts[self._bin(score)] / total for p, score in s.items()}

    @staticmethod
    def _bin(score: float) -> int:
        """A score's frequency bin; 100 has a bin of its own."""
        max_idx = 100 // DPO_FREQ_BIN_WIDTH
        clamped = min(max(score, 0.0), 100.0)
        return max_idx if int(clamped) >= 100 else int(clamped) // DPO_FREQ_BIN_WIDTH

    def _current_stage(self) -> Dict[str, int]:
        epoch = self._sample_index // max(len(self.rows), 1)
        start = 0
        for stage in DPO_STAGE_SCHEDULE:
            if start <= epoch < start + stage["epochs"]:
                return stage
            start += stage["epochs"]
        return DPO_STAGE_SCHEDULE[-1]

    def _pair_weight(self, win: str, lose: str) -> float:
        s0, s1 = self.score_by_path.get(win, 0.0), self.score_by_path.get(lose, 0.0)
        p0, p1 = self.prob_by_path.get(win, 1.0), self.prob_by_path.get(lose, 1.0)
        prob = (max(p0, DPO_WEIGHT_EPS) * max(p1, DPO_WEIGHT_EPS)) ** 0.5
        return (abs(s0 - s1) * DPO_WEIGHT_BETA / max(prob, DPO_WEIGHT_EPS)) ** DPO_WEIGHT_ALPHA

    def _construct_pair(self, row: Dict[str, Any]):
        """(win, lose, reference, weight) for ``row`` at the current stage,
        or None where a pool is empty."""
        stage = self._current_stage()
        pos_min = min(max((stage["pos_min"] // 10) * 10, 0), 100)
        neg_max = min(max((stage["neg_max"] // 10) * 10, 0), 100)
        kind = row["kind"]
        pos_pool = self.pos_pools.get(kind, {}).get(pos_min, [])
        neg_pool = self.neg_pools.get(kind, {}).get(neg_max, [])
        if not pos_pool or not neg_pool:
            return None
        win = self._rng.choice(pos_pool)
        lose_candidates = [v for v in neg_pool if v != win]
        if not lose_candidates:
            return None
        lose = self._rng.choice(lose_candidates)
        ban = {win, lose}
        ref_pool = [v for v in self.ref_pool_eq100.get(kind, []) if v not in ban]
        if not ref_pool:
            ref_pool = [v for v in self.ref_pool_80_100.get(kind, []) if v not in ban]
        if not ref_pool:
            return None
        return win, lose, self._rng.choice(ref_pool), self._pair_weight(win, lose)

    def _make_sample(self, row: Dict[str, Any]) -> Dict[str, Any]:
        if self._explicit_pairs:
            sample = super()._make_sample(dict(row, video_paths=row["win_video_paths"]))
            sample["video_lose"] = _decode_resampled(
                os.path.join(self.root, str(row["lose_video_paths"])))
            sample["dpo_weight"] = float(row.get("dpo_weight", 1.0))
            return sample
        pair = self._construct_pair(row)
        if pair is None:
            raise ValueError(f"no DPO pair for kind {row['kind']!r} at this stage")
        win, lose, ref, weight = pair
        win_v = _decode_resampled(os.path.join(self.root, win))
        lose_v = _decode_resampled(os.path.join(self.root, lose))
        ref_v = _decode_resampled(os.path.join(self.root, ref))
        caption = str(self.caption_by_path.get(win, "")).strip()
        caption_lose = str(self.caption_by_path.get(lose, "")).strip()
        ref_caption = str(self.caption_by_path.get(ref, "")).strip()
        if self._rng.random() < self.mask_caption_ratio:
            caption = caption_lose = ref_caption = ""
        return {"video": win_v, "video_lose": lose_v, "caption": caption,
                "caption_lose": caption_lose, "ref_videos": [ref_v],
                "caption_mot_ref": [ref_caption], "effect_types": [row["kind"]],
                "kind": row["kind"], "dpo_weight": float(weight)}


class VideoAsPromptValidationDataset:
    """Benchmark rows for validation: each yields the target's first frame
    and prompt, and the reference video(s) and their prompt(s)."""

    def __init__(self, csv_path: str, root: Optional[str] = None, num_frames: int = 49,
                 shard_index: int = 0, num_shards: int = 1):
        self.root = root or os.path.dirname(os.path.abspath(csv_path))
        self.rows = _read_csv_rows(csv_path)[shard_index::num_shards]
        self.num_frames = num_frames

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        for row in self.rows:
            video = _decode_resampled(os.path.join(self.root, str(row["video_paths"])))
            refs = [_decode_resampled(os.path.join(self.root, p)) for p in row["ref_video_paths"]]
            yield {"image": video[0], "video": video, "caption": row["tar_video_caption"],
                   "ref_videos": refs,
                   "caption_mot_ref": [row.get("ref_video_caption", row["tar_video_caption"])]
                   * len(refs),
                   "kind": row.get("kind")}
