"""The port's host-side data path against the JAX package's, on the CPU.

The CSV reader against pandas on an awkward file; the VAP datasets' sample
stream (captions, references, masks, frames bit-equal: both sides decode
with cv2) and its resume; the bucket fit against cv2's resize at
shrinking, growing and mixed ratios; the plain video layouts, the caption
wrapper and the three recipes' ``training.json`` files; the prefetching
loader's state; the missing codec's error.
"""

import json
import os
import random
import sys

import numpy as np
import pandas as pd
import pytest

from torch_data_util import vap_data_dir, write_clip, write_csv
from vap_tpu import native as jnative
from vap_tpu.data import config as jconfig
from vap_tpu.data import dataset as jdataset
from vap_tpu.data import generic as jgeneric
from vap_tpu.data import video as jvideo
from vap_tpu.data.dataloader import PrefetchingDataLoader as JaxLoader
from vap_tpu.training.args import TrainingArgs as JaxArgs
from vap_tpu_torch.data import config as tconfig
from vap_tpu_torch.data import dataset as tdataset
from vap_tpu_torch.data import generic as tgeneric
from vap_tpu_torch.data import video as tvideo
from vap_tpu_torch.data.dataloader import PrefetchingDataLoader
from vap_tpu_torch.training.args import TrainingArgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {"cogvideox_vap": "examples/training/sft/cogvideox/vap_mot/training.json",
           "wan_lora": "examples/training/sft/wan/crush_smol_lora/training.json",
           "hunyuan_lora": "examples/training/sft/hunyuan_video/modal_labs_dissolve/training.json"}


@pytest.fixture(autouse=True)
def cv2_on_both_sides(monkeypatch):
    """The JAX package would decode with its native decoder where it loads:
    both sides decode with cv2 here, so frames compare to the bit."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _same(a, b):
    """Equal, NaN equal to NaN, arrays to the bit."""
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def test_csv_reader_matches_pandas(tmp_path):
    path = tmp_path / "awkward.csv"
    path.write_text(
        "video_paths,tar_video_caption,ref_video_paths,kind,split,reference_alignment_score,"
        "_valid,ref_video_caption,count\n"
        'a.mp4,"a cat, then a dog","[""b.mp4"", ""c.mp4""]",fx,train,9,1,,3\n'
        'b.mp4,,"[""a.mp4""]",fx,train,7.5,,ref b,4\n'
        'c.mp4,plain caption,[],gx,test,10,0,NA,5\n')
    got = tdataset.read_csv_records(str(path))
    want = pd.read_csv(path).to_dict("records")
    assert _same(got, want), (got, want)
    assert isinstance(got[0]["count"], int) and isinstance(got[0]["reference_alignment_score"],
                                                           float)
    assert _same(tdataset._read_csv_rows(str(path)), jdataset._read_csv_rows(str(path)))


def test_filter_and_update_refs_matches_jax():
    rows = [{"video_paths": f"v{i}.mp4", "ref_video_paths": [f"v{(i + 1) % 6}.mp4"],
             "kind": "ab"[i % 2], "reference_alignment_score": [9, 3, 8, 7, 2, 6][i],
             "_valid": [1, 1, float("nan"), 1, 1, 1][i]} for i in range(6)]
    for seed in (0, 42):
        assert _same(tdataset.filter_and_update_refs(rows, 5.0, seed),
                     jdataset.filter_and_update_refs(rows, 5.0, seed))


@pytest.mark.parametrize("fps,n", [(16, 49), (24, 49), (30, 97), (8, 20), (60, 3)])
def test_resample_indices_match_jax(fps, n):
    np.testing.assert_array_equal(tdataset._ref_resample_indices(fps, 16, n),
                                  jdataset._ref_resample_indices(fps, 16, n))
    assert tvideo.get_resample_indices(n, fps) == jvideo.get_resample_indices(n, fps)


@pytest.fixture(scope="module")
def awkward_vap(tmp_path_factory):
    """Six clips (one at 24 fps), two kinds, two references a row, a row
    under the alignment threshold."""
    root = tmp_path_factory.mktemp("vap6")
    for i in range(6):
        write_clip(root / f"v{i}.mp4", i, (13 if i == 2 else 9, 32, 32, 3), fps=24 if i == 2 else 16)
    rows = [{"video_paths": f"v{i}.mp4", "tar_video_caption": f"The video shows clip {i}",
             "ref_video_paths": json.dumps([f"v{(i + 1) % 6}.mp4", f"v{(i + 2) % 6}.mp4"]),
             "kind": "ab"[i % 2], "split": "train",
             "reference_alignment_score": [9, 8, 3, 7, 6, 9.5][i]} for i in range(6)]
    write_csv(root / "vap_data.csv", rows)
    write_csv(root / "benchmark.csv", [dict(rows[0], ref_video_caption="explode it")])
    return str(root)


VAP_KW = dict(sample_ref_videos_num=2, mask_ref_ratio=0.5, mask_caption_ratio=0.5, seed=2,
              infinite=True)


def _take(ds, n):
    it = iter(ds)
    return [next(it) for _ in range(n)]


def test_vap_dataset_matches_jax(awkward_vap):
    got = _take(tdataset.VideoAsPromptDataset(awkward_vap, **VAP_KW), 6)
    want = _take(jdataset.VideoAsPromptDataset(awkward_vap, **VAP_KW), 6)
    assert _same(got, want)
    # the draws show: references kept and masked, captions kept and masked
    assert {len(s["ref_videos"]) for s in got} == {1, 2}
    assert {s["caption"] == "" for s in got} == {True, False}
    assert got[0]["video"].dtype == np.float32


def test_vap_dataset_resumes_mid_stream(awkward_vap):
    whole = tdataset.VideoAsPromptDataset(awkward_vap, **VAP_KW)
    it = iter(whole)
    for _ in range(3):
        next(it)
    state = json.loads(json.dumps(whole.state_dict()))  # what a checkpoint holds
    rest = [next(it) for _ in range(3)]
    resumed = tdataset.VideoAsPromptDataset(awkward_vap, **VAP_KW)
    resumed.load_state_dict(state)
    jax_resumed = jdataset.VideoAsPromptDataset(awkward_vap, **VAP_KW)
    jax_resumed.load_state_dict(state)
    assert _same(_take(resumed, 3), rest)
    assert _same(_take(jax_resumed, 3), rest)


def test_validation_dataset_matches_jax(awkward_vap):
    path = os.path.join(awkward_vap, "benchmark.csv")
    got = list(tdataset.VideoAsPromptValidationDataset(path))
    assert _same(got, list(jdataset.VideoAsPromptValidationDataset(path)))
    assert got[0]["caption_mot_ref"] == ["explode it", "explode it"]


RATIOS = {"shrink": ((40, 60), (32, 48)), "grow": ((20, 30), (32, 48)),
          "mixed_area": ((40, 30), (32, 48)), "mixed_linear": ((24, 60), (32, 48))}


@pytest.mark.parametrize("ratio", list(RATIOS))
@pytest.mark.parametrize("selection", ["evenly", "first", "random"])
def test_bucket_fit_matches_cv2(ratio, selection):
    (h, w), (bh, bw) = RATIOS[ratio]
    frames = np.random.default_rng(1).uniform(-1, 1, (13, h, w, 3)).astype(np.float32)
    buckets = ((9, bh, bw), (17, bh, bw))
    got, short = tvideo.resize_to_nearest_bucket(frames, buckets, selection, random.Random(3))
    want, jshort = jvideo.resize_to_nearest_bucket(frames, buckets, selection, random.Random(3))
    assert got.shape == want.shape == (9, bh, bw, 3) and short == jshort is False
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    img = tvideo.resize_to_nearest_bucket_image(frames[0], ((bh, bw), (bw, bh)))
    np.testing.assert_allclose(img, jvideo.resize_to_nearest_bucket_image(
        frames[0], ((bh, bw), (bw, bh))), atol=1e-5, rtol=0)


CAPTIONS = ["The video shows a cat", "  In this video, a dog runs", "Caption: x", "plain",
            "This clip depicts a car", "The image presents art", "This video showsX"]


def test_remove_llm_prefixes_matches_jax():
    assert ([tgeneric.remove_llm_prefixes(c) for c in CAPTIONS]
            == [jgeneric.remove_llm_prefixes(c) for c in CAPTIONS])


def _layout(root, kind):
    """Two clips in one of the four plain video layouts."""
    os.makedirs(root, exist_ok=True)
    names = []
    for i in range(2):
        write_clip(os.path.join(root, f"c{i}.mp4"), 10 + i)
        names.append(f"c{i}.mp4")
    caps = ["The video shows a crush", "a press flattens a car"]
    if kind == "metadata":
        write_csv(os.path.join(root, "metadata.csv"),
                  [{"file_name": n, "caption": c, "score": i} for i, (n, c) in
                   enumerate(zip(names, caps))])
    elif kind == "pairs":
        for n, c in zip(names, caps):
            with open(os.path.join(root, n[:-4] + ".txt"), "w") as f:
                f.write(c)
    elif kind == "lists":
        with open(os.path.join(root, "caption.txt"), "w") as f:
            f.write("\n".join(caps))
        with open(os.path.join(root, "video.txt"), "w") as f:
            f.write("\n".join(names))
    elif kind == "tar":
        import tarfile

        with tarfile.open(os.path.join(root, "shard.tar"), "w") as tf:
            for n, c in zip(names, caps):
                tf.add(os.path.join(root, n), arcname=n)
                txt = os.path.join(root, n[:-4] + ".caption")
                with open(txt, "w") as f:
                    f.write(c)
                tf.add(txt, arcname=n[:-4] + ".txt")
                os.remove(txt)
        for n in names:
            os.remove(os.path.join(root, n))
    return root


@pytest.mark.parametrize("kind", ["metadata", "tar", "pairs", "lists"])
def test_video_layouts_match_jax(tmp_path, kind):
    root = _layout(str(tmp_path / kind), kind)
    ds, jds = tgeneric.initialize_dataset(root, "video"), jgeneric.initialize_dataset(root, "video")
    assert type(ds).__name__ == type(jds).__name__
    wrap = dict(id_token="PIKA_CRUSH", remove_common_llm_caption_prefixes=True)
    got = list(tgeneric.DatasetPreprocessingWrapper(ds, **wrap))
    want = list(jgeneric.DatasetPreprocessingWrapper(jds, **wrap))
    assert len(got) == 2 and _same(got, want)
    assert got[0]["caption"] == "PIKA_CRUSH a crush"


def test_image_layouts_are_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="image"):
        tgeneric.initialize_dataset(str(tmp_path), "image")


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_recipe_dataset_configs_match_jax(tmp_path, recipe):
    vap = recipe == "cogvideox_vap"
    root = (vap_data_dir(str(tmp_path / "d"), n=3) if vap
            else _layout(str(tmp_path / "d"), "pairs"))
    kw = dict(data_root=root, mask_caption_ratio=0.0,
              training_type="video_as_prompt_mot" if vap else "lora",
              model_name={"cogvideox_vap": "cogvideox", "wan_lora": "wan",
                          "hunyuan_lora": "hunyuan_video"}[recipe])
    path = os.path.join(REPO, RECIPES[recipe])
    ds = tconfig.build_datasets_from_config(path, TrainingArgs(**kw), family=kw["model_name"])
    jds = jconfig.build_datasets_from_config(path, JaxArgs(**kw), family=kw["model_name"])
    got, want = _take(ds, 4), _take(jds, 4)
    assert _same(got, want)
    assert all("_resolution_buckets" in s for s in got)
    if vap:  # the recipe strips the LLM lead-in ("This video shows ...")
        assert got[0]["caption"].startswith("clip ")


def test_prefetching_loader_state_is_the_consumed_sample(awkward_vap):
    ds = tdataset.VideoAsPromptDataset(awkward_vap, **VAP_KW)
    loader = PrefetchingDataLoader(ds, prefetch=4)
    it = iter(loader)
    next(it), next(it)
    jds = jdataset.VideoAsPromptDataset(awkward_vap, **VAP_KW)
    jloader = JaxLoader(jds, prefetch=4)
    jit = iter(jloader)
    next(jit), next(jit)
    assert loader.state_dict()["dataset"]["sample_index"] == 2
    assert _same(loader.state_dict(), jloader.state_dict())
    loader.close()  # the thread stops and drops what it prefetched
    assert loader._thread is None and loader.state_dict()["dataset"]["sample_index"] == 2


def test_missing_codec_raises(tmp_path, monkeypatch):
    path = write_clip(tmp_path / "a.mp4", 0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tvideo.load_video(path)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tvideo.export_to_video(np.zeros((2, 8, 8, 3), np.uint8), str(tmp_path / "b.mp4"))


def test_video_round_trip_and_decoder_count(tmp_path):
    frames = (np.random.default_rng(0).uniform(0, 1, (5, 16, 16, 3))).astype(np.float32)
    path = tvideo.export_to_video(frames, str(tmp_path / "sub" / "a.mp4"), fps=16)
    before = dict(tvideo.DECODES)
    got, fps = tvideo.load_video(path)
    want, jfps = jvideo.load_video(path)
    assert fps == jfps == 16.0 and np.array_equal(got, want) and got.shape == (5, 16, 16, 3)
    assert tvideo.DECODES["cv2"] == before["cv2"] + 1
