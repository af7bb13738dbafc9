"""The port's checkpoint-directory resolution (``vap_tpu_torch/utils/hub.py``)
against the JAX package's (``vap_tpu/utils/hub.py``): the cases of
``tests/test_hub.py`` through both, and a fabricated Hugging Face cache
tree resolved as ``huggingface_hub.snapshot_download(local_files_only=True)``
resolves it, with no network."""

import os

import pytest

from vap_tpu.utils import hub as jhub
from vap_tpu_torch.utils import hub

SIDES = [jhub, hub]


def _touch(d, *names):
    for n in names:
        (d / n).write_bytes(b"")


def _names(files):
    return [os.path.basename(f) for f in files]


@pytest.mark.parametrize("side", SIDES, ids=["jax", "port"])
def test_local_dir_passthrough(tmp_path, side):
    assert side.resolve_model_dir(str(tmp_path)) == str(tmp_path)


@pytest.mark.parametrize("side", SIDES, ids=["jax", "port"])
def test_uncached_id_raises(tmp_path, side):
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        side.resolve_model_dir("definitely/not-a-cached-repo", cache_dir=str(tmp_path / "cache"))


@pytest.mark.parametrize("side", SIDES, ids=["jax", "port"])
def test_variant_weight_files(tmp_path, side):
    _touch(tmp_path, "diffusion_pytorch_model.safetensors",
           "diffusion_pytorch_model.fp16.safetensors", "config.json")
    assert _names(side.variant_weight_files(str(tmp_path), "fp16")) == [
        "diffusion_pytorch_model.fp16.safetensors"]
    assert _names(side.variant_weight_files(str(tmp_path), None)) == [
        "diffusion_pytorch_model.safetensors"]
    assert _names(side.variant_weight_files(str(tmp_path), "bf16")) == [
        "diffusion_pytorch_model.safetensors"]


@pytest.mark.parametrize("side", SIDES, ids=["jax", "port"])
def test_variant_weight_files_sharded(tmp_path, side):
    _touch(tmp_path, "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors",
           "model.fp16-00001-of-00002.safetensors", "model.fp16-00002-of-00002.safetensors")
    assert _names(side.variant_weight_files(str(tmp_path), "fp16")) == [
        "model.fp16-00001-of-00002.safetensors", "model.fp16-00002-of-00002.safetensors"]
    assert _names(side.variant_weight_files(str(tmp_path))) == [
        "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]


@pytest.mark.parametrize("side", SIDES, ids=["jax", "port"])
def test_variant_only_directory(tmp_path, side):
    _touch(tmp_path, "model.fp16.safetensors")
    assert _names(side.variant_weight_files(str(tmp_path), None)) == ["model.fp16.safetensors"]
    _touch(tmp_path, "model.bf16.safetensors")
    with pytest.raises(FileNotFoundError, match="multiple"):
        side.variant_weight_files(str(tmp_path), None)
    assert _names(side.variant_weight_files(str(tmp_path), "bf16")) == ["model.bf16.safetensors"]


@pytest.mark.parametrize("side", SIDES, ids=["jax", "port"])
def test_empty_directory_raises(tmp_path, side):
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        side.variant_weight_files(str(tmp_path))


def test_component_config_kwargs_matches_jax(tmp_path):
    from vap_tpu.models.cogvideox.config import CogVideoXMOTConfig as JaxConfig
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig

    (tmp_path / "config.json").write_text(
        '{"_class_name": "X", "num_layers": 3, "block_idx_with_mot_ref": [0, 2], '
        '"use_learned_positional_embeddings": true}')
    got = hub.component_config_kwargs(CogVideoXMOTConfig, str(tmp_path))
    assert got == jhub.component_config_kwargs(JaxConfig, str(tmp_path))
    assert got == {"num_layers": 3, "block_idx_with_mot_ref": (0, 2),
                   "use_learned_positional_embeddings": True}
    assert hub.component_config_kwargs(CogVideoXMOTConfig, None) == {}
    assert hub.component_config_kwargs(CogVideoXMOTConfig, str(tmp_path / "none")) == {}


COMMIT = "0123456789abcdef0123456789abcdef01234567"
OTHER = "fedcba9876543210fedcba9876543210fedcba98"


def _fake_cache(root, repo_id="org/model", refs=(("main", COMMIT),), snapshots=(COMMIT, OTHER)):
    """A hub cache tree as huggingface_hub lays it out: models--org--name/
    refs/<ref> holding a commit hash, snapshots/<hash>/<files>."""
    repo = root / ("models--" + repo_id.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    for ref, commit in refs:
        (repo / "refs" / ref).write_text(commit)
    for commit in snapshots:
        snap = repo / "snapshots" / commit / "transformer"
        snap.mkdir(parents=True)
        (snap / "config.json").write_text("{}")
    return repo


@pytest.mark.parametrize("revision", [None, "main", "v1", COMMIT, OTHER])
def test_cache_tree_resolves_like_huggingface_hub(tmp_path, revision):
    from huggingface_hub import snapshot_download

    cache = tmp_path / "cache"
    _fake_cache(cache, refs=(("main", COMMIT), ("v1", OTHER)))
    want = snapshot_download("org/model", revision=revision, cache_dir=str(cache),
                             local_files_only=True)
    got = hub.resolve_model_dir("org/model", revision=revision, cache_dir=str(cache))
    assert os.path.realpath(got) == os.path.realpath(want)
    assert got == jhub.resolve_model_dir("org/model", revision=revision, cache_dir=str(cache))
    assert os.path.isdir(os.path.join(got, "transformer"))


@pytest.mark.parametrize("env", ["HF_HUB_CACHE", "HF_HOME"])
def test_cache_root_from_the_environment(tmp_path, monkeypatch, env):
    root = tmp_path / "hf"
    cache = root / "hub" if env == "HF_HOME" else root
    _fake_cache(cache)
    for name in ("HF_HUB_CACHE", "HF_HOME"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(env, str(root))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert hub.hub_cache_dir() == str(cache)
    assert hub.resolve_model_dir("org/model") == str(cache / "models--org--model" / "snapshots"
                                                     / COMMIT)


def test_default_cache_root_is_under_home(tmp_path, monkeypatch):
    for name in ("HF_HUB_CACHE", "HF_HOME"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert hub.hub_cache_dir() == str(tmp_path / ".cache" / "huggingface" / "hub")


@pytest.mark.parametrize("case", ["unknown_revision", "missing_snapshot", "other_repo",
                                  "malformed_id"])
def test_uncached_cases_raise_as_huggingface_hub_does(tmp_path, case):
    from huggingface_hub import snapshot_download

    cache = tmp_path / "cache"
    _fake_cache(cache, refs=(("main", COMMIT),), snapshots=(OTHER,) if case ==
                "missing_snapshot" else (COMMIT,))
    repo_id = {"other_repo": "org/other", "malformed_id": "a/b/c"}.get(case, "org/model")
    revision = "v2" if case == "unknown_revision" else None
    with pytest.raises(Exception):
        snapshot_download(repo_id, revision=revision, cache_dir=str(cache), local_files_only=True)
    with pytest.raises(FileNotFoundError, match="not in the local huggingface cache"):
        hub.resolve_model_dir(repo_id, revision=revision, cache_dir=str(cache))
