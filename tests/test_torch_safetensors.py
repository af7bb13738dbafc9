"""The port's safetensors reader and writer (``vap_tpu_torch/utils/safetensors.py``)
against the ``safetensors`` package, and ``load_safetensors`` against the
JAX package's: every dtype the port takes, 0-d and empty tensors, metadata,
shards through an index, the component-directory candidates, and files
that break the format."""

import json
import os
import struct

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load
from safetensors.numpy import save_file as np_save
from safetensors.torch import load_file as torch_load
from safetensors.torch import save_file as torch_save

from vap_tpu.training import checkpoint as jckpt
from vap_tpu_torch.training.checkpoint import COMPONENT_FILES, load_lora_metadata, load_safetensors
from vap_tpu_torch.utils.safetensors import (DTYPES, SafetensorsDict, SafetensorsError,
                                             SafetensorsFile, read_metadata, save_file,
                                             save_sharded)

FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _tensors(seed=0):
    """One tensor of every dtype the port takes, each from a numpy seed, plus
    a 0-d, an empty and an odd-length one."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (name, dtype) in enumerate(sorted(DTYPES.items())):
        x = torch.from_numpy(rng.standard_normal((3, 5 + i)).astype(np.float32) * 20)
        out[f"t.{name}"] = x > 0 if dtype == torch.bool else x.to(dtype)
    out["zero_d"] = torch.tensor(-1.25, dtype=torch.bfloat16)
    out["empty"] = torch.empty((0, 7), dtype=torch.float32)
    out["odd.u8"] = torch.from_numpy(rng.integers(0, 255, 7, dtype=np.uint8))
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, so NaN and float8 compare bit for bit."""
    t = t.contiguous()
    return t.to(torch.uint8) if t.dtype == torch.bool else t.reshape(-1).view(torch.uint8)


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


def test_port_reads_the_package_bit_equal(tmp_path):
    want = _tensors()
    path = str(tmp_path / "a.safetensors")
    torch_save(want, path, metadata={"format": "pt", "note": "x"})
    f = SafetensorsFile(path)
    _assert_bit_equal(dict(f), want)
    assert f.metadata == {"format": "pt", "note": "x"}
    assert read_metadata(path) == f.metadata


@pytest.mark.parametrize("metadata", [None, {"format": "pt", "lora_config": "{\"r\": 4}"}, {}])
def test_package_reads_the_port_bit_equal(tmp_path, metadata):
    want = _tensors(1)
    path = str(tmp_path / "b.safetensors")
    n = save_file(want, path, metadata)
    assert n == os.path.getsize(path)
    _assert_bit_equal(torch_load(path), want)
    (header_len,) = struct.unpack("<Q", open(path, "rb").read(8))
    assert header_len % 8 == 0  # padded as the package pads
    from safetensors import safe_open

    with safe_open(path, "pt") as f:
        assert f.metadata() == ({"format": "pt"} if metadata is None else (metadata or None))


def test_numpy_side_and_bf16_through_ml_dtypes(tmp_path):
    """What ``safetensors.numpy`` writes (bf16 as ml_dtypes, as the JAX
    package's exports are) reads back bit-equal, and back again."""
    rng = np.random.default_rng(2)
    arrays = {"bf16": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
              "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
              "i64": rng.integers(-9, 9, (5,)), "scalar": np.array(3.5, np.float16)}
    path = str(tmp_path / "n.safetensors")
    np_save(arrays, path)
    got = SafetensorsFile(path)
    for k, a in arrays.items():
        t = got[k]
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        ref = a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a
        np.testing.assert_array_equal(raw.numpy(), ref)
    back = str(tmp_path / "back.safetensors")
    save_file(dict(got), back)
    for k, a in np_load(back).items():
        assert a.dtype == arrays[k].dtype and a.tobytes() == arrays[k].tobytes(), k


def test_views_copy_nothing_until_written(tmp_path):
    """A tensor read is a view of the map (no copy); writing it leaves the
    file as it was (the map is copy-on-write)."""
    path = str(tmp_path / "c.safetensors")
    save_file({"w": torch.arange(6, dtype=torch.float32)}, path)
    f = SafetensorsFile(path)
    a, b = f["w"], f["w"]
    assert a.data_ptr() == b.data_ptr()
    a.mul_(0)
    assert torch.equal(SafetensorsFile(path)["w"], torch.arange(6, dtype=torch.float32))


def _shards(d, tensors, names=("model-00001-of-00002.safetensors",
                                "model-00002-of-00002.safetensors")):
    keys = sorted(tensors)
    half = len(keys) // 2
    weight_map = {}
    for fname, part in zip(names, (keys[:half], keys[half:])):
        torch_save({k: tensors[k] for k in part}, os.path.join(d, fname))
        weight_map.update(dict.fromkeys(part, fname))
    index = os.path.join(d, "model.safetensors.index.json")
    with open(index, "w") as fh:
        json.dump({"metadata": {}, "weight_map": weight_map}, fh)
    return index


def test_shards_through_an_index(tmp_path):
    want = {k: v for k, v in _tensors(3).items() if v.dtype not in FLOAT8}
    index = _shards(str(tmp_path), want)
    got = load_safetensors(index)
    _assert_bit_equal(dict(got), want)
    assert len(got.files) == 2
    ref = jckpt.load_safetensors(index)  # the JAX package's, through safetensors.numpy
    assert set(ref) == set(want)
    for k, a in ref.items():
        t = got[k]
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy(),
            a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a, err_msg=k)


@pytest.mark.parametrize("shard_bytes", [10**9, 200])
def test_save_sharded_round_trip(tmp_path, shard_bytes):
    want = _tensors(4)
    save_sharded(want, str(tmp_path), max_shard_bytes=shard_bytes)
    names = sorted(os.listdir(tmp_path))
    if shard_bytes > 10**6:
        assert names == ["diffusion_pytorch_model.safetensors"]
    else:
        assert "diffusion_pytorch_model.safetensors.index.json" in names and len(names) > 3
    _assert_bit_equal(dict(load_safetensors(str(tmp_path))), want)


@pytest.mark.parametrize("present", list(range(len(COMPONENT_FILES))))
def test_component_directory_candidates(tmp_path, present):
    """A component directory resolves to the first candidate present, in
    the JAX package's order (``checkpoint.py:236-241``), as JAX's does."""
    tensors = {"w": torch.arange(4, dtype=torch.float32)}
    for i, name in enumerate(COMPONENT_FILES):
        if i < present:
            continue
        if name.endswith(".index.json"):
            shard = name.replace(".safetensors.index.json", "-00001-of-00001.safetensors")
            torch_save({"w": tensors["w"] + i}, str(tmp_path / shard))
            (tmp_path / name).write_text(json.dumps({"weight_map": {"w": shard}}))
        else:
            torch_save({"w": tensors["w"] + i}, str(tmp_path / name))
    got = load_safetensors(str(tmp_path))["w"]
    assert torch.equal(got, tensors["w"] + present)
    np.testing.assert_array_equal(got.numpy(), jckpt.load_safetensors(str(tmp_path))["w"])


def test_directory_without_weights_raises(tmp_path):
    for fn in (load_safetensors, jckpt.load_safetensors):
        with pytest.raises(FileNotFoundError, match="no \\(sharded\\) safetensors"):
            fn(str(tmp_path))


def test_later_file_wins_like_dict_update(tmp_path):
    a, b = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    save_file({"x": torch.zeros(2), "y": torch.ones(1)}, a)
    save_file({"x": torch.ones(2)}, b)
    d = SafetensorsDict([a, b])
    assert torch.equal(d["x"], torch.ones(2)) and torch.equal(d["y"], torch.ones(1))
    assert d["x"].shape == (2,)


def _write_raw(path, header: dict, buffer: bytes, pad=True):
    raw = json.dumps(header).encode()
    if pad:
        raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + buffer)


@pytest.mark.parametrize("case", ["overlap", "gap", "short_buffer", "long_buffer", "bad_size",
                                  "bad_dtype", "not_json", "header_too_long", "tiny_file",
                                  "bad_metadata"])
def test_broken_files_raise(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    good = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
            "b": {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}}
    buf = bytes(16)
    if case == "overlap":
        good["b"]["data_offsets"] = [4, 12]
    elif case == "gap":
        good["b"]["data_offsets"] = [12, 20]
        buf = bytes(20)
    elif case == "short_buffer":
        buf = bytes(12)
    elif case == "long_buffer":
        buf = bytes(24)
    elif case == "bad_size":
        good["b"]["shape"] = [3]
    elif case == "bad_dtype":
        good["b"]["dtype"] = "Q7"
    elif case == "bad_metadata":
        good["__metadata__"] = {"k": 1}
    if case == "not_json":
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 8) + b"{not js}" + buf)
    elif case == "header_too_long":
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 10**6) + b"{}")
    elif case == "tiny_file":
        with open(path, "wb") as f:
            f.write(b"\x01\x02")
    else:
        _write_raw(path, good, buf)
    with pytest.raises(SafetensorsError):
        SafetensorsFile(path)
    with pytest.raises(Exception):  # the package refuses the same files
        torch_load(path)


def test_lora_metadata_agrees(tmp_path):
    path = str(tmp_path / "l.safetensors")
    cfg = {"r": 4, "lora_alpha": 8.0, "peft_type": "LORA", "target_modules": ["to_q"]}
    save_file({"x": torch.zeros(1)}, path, {"format": "pt", "lora_config": json.dumps(cfg)})
    assert load_lora_metadata(path) == jckpt.load_lora_metadata(path) == cfg
    plain = str(tmp_path / "p.safetensors")
    save_file({"x": torch.zeros(1)}, plain)
    assert load_lora_metadata(plain) == jckpt.load_lora_metadata(plain) == {}
