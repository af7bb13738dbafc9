"""The port stands without JAX: every slice module, and the scripts that
drive it on the card, import with jax blocked, and importing them pulls in
neither jax nor the JAX package, nor ``safetensors``, ``huggingface_hub``
or ``transformers``, which the card's machine does not have."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_MODULES = [
    "vap_tpu_torch",
    "vap_tpu_torch.convert",
    "vap_tpu_torch.ops._build",
    "vap_tpu_torch.ops.attention",
    "vap_tpu_torch.ops.flash_attention",
    "vap_tpu_torch.ops.gemm_probe",
    "vap_tpu_torch.ops.int8_matmul",
    "vap_tpu_torch.ops.rope",
    "vap_tpu_torch.ops.schedulers",
    "vap_tpu_torch.ops.schedulers.common",
    "vap_tpu_torch.ops.schedulers.ddim",
    "vap_tpu_torch.ops.schedulers.dpm",
    "vap_tpu_torch.ops.schedulers.flow_match",
    "vap_tpu_torch.models.common",
    "vap_tpu_torch.models.cogvideox.config",
    "vap_tpu_torch.models.cogvideox.transformer_mot",
    "vap_tpu_torch.models.cogvideox.vae",
    "vap_tpu_torch.models.text_encoders.t5",
    "vap_tpu_torch.models.text_encoders.clip_vision",
    "vap_tpu_torch.models.text_encoders.clip_text",
    "vap_tpu_torch.models.text_encoders.llama",
    "vap_tpu_torch.models.hunyuan_video.config",
    "vap_tpu_torch.models.hunyuan_video.transformer",
    "vap_tpu_torch.models.hunyuan_video.vae",
    "vap_tpu_torch.models.wan.config",
    "vap_tpu_torch.models.wan.transformer_mot",
    "vap_tpu_torch.models.wan.vae",
    "vap_tpu_torch.pipelines.cogvideox_i2v_mot",
    "vap_tpu_torch.pipelines.offload",
    "vap_tpu_torch.pipelines.step_cache",
    "vap_tpu_torch.pipelines.wan_i2v_mot",
    "vap_tpu_torch.pipelines.hunyuan_video",
    "vap_tpu_torch.models.random_init",
    "vap_tpu_torch.models.loading",
    "vap_tpu_torch.utils",
    "vap_tpu_torch.utils.safetensors",
    "vap_tpu_torch.utils.hub",
    "vap_tpu_torch.infer",
    "vap_tpu_torch.infer.cog_vap",
    "vap_tpu_torch.infer.wan_vap",
    "vap_tpu_torch.training.specs",
    "vap_tpu_torch.data",
    "vap_tpu_torch.data.precomputation",
    "vap_tpu_torch.data.sampler",
    "vap_tpu_torch.training",
    "vap_tpu_torch.training.args",
    "vap_tpu_torch.training.checkpoint",
    "vap_tpu_torch.training.lora",
    "vap_tpu_torch.training.optimizer",
    "vap_tpu_torch.training.train_step",
    "vap_tpu_torch.training.trainer",
    "vap_tpu_torch.train",
    "vap_tpu_torch.scripts.linear_bench",
    "vap_tpu_torch.scripts.attention_ab",
    "vap_tpu_torch.parallel",
    "vap_tpu_torch.parallel.mesh",
    "vap_tpu_torch.parallel.ring_attention",
]

_PROBE = """
import importlib, sys
before = set(sys.modules)
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["cv2"] = None  # the port must run where cv2 is not installed
for name in ("safetensors", "huggingface_hub", "transformers"):
    sys.modules[name] = None  # not installed on the card's machine
for name in {modules!r}:
    importlib.import_module(name)
leaked = sorted(m for m in set(sys.modules) - before if m == "vap_tpu"
                or m.startswith(("vap_tpu.", "jax.", "cv2.", "safetensors.", "huggingface_hub.",
                                 "transformers.")))
assert not leaked, leaked
print("ok")
"""


@pytest.mark.parametrize("modules", [SLICE_MODULES, ["chip_smoke", "chip_profile"]],
                         ids=["slice", "chip_scripts"])
def test_port_imports_without_jax(modules):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(modules=modules)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_jax_sdpa_or_compile_in_port_sources():
    """The port imports neither jax, cv2, the JAX package, safetensors,
    huggingface_hub nor transformers, and calls neither torch's SDPA nor
    torch.compile."""
    banned = re.compile(r"^\s*(import (jax|cv2|safetensors|huggingface_hub|transformers)\b"
                        r"|from (jax|cv2|safetensors|huggingface_hub|transformers)\b)"
                        r"|vap_tpu\.|torch\.compile|scaled_dot_product_attention\(")
    root = os.path.join(REPO, "vap_tpu_torch")
    hits = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(dirpath, name)) as fh:
                    hits += [f"{name}:{n}: {line.strip()}" for n, line in enumerate(fh, 1)
                             if banned.search(line)]
    assert not hits, hits


def test_linear_bench_raises_without_a_card():
    """The rate probe's entry point measures the card: with no CUDA device
    it exits non-zero and prints no timing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "vap_tpu_torch.scripts.linear_bench",
                           "--impl", "diag"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "ms" not in proc.stdout
