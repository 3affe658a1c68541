"""The port stands alone: it never imports jax, flax, optax or
``deepspeed_tpu``, neither in its sources nor at run time."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu")

_DRIVE = """
import sys
import torch
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.transformer_lm import GPT, GPTConfig
from deepspeed_tpu_torch.module_inject import jax_params  # noqa: F401
cfg = GPTConfig(vocab_size=64, n_positions=256, n_embd=64, n_layer=1,
                n_head=2, dtype=torch.float32, use_flash_attention=True)
engine = deepspeed_tpu_torch.init_inference(GPT(cfg), dtype="fp32",
                                            device="cpu")
ids = torch.randint(0, 64, (1, 128))
assert engine(ids).shape == (1, 128, 64)
assert engine.generate(ids[:, :9], max_new_tokens=3).shape == (1, 3)
lcfg = GPTConfig(vocab_size=64, n_positions=256, n_embd=64, n_layer=1,
                 n_head=2, n_kv_head=1, norm="rmsnorm", activation="silu",
                 gated_mlp=True, use_bias=False, rotary=True,
                 learned_positions=False, tie_word_embeddings=False,
                 dtype=torch.float32, use_flash_attention=True)
llama = deepspeed_tpu_torch.init_inference(GPT(lcfg), dtype="fp32",
                                           device="cpu")
assert llama(ids).shape == (1, 128, 64)
assert llama.generate(ids[:, :9], max_new_tokens=3).shape == (1, 3)
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
tcfg = GPTConfig(vocab_size=64, n_positions=256, n_embd=64, n_layer=1,
                 n_head=2, dtype=torch.float32, use_flash_attention=True,
                 remat=True)
trainer, _, _, _ = deepspeed_tpu_torch.initialize(
    model=GPT(tcfg), device="cpu", config=dict(
        train_micro_batch_size_per_gpu=1, gradient_clipping=1.0,
        optimizer=dict(type="FusedAdam", params=dict(lr=1e-3)),
        tpu=dict(use_pallas_optimizer=True)))
batch = dict(input_ids=ids.numpy(), labels=ids.numpy())
loss = trainer.train_batch(iter(RepeatingLoader([batch])))
assert bool(torch.isfinite(loss)) and trainer.global_steps == 1
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
bcfg = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                  num_attention_heads=2, intermediate_size=64,
                  max_position_embeddings=64, dtype=torch.float32, remat=True)
bert, _, _, _ = deepspeed_tpu_torch.initialize(
    model=BertForPreTraining(bcfg), device="cpu", config=dict(
        train_micro_batch_size_per_gpu=1,
        optimizer=dict(type="FusedAdam", params=dict(lr=1e-3)),
        tpu=dict(use_pallas_optimizer=True),
        sparse_attention=dict(mode="bigbird", block=16, kernel="pallas")))
mlm = dict(input_ids=ids[:, :64].numpy(), labels=ids[:, :64].numpy())
loss = bert.train_batch(iter(RepeatingLoader([mlm])))
assert bool(torch.isfinite(loss)) and bert.global_steps == 1
print("loaded:" + ",".join(sorted(m for m in sys.modules
                                  if m.split(".")[0] in {forbidden!r})))
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_running_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _DRIVE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "loaded:", out.stdout


def test_sources_import_no_jax():
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "sparse_grad_spread.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert len(files) > 10
    assert not bad, bad
